// K8: grouped (ragged) W4A16 GEMM for MoE experts over expert-sorted
// bm-row tiles.
//
// Replaces the Pallas kernel of quick_tpu/ops/grouped_matmul.py:
//   _make_grouped_kernel (:48), launched from quantized_matmul_grouped
//   (:205, pallas_call :274).
//
// What it computes: for every bm-row tile i of x [Mp, K] bf16 (rows sorted
// by expert, build_routing), the tile's rows times dequant(qweight[e]) with
// e = tile_expert[i], read on the card, with K1's numerics: per quant group
// of G input channels, the bf16 activations times the integer codes summed
// in f32, the group scale applied on the output side, minus
// xsum_g * zeros_x_scales[e, g, n], the sum over K in f32, written as
// bf16. Tiles with tile_live[i] == 0 (past the last routed segment) are
// written as zeros, as the Pallas kernel writes them (:84-88). Weights are
// the per-expert QTPU layout: qweight int32 [E, K/8, N], scales and
// zeros_x_scales f32 [E, K/G, N]; expert offsets are 64-bit. G is 128 (the
// Pallas kernel's group) or 64 or 32: the JAX package runs small-group
// experts on _grouped_fallback (:146-196), whose output-side form this
// kernel computes at every G.
//
// What bounds it on the H100: at decode each tile streams its expert's
// packed weights (K*N/2 bytes of codes plus 8*(K/G)*N of f32 scales), so the
// bytes of the distinct experts a launch touches against 3.35 TB/s; at
// prefill the routed multiply-adds (2 * T * topk * K * N) against the bf16
// tensor-core rate (989 TFLOP/s dense).
//
// Design: K1's tensor-core prefill body (qmm_mma.cuh: mma.sync m16n8k16,
// bf16 in, f32 accumulate; codes turned into bf16 exactly and staged
// n-major with k contiguous on padded rows; the group a compile-time
// parameter) with a per-block expert base pointer. A block covers BM = 32 or 64 rows and 128 columns with 8 warps
// (2 row groups x 4 column groups); BM divides bm, so a block never spans
// two tiles and has one expert, and a tile of 64 or 128 rows spans several
// blocks. The block reads its expert and live flag from device memory: the
// host never sees them. Blocks run in no order and carry nothing between them; the
// group loop runs inside the block.
//
// Not carried over from the TPU: the VMEM-sized (bn, gpb) tile pickers,
// the scalar-prefetched BlockSpec index maps. Later work: wgmma, TMA, and
// reading each expert's weights once per expert rather than once per tile.
#include "qmm_mma.cuh"

namespace {

// MT = m16 tiles per warp: BM = 2 warps x MT x 16 rows. Blocks per SM are
// pinned: three of 32 rows (<= 85 registers), two of 64 (<= 128). With one
// block fewer per SM (98 or 144 registers), K8 ran 10-46 % slower.
template <int MT, int G>
__global__ void __launch_bounds__(kMmaThreads, MT == 1 ? 3 : 2)
grouped_mma_kernel(const bf16* __restrict__ x,
                   const uint32_t* __restrict__ qw_all,
                   const float* __restrict__ scales_all,
                   const float* __restrict__ zs_all,
                   const int* __restrict__ tile_expert,
                   const int* __restrict__ tile_live,
                   int Mp, int K, int N, int bm, bf16* __restrict__ out) {
  constexpr int BM = 32 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int tile = m0 / bm;

  if (tile_live[tile] == 0) {  // dead tile: zeros, no weight traffic
    for (int i = threadIdx.x; i < BM * kBN; i += kMmaThreads) {
      const int r = i / kBN, n = n0 + i % kBN;
      if (n < N) out[(size_t)(m0 + r) * N + n] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  const int ng = K / G;
  const size_t e = (size_t)tile_expert[tile];
  float acc[MT][4][4];
  mma_groups<MT, G>(x, K, Mp, qw_all + e * (size_t)(K / kPack) * N,
                    scales_all + e * (size_t)ng * N, zs_all + e * (size_t)ng * N,
                    N, m0, n0, 0, ng, smem, acc);
  mma_store<MT>(acc, Mp, N, m0, n0, nullptr, out);
}

template <int MT, int G>
cudaError_t launch(const bf16* x, const uint32_t* qw, const float* s,
                   const float* zs, const int* te, const int* live, int Mp,
                   int K, int N, int bm, bf16* out, cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<32 * MT, G>();
  cudaError_t err = allow_smem(grouped_mma_kernel<MT, G>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, Mp / (32 * MT));
  grouped_mma_kernel<MT, G><<<grid, kMmaThreads, smem, st>>>(x, qw, s, zs, te, live,
                                                             Mp, K, N, bm, out);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_g(const bf16* x, const uint32_t* qw, const float* s,
                     const float* zs, const int* te, const int* live, int Mp,
                     int K, int N, int bm, bf16* out, cudaStream_t st) {
  if (bm % 64 == 0) return launch<2, G>(x, qw, s, zs, te, live, Mp, K, N, bm, out, st);
  return launch<1, G>(x, qw, s, zs, te, live, Mp, K, N, bm, out, st);
}

}  // namespace

// x: [Mp, K] bf16, 16-byte aligned, rows sorted by expert in bm-row tiles;
// qweight: int32 [E, K/8, N]; scales, zeros_x_scales: f32 [E, K/G, N];
// tile_expert, tile_live: int32 [Mp/bm] (device); out: [Mp, N] bf16.
// G = 128, 64 or 32; bm % 32 == 0, Mp % bm == 0, K % G == 0. Blocks of 64 rows where bm allows, else 32.
extern "C" int qtt_grouped_matmul(const void* x, const void* qweight,
                                  const void* scales, const void* zeros_x_scales,
                                  const void* tile_expert, const void* tile_live,
                                  int Mp, int K, int N, int E, int bm, int G,
                                  void* out, void* stream) {
  if (Mp <= 0 || K <= 0 || N <= 0 || E <= 0 || bm <= 0 || bm % 32 != 0 ||
      Mp % bm != 0 || (G != 128 && G != 64 && G != 32) || K % G != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto qw = static_cast<const uint32_t*>(qweight);
  auto s = static_cast<const float*>(scales);
  auto zs = static_cast<const float*>(zeros_x_scales);
  auto te = static_cast<const int*>(tile_expert);
  auto live = static_cast<const int*>(tile_live);
  auto o = static_cast<bf16*>(out);
  if (G == 64) return launch_g<64>(xb, qw, s, zs, te, live, Mp, K, N, bm, o, st);
  if (G == 32) return launch_g<32>(xb, qw, s, zs, te, live, Mp, K, N, bm, o, st);
  return launch_g<kG>(xb, qw, s, zs, te, live, Mp, K, N, bm, o, st);
}
