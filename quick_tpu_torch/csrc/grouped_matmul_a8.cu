// K12: grouped (ragged) W4A8 GEMM for MoE experts over expert-sorted
// bm-row tiles, on the int8 tensor cores.
//
// Replaces the Pallas kernel of quick_tpu/ops/grouped_matmul.py:
//   _make_grouped_kernel_a8 (:93), launched from quantized_matmul_grouped
//   (:205, pallas_call :274) under a8 (QUICK_TPU_MOE_A8=1).
//
// What it computes: for every bm-row tile i of the int8 codes xq [Mp, K]
// (rows sorted by expert, build_routing; codes and row scales sx [Mp] from
// quantize_activations), the tile's rows times the codes of expert
// e = tile_expert[i], read on the card: per quant group of 128 channels the
// integer dot in int32, as f32 times scales[e, g, n], minus
// rowsum(xq_g) * zeros_x_scales[e, g, n], summed over K in f32; then times
// sx and rounded once to bf16. The Pallas kernel writes the unscaled f32
// sum and XLA multiplies by sx outside it (:297; a [Mp, 1] operand pads
// 128x on the TPU); here the same f32 multiply runs in the epilogue before
// the same single rounding. Tiles with tile_live[i] == 0 (past the last
// routed segment) are written as zeros, as the Pallas kernel writes them.
//
// What bounds it on the H100: at decode each tile streams its expert's
// packed weights (K*N/2 bytes of codes plus 8*(K/128)*N of f32 scales), so
// the bytes of the distinct experts a launch touches against 3.35 TB/s; at
// prefill the routed multiply-adds against the int8 tensor-core rate (1,979
// TOP/s dense), half K8's bf16 bound.
//
// Design: K11's first int8 body (qmm_mma_a8.cuh: mma.sync m16n8k32 s8 x s8 -> s32)
// with a per-block expert base pointer, as K8 uses K1's. A block covers
// BM = 32 or 64 rows and 128 columns with 8 warps; BM divides bm, so a
// block never spans two tiles. Only G = 128 (the JAX package falls back to
// W4A16 at other groups or bm % 32 != 0, :233, and so does the wrapper).
//
// Not carried over from the TPU: the scalar-prefetched BlockSpec index maps,
// the VMEM-sized (bn, gpb) pickers. Later work: wgmma, TMA, and reading each
// expert's weights once per expert rather than once per tile.
#include "qmm_mma_a8.cuh"

using namespace a8;

namespace {

template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 3 : 2)
grouped_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
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
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int r = i / kBN, n = n0 + i % kBN;
      if (n < N) out[(size_t)(m0 + r) * N + n] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  const int ng = K / kChunk;
  const size_t e = (size_t)tile_expert[tile];
  float acc[MT][4][4];
  mma_groups_a8<MT, kChunk>(xq, K, Mp, qw_all + e * (size_t)(K / kPack) * N,
                            scales_all + e * (size_t)ng * N, zs_all + e * (size_t)ng * N,
                            N, m0, n0, 0, ng, smem, acc);
  store_a8<MT>(acc, Mp, N, m0, n0, sx + m0, nullptr, out);
}

template <int MT>
cudaError_t launch(const int8_t* xq, const float* sx, const uint32_t* qw, const float* s,
                   const float* zs, const int* te, const int* live, int Mp, int K, int N,
                   int bm, bf16* out, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<32 * MT, kChunk>();
  cudaError_t err = allow_smem(grouped_a8_kernel<MT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, Mp / (32 * MT));
  grouped_a8_kernel<MT><<<grid, kThreads, smem, st>>>(xq, sx, qw, s, zs, te, live, Mp, K, N,
                                                      bm, out);
  return cudaGetLastError();
}

}  // namespace

// xq: [Mp, K] int8 codes, 16-byte aligned, rows sorted by expert in bm-row
// tiles; sx: [Mp] f32 row scales; qweight: int32 [E, K/8, N]; scales,
// zeros_x_scales: f32 [E, K/128, N]; tile_expert, tile_live: int32 [Mp/bm]
// (device); out: [Mp, N] bf16. bm % 32 == 0, Mp % bm == 0, K % 128 == 0.
// Blocks of 64 rows where bm allows, else 32.
extern "C" int qtt_grouped_matmul_a8(const void* xq, const void* sx, const void* qweight,
                                     const void* scales, const void* zeros_x_scales,
                                     const void* tile_expert, const void* tile_live,
                                     int Mp, int K, int N, int E, int bm, void* out,
                                     void* stream) {
  if (Mp <= 0 || K <= 0 || N <= 0 || E <= 0 || bm <= 0 || bm % 32 != 0 || Mp % bm != 0 ||
      K % kChunk != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int8_t*>(xq);
  auto s_x = static_cast<const float*>(sx);
  auto qw = static_cast<const uint32_t*>(qweight);
  auto s = static_cast<const float*>(scales);
  auto zs = static_cast<const float*>(zeros_x_scales);
  auto te = static_cast<const int*>(tile_expert);
  auto live = static_cast<const int*>(tile_live);
  auto o = static_cast<bf16*>(out);
  if (bm % 64 == 0) return launch<2>(x, s_x, qw, s, zs, te, live, Mp, K, N, bm, o, st);
  return launch<1>(x, s_x, qw, s, zs, te, live, Mp, K, N, bm, o, st);
}
