// K11 and K11f: W4A8 GEMM over QTPU-packed weights on the int8 tensor cores.
//
// Replaces the Pallas kernels of quick_tpu/ops/quantized_matmul.py:
//   _make_kernel_a8 (:284) and _make_kernel_a8_fused (:324), launched from
//   _quantized_matmul_2d_a8 (:394, pallas_call :496 and :463).
//
// What it computes (numerics of _quantized_matmul_a8_jnp, :258-281): with
// per-row int8 activation codes xq and row scales sx (quantize_activations,
// :246), out = bf16(sx * [sum_g f32(xq_g . q_g) * s_g - rowsum(xq_g) * zs_g]),
// the per-group dot exact in int32. K11 reads the codes and sx that the
// wrapper computed; K11f reads bf16 x and quantizes each row once in a
// first small kernel (codes, sx and the groups' row sums, equal to
// quantize_activations': true divisions, round half to even, clamp +-127).
//
// What bounds it on the H100: at the prefill and Engine-chunk rows it takes
// (M > 96) the multiply-adds against the int8 tensor-core rate (1,979 TOP/s
// dense), or at M ~ 128 the packed weight stream (K*N/2 bytes of codes plus
// 8*(K/G)*N of f32 scales) against 3.35 TB/s.
//
// Design, K11: the body of qmm_mma_a8.cuh (mma.sync m16n8k32 s8 x s8 ->
// s32, 64 x 128 tiles of 8 warps), the group G a compile-time parameter
// (128, 64, 32: the JAX package leaves G != 128 to its jnp route, :415,
// whose arithmetic this kernel computes). Ragged M needs no padding: rows
// >= M read as zeros and are not written. When the output tiles cannot fill
// the card, K is split over blocks in chunks of 128 channels, as K1 splits
// it. Later work: K11 onto K11f's body.
//
// Design, K11f (G = 128; qmm_wgmma_a8.cuh): the output tile computed
// transposed on int8 wgmma (m64nBTk32) with the QTPU words' codes as the
// register operand and the row-quantized activations as the shared
// operand, a 6-stage ring of one group a stage filled by the Tensor Memory
// Accelerator, BT = 16, 32, 64 or 128 tokens a block from the wrapper's
// plan, each group's exact dot folded on the output side.
//
// Both write unscaled f32 partials when K is split; a second kernel sums
// them in a fixed order, multiplies by sx and rounds once.
//
// Not carried over from the TPU: the 32-row padding, the VMEM-sized
// (bm, bn, gpb) pickers, the sequential grid that lets the TPU quantize a
// row block once for all its column tiles (K11f's first kernel does that).
#include "qmm_mma_a8.cuh"
#include "qmm_wgmma_a8.cuh"

using namespace a8;

namespace {

constexpr int kMT = 2;             // m16 tiles per warp: 64-row blocks
constexpr int kBM = 32 * kMT;

template <int G, bool FUSED>
__global__ void __launch_bounds__(kThreads)
qmm_a8_kernel(const void* __restrict__ x, const float* __restrict__ sx,
              const uint32_t* __restrict__ qw, const float* __restrict__ scales,
              const float* __restrict__ zs, int M, int K, int N,
              int chunks_per_split, float* __restrict__ sx_out,
              float* __restrict__ partial, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CG = kChunk / G;
  constexpr size_t kSmem = smem_bytes<kBM, G>();
  float* sx_s = reinterpret_cast<float*>(smem + kSmem - kBM * 4);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ng = K / G;
  const int g0 = blockIdx.z * chunks_per_split * CG;
  const int g1 = min(ng, g0 + chunks_per_split * CG);
  const float* sx_rows = sx + m0;
  if (FUSED) {
    a8_row_scales<kBM>(static_cast<const bf16*>(x), K, M, K, m0, sx_s);
    __syncthreads();
    if (sx_out != nullptr && blockIdx.x == 0 && blockIdx.z == 0)
      for (int r = threadIdx.x; r < kBM && m0 + r < M; r += kThreads) sx_out[m0 + r] = sx_s[r];
    sx_rows = sx_s;
  }
  float acc[kMT][4][4];
  mma_groups_a8<kMT, G, FUSED>(x, K, M, qw, scales, zs, N, m0, n0, g0, g1, sx_s, smem, acc);
  store_a8<kMT>(acc, M, N, m0, n0, sx_rows,
                partial != nullptr ? partial + (size_t)blockIdx.z * M * N : nullptr, out);
}

// out[m, n] = bf16(sx[m] * sum_s partial[s, m, n]), the splits in order
__global__ void a8_splitk_reduce_kernel(const float* __restrict__ partial, int splits,
                                        int M, int N, const float* __restrict__ sx,
                                        bf16* __restrict__ out) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * mn + i];
  out[i] = __float2bfloat16_rn(s * sx[i / N]);
}

template <int G, bool FUSED>
cudaError_t launch(const void* x, const float* sx, const uint32_t* qw, const float* s,
                   const float* zs, int M, int K, int N, int splits, int cps,
                   float* sx_out, float* partial, bf16* out, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<kBM, G>();
  cudaError_t err = allow_smem(qmm_a8_kernel<G, FUSED>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  qmm_a8_kernel<G, FUSED><<<grid, kThreads, smem, st>>>(
      x, sx, qw, s, zs, M, K, N, cps, sx_out, splits > 1 ? partial : nullptr, out);
  return cudaGetLastError();
}

}  // namespace

// fused = 0 (K11): x int8 codes [M, K], sx f32 [M] (quantize_activations);
// splits and chunks_per_split (chunks of 128 channels; a last partial chunk
// counts as one) from the 64-row plan; rows and scratch unused.
// fused = 1 (K11f, G = 128 only): x bf16 [M, K]; sx f32 [M] scratch that
// the first kernel fills with the row scales; scratch: the int8 codes [M, K]
// then f32 row sums [K/128, (M + 3) & ~3], 16-byte aligned; rows (16, 32,
// 64, 128 tokens a block), splits and chunks_per_split (groups) from the
// wgmma plan; N % 4 == 0.
// Rows 16-byte aligned. qweight int32 [K/8, N]; scales, zeros_x_scales f32
// [K/G, N]; G = 128, 64 or 32, K % G == 0; partial: f32 [splits, M, N]
// scratch (splits > 1 only); out: [M, N] bf16.
extern "C" int qtt_quantized_matmul_a8(const void* x, void* sx, const void* qweight,
                                       const void* scales, const void* zeros_x_scales,
                                       int fused, int M, int K, int N, int G, int rows,
                                       int splits, int chunks_per_split, void* scratch,
                                       void* partial, void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || chunks_per_split <= 0 || sx == nullptr ||
      (G != 128 && G != 64 && G != 32) || K % G != 0 || (fused && (G != 128 || !scratch)))
    return cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto qw = static_cast<const uint32_t*>(qweight);
  auto s = static_cast<const float*>(scales);
  auto zs = static_cast<const float*>(zeros_x_scales);
  auto sxf = static_cast<float*>(sx);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<bf16*>(out);
  cudaError_t err;
  if (fused) {
    auto codes = static_cast<int8_t*>(scratch);
    auto rowsum = reinterpret_cast<float*>(codes + (size_t)M * K);
    err = qwa::launch(rows, static_cast<const bf16*>(x), qw, s, zs, codes, rowsum, sxf, M, K, N,
                      splits, chunks_per_split, part, o, st);
  } else {
    err = G == 64   ? launch<64, false>(x, sxf, qw, s, zs, M, K, N, splits, chunks_per_split,
                                         nullptr, part, o, st)
          : G == 32 ? launch<32, false>(x, sxf, qw, s, zs, M, K, N, splits, chunks_per_split,
                                         nullptr, part, o, st)
                    : launch<128, false>(x, sxf, qw, s, zs, M, K, N, splits, chunks_per_split,
                                          nullptr, part, o, st);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  a8_splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(part, splits, M, N, sxf, o);
  return cudaGetLastError();
}
