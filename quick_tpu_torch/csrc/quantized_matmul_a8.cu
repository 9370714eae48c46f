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
// Design (qmm_wgmma_a8.cuh): a first small kernel writes each group's row
// sums (K11: a8_rowsum_kernel over the given codes; K11f: a8_quant_kernel,
// which also writes the codes and sx); then the output tile is computed
// transposed on int8 wgmma (m64nBTk32) with the QTPU words' codes as the
// register operand and the codes as the shared operand, a 6-stage ring of
// 128 depths a stage (128 / G groups: G = 128, 64 or 32, the JAX package
// leaving G != 128 to its jnp route, :415, whose arithmetic this computes)
// filled by the Tensor Memory Accelerator, BT = 16, 32, 64 or 128 tokens a
// block from the wrapper's plan, each group's exact dot folded on the
// output side. K11 and K11f share the body and the plan, so they agree bit
// for bit on the same x.
//
// When the output tiles cannot fill the card, K is split over blocks in
// chunks of 128 channels, as K1 splits it: the body writes unscaled f32
// partials and a second kernel sums them in a fixed order, multiplies by
// sx and rounds once.
//
// Not carried over from the TPU: the 32-row padding, the VMEM-sized
// (bm, bn, gpb) pickers, the sequential grid that lets the TPU quantize a
// row block once for all its column tiles (K11f's first kernel does that).
#include "qmm_wgmma_a8.cuh"

namespace {

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

}  // namespace

// fused = 0 (K11): x int8 codes [M, K], sx f32 [M] (quantize_activations);
// scratch: f32 row sums [K/G, (M + 3) & ~3].
// fused = 1 (K11f, G = 128 only): x bf16 [M, K]; sx f32 [M] scratch that
// the first kernel fills with the row scales; scratch: the int8 codes
// [M, K] then f32 row sums [K/128, (M + 3) & ~3].
// Both: rows (16, 32, 64, 128 tokens a block), splits and chunks_per_split
// (chunks of 128 channels; a last partial chunk counts as one) from the
// wrapper's plan; N % 4 == 0; x, scratch and the row sums 16-byte aligned.
// qweight int32 [K/8, N]; scales, zeros_x_scales f32 [K/G, N]; G = 128, 64
// or 32, K % G == 0; partial: f32 [splits, M, N] scratch (splits > 1
// only); out: [M, N] bf16.
extern "C" int qtt_quantized_matmul_a8(const void* x, void* sx, const void* qweight,
                                       const void* scales, const void* zeros_x_scales,
                                       int fused, int M, int K, int N, int G, int rows,
                                       int splits, int chunks_per_split, void* scratch,
                                       void* partial, void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || chunks_per_split <= 0 || sx == nullptr ||
      scratch == nullptr || (G != 128 && G != 64 && G != 32) || K % G != 0 ||
      (fused && G != 128))
    return cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto sxf = static_cast<float*>(sx);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<bf16*>(out);
  auto codes = fused ? static_cast<int8_t*>(scratch) : nullptr;
  auto rowsum = reinterpret_cast<float*>(static_cast<int8_t*>(scratch) +
                                         (fused ? (size_t)M * K : 0));
  cudaError_t err = qwa::launch(fused != 0, rows, G, x, static_cast<const uint32_t*>(qweight),
                                static_cast<const float*>(scales),
                                static_cast<const float*>(zeros_x_scales), codes, rowsum, sxf,
                                M, K, N, splits, chunks_per_split, part, o, st);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  a8_splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(part, splits, M, N, sxf, o);
  return cudaGetLastError();
}
