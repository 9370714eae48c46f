// K9: W4A16 GEMM for small quant groups (G = 32, GGUF's group, or 64) over
// QTPU-packed weights, dequantizing each weight before the dot.
//
// Replaces the Pallas kernel of quick_tpu/ops/quantized_matmul.py:
//   _make_kernel_dequant (:522), launched from _quantized_matmul_2d's
//   small-group branch (:721-847, pallas_call :870).
//
// What it computes: w[k, n] = bf16(code[k, n] * s[g, n] - zs[g, n]) with
// g = k / G, the product and the difference each rounded in f32 (no fused
// multiply-add, so the bf16 weight is the one XLA and the plain version
// round), then y = sum_k bf16(x[m, k]) * w[k, n] in f32, written as bf16.
// In the QTPU layout the code of k sits in nibble (k % G) / slab of packed
// row g * slab + k % slab, slab = G / 8: a 32-bit word holds 8 codes of one
// group at k-stride slab. The TPU kernel's x-column permutation
// (_small_g_perm :588) and its one-hot scale expansion (:560-571) are
// layout devices of the TPU and are not carried over.
//
// What bounds it on the H100: at decode (M <= 8) the weight stream, K*N/2
// bytes of codes plus 8*(K/G)*N bytes of f32 scales and zeros (at G = 32
// the scales are half the code bytes) against 3.35 TB/s; at prefill the
// multiply-adds against the bf16 tensor-core rate (989 TFLOP/s dense).
//
// Design (qmm_wgmma_dq.cuh): the output tile computed transposed on wgmma
// (m64nBTk16, bf16 in, f32 accumulate) with the weight as the register
// operand, dequantized straight from the QTPU words, the activations as the
// shared-memory operand, a ring of 128-deep stages filled by the Tensor
// Memory Accelerator (K need only be a multiple of G: a stage past the end
// of K reads zeros), BT = 8 (the decode rows, M <= 8), 16, 32, 64 or 128
// tokens a block from the wrapper's plan, one accumulator across K. Where
// the output tiles cannot fill the card, K is split over blocks into f32
// partials: at BT = 8 the last block of a tile sums them itself; above, a
// second kernel sums them. Both sum in split order, so results do not vary
// from run to run.
#include "qmm_wgmma_dq.cuh"

namespace {

__global__ void dq_splitk_reduce_kernel(const float* __restrict__ partial,
                                        int splits, size_t mn,
                                        bf16* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + i];
  out[i] = __float2bfloat16_rn(s);
}

}  // namespace

// x: [M, K] bf16, 16-byte aligned; qweight: int32 [K/8, N]; scales,
// zeros_x_scales: f32 [K/G, N], all three 16-byte aligned with N % 4 == 0;
// partial: f32 [splits, M, N] scratch (splits > 1 only); counters: int32
// [ceil(N / 128)], zero before the launch and left at zero by it (rows 8
// with splits > 1 only; one such launch at a time); out: [M, N] bf16. G =
// 32 or 64, K % G == 0. rows (8 for M <= 8, with at most 16 splits; else
// 16, 32, 64 or 128: the wgmma body's tokens per block), splits and
// chunks_per_split (chunks of 128 k) come from the wrapper's launch plan.
extern "C" int qtt_quantized_matmul_dequant(
    const void* x, const void* qweight, const void* scales,
    const void* zeros_x_scales, int M, int K, int N, int G, int rows,
    int splits, int chunks_per_split, void* partial, void* counters, void* out,
    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (G != 32 && G != 64) || K % G != 0 ||
      splits <= 0 || chunks_per_split <= 0)
    return cudaErrorInvalidValue;
  if (splits > 1 && (partial == nullptr || (rows == 8 && counters == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint32_t* qw = static_cast<const uint32_t*>(qweight);
  const float* sc = static_cast<const float*>(scales);
  const float* zs = static_cast<const float*>(zeros_x_scales);
  float* part = static_cast<float*>(partial);
  bf16* o = static_cast<bf16*>(out);
  int* cnt = static_cast<int*>(counters);
  cudaError_t err = G == 32
      ? qwd::launch<32>(rows, xb, qw, sc, zs, M, K, N, splits, chunks_per_split, part, o, cnt, st)
      : qwd::launch<64>(rows, xb, qw, sc, zs, M, K, N, splits, chunks_per_split, part, o, cnt, st);
  if (err != cudaSuccess || splits == 1 || rows == 8) return err;
  const size_t mn = (size_t)M * N;
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  dq_splitk_reduce_kernel<<<blocks, 256, 0, st>>>(part, splits, mn, o);
  return cudaGetLastError();
}
