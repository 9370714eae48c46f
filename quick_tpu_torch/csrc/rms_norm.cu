// K13: RMSNorm over the last dim.
//
// Replaces the Pallas kernel of quick_tpu/ops/norms.py:
//   _rms_norm_kernel (:38), launched from rms_norm_pallas (:46, pallas_call
//   :58). The JAX package leaves its model path to XLA, which fuses the jnp
//   rms_norm (:17) into one pass; eager PyTorch runs that expression as
//   about nine separate calls, so on the card every standalone rms_norm of
//   the port launches this kernel instead.
//
// What it computes: y = x * rsqrt(mean(x^2) + eps) * w, in f32, then cast
// once to x's type (bf16 or f32); w bf16 or f32. Rows may be strided
// (ldx >= D: the latent slice ckv[..., :512] of a 576-wide row); the output
// is contiguous [M, D].
//
// What bounds it on the H100: the bytes (x read, y written, w read) against
// 3.35 TB/s; at the model's sizes (a few to 512 rows of 4096) a launch is
// far shorter than its dispatch, so the host's cost is what it saves.
//
// Design: one block of 256 threads per row; each thread keeps its elements
// of the row in registers between the sum of squares and the scaling, so x
// is read once (rows up to kMaxPerThread * 256 elements; longer rows read x
// again). A warp-shuffle and shared-memory reduction gives the sum.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 16;  // 4096 elements held in registers

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, bf16* p) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const TX* __restrict__ x, int ldx, const TW* __restrict__ w, int D, float eps,
                TX* __restrict__ out) {
  __shared__ float red[kThreads / 32];
  const TX* row = x + (size_t)blockIdx.x * ldx;
  TX* orow = out + (size_t)blockIdx.x * D;
  float v[kMaxPerThread];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int k = threadIdx.x + i * kThreads;
    v[i] = k < D ? to_f32(row[k]) : 0.f;
    ss = fmaf(v[i], v[i], ss);
  }
  for (int k = threadIdx.x + kMaxPerThread * kThreads; k < D; k += kThreads) {
    const float f = to_f32(row[k]);
    ss = fmaf(f, f, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += red[i];
  const float r = rsqrtf(__fdiv_rn(total, (float)D) + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int k = threadIdx.x + i * kThreads;
    if (k < D) from_f32(v[i] * r * to_f32(w[k]), orow + k);
  }
  for (int k = threadIdx.x + kMaxPerThread * kThreads; k < D; k += kThreads)
    from_f32(to_f32(row[k]) * r * to_f32(w[k]), orow + k);
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, int ldx, const void* w, int M, int D, float eps, void* out,
                   cudaStream_t st) {
  rms_norm_kernel<TX, TW><<<M, kThreads, 0, st>>>(static_cast<const TX*>(x), ldx,
                                                  static_cast<const TW*>(w), D, eps,
                                                  static_cast<TX*>(out));
  return cudaGetLastError();
}

}  // namespace

// x: [M, ldx] (ldx >= D; x_f32 = 0: bf16, 1: f32); weight: [D] (w_f32 = 0:
// bf16, 1: f32); out: [M, D], x's type.
extern "C" int qtt_rms_norm(const void* x, int ldx, const void* weight, int M, int D, float eps,
                            int x_f32, int w_f32, void* out, void* stream) {
  if (M <= 0 || D <= 0 || ldx < D) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    return w_f32 ? launch<float, float>(x, ldx, weight, M, D, eps, out, st)
                 : launch<float, bf16>(x, ldx, weight, M, D, eps, out, st);
  }
  return w_f32 ? launch<bf16, float>(x, ldx, weight, M, D, eps, out, st)
               : launch<bf16, bf16>(x, ldx, weight, M, D, eps, out, st);
}
