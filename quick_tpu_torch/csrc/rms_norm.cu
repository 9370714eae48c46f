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
// 3.35 TB/s: 0.02 us at 4 rows of 4096, 2.5 us at 512. A launch takes a few
// microseconds, so it is bound by its launch and its chain of dependent
// memory round trips; the design cuts both.
//
// Design: one global round trip before compute. A row belongs to a group
// of 2^lg lanes (32, 64 or 128: a warp, or a few warps of one block), each
// lane holding up to kMaxUnits units of the row in registers, a unit 8
// values (one 16-byte load of bf16, two of f32); lane l holds units l, l +
// 2^lg, ... (ops/norms.py::norm_plan: Mistral's 4096-wide rows take 128
// lanes x 4 units, a block each; DeepSeek's 512-wide latent rows a warp x
// 2 units, 8 rows a block). Each lane issues all its loads before it uses
// any: the weight's units first, before griddepcontrol.wait (the kernel
// before does not write a norm weight), then x's. The sum of squares is a warp shuffle,
// plus one shared-memory round when a row spans warps; the division by D
// is IEEE (__fdiv_rn). A row whose base or stride is off 16 bytes, or whose
// width is no whole number of units or longer than 128 x kMaxUnits units,
// takes the scalar path (a block a row, 256 lanes, values past the 16 a
// lane holds read twice). It is a programmatic dependent launch
// (cudaLaunchKernelEx with programmatic stream serialization, as K9's and
// K1's decode rows, which often follow it): its blocks start while the
// kernel before finishes, and once its loads are in flight it lets the
// kernel after start setting up (griddepcontrol.launch_dependents); that
// kernel waits for this one to finish before it reads (griddepcontrol.
// wait), and this one waits on no kernel after it.
#include "common.cuh"

namespace {

constexpr int kMaxUnits = 4;       // units a lane holds at most
constexpr int kBlock = 256;        // threads a block at most
constexpr int kMaxPerThread = 16;  // the scalar path's values held in registers

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, bf16* p) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }

// a unit of 8 values of type T: 16-byte loads
template <typename T>
struct Unit {
  static constexpr int kLoads = sizeof(T) / 2;
  uint4 q[kLoads];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) q[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ void values(float (&f)[8]) const {
    if constexpr (sizeof(T) == 2) {
      const uint32_t u[4] = {q[0].x, q[0].y, q[0].z, q[0].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[2 * k] = __uint_as_float(u[k] << 16);
        f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        f[4 * i] = __uint_as_float(q[i].x);
        f[4 * i + 1] = __uint_as_float(q[i].y);
        f[4 * i + 2] = __uint_as_float(q[i].z);
        f[4 * i + 3] = __uint_as_float(q[i].w);
      }
    }
  }
};

__device__ __forceinline__ void store8(const float (&f)[8], bf16* p) {
  uint4 v;
  uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    u[k] = *reinterpret_cast<uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = v;
}
__device__ __forceinline__ void store8(const float (&f)[8], float* p) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// rows of 2^lg lanes, V units a lane, blockDim.x >> lg rows a block
template <typename TX, typename TW>
__global__ void __launch_bounds__(kBlock)
rms_norm_vec(const TX* __restrict__ x, int ldx, const TW* __restrict__ w, int M, int D,
             float eps, int lg, int V, TX* __restrict__ out) {
  __shared__ float red[kBlock / 32];
  const int lanes = 1 << lg;
  const int row = blockIdx.x * (blockDim.x >> lg) + (threadIdx.x >> lg);
  const int lane = threadIdx.x & (lanes - 1);
  const int U = D >> 3;
  const bool ok = row < M;
  Unit<TW> wu[kMaxUnits];
#pragma unroll
  for (int v = 0; v < kMaxUnits; ++v) {
    const int u = lane + (v << lg);
    if (v < V && u < U) wu[v].load(w + 8 * u);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const TX* xrow = x + (size_t)row * ldx;
  Unit<TX> xu[kMaxUnits];
#pragma unroll
  for (int v = 0; v < kMaxUnits; ++v) {
    const int u = lane + (v << lg);
    if (ok && v < V && u < U) xu[v].load(xrow + 8 * u);
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < kMaxUnits; ++v) {
    const int u = lane + (v << lg);
    if (ok && v < V && u < U) {
      float f[8];
      xu[v].values(f);
#pragma unroll
      for (int k = 0; k < 8; ++k) ss = fmaf(f[k], f[k], ss);
    }
  }
  ss = warp_sum(ss);
  if (lg > 5) {  // the row's warps: one shared-memory round
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int w0 = (threadIdx.x >> 5) & ~((lanes >> 5) - 1);
    ss = 0.f;
    for (int q = 0; q < (lanes >> 5); ++q) ss += red[w0 + q];
  }
  const float r = rsqrtf(__fdiv_rn(ss, (float)D) + eps);
  TX* orow = out + (size_t)row * D;
#pragma unroll
  for (int v = 0; v < kMaxUnits; ++v) {
    const int u = lane + (v << lg);
    if (ok && v < V && u < U) {
      float f[8], g[8];
      xu[v].values(f);
      wu[v].values(g);
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = f[k] * r * g[k];
      store8(f, orow + 8 * u);
    }
  }
}

// the scalar path: a block of kBlock threads a row, any alignment; each
// thread keeps up to kMaxPerThread of the row's values in registers between
// the sum of squares and the scaling (longer rows read x again)
template <typename TX, typename TW>
__global__ void __launch_bounds__(kBlock)
rms_norm_kernel(const TX* __restrict__ x, int ldx, const TW* __restrict__ w, int D, float eps,
                TX* __restrict__ out) {
  __shared__ float red[kBlock / 32];
  const TX* row = x + (size_t)blockIdx.x * ldx;
  TX* orow = out + (size_t)blockIdx.x * D;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float v[kMaxPerThread];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int k = threadIdx.x + i * kBlock;
    v[i] = k < D ? to_f32(row[k]) : 0.f;
    ss = fmaf(v[i], v[i], ss);
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int k = threadIdx.x + kMaxPerThread * kBlock; k < D; k += kBlock) {
    const float f = to_f32(row[k]);
    ss = fmaf(f, f, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kBlock / 32; ++i) total += red[i];
  const float r = rsqrtf(__fdiv_rn(total, (float)D) + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int k = threadIdx.x + i * kBlock;
    if (k < D) from_f32(v[i] * r * to_f32(w[k]), orow + k);
  }
  for (int k = threadIdx.x + kMaxPerThread * kBlock; k < D; k += kBlock)
    from_f32(to_f32(row[k]) * r * to_f32(w[k]), orow + k);
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, int ldx, const void* w, int M, int D, float eps, int lg,
                   int V, int rows, int pdl, void* out, cudaStream_t st) {
  // programmatic stream serialization (pdl): the blocks may start, and load
  // the weight, while the kernel before finishes; they wait for it before
  // they read x (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(V > 0 ? rows << lg : kBlock);
  cfg.gridDim = dim3(V > 0 ? (M + rows - 1) / rows : M);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  const cudaError_t err =
      V > 0 ? cudaLaunchKernelEx(&cfg, rms_norm_vec<TX, TW>, xp, ldx, wp, M, D, eps, lg, V, op)
            : cudaLaunchKernelEx(&cfg, rms_norm_kernel<TX, TW>, xp, ldx, wp, D, eps, op);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x: [M, ldx] (ldx >= D; x_f32 = 0: bf16, 1: f32); weight: [D] (w_f32 = 0:
// bf16, 1: f32); out: [M, D], x's type, contiguous. The plan
// (ops/norms.py::norm_plan): log2 of the lanes a row (lg, 5-7), the units a
// lane (units 1-4; 0: the scalar path, whose pointers need no alignment)
// and the rows a block (rows << lg <= 256); pdl 1: a programmatic dependent
// launch. The vector path needs D % 8 == 0, x, weight and the row stride on
// 16 bytes and 2^lg x units x 8 >= D.
extern "C" int qtt_rms_norm(const void* x, int ldx, const void* weight, int M, int D, float eps,
                            int x_f32, int w_f32, int lg, int units, int rows, int pdl,
                            void* out, void* stream) {
  if (M <= 0 || D <= 0 || ldx < D) return cudaErrorInvalidValue;
  if (units != 0) {
    const int xsize = x_f32 ? 4 : 2;
    if (lg < 5 || lg > 7 || units < 0 || units > kMaxUnits || rows <= 0 ||
        (rows << lg) > kBlock || D % 8 || (long long)(units << lg) * 8 < D || !aligned16(x) ||
        !aligned16(weight) || (M > 1 && ((long long)ldx * xsize) % 16))
      return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    return w_f32 ? launch<float, float>(x, ldx, weight, M, D, eps, lg, units, rows, pdl, out, st)
                 : launch<float, bf16>(x, ldx, weight, M, D, eps, lg, units, rows, pdl, out, st);
  }
  return w_f32 ? launch<bf16, float>(x, ldx, weight, M, D, eps, lg, units, rows, pdl, out, st)
               : launch<bf16, bf16>(x, ldx, weight, M, D, eps, lg, units, rows, pdl, out, st);
}
