// K1: W4A16 GEMM over QTPU-packed weights, with a compile-time prologue
// (none | RMSNorm | SiLU-GLU) at the decode rows.
//
// Replaces the Pallas kernels of quick_tpu/ops/quantized_matmul.py:
//   _make_kernel (:115), _make_kernel_fused_norm (:160) and
//   _make_kernel_fused_glu (:204), launched from _quantized_matmul_2d (:692).
//
// What it computes (numerics of _quantized_matmul_jnp, :88-112): for every
// quant group g of 128 input channels, the bf16 activations times the
// integer codes summed in f32, scaled on the output side by scales[g, n],
// minus xsum_g * zeros_x_scales[g, n], where xsum_g sums the bf16-rounded
// activations of the group. The prologues round their result to bf16
// before both the dot and the xsum, as the Pallas prologues do (:182, :224).
//
// What bounds it on the H100: at decode (M <= 8) the packed weight stream,
// K*N/2 bytes of codes plus K*N/16 bytes of f32 scales, against 3.35 TB/s;
// the work per byte is tiny. At prefill (M = 512) the multiply-adds, here
// against the bf16 tensor-core rate (989 TFLOP/s dense). The wgmma body
// falls short of that: at M = 4096 its tile copies (128 x 128 tiles move
// ~9.5 GB from L2 for a 4096 x 28672 x 4096 product, x four times the
// weights' bytes) take ~2/3 of its time alone, and each group's fold waits
// for that group's MMAs.
//
// Both bodies compute the output tile transposed on wgmma (bf16 in, f32
// accumulate) with the weight as the register operand, dequantized straight
// from the QTPU words (whose j-major order is already k16 fragment order;
// qmm_wgmma.cuh), and fold each group's dot on the output side before the
// next, as the numerics above.
//
// More than 8 rows (qmm_wgmma.cuh): m64nBTk16, the activations and their
// group sums as the shared-memory operand through a 4-stage ring filled by
// the Tensor Memory Accelerator, BT = 16, 32, 64 or 128 tokens a block from
// the wrapper's plan, no prologue.
//
// The decode rows (M <= 8, `decode_kernel` below): one 8-token tile,
// m64n8k16, on K9's decode skeleton (qmm_wgmma_dq.cuh): K split by the
// wrapper's dequant_decode_plan (one 128-deep stage a K1 group, at most 16
// splits), an 8-stage TMA ring of the words, scales and zeros_x_scales (a
// stage is 9 KB; two blocks an SM), the last block of a column tile
// merging the splits' f32 partials in split order (decode_store), and a
// programmatic dependent launch. The body (qmm_decode_rows.cuh, shared
// with K14, the decode layer tail) stages the 8-row B tile itself, with
// the prologue applied, and folds each group's dot once its 8 MMAs are
// done. RMSNorm needs whole-row statistics, so a first small kernel
// (rms_stats_kernel) computes rsqrt(mean(x^2) + eps) per row, and the
// decode kernel, a programmatic dependent of it, reads them after
// griddepcontrol.wait.
//
// Not carried over from the TPU: the 8-row padding, the (8, K) broadcast
// of the norm weight, the VMEM tile pickers.
#include "qmm_decode_rows.cuh"
#include "qmm_wgmma.cuh"

namespace {

__global__ void rms_stats_kernel(const bf16* __restrict__ x, int ldx, int K,
                                 float eps, float* __restrict__ rstd) {
  __shared__ float red[8];
  const bf16* row = x + (size_t)blockIdx.x * ldx;
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = bf2f(row[k]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += red[w];
    rstd[blockIdx.x] = rsqrtf(tot / (float)K + eps);
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     int splits, size_t mn,
                                     bf16* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + i];
  out[i] = __float2bfloat16_rn(s);
}

// ------------------------------------------------------------ decode rows
namespace qwk {

// out[0:M, n0:n0+128] of prologue(x) @ dequant(qw) over the groups g0 ..
// g0 + gps - 1 (M <= 8; the body is qmm_decode_rows.cuh's, the block's
// stream its one item): into partial [splits, M, N] f32 and merged by the
// tile's last block when the grid has splits, else straight into out [M,
// N] bf16 (decode_store)
template <int PRO>
__global__ void __launch_bounds__(kThreads, 2)
decode_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ x, int ldx,
              const bf16* __restrict__ nw, const float* __restrict__ rstd, int M, int K, int N,
              int gps, float* __restrict__ partial, bf16* __restrict__ out,
              int* __restrict__ counters) {
  using L = Layout;
  extern __shared__ unsigned char qwk_smem[];
  unsigned char* smem = qwk_smem + ((1024 - (qwg::smem_u32(qwk_smem) & 1023)) & 1023);
  const uint32_t sbase = qwg::smem_u32(smem);
  const uint32_t full = sbase + L::oBar;  // full[s] = full + 8s
  const uint32_t empty = full + 8 * kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int c0 = (tid >> 7) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int n0 = blockIdx.y * kBN;
  const int g0 = blockIdx.z * gps;
  const int nit = max(0, min(K / kG, g0 + gps) - g0);

  // thread 0: group g0 + j's copies into stage j % kStages
  auto load = [&](int j) { load_stage(maps, sbase, j, n0, g0 + j); };
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.w) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.s) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.z) : "memory");
    init_ring(full, empty);
  }
  __syncthreads();
  // a programmatic dependent launch: x, rstd and the words are read after
  // the kernel before has finished
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0)
    for (int j = 0; j < kStages - 1 && j < nit; ++j) load(j);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  decode_rows<PRO, false>(smem, x, ldx, nw, rstd, M, K, g0, nit, 0, [&](int it) {
    if (tid == 0 && it + kStages - 1 < nit) load(it + kStages - 1);
  }, acc);
  qwd::decode_store(acc, smem, M, N, n0, c0, t, tid, partial, out, counters);
}

template <int PRO>
cudaError_t launch_pro(const bf16* x, int ldx, const uint32_t* qw, const float* scales,
                       const float* zs, const bf16* nw, const float* rstd, int M, int K, int N,
                       int splits, int gps, float* partial, bf16* out, int* counters,
                       cudaStream_t st) {
  Maps maps;
  if (!encode_maps(&maps, qw, scales, zs, K, N)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(decode_kernel<PRO>, Layout::kBytes);
  if (err != cudaSuccess) return err;
  // programmatic stream serialization: the blocks may start, and set up
  // their barriers and maps, while the kernel before finishes; they wait
  // for it before their first read (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, (N + kBN - 1) / kBN, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout::kBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_kernel<PRO>, maps, x, ldx, nw, rstd, M, K, N, gps,
                           splits > 1 ? partial : nullptr, out, counters);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace qwk
}  // namespace

// x: [M, ldx] bf16, 16-byte aligned (ldx = K, or 2K for the GLU prologue:
// [gate | up]); qweight: int32 [K/8, N]; scales, zeros_x_scales: f32
// [K/128, N], all three 16-byte aligned with N % 4 == 0; norm_weight: bf16
// [K] (RMSNorm prologue only); rstd: f32 [M] scratch (RMSNorm only);
// partial: f32 [splits, M, N] scratch (splits > 1 only); xsum: f32
// [K/128, (M + 3) & ~3] scratch, 16-byte aligned (rows > 8 only);
// counters: int32 [ceil(N / 128)], zero before the launch and left at zero
// by it (rows 8 with splits > 1 only; one such launch at a time); out:
// [M, N] bf16. rows (8: the decode rows, M <= 8, any prologue, at most 16
// splits; 16, 32, 64, 128: the wgmma body's tokens per block, no
// prologue), splits and groups_per_split come from the wrapper's launch
// plan.
extern "C" int qtt_quantized_matmul(
    const void* x, int ldx, const void* qweight, const void* scales,
    const void* zeros_x_scales, const void* norm_weight, float eps,
    int prologue, int M, int K, int N, int rows, int splits,
    int groups_per_split, void* rstd, void* partial, void* xsum, void* counters, void* out,
    void* stream) {
  if (M <= 0 || K % qwg::kG != 0 || N <= 0 || N % 4 != 0 || splits <= 0 || groups_per_split <= 0)
    return cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint32_t* qw = static_cast<const uint32_t*>(qweight);
  const float* sc = static_cast<const float*>(scales);
  const float* zs = static_cast<const float*>(zeros_x_scales);
  float* part = static_cast<float*>(partial);
  bf16* o = static_cast<bf16*>(out);
  if (rows == 8) {
    if (M > 8 || splits > qwk::kMaxSplits || (splits > 1 && counters == nullptr))
      return cudaErrorInvalidValue;
    const bf16* nw = static_cast<const bf16*>(norm_weight);
    float* rs = static_cast<float*>(rstd);
    int* cnt = static_cast<int*>(counters);
#define QWK_LAUNCH(P) \
  qwk::launch_pro<P>(xb, ldx, qw, sc, zs, nw, rs, M, K, N, splits, groups_per_split, part, o, cnt, st)
    switch (prologue) {
      case kNone: return QWK_LAUNCH(kNone);
      case kSiluGlu: return QWK_LAUNCH(kSiluGlu);
      case kRmsNorm: {
        if (rs == nullptr || nw == nullptr) return cudaErrorInvalidValue;
        rms_stats_kernel<<<M, 256, 0, st>>>(xb, ldx, K, eps, rs);
        const cudaError_t err = cudaGetLastError();
        return err != cudaSuccess ? err : QWK_LAUNCH(kRmsNorm);
      }
      default: return cudaErrorInvalidValue;
    }
#undef QWK_LAUNCH
  }
  if (prologue != kNone || xsum == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = qwg::launch(rows, xb, ldx, qw, sc, zs, static_cast<float*>(xsum), M, K, N,
                                splits, groups_per_split, part, o, st);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  splitk_reduce_kernel<<<blocks, 256, 0, st>>>(part, splits, mn, o);
  return cudaGetLastError();
}
