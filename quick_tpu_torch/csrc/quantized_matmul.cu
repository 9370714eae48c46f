// K1: W4A16 GEMM over QTPU-packed weights, with a compile-time prologue
// (none | RMSNorm | SiLU-GLU).
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
// Design, decode (M <= 8; the body is qmm_decode.cuh, which K14 shares):
// one thread owns one output column n, so a
// warp's loads of a packed row are 128 contiguous bytes; the 16 words of a
// group are issued together before the activations are staged, so they are
// in flight while the block stages the group's activations (prologue
// applied, bf16-rounded, as f32 in shared memory, k-major so the ROWS values
// of one k are one vector load). Codes become floats with the 0x4B000000
// exponent trick (exact). Blocks run in no order, so there is no carried
// accumulator: a block loops over its range of groups, and when the output
// tiles alone cannot fill the card the K range is split over blocks
// (split-K) whose f32 partials a second small kernel sums in a fixed order
// (deterministic). RMSNorm needs whole-row statistics, so a first small
// kernel computes rsqrt(mean(x^2) + eps) per row; the main kernel applies
// it per element.
//
// Design, more than 8 rows (qmm_wgmma.cuh): the output tile computed
// transposed on wgmma (m64nBTk16, bf16 in, f32 accumulate) with the weight
// as the register operand, dequantized straight from the QTPU words (whose
// j-major order is already k16 fragment order), the activations as the
// shared-memory operand, a 4-stage ring filled by the Tensor Memory
// Accelerator, BT = 16, 32, 64 or 128 tokens a block from the wrapper's
// plan; each group's dot scaled on the output side before the next, as in
// the decode path.
//
// Not carried over from the TPU: the 8-row padding, the (8, K) broadcast
// of the norm weight, the VMEM tile pickers.
#include "qmm_decode.cuh"
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

template <int ROWS, int PRO>
__global__ void __launch_bounds__(kBN)
qmm_kernel(const bf16* __restrict__ x, int ldx,
           const uint32_t* __restrict__ qw,
           const float* __restrict__ scales, const float* __restrict__ zs,
           const bf16* __restrict__ nw, const float* __restrict__ rstd,
           int M, int K, int N, int groups_per_split,
           float* __restrict__ partial, bf16* __restrict__ out) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n = blockIdx.x * kBN + t;
  const bool col_ok = n < N;
  const int m0 = blockIdx.y * ROWS;
  const int ng = K / kG;
  const int g0 = blockIdx.z * groups_per_split;
  const int g1 = min(ng, g0 + groups_per_split);

  float acc[ROWS];
  qmm_decode_groups<ROWS, PRO>(x, ldx, qw, scales, zs, nw, rstd, M, K, N, t,
                               lane, warp, n, col_ok, m0, g0, g1, acc);

  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int m = m0 + i;
    if (m >= M) break;
    const size_t o = (size_t)m * N + n;
    if (partial != nullptr) {
      partial[(size_t)blockIdx.z * M * N + o] = acc[i];
    } else {
      out[o] = __float2bfloat16_rn(acc[i]);
    }
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

struct Args {
  const bf16* x; int ldx; const uint32_t* qw; const float* scales;
  const float* zs; const bf16* nw; float* rstd; int M, K, N;
  int splits, gps; float* partial; bf16* out;
};

template <int ROWS, int PRO>
cudaError_t launch_main(const Args& a, cudaStream_t st) {
  dim3 grid((a.N + kBN - 1) / kBN, (a.M + ROWS - 1) / ROWS, a.splits);
  qmm_kernel<ROWS, PRO><<<grid, kBN, 0, st>>>(
      a.x, a.ldx, a.qw, a.scales, a.zs, a.nw, a.rstd, a.M, a.K, a.N, a.gps,
      a.splits > 1 ? a.partial : nullptr, a.out);
  return cudaGetLastError();
}

template <int PRO>
cudaError_t dispatch_rows(int rows, const Args& a, cudaStream_t st) {
  switch (rows) {
    case 1: return launch_main<1, PRO>(a, st);
    case 2: return launch_main<2, PRO>(a, st);
    case 4: return launch_main<4, PRO>(a, st);
    case 8: return launch_main<8, PRO>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [M, ldx] bf16 (ldx = K, or 2K for the GLU prologue: [gate | up]);
// qweight: int32 [K/8, N]; scales, zeros_x_scales: f32 [K/128, N];
// norm_weight: bf16 [K] (RMSNorm prologue only); rstd: f32 [M] scratch
// (RMSNorm only); partial: f32 [splits, M, N] scratch (splits > 1 only);
// xsum: f32 [K/128, (M + 3) & ~3] scratch, 16-byte aligned (rows > 8 only);
// out: [M, N] bf16. rows (1, 2, 4, 8: decode path; 16, 32, 64, 128: the
// wgmma body's tokens per block, no prologue, N % 4 == 0, x, qweight,
// scales and zeros_x_scales 16-byte aligned), splits and groups_per_split
// come from the wrapper's launch plan.
extern "C" int qtt_quantized_matmul(
    const void* x, int ldx, const void* qweight, const void* scales,
    const void* zeros_x_scales, const void* norm_weight, float eps,
    int prologue, int M, int K, int N, int rows, int splits,
    int groups_per_split, void* rstd, void* partial, void* xsum, void* out,
    void* stream) {
  if (M <= 0 || K % kG != 0 || N <= 0 || splits <= 0 || groups_per_split <= 0)
    return cudaErrorInvalidValue;
  if (prologue != kNone && rows > 8) return cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  if (rows > 8 && xsum == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const bf16*>(x), ldx,
         static_cast<const uint32_t*>(qweight),
         static_cast<const float*>(scales),
         static_cast<const float*>(zeros_x_scales),
         static_cast<const bf16*>(norm_weight),
         static_cast<float*>(rstd), M, K, N, splits, groups_per_split,
         static_cast<float*>(partial), static_cast<bf16*>(out)};
  cudaError_t err;
  if (prologue == kRmsNorm) {
    if (rstd == nullptr || norm_weight == nullptr) return cudaErrorInvalidValue;
    rms_stats_kernel<<<M, 256, 0, st>>>(a.x, ldx, K, eps, a.rstd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = dispatch_rows<kRmsNorm>(rows, a, st);
  } else if (prologue == kSiluGlu) {
    err = dispatch_rows<kSiluGlu>(rows, a, st);
  } else if (prologue == kNone) {
    err = rows > 8 ? qwg::launch(rows, a.x, ldx, a.qw, a.scales, a.zs,
                                 static_cast<float*>(xsum), M, K, N, splits,
                                 groups_per_split, a.partial, a.out, st)
                   : dispatch_rows<kNone>(rows, a, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  splitk_reduce_kernel<<<blocks, 256, 0, st>>>(a.partial, splits, mn, a.out);
  return cudaGetLastError();
}
