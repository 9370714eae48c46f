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
// programmatic dependent launch. The activations cannot come by tensor
// copy, since the prologue transforms them: each stage's 8 x 128 are
// loaded by the block's threads one stage ahead (8 bytes a thread, a warp
// a row), the prologue applied, rounded to bf16 and stored into the 8-row B
// tile in the swizzled layout the descriptor reads (two 1024-byte atoms),
// and each warp's sum of its row is the row's xsum. Each group's dot goes
// into its own 4-register accumulator, folded once the group's 8 MMAs are
// done; while they run, the block builds the next stage's fragments (into
// a second buffer: a stage's register operand is the MMAs' until then),
// stages the next B tile (two tiles ring) and loads the raw activations of
// the stage after. (Two accumulators in turn, the fold of group g under
// group g + 1's MMAs with wgmma.wait_group 1, made ptxas inject warpgroup
// waits and serialize every wgmma: C7517 / C7518.) RMSNorm needs whole-row
// statistics, so a first small kernel (rms_stats_kernel) computes
// rsqrt(mean(x^2) + eps) per row, and the decode kernel, a programmatic
// dependent of it, reads them after griddepcontrol.wait.
//
// Not carried over from the TPU: the 8-row padding, the (8, K) broadcast
// of the norm weight, the VMEM tile pickers.
#include "qmm_wgmma.cuh"
#include "qmm_wgmma_dq.cuh"

namespace {

enum Prologue { kNone = 0, kRmsNorm = 1, kSiluGlu = 2 };

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

using qwg::kG;
using qwg::kSlab;
using qwd::kBN;
using qwd::kThreads;
using qwd::kMaxSplits;

constexpr int kStages = 8;   // the words' ring, loaded kStages - 1 stages ahead
constexpr int kXStages = 2;  // the B tiles: this stage's, the next one's

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Layout {
  static constexpr int kW = kSlab * kBN * 4;          // packed words
  static constexpr int kS = kBN * 4;                  // scales; zeros_x_scales follow
  static constexpr int kBytesIn = kW + 2 * kS;        // a stage's copies
  static constexpr int kStage = (kBytesIn + 1023) / 1024 * 1024;
  static constexpr int kX = 8 * kG * 2;               // an 8-row B tile: two 1024-byte atoms
  static constexpr int oX = kStages * kStage;         // the B tiles' ring
  static constexpr int oXs = oX + kXStages * kX;      // [kXStages][8] f32 xsums
  static constexpr int oBar = oXs + kXStages * 8 * 4;  // full[kStages], empty[kStages]
  static constexpr size_t kBytes = oBar + 16 * kStages + 1024;
  static_assert(16 + kMaxSplits * 8 * kBN * 4 <= oX, "the merge stages every split in the ring");
};

// words [K/8, N] int32 in 128 x 16 boxes; scales / zeros_x_scales [K/128,
// N] f32 in 128 x 1 boxes
struct Maps {
  CUtensorMap w, s, z;
};

// out[0:M, n0:n0+128] of prologue(x) @ dequant(qw) over the groups g0 ..
// g0 + gps - 1 (M <= 8): into partial [splits, M, N] f32 and merged by the
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
  float* xsums = reinterpret_cast<float*>(smem + L::oXs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = tid >> 7, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = wgi * 64 + wq * 16 + g;  // the lane's channels c0, c0 + 8
  const int n0 = blockIdx.y * kBN;
  const int g0 = blockIdx.z * gps;
  const int nit = max(0, min(K / kG, g0 + gps) - g0);

  // thread 0: group g0 + j's copies into stage j % kStages, once the stage's
  // previous group has been released by every thread
  auto load = [&](int j) {
    const int st = j % kStages, grp = g0 + j;
    if (j >= kStages) qwg::mbar_wait(empty + 8 * st, ((j / kStages) - 1) & 1);
    const uint32_t bar = full + 8 * st;
    const uint32_t ws = sbase + st * L::kStage;
    qwg::mbar_arrive_expect_tx(bar, L::kBytesIn);
    qwg::tma_load(ws, &maps.w, n0, grp * kSlab, bar);
    qwg::tma_load(ws + L::kW, &maps.s, n0, grp, bar);
    qwg::tma_load(ws + L::kW + L::kS, &maps.z, n0, grp, bar);
  };
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.w) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.s) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.z) : "memory");
    for (int s = 0; s < kStages; ++s) {
      qwg::mbar_init(full + 8 * s, 1);
      qwg::mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // a programmatic dependent launch: x, rstd and the words are read after
  // the kernel before has finished
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0)
    for (int j = 0; j < kStages - 1 && j < nit; ++j) load(j);

  // the activations: warp r stages row r, lane l its k = 4l .. 4l + 3 of a
  // group (8 bytes; GLU: gate and up), as raw bf16 one stage ahead
  const int r = warp;
  const bool row_ok = r < M;
  const bf16* xrow = x + (size_t)r * ldx;
  const float rs = PRO == kRmsNorm && row_ok ? rstd[r] : 0.f;
  auto load_raw = [&](int it, uint2 (&raw)[2]) {
    const int k = (g0 + it) * kG + 4 * lane;
    raw[0] = raw[1] = make_uint2(0u, 0u);
    if (row_ok) {
      raw[0] = *reinterpret_cast<const uint2*>(xrow + k);
      if (PRO == kSiluGlu) raw[1] = *reinterpret_cast<const uint2*>(xrow + K + k);
      if (PRO == kRmsNorm) raw[1] = *reinterpret_cast<const uint2*>(nw + k);
    }
  };
  // stage `it`'s B tile: the prologue, bf16, into row r of the swizzled
  // tile (chunk c of 16 bytes of a 64-wide half at c ^ (r & 7)), and the
  // row's xsum over the rounded values; then the proxy fence, so that the
  // MMAs after the next barrier read the stores
  auto stage_x = [&](int it, const uint2 (&raw)[2]) {
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw[0]);
    const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&raw[1]);
    uint2 packed = raw[0];
    float sum;
    if (PRO == kNone) {
      const float2 a = __bfloat1622float2(xv[0]), b = __bfloat1622float2(xv[1]);
      sum = (a.x + a.y) + (b.x + b.y);
    } else {
      float v[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 a = __bfloat1622float2(xv[h]), b = __bfloat1622float2(yv[h]);
        if (PRO == kRmsNorm) {
          v[2 * h] = round_bf16(a.x * rs * b.x);
          v[2 * h + 1] = round_bf16(a.y * rs * b.y);
        } else {
          v[2 * h] = round_bf16(a.x * (1.f / (1.f + expf(-a.x))) * b.x);
          v[2 * h + 1] = round_bf16(a.y * (1.f / (1.f + expf(-a.y))) * b.y);
        }
      }
      packed.x = pack2(v[0], v[1]);
      packed.y = pack2(v[2], v[3]);
      sum = (v[0] + v[1]) + (v[2] + v[3]);
    }
    const int slot = it % kXStages;
    unsigned char* tile = smem + L::oX + slot * L::kX;
    const int half = lane >> 4, chunk = (lane & 15) >> 1;
    *reinterpret_cast<uint2*>(tile + half * 1024 + r * 128 + ((chunk ^ r) << 4) + (lane & 1) * 8) =
        packed;
    sum = warp_sum(sum);
    if (lane == 0) xsums[slot * 8 + r] = sum;
    qwg::fence_proxy_async();
  };

  // stage `it`'s 8 fragments from the lane's 8 words of its two channels
  // (qmm_wgmma.cuh's map), once its copies have landed
  auto build = [&](int it, uint32_t (&a)[8][4]) {
    const int st = it % kStages;
    qwg::mbar_wait(full + 8 * st, (it / kStages) & 1);
    const uint32_t* wsm = reinterpret_cast<const uint32_t*>(smem + st * L::kStage);
    uint32_t w[4][2];  // packed rows 2t, 2t + 1, 2t + 8, 2t + 9 x channels c0, c0 + 8
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 2 * t + (i & 1) + (i >> 1) * 8;
      w[i][0] = wsm[row * kBN + c0];
      w[i][1] = wsm[row * kBN + c0 + 8];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j][0] = qwg::code_pair(w[0][0], w[1][0], j);  // channel c0, depths 2t, 2t + 1
      a[j][1] = qwg::code_pair(w[0][1], w[1][1], j);  // channel c0 + 8
      a[j][2] = qwg::code_pair(w[2][0], w[3][0], j);  // channel c0, depths 2t + 8, 2t + 9
      a[j][3] = qwg::code_pair(w[2][1], w[3][1], j);
    }
  };
  // stage `it`'s group dot into dot: 8 MMAs, one commit group
  float dot[4] = {0.f, 0.f, 0.f, 0.f}, acc[4] = {0.f, 0.f, 0.f, 0.f};
  auto issue = [&](int it, const uint32_t (&a)[8][4]) {
    const uint32_t xb = sbase + L::oX + (it % kXStages) * L::kX;
    qwg::hold(dot);
    qwg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      qwg::Wgmma<8>::mma(dot, a[j], qwg::desc_b(xb + (j >> 2) * 1024 + (j & 3) * 32), j > 0);
    qwg::wgmma_commit();
  };
  // wait for stage `it`'s MMAs (a is theirs until then), fold its dot,
  // acc += s * dot - xsum * zs (register e: channel c0 + 8 * (e >> 1),
  // token 2t + (e & 1)), and release its words' stage
  auto fold = [&](int it, uint32_t (&a)[8][4]) {
    qwg::wgmma_wait0();
    qwg::hold(dot);
    qwg::hold(a);
    const float* ssm = reinterpret_cast<const float*>(smem + (it % kStages) * L::kStage + L::kW);
    const float s0 = ssm[c0], s1 = ssm[c0 + 8];
    const float z0 = -ssm[kBN + c0], z1 = -ssm[kBN + c0 + 8];
    const float2 xv = *reinterpret_cast<const float2*>(xsums + (it % kXStages) * 8 + 2 * t);
    acc[0] = fmaf(xv.x, z0, fmaf(dot[0], s0, acc[0]));
    acc[1] = fmaf(xv.y, z0, fmaf(dot[1], s0, acc[1]));
    acc[2] = fmaf(xv.x, z1, fmaf(dot[2], s1, acc[2]));
    acc[3] = fmaf(xv.y, z1, fmaf(dot[3], s1, acc[3]));
    qwg::mbar_arrive(empty + 8 * (it % kStages));
  };
  // a turn's head: every thread is done with the turn before (so stage
  // it's B tile is published, and the stage before's words and B tile are
  // free); the copies run kStages - 1 stages ahead
  auto head = [&](int it) {
    __syncthreads();
    if (tid == 0 && it + kStages - 1 < nit) load(it + kStages - 1);
  };
  // while stage it's MMAs run: the next stage's fragments and B tile, and
  // the raw activations of the one after
  auto next = [&](int it, uint32_t (&a)[8][4], uint2 (&raw)[2]) {
    if (it + 1 >= nit) return;
    build(it + 1, a);
    stage_x(it + 1, raw);
    if (it + 2 < nit) load_raw(it + 2, raw);
  };

  uint2 raw[2];
  uint32_t a0[8][4], a1[8][4];
  if (nit > 0) {
    load_raw(0, raw);
    stage_x(0, raw);
    if (nit > 1) load_raw(1, raw);
    build(0, a0);
  }
  // two turns a pass, on the fragment buffers a0 and a1 in turn
  for (int it = 0; it < nit; it += 2) {
    head(it);
    issue(it, a0);
    next(it, a1, raw);
    fold(it, a0);
    if (it + 1 == nit) break;
    head(it + 1);
    issue(it + 1, a1);
    next(it + 1, a0, raw);
    fold(it + 1, a1);
  }
  qwd::decode_store(acc, smem, M, N, n0, c0, t, tid, partial, out, counters);
}

template <int PRO>
cudaError_t launch_pro(const bf16* x, int ldx, const uint32_t* qw, const float* scales,
                       const float* zs, const bf16* nw, const float* rstd, int M, int K, int N,
                       int splits, int gps, float* partial, bf16* out, int* counters,
                       cudaStream_t st) {
  const int ng = K / kG;
  Maps maps;
  if (!qwg::encode(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, qw, K / 8, N, N, kBN, kSlab,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !qwg::encode(&maps.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, ng, N, N, kBN, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !qwg::encode(&maps.z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zs, ng, N, N, kBN, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
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
