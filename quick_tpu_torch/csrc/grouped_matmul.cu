// K8: grouped (ragged) W4A16 GEMM for MoE experts over expert-sorted
// bm-row tiles, on Hopper's warpgroup tensor-core instruction.
//
// Replaces the Pallas kernel of quick_tpu/ops/grouped_matmul.py:
//   _make_grouped_kernel (:48), launched from quantized_matmul_grouped
//   (:205, pallas_call :274); at G = 64 and 32, the output-side form of
//   _grouped_fallback (:146-196), which the JAX package runs there.
//
// What it computes: for every bm-row tile i of x [Mp, K] bf16 (rows sorted
// by expert, build_routing), the tile's rows times dequant(qweight[e]) with
// e = tile_expert[i], read on the card, with K1's numerics: per quant group
// of G input channels, the bf16 activations times the integer codes summed
// in f32, then acc += s[g, n] * dot - xsum_g * zeros_x_scales[g, n], xsum_g
// the f32 sum of the group's bf16 activations, the sum over K in f32,
// written as bf16. Every row of a live tile is computed, padding rows
// included; tiles with tile_live[i] == 0 are written as zeros, as the
// Pallas kernel writes them (:84-88). Weights are the per-expert QTPU
// layout: qweight int32 [E, K/8, N], scales and zeros_x_scales f32
// [E, K/G, N].
//
// What bounds it on the H100: at decode the bytes of the distinct experts
// the routing touches (K*N/2 of codes plus 8*(K/G)*N of f32 scales each)
// against 3.35 TB/s; at prefill the routed multiply-adds (2 * T * topk * K
// * N) against the bf16 tensor-core rate.
//
// Design: K1's body (qmm_wgmma.cuh) with the expert as a grid dimension,
// on the skeleton it shares with K12 (grouped_wgmma.cuh: blocks of (column
// tile, expert, K slice) that scan the tile layout on the card and stream
// their expert's weights once a pass of up to 64 or 128 rows, the K split
// and its reduce). Here the body: wgmma.mma_async m64nWk16 (bf16) with A,
// the 64 channels x 16 depths of codes, built by each lane straight from
// the QTPU words in registers (K1's prmt / mask / bf16x2 subtraction at
// G = 128; K9's fragment map at G = 64 and 32), B the pass's bf16 rows in
// two 64-wide 128-byte swizzled slices; each group's dot in its own f32
// accumulator (its k16 steps, the first with scale-d = 0), folded as
// acc += s * dot - xsum * zs. The group sums come from a first kernel,
// once per row and group.
//
// Not carried over from the TPU: the VMEM-sized (bn, gpb) tile pickers,
// the scalar-prefetched BlockSpec index maps.
#include "grouped_wgmma.cuh"

namespace {
namespace qgm {

using namespace qwg;

// xsumT[g, m] = f32 sum of x[m, g*G .. g*G + G - 1] (bf16): one warp a row
// and 128 channels, lanes 4 channels each, a fixed shuffle tree over the
// G / 4 lanes of a group
template <int G>
__global__ void __launch_bounds__(256)
grouped_xsum_kernel(const bf16* __restrict__ x, int M, int K, int ldxs,
                    float* __restrict__ xsumT) {
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int nch = (K + kKC - 1) / kKC;
  if (w >= M * nch) return;
  const int m = w / nch, k = (w % nch) * kKC + lane * 4;
  float sum = 0.f;
  if (k < K) {
    const uint2 v = *reinterpret_cast<const uint2*>(x + (size_t)m * K + k);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    sum = (a.x + a.y) + (b.x + b.y);
  }
#pragma unroll
  for (int o = G / 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane % (G / 4) == 0 && k < K) xsumT[(size_t)(k / G) * ldxs + m] = sum;
}

// The lane's A fragments of group q of a stage (its G / 16 k16 steps, from
// the 16 packed rows of words wsm [16][kBN]) for channels c0 (registers 0,
// 2) and c0 + 8 (1, 3), depths 2t, 2t+1 (registers 0, 1) and 2t+8, 2t+9
// (2, 3) of each step. Code k = g*G + j*(G/8) + r sits in nibble j of word
// [g*G/8 + r, n]:
//   G = 128: words 2t, 2t+1, 2t+8, 2t+9; step j is nibble j;
//   G = 64: words q*8 + 2t, +1; step s is nibbles 2s (depths 2t..) and
//     2s + 1 (2t + 8..);
//   G = 32: words q*4 + 2(t%2), +1, shifted right by 4(t/2); step s is
//     nibbles 4s and 4s + 2 of the shifted words.
template <int G>
__device__ __forceinline__ void a_fragments(const uint32_t* wsm, int q, int c0, int t,
                                            uint32_t (&a)[G / 16][4]) {
  if constexpr (G == 128) {
    uint32_t w[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * t + (i & 1) + (i >> 1) * 8;
      w[i][0] = wsm[r * kBN + c0];
      w[i][1] = wsm[r * kBN + c0 + 8];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j][0] = code_pair(w[0][0], w[1][0], j);
      a[j][1] = code_pair(w[0][1], w[1][1], j);
      a[j][2] = code_pair(w[2][0], w[3][0], j);
      a[j][3] = code_pair(w[2][1], w[3][1], j);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = c0 + 8 * h;
      if constexpr (G == 64) {
        const uint32_t lo = wsm[(q * 8 + 2 * t) * kBN + ch];
        const uint32_t hi = wsm[(q * 8 + 2 * t + 1) * kBN + ch];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          a[s][h] = code_pair(lo, hi, 2 * s);
          a[s][2 + h] = code_pair(lo, hi, 2 * s + 1);
        }
      } else {
        const int sh = 4 * (t >> 1);
        const uint32_t lo = wsm[(q * 4 + 2 * (t & 1)) * kBN + ch] >> sh;
        const uint32_t hi = wsm[(q * 4 + 2 * (t & 1) + 1) * kBN + ch] >> sh;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          a[s][h] = code_pair(lo, hi, 4 * s);
          a[s][2 + h] = code_pair(lo, hi, 4 * s + 2);
        }
      }
    }
  }
}

// group c's k16 steps on the first W tokens of the pass: dot = A * B
template <int W, int PR, int G, int NR>
__device__ __forceinline__ void mma_group(float (&dot)[NR], const uint32_t (&a)[G / 16][4],
                                          uint32_t xb, int c) {
  constexpr int kSteps = G / 16;
  float (&d)[W / 2] = *reinterpret_cast<float (*)[W / 2]>(&dot[0]);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int j = c * kSteps + s;
    Wgmma<W>::mma(d, a[s], desc_b(xb + (j >> 2) * (PR * 128) + (j & 3) * 32), s > 0);
  }
}

// K8's body: bf16 rows, bf16 wgmma, the fold of K1
struct Bf16Body {
  typedef float Dot;
  static constexpr int kXBytes = 2;
  static constexpr CUtensorMapDataType kXType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kMaxStages = 4;
  static constexpr bool kRowScale = false;

  // the ngs groups of stage sp, in order: each group's A fragments (the
  // next group's built while this one's MMAs run), its MMAs on the pass's
  // rows at xb and its fold. Only one or two groups' steps are held, and
  // the scales' address is formed after the MMAs, so that the warpgroup
  // pipeline fits the 128 registers of two blocks an SM (else ptxas
  // serializes it)
  template <int PR, int G>
  static __device__ __forceinline__ void stage(float (&acc)[PR / 2], float (&dot)[PR / 2],
                                               uint32_t xb, const unsigned char* sp, int ngs,
                                               int c0, int t, int nrow) {
    const uint32_t* wsm = reinterpret_cast<const uint32_t*>(sp + PR * kKC * 2);
    uint32_t a[G / 16][4];
    a_fragments<G>(wsm, 0, c0, t, a);
    groups<PR, G, 0>(acc, dot, a, xb, sp, wsm, ngs, c0, t, nrow);
  }

  template <int PR, int G, int C>
  static __device__ __forceinline__ void groups(float (&acc)[PR / 2], float (&dot)[PR / 2],
                                                uint32_t (&a)[G / 16][4], uint32_t xb,
                                                const unsigned char* sp, const uint32_t* wsm,
                                                int ngs, int c0, int t, int nrow) {
    constexpr int kCG = kKC / G;
    hold(dot);
    wgmma_fence();
    if (PR == 64 && nrow <= 32) {
      mma_group<32, PR, G>(dot, a, xb, C);
    } else {
      mma_group<PR, PR, G>(dot, a, xb, C);
    }
    wgmma_commit();
    uint32_t an[G / 16][4];
    if constexpr (C + 1 < kCG) {
      if (C + 1 < ngs) a_fragments<G>(wsm, C + 1, c0, t, an);
    }
    wgmma_wait0();
    hold(dot);
    hold(a);
    // the fold with the scales, zeros_x_scales and group sums ([kCG][kBN],
    // [kCG][kBN], [kCG][PR] after the rows and words)
    const float* ssm = reinterpret_cast<const float*>(sp + PR * kKC * 2 + kSlab * kBN * 4);
    const float s0c = ssm[C * kBN + c0], s1c = ssm[C * kBN + c0 + 8];
    const float z0 = -ssm[(kCG + C) * kBN + c0], z1 = -ssm[(kCG + C) * kBN + c0 + 8];
    const float* xsm = ssm + 2 * kCG * kBN + C * PR;
#pragma unroll
    for (int i = 0; i < PR / 8; ++i) {
      if (8 * i >= nrow) break;
      const float2 xv = *reinterpret_cast<const float2*>(xsm + 8 * i + 2 * t);
      acc[4 * i + 0] = fmaf(xv.x, z0, fmaf(dot[4 * i + 0], s0c, acc[4 * i + 0]));
      acc[4 * i + 1] = fmaf(xv.y, z0, fmaf(dot[4 * i + 1], s0c, acc[4 * i + 1]));
      acc[4 * i + 2] = fmaf(xv.x, z1, fmaf(dot[4 * i + 2], s1c, acc[4 * i + 2]));
      acc[4 * i + 3] = fmaf(xv.y, z1, fmaf(dot[4 * i + 3], s1c, acc[4 * i + 3]));
    }
    if constexpr (C + 1 < kCG) {
      if (C + 1 < ngs) groups<PR, G, C + 1>(acc, dot, an, xb, sp, wsm, ngs, c0, t, nrow);
    }
  }

  // the group sums of the bf16 rows
  template <int G>
  static cudaError_t first(const void* x, int Mp, int K, int ldxs, float* xsumT,
                           cudaStream_t st) {
    const int nch = (K + kKC - 1) / kKC;
    grouped_xsum_kernel<G><<<(Mp * nch + 7) / 8, 256, 0, st>>>(static_cast<const bf16*>(x), Mp,
                                                              K, ldxs, xsumT);
    return cudaGetLastError();
  }
};

}  // namespace qgm
}  // namespace

// x: [Mp, K] bf16, 16-byte aligned, rows sorted by expert in bm-row tiles;
// qweight: int32 [E, K/8, N]; scales, zeros_x_scales: f32 [E, K/G, N] (all
// 16-byte aligned); tile_expert, tile_live: int32 [Mp/bm] (device); xsum:
// f32 [K/G, (Mp + 3) & ~3] scratch, 16-byte aligned; partial: f32 [splits,
// Mp, N] scratch (splits > 1 only); out: [Mp, N] bf16. G = 128, 64 or 32;
// bm = 32, 64 or 128; Mp % bm == 0, K % G == 0, N % 4 == 0; K is cut into
// splits slices of cps stages of 128 (the wrapper's plan).
extern "C" int qtt_grouped_matmul(const void* x, const void* qweight, const void* scales,
                                  const void* zeros_x_scales, const void* tile_expert,
                                  const void* tile_live, void* xsum, void* partial, int Mp,
                                  int K, int N, int E, int bm, int G, int splits, int cps,
                                  void* out, void* stream) {
  using namespace qgm;
  if (!plan_ok(Mp, K, N, E, bm, G, splits, cps) || (G != 128 && G != 64 && G != 32) ||
      xsum == nullptr || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto qw = static_cast<const uint32_t*>(qweight);
  auto s = static_cast<const float*>(scales);
  auto zs = static_cast<const float*>(zeros_x_scales);
  auto te = static_cast<const int*>(tile_expert);
  auto live = static_cast<const int*>(tile_live);
  auto xs = static_cast<float*>(xsum);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<bf16*>(out);
#define QGM_LAUNCH(GG) \
  launch_g<Bf16Body, GG>(x, qw, s, zs, te, live, nullptr, xs, part, Mp, K, N, E, bm, splits, cps, o, st)
  switch (G) {
    case 128: return QGM_LAUNCH(128);
    case 64: return QGM_LAUNCH(64);
    default: return QGM_LAUNCH(32);
  }
#undef QGM_LAUNCH
}
