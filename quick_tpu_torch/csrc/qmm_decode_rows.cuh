// The 8-token decode body (M <= 8 rows) of the W4A16 GEMM at G = 128,
// shared by K1's decode rows (quantized_matmul.cu, qwk::decode_kernel: one
// item a block) and K14, the decode layer tail (fused_layer_tail.cu: every
// item of its three GEMMs, one weight stream a block).
//
// An item is one 128-channel tile over consecutive groups of 128 depths.
// The words, scales and zeros_x_scales of a group come by tensor copy into
// a ring of kStages stages (9 KB each); stage j of the block's stream sits
// in slot j % kStages and completes phase j / kStages of the slot's "full"
// mbarrier. The caller's producer (thread 0) issues the copies kStages - 1
// stages ahead: K1 counts the stages of its one item, K14 of its whole
// work list, so that an item's stream runs on into the next item's and the
// next GEMM's. The activations cannot come by tensor copy, since the
// prologue transforms them: each stage's 8 x 128 are loaded by the block's
// threads one stage ahead (8 bytes a thread, a warp a row), the prologue
// applied (none | RMSNorm with the row's rstd | SiLU-GLU over [gate |
// up]), rounded to bf16 and stored into the 8-row B tile in the swizzled
// layout the descriptor reads (two 1024-byte atoms), and each warp's sum of
// its row is the row's xsum. The output tile is computed transposed on
// m64n8k16 wgmma with the dequantized weight as the register operand
// (qmm_wgmma.cuh's map). Each group's dot goes into its own 4-register
// accumulator, folded once the group's 8 MMAs are done (acc += s * dot -
// xsum * zs); while they run, the block builds the next stage's fragments
// (into a second buffer: a stage's register operand is the MMAs' until
// then), stages the next B tile (two tiles ring) and loads the raw
// activations of the stage after. (Two accumulators in turn, the fold of
// group g under group g + 1's MMAs with wgmma.wait_group 1, made ptxas
// inject warpgroup waits and serialize every wgmma: C7517 / C7518.)
#pragma once

#include "qmm_wgmma_dq.cuh"

namespace {

enum Prologue { kNone = 0, kRmsNorm = 1, kSiluGlu = 2 };

namespace qwk {

constexpr int kG = 128;    // quant group: 16 packed rows x 8 nibbles (qmm_wgmma.cuh's)
constexpr int kSlab = 16;  // packed rows per group
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

// host: one GEMM's three tensor maps
inline bool encode_maps(Maps* maps, const uint32_t* qw, const float* scales, const float* zs,
                        int K, int N) {
  const int ng = K / kG;
  return qwg::encode(&maps->w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, qw, K / 8, N, N, kBN, kSlab,
                     CU_TENSOR_MAP_SWIZZLE_NONE) &&
         qwg::encode(&maps->s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, ng, N, N, kBN, 1,
                     CU_TENSOR_MAP_SWIZZLE_NONE) &&
         qwg::encode(&maps->z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zs, ng, N, N, kBN, 1,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
}

// thread 0, once: the ring's barriers (full: the copies' transaction
// count; empty: every thread's release)
__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty) {
  for (int s = 0; s < kStages; ++s) {
    qwg::mbar_init(full + 8 * s, 1);
    qwg::mbar_init(empty + 8 * s, kThreads);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// thread 0: stage j of the block's stream (group grp of the 128 columns
// from n0) into slot j % kStages, once the slot's previous stage has been
// released by every thread
__device__ __forceinline__ void load_stage(const Maps& maps, uint32_t sbase, int j, int n0,
                                           int grp) {
  using L = Layout;
  const uint32_t full = sbase + L::oBar, empty = full + 8 * kStages;
  const int st = j % kStages;
  if (j >= kStages) qwg::mbar_wait(empty + 8 * st, ((j / kStages) - 1) & 1);
  const uint32_t bar = full + 8 * st;
  const uint32_t ws = sbase + st * L::kStage;
  qwg::mbar_arrive_expect_tx(bar, L::kBytesIn);
  qwg::tma_load(ws, &maps.w, n0, grp * kSlab, bar);
  qwg::tma_load(ws + L::kW, &maps.s, n0, grp, bar);
  qwg::tma_load(ws + L::kW + L::kS, &maps.z, n0, grp, bar);
}

// One item: acc (register e: channel c0 + 8 * (e >> 1), token 2t + (e & 1),
// c0 = 64 * warpgroup + 16 * (warp % 4) + lane / 4, t = lane % 4) +=
// prologue(x)[0:8, groups g0 .. g0 + nit - 1] @ dequant(W) of the item's
// 128 channels, whose copies are the block's stages base .. base + nit - 1.
// x: [M, ldx] bf16 (GLU: [gate | up], ldx >= 2K), rows >= M staged as
// zeros; nw: [K] bf16 and rstd[M] f32 (RMSNorm only); COHERENT reads x
// through L2 (ld.global.cg: x was written by other blocks of the same
// launch) instead of any path the compiler picks. ahead(it): every thread
// at the head of the item's turn it, right after a block barrier (every
// thread is done with turn it - 1); the caller's producer issues the stage
// kStages - 1 ahead there. smem: the block's Layout, 1024-aligned.
template <int PRO, bool COHERENT, class Ahead>
__device__ __forceinline__ void decode_rows(unsigned char* smem, const bf16* __restrict__ x,
                                            int ldx, const bf16* __restrict__ nw,
                                            const float* __restrict__ rstd, int M, int K, int g0,
                                            int nit, int base, Ahead ahead, float (&acc)[4]) {
  using L = Layout;
  const uint32_t sbase = qwg::smem_u32(smem);
  const uint32_t full = sbase + L::oBar;  // full[s] = full + 8s
  const uint32_t empty = full + 8 * kStages;
  float* xsums = reinterpret_cast<float*>(smem + L::oXs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = tid >> 7, wq = warp & 3;
  const int t = lane & 3;
  const int c0 = wgi * 64 + wq * 16 + (lane >> 2);  // the lane's channels c0, c0 + 8

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
      if constexpr (COHERENT) {
        raw[0] = __ldcg(reinterpret_cast<const uint2*>(xrow + k));
        if (PRO == kSiluGlu) raw[1] = __ldcg(reinterpret_cast<const uint2*>(xrow + K + k));
      } else {
        raw[0] = *reinterpret_cast<const uint2*>(xrow + k);
        if (PRO == kSiluGlu) raw[1] = *reinterpret_cast<const uint2*>(xrow + K + k);
      }
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
    const int st = (base + it) % kStages;
    qwg::mbar_wait(full + 8 * st, ((base + it) / kStages) & 1);
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
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
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
  // acc += s * dot - xsum * zs, and release its words' stage
  auto fold = [&](int it, uint32_t (&a)[8][4]) {
    qwg::wgmma_wait0();
    qwg::hold(dot);
    qwg::hold(a);
    const int st = (base + it) % kStages;
    const float* ssm = reinterpret_cast<const float*>(smem + st * L::kStage + L::kW);
    const float s0 = ssm[c0], s1 = ssm[c0 + 8];
    const float z0 = -ssm[kBN + c0], z1 = -ssm[kBN + c0 + 8];
    const float2 xv = *reinterpret_cast<const float2*>(xsums + (it % kXStages) * 8 + 2 * t);
    acc[0] = fmaf(xv.x, z0, fmaf(dot[0], s0, acc[0]));
    acc[1] = fmaf(xv.y, z0, fmaf(dot[1], s0, acc[1]));
    acc[2] = fmaf(xv.x, z1, fmaf(dot[2], s1, acc[2]));
    acc[3] = fmaf(xv.y, z1, fmaf(dot[3], s1, acc[3]));
    qwg::mbar_arrive(empty + 8 * st);
  };
  // a turn's head: every thread is done with the turn before (so stage
  // it's B tile is published, and the stage before's words and B tile are
  // free); the producer issues kStages - 1 stages ahead
  auto head = [&](int it) {
    __syncthreads();
    ahead(it);
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
}

}  // namespace qwk
}  // namespace
