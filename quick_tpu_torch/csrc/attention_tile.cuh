// Online-softmax attention over one staged K/V tile, for the rows a warp
// owns, on the CUDA cores. Used by the dense-cache decode kernel (K7); K2,
// K3, K5, K6 and K6q run their tiles on the tensor cores instead.
//
// A tile holds BK = 64 keys in shared memory: K as bf16 pairs with a padded
// row stride (D/2 + 1 words) so that 32 lanes reading 32 different keys hit
// 32 different banks, V unpadded (lanes read consecutive dims). Each lane
// scores keys `lane` and `lane + 32` against every row of the warp, so one K
// read serves all R rows; each lane accumulates D/32 consecutive output
// dims. Probabilities are rounded to bf16 before p @ v, as the Pallas
// kernels do (p.astype(v.dtype)); the running sum l keeps the f32 p.
//
// V may be narrower than Q / K (DV != D: DeepSeek's MLA expanded prefill,
// q / k 192 wide, v 128, through K2). DV defaults to D, and every
// instantiation with DV == D compiles to the code it had before DV existed
// (the DV != D branches are compile-time).
#pragma once

#include "common.cuh"

namespace attn {

constexpr int kBK = 64;       // keys per tile
constexpr int kKeysPerLane = kBK / 32;

template <int D, int DV = D>
struct Tile {
  static constexpr int kStride = D / 2 + 1;  // padded K row, in bf16 pairs
  static constexpr size_t kKBytes = (size_t)kBK * kStride * 4;
  static constexpr size_t kVBytes = (size_t)kBK * DV * 2;
};

// Stage keys [t0, t0 + kBK) of one head's [T, D] K and [T, DV] V (row-major
// bf16) into shared memory with all threads of the block; keys at or past
// `t_end` are zero-filled (they are masked by the caller's rules).
template <int D, int DV = D>
__device__ __forceinline__ void stage_kv(const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, int t0,
                                         int t_end, uint32_t* ks, bf16* vs) {
  if constexpr (D == DV) {
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < kBK * kChunks; c += blockDim.x) {
      const int j = c / kChunks, d8 = (c % kChunks) * 8;
      const int t = t0 + j;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (t < t_end) {
        kv4 = *reinterpret_cast<const uint4*>(k + (size_t)t * D + d8);
        vv4 = *reinterpret_cast<const uint4*>(v + (size_t)t * D + d8);
      }
      uint32_t* kr = ks + j * Tile<D>::kStride + d8 / 2;
      kr[0] = kv4.x; kr[1] = kv4.y; kr[2] = kv4.z; kr[3] = kv4.w;
      *reinterpret_cast<uint4*>(vs + j * D + d8) = vv4;
    }
  } else {
    constexpr int kChunks = D / 8, kVChunks = DV / 8;
    for (int c = threadIdx.x; c < kBK * kChunks; c += blockDim.x) {
      const int j = c / kChunks, d8 = (c % kChunks) * 8;
      const int t = t0 + j;
      uint4 kv4 = make_uint4(0, 0, 0, 0);
      if (t < t_end) kv4 = *reinterpret_cast<const uint4*>(k + (size_t)t * D + d8);
      uint32_t* kr = ks + j * Tile<D, DV>::kStride + d8 / 2;
      kr[0] = kv4.x; kr[1] = kv4.y; kr[2] = kv4.z; kr[3] = kv4.w;
    }
    for (int c = threadIdx.x; c < kBK * kVChunks; c += blockDim.x) {
      const int j = c / kVChunks, d8 = (c % kVChunks) * 8;
      const int t = t0 + j;
      uint4 vv4 = make_uint4(0, 0, 0, 0);
      if (t < t_end) vv4 = *reinterpret_cast<const uint4*>(v + (size_t)t * DV + d8);
      *reinterpret_cast<uint4*>(vs + j * DV + d8) = vv4;
    }
  }
}

template <int D, int R>
struct RowState {
  float m[R], l[R], acc[R][D / 32];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = QTT_NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[r][i] = 0.f;
    }
  }
};

// Per-row masking and bias parameters.
struct RowRule {
  int qpos;        // absolute query position
  int klen;        // keys at or past klen are invisible
  int window;      // > 0: key t visible iff t > qpos - window
  float slope;     // ALiBi slope (0 disables)
};

// Fold one staged tile (keys t0 .. t0 + kBK) into the rows' state.
// q: the warp's R rows in shared memory, f32, row stride D; the score is
// dot(q, k) * score_mul, then softcap (cap * tanh(s / cap) when softcap > 0),
// then the ALiBi bias, then the causal / length / window mask.
// DV: the width of V and of the rows' state (D unless given).
template <int D, int R, int DV = D>
__device__ __forceinline__ void attend_tile(RowState<DV, R>& st,
                                            const float* q,
                                            const RowRule (&rule)[R],
                                            const uint32_t* ks, const bf16* vs,
                                            int t0, float score_mul,
                                            float softcap, int lane) {
  constexpr int kDPL = DV / 32;
  float s[R][kKeysPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int jj = 0; jj < kKeysPerLane; ++jj) s[r][jj] = 0.f;
#pragma unroll 4
  for (int d2 = 0; d2 < D / 2; ++d2) {
    float2 kf[kKeysPerLane];
#pragma unroll
    for (int jj = 0; jj < kKeysPerLane; ++jj) {
      const uint32_t w = ks[(lane + 32 * jj) * Tile<D, DV>::kStride + d2];
      kf[jj] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 qv = *reinterpret_cast<const float2*>(q + r * D + 2 * d2);
#pragma unroll
      for (int jj = 0; jj < kKeysPerLane; ++jj)
        s[r][jj] = fmaf(qv.y, kf[jj].y, fmaf(qv.x, kf[jj].x, s[r][jj]));
    }
  }
  float p[R][kKeysPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bool ok[kKeysPerLane];
    float tmax = QTT_NEG_INF;
#pragma unroll
    for (int jj = 0; jj < kKeysPerLane; ++jj) {
      const int t = t0 + lane + 32 * jj;
      float sc = s[r][jj] * score_mul;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      sc += rule[r].slope * (float)(t - rule[r].qpos);
      ok[jj] = t <= rule[r].qpos && t < rule[r].klen &&
               (rule[r].window <= 0 || t > rule[r].qpos - rule[r].window);
      s[r][jj] = ok[jj] ? sc : QTT_NEG_INF;
      tmax = fmaxf(tmax, s[r][jj]);
    }
    const float m_new = fmaxf(st.m[r], warp_max(tmax));
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeysPerLane; ++jj) {
      p[r][jj] = ok[jj] ? expf(s[r][jj] - m_new) : 0.f;
      psum += p[r][jj];
    }
    const float alpha = expf(st.m[r] - m_new);
    st.l[r] = st.l[r] * alpha + warp_sum(psum);
    st.m[r] = m_new;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) st.acc[r][i] *= alpha;
  }
  // p @ v: key j's probability lives in lane j % 32, slot j / 32
#pragma unroll
  for (int jj = 0; jj < kKeysPerLane; ++jj) {
#pragma unroll 4
    for (int src = 0; src < 32; ++src) {
      const int j = jj * 32 + src;
      const __nv_bfloat162* v2 =
          reinterpret_cast<const __nv_bfloat162*>(vs + j * DV + lane * kDPL);
      float vf[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL / 2; ++i) {
        const float2 f = __bfloat1622float2(v2[i]);
        vf[2 * i] = f.x;
        vf[2 * i + 1] = f.y;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float pj = __shfl_sync(0xffffffffu, p[r][jj], src);
        pj = round_bf16(pj);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) st.acc[r][i] = fmaf(pj, vf[i], st.acc[r][i]);
      }
    }
  }
}

}  // namespace attn
