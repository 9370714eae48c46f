// The W4A16 CUDA-core decode body (M <= 8 rows) of K14, the decode layer
// tail (fused_layer_tail.cu); K1's decode rows ran it until they moved onto
// the wgmma body (quantized_matmul.cu).
//
// A block of 128 threads owns 128 output columns (thread t: column n) and
// ROWS rows from m0. Per quant group of 128 input channels it issues the
// group's 16 packed words of its column before staging the group's
// activations (prologue applied, bf16-rounded, as f32 in shared memory,
// k-major so the ROWS values of one k are one vector load), so the weight
// loads are in flight while the block stages. Codes become floats with the
// 0x4B000000 exponent trick (exact). The group's dot is scaled on the
// output side, minus xsum * zeros_x_scales, before the next group (the
// numerics of quick_tpu/ops/quantized_matmul.py::_quantized_matmul_jnp).
#pragma once

#include "common.cuh"

namespace {

constexpr int kG = 128;       // quant group: 16 packed rows x 8 nibbles
constexpr int kSlab = 16;     // packed rows per group
constexpr int kPack = 8;      // nibbles per word
constexpr int kBN = 128;      // columns per block

// nibble j of a QTPU word as its code, an exact f32 (the 2^23 exponent trick)
__device__ __forceinline__ float code_f32(uint32_t w, int j) {
  return __uint_as_float(((w >> (4 * j)) & 0xFu) | 0x4B000000u) - 8388608.f;
}

enum Prologue { kNone = 0, kRmsNorm = 1, kSiluGlu = 2 };

// An activation load: plain where x is read-only for the whole launch (the
// compiler may take the non-coherent path), through L2 (ld.global.cg)
// where other blocks of the same launch wrote x (K14's h and gu).
template <bool COHERENT>
__device__ __forceinline__ float load_act(const bf16* p) {
  return bf2f(COHERENT ? __ldcg(p) : *p);
}

// acc[i] = row m0 + i, column n of x @ dequant(qw) over groups g0 .. g1 - 1
// (rows >= M and columns >= N read as zeros). x: [M, ldx] bf16, read as
// x[m, k] (kNone), bf16(x[m, k] * rstd[m] * nw[k]) (kRmsNorm) or
// bf16(silu(x[m, k]) * x[m, K + k]) in f32 (kSiluGlu, ldx >= 2K). t, lane
// and warp are the thread's index, lane and warp; col_ok is n < N. Every
// thread of the block calls this with the same g0, g1; its shared staging
// buffers are the block's (one pair per instantiation). COHERENT reads x
// through L2 (load_act).
template <int ROWS, int PRO, bool COHERENT = false>
__device__ __forceinline__ void qmm_decode_groups(
    const bf16* __restrict__ x, int ldx, const uint32_t* __restrict__ qw,
    const float* __restrict__ scales, const float* __restrict__ zs,
    const bf16* __restrict__ nw, const float* __restrict__ rstd, int M,
    int K, int N, int t, int lane, int warp, int n, bool col_ok, int m0,
    int g0, int g1, float (&acc)[ROWS]) {
  __shared__ __align__(16) float xs[kG * ROWS];
  __shared__ float red[kBN / 32][ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;

  for (int g = g0; g < g1; ++g) {
    uint32_t w[kSlab];
#pragma unroll
    for (int r = 0; r < kSlab; ++r)
      w[r] = col_ok ? __ldg(qw + (size_t)(g * kSlab + r) * N + n) : 0u;
    const float s = col_ok ? __ldg(scales + (size_t)g * N + n) : 0.f;
    const float z = col_ok ? __ldg(zs + (size_t)g * N + n) : 0.f;

    // stage the group's activations: thread t owns k = g*128 + t
    const int k = g * kG + t;
    float v[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int m = m0 + i;
      float a = 0.f;
      if (m < M) {
        const bf16* row = x + (size_t)m * ldx;
        if (PRO == kRmsNorm) {
          a = round_bf16(load_act<COHERENT>(row + k) * rstd[m] * bf2f(nw[k]));
        } else if (PRO == kSiluGlu) {
          const float gt = load_act<COHERENT>(row + k), up = load_act<COHERENT>(row + (K + k));
          a = round_bf16(gt * (1.f / (1.f + expf(-gt))) * up);
        } else {
          a = load_act<COHERENT>(row + k);
        }
      }
      v[i] = a;
      xs[t * ROWS + i] = a;
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float p = warp_sum(v[i]);
      if (lane == 0) red[warp][i] = p;
    }
    __syncthreads();
    float xsum[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float tot = 0.f;
#pragma unroll
      for (int q = 0; q < kBN / 32; ++q) tot += red[q][i];
      xsum[i] = tot;
    }

    // per-group integer dot: nibble j of packed row r is k = j*16 + r
    float dot[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) dot[i] = 0.f;
#pragma unroll
    for (int r = 0; r < kSlab; ++r) {
#pragma unroll
      for (int j = 0; j < kPack; ++j) {
        const float c = code_f32(w[r], j);
        const float* xk = xs + (j * kSlab + r) * ROWS;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) dot[i] = fmaf(xk[i], c, dot[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] += dot[i] * s - xsum[i] * z;
    __syncthreads();  // xs and red are restaged by the next group
  }
}

}  // namespace
