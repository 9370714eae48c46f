// The int8 pieces of K11's wgmma body (qmm_wgmma_a8.cuh) that K12's
// (grouped_matmul_a8.cu) runs too: the sums of each group's given int8
// codes (a8_rowsum_kernel, the zero-point term's row sums), the register A
// operand taken straight from the QTPU words (byte_transpose, a_fragments:
// the fragment map is set out in qmm_wgmma_a8.cuh and modelled in
// tests/test_torch_wgmma_fragments.py) and the exact int32 -> f32
// conversion of a group's dot (small_i2f).
#pragma once

#include "wgmma_common.cuh"

namespace {
namespace qwa {

using namespace qwg;

constexpr int kKC = 128;      // depths per stage
constexpr int kSlab = 16;     // packed rows per stage
constexpr int kBN = 128;      // output channels per block: 2 warpgroups x 64

// rowsumT[g, m] = sum of the G codes of group g of row m = blockIdx.x, as
// f32 (exact: at most 128 * 127), for the codes the wrapper computed
// (int8 [M, K], K % G == 0, 16-byte aligned base): one block a row, 8 codes
// a thread, G / 8 threads a group
template <int G>
__global__ void __launch_bounds__(256)
a8_rowsum_kernel(const int8_t* __restrict__ codes, int K, int ldrs,
                 float* __restrict__ rowsumT) {
  const int m = blockIdx.x, tid = threadIdx.x;
  const int8_t* row = codes + (size_t)m * K;
  for (int k0 = 0; k0 < K; k0 += 256 * 8) {
    const int k = k0 + tid * 8;
    int sum = 0;
    if (k < K) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + k);
      sum = __dp4a((int)v.y, 0x01010101, __dp4a((int)v.x, 0x01010101, 0));
    }
#pragma unroll
    for (int o = G / 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if ((tid & (G / 8 - 1)) == 0 && k < K) rowsumT[(size_t)(k / G) * ldrs + m] = (float)sum;
  }
}

// bytes b of four words into register b: out[b] = {v0.b, v1.b, v2.b, v3.b}
__device__ __forceinline__ void byte_transpose(const uint32_t (&v)[4], uint32_t (&out)[4]) {
  const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);  // v0.b0 v1.b0 v0.b1 v1.b1
  const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);  // v0.b2 v1.b2 v0.b3 v1.b3
  const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

// an int32 of magnitude below 2^22 as f32, exactly
__device__ __forceinline__ float small_i2f(int v) {
  return __int_as_float(v + 0x4B400000) - 12582912.f;
}

// the A fragments of the G / 32 k32 steps of group c of a stage (words
// wsm [16][kBN]) for the lane's channels ch (h = 0) and ch + 8 (h = 1)
template <int G>
__device__ __forceinline__ void a_fragments(const uint32_t* wsm, int c, int c0, int t,
                                            uint32_t (&a)[G / 32][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4], b[4];
    if constexpr (G == 128) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = wsm[(4 * t + i) * kBN + c0 + 8 * h];
    } else if constexpr (G == 64) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = wsm[(c * 8 + 4 * (t & 1) + i) * kBN + c0 + 8 * h] >> (4 * (t >> 1));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = wsm[(c * 4 + i) * kBN + c0 + 8 * h] >> (4 * t);
    }
    byte_transpose(w, b);
#pragma unroll
    for (int s = 0; s < G / 32; ++s) {
      if constexpr (G == 128) {
        a[s][h] = b[s] & 0x0F0F0F0Fu;             // nibble 2s: depths 32s + 4t + i
        a[s][2 + h] = (b[s] >> 4) & 0x0F0F0F0Fu;  // nibble 2s + 1: 32s + 16 + 4t + i
      } else {
        a[s][h] = b[2 * s] & 0x0F0F0F0Fu;
        a[s][2 + h] = b[2 * s + 1 + (G == 32)] & 0x0F0F0F0Fu;
      }
    }
  }
}

}  // namespace qwa
}  // namespace
