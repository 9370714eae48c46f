// The W4A8 tensor-core block body of K12 (grouped_matmul_a8.cu).
//
// A block of 8 warps (2 row groups x 4 column groups) owns a BM x 128
// output tile, BM = 32 * MT. Per chunk of 128 input channels (one quant
// group at G = 128, 128 / G groups at G = 64 or 32) it stages the BM x 128
// int8 activation codes and the chunk's weight codes (0..15, exact in int8),
// both k-contiguous on rows padded to 144 bytes (36 words: the fragment
// loads of the 8 row groups x 4 lanes fall on 32 distinct banks);
// mma.sync m16n8k32 (s8 x s8 -> s32) gives each group's integer dot
// exactly (at most 128 * 127 * 15 = 243,840 in magnitude). The group's dot
// becomes f32, times scales[g, n], minus rowsum(xq_g) * zeros_x_scales[g, n],
// and accumulates in f32; the caller multiplies by the row scale sx before
// the one bf16 rounding. Codes of four packed rows r .. r + 3 sit at four
// neighbouring k (G / 8 is a multiple of 4, so all four are of one group):
// one thread loads the four words and writes one 32-bit word per nibble.
//
// The activations are int8 codes [M, ldx] with their row scales
// (quantize_activations' arithmetic). K11 ran this body until it moved to
// the int8 wgmma body (qmm_wgmma_a8.cuh); K12 is its one user.
#pragma once

#include "common.cuh"

namespace a8 {

constexpr int kChunk = 128;   // input channels per staged chunk
constexpr int kSlab = 16;     // packed rows per chunk
constexpr int kPack = 8;      // nibbles per word
constexpr int kBN = 128;      // columns per block
constexpr int kThreads = 256; // 8 warps: 2 (rows) x 4 (columns)
constexpr int kLd = kChunk + 16;  // padded shared row, in bytes

// D += A (16 x 32, row) * B (32 x 8, col): s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// dynamic shared memory of a BM-row block at group G
template <int BM, int G>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(BM + kBN) * kLd + (size_t)(kChunk / G) * (BM + 2 * kBN) * 4 + BM * 4;
}

// acc[MT][4][4] = sum over groups g0 .. g1 - 1 (of G channels) of
// f32(xq_g @ q_g) * scales[g, n] - rowsum(xq_g) * zs[g, n] for the block's
// tile; the row scale is left to the caller. x: int8 codes [M, ldx], rows
// 16-byte aligned; rows >= M read as zeros. qw int32 [K/8, N]; scales,
// zs f32 [K/G, N]; g0 is a multiple of 128 / G, and a last chunk of fewer
// than 128 / G groups reads zeros past g1. Fragment (mt, nt, q) of warp
// (wm, wn) holds row wm*16*MT + mt*16 + g + 8*(q >= 2) and column
// wn*32 + nt*8 + 2*tq + (q & 1), with g = lane / 4, tq = lane % 4.
template <int MT, int G>
__device__ __forceinline__ void mma_groups_a8(
    const int8_t* __restrict__ x, int ldx, int M,
    const uint32_t* __restrict__ qw, const float* __restrict__ scales,
    const float* __restrict__ zs, int N, int m0, int n0, int g0, int g1,
    unsigned char* smem, float (&acc)[MT][4][4]) {
  constexpr int BM = 32 * MT;
  constexpr int CG = kChunk / G;     // groups per chunk
  constexpr int SLAB = G / kPack;    // packed rows per group
  static_assert(CG * G == kChunk && SLAB % 4 == 0, "G must be 32, 64 or 128");
  int8_t* As = reinterpret_cast<int8_t*>(smem);   // [BM rows][kLd], k contiguous
  int8_t* Bs = As + BM * kLd;                      // [128 cols][kLd], k contiguous
  int* xsum_s = reinterpret_cast<int*>(Bs + kBN * kLd);  // [CG][BM]
  float* s_s = reinterpret_cast<float*>(xsum_s + CG * BM);  // [CG][128]
  float* z_s = s_s + CG * kBN;                               // [CG][128]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  for (int grp = g0; grp < g1; grp += CG) {
    const int kend = (g1 - grp) * G;  // valid channels of this chunk (>= 128 when full)
    // int8 codes, 16 channels a thread
    for (int c = tid; c < BM * (kChunk / 16); c += kThreads) {
      const int r = c / (kChunk / 16), k16 = (c % (kChunk / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && (CG == 1 || k16 < kend))
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * ldx + (size_t)grp * G + k16);
      *reinterpret_cast<uint4*>(As + r * kLd + k16) = v;
    }
    // codes: lane -> (8 columns) x (4 quads of packed rows); per quad four
    // words in, one 32-bit store per nibble j (k = j * SLAB + kr .. + 3)
#pragma unroll
    for (int i = 0; i < (kSlab / 4) * kBN / kThreads; ++i) {
      const int idx = i * kThreads + tid;
      const int l = idx & 31, q32 = idx >> 5;
      const int n = (q32 % (kBN / 8)) * 8 + (l & 7);
      const int r = ((q32 / (kBN / 8)) * 4 + (l >> 3)) * 4;
      const int gn = n0 + n;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gn < N && (CG == 1 || grp * SLAB + r < g1 * SLAB)) {
#pragma unroll
        for (int t = 0; t < 4; ++t) w[t] = __ldg(qw + (size_t)(grp * SLAB + r + t) * N + gn);
      }
      const int kr = CG == 1 ? r : (r / SLAB) * G + r % SLAB;
      uint32_t* brow = reinterpret_cast<uint32_t*>(Bs + n * kLd);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // nibbles j = 2 i + half of the four words, one per byte
        uint32_t v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = (w[t] >> (4 * half)) & 0x0F0F0F0Fu;
        // 4 x 4 byte transpose: out word of byte b = [v0.b, v1.b, v2.b, v3.b]
        const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);  // v0.b0 v1.b0 v0.b1 v1.b1
        const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
        const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);  // v0.b2 v1.b2 v0.b3 v1.b3
        const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
        const uint32_t out[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                                 __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
        for (int b = 0; b < 4; ++b) brow[((2 * b + half) * SLAB + kr) / 4] = out[b];
      }
    }
    if (tid < kBN) {
      const int gn = n0 + tid;
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const bool ok = gn < N && (CG == 1 || grp + c < g1);
        s_s[c * kBN + tid] = ok ? scales[(size_t)(grp + c) * N + gn] : 0.f;
        z_s[c * kBN + tid] = ok ? zs[(size_t)(grp + c) * N + gn] : 0.f;
      }
    }
    __syncthreads();

    // rowsum of each group's codes: 4 threads a row, 32 codes each
    if (BM * 4 >= kThreads || tid < BM * 4) {
      const int r = tid >> 2, part = tid & 3;
      int sum = 0;
#pragma unroll
      for (int k = 0; k < kChunk / 4; k += 4)
        sum = __dp4a((int)ld_u32(As + r * kLd + part * (kChunk / 4) + k), 0x01010101, sum);
      if (G >= 64) sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (G >= 128) sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (CG == 1) {
        if (part == 0) xsum_s[r] = sum;
      } else if (part % (4 / CG) == 0) {
        xsum_s[(part / (4 / CG)) * BM + r] = sum;
      }
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      int dot[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) dot[mt][nt][q] = 0;
#pragma unroll
      for (int kk = c * G; kk < (c + 1) * G; kk += 32) {
        uint32_t a[MT][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int8_t* ap = As + (wm * 16 * MT + mt * 16 + g) * kLd + kk + 4 * tq;
          a[mt][0] = ld_u32(ap);
          a[mt][1] = ld_u32(ap + 8 * kLd);
          a[mt][2] = ld_u32(ap + 16);
          a[mt][3] = ld_u32(ap + 8 * kLd + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int8_t* bp = Bs + (wn * 32 + nt * 8 + g) * kLd + kk + 4 * tq;
          b[nt][0] = ld_u32(bp);
          b[nt][1] = ld_u32(bp + 16);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(dot[mt][nt], a[mt], b[nt]);
      }
      if (c == 0) __syncthreads();  // xsum_s complete
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = wm * 16 * MT + mt * 16 + g + (q >= 2 ? 8 : 0);
            const int n = wn * 32 + nt * 8 + 2 * tq + (q & 1);
            acc[mt][nt][q] += (float)dot[mt][nt][q] * s_s[c * kBN + n] -
                              (float)xsum_s[c * BM + m] * z_s[c * kBN + n];
          }
    }
    __syncthreads();  // shared tiles are restaged by the next chunk
  }
}

// Write the block's tile: the unscaled f32 sums into partial [M, N] where it
// is given (a split-K slice), else bf16(acc * sx[m]) into out [M, N], with
// sx the block's row scales (sx_rows[r] of row m0 + r); rows >= M and
// columns >= N are skipped.
template <int MT>
__device__ __forceinline__ void store_a8(const float (&acc)[MT][4][4], int M, int N,
                                         int m0, int n0, const float* sx_rows,
                                         float* __restrict__ partial,
                                         bf16* __restrict__ out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm * 16 * MT + mt * 16 + g + (q >= 2 ? 8 : 0);
        const int m = m0 + r;
        const int n = n0 + wn * 32 + nt * 8 + 2 * tq + (q & 1);
        if (m >= M || n >= N) continue;
        const size_t o = (size_t)m * N + n;
        if (partial != nullptr) {
          partial[o] = acc[mt][nt][q];
        } else {
          out[o] = __float2bfloat16_rn(acc[mt][nt][q] * sx_rows[r]);
        }
      }
}

}  // namespace a8
