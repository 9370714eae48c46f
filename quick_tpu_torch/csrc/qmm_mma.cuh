// The W4A16 tensor-core block body shared by K1's prefill path
// (quantized_matmul.cu) and K8 (grouped_matmul.cu).
//
// A block of 8 warps (2 row groups x 4 column groups) owns a BM x 128
// output tile, BM = 32 * MT. Per chunk of 128 input channels (one quant
// group at G = 128, 128 / G groups at G = 64 or 32) it stages the BM x 128
// activations and the chunk's codes, turned into bf16 (exact for 0..15) and
// stored n-major with k contiguous, both on padded rows (136 elements) so
// the fragment loads are free of bank conflicts; mma.sync m16n8k16 (bf16
// in, f32 accumulate) gives each group's integer dot in f32 registers,
// scaled on the output side by scales[g, n] minus xsum_g *
// zeros_x_scales[g, n] before the next group, where xsum_g sums the group's
// bf16 activations. Codes of packed rows r and r + 1 sit at neighbouring k
// (slab = G / 8 is even, so both rows are of one group), so one 32-bit
// store writes two of them. The group G is a compile-time parameter: at
// G = 128 the body is the one K1 and K8 were built with.
#pragma once

#include "common.cuh"

namespace {

constexpr int kG = 128;       // quant group: 16 packed rows x 8 nibbles
constexpr int kSlab = 16;     // packed rows per group
constexpr int kPack = 8;      // nibbles per word
constexpr int kBN = 128;      // columns per block
constexpr int kMmaThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int kLd = kG + 8;   // padded shared row, in bf16 elements

__device__ __forceinline__ float code_f32(uint32_t w, int j) {
  return __uint_as_float(((w >> (4 * j)) & 0xFu) | 0x4B000000u) - 8388608.f;
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16 x 16, row) * B (16 x 8, col): bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// dynamic shared memory of a BM-row block at group G
template <int BM, int G = kG>
constexpr size_t mma_smem_bytes() {
  return (size_t)(BM + kBN) * kLd * 2 + (size_t)(kG / G) * (BM + 2 * kBN) * 4;
}

// acc[MT][4][4] = x[m0:m0+BM, g0*G:g1*G] @ dequant(qw)[., n0:n0+128] for
// the block's tile, groups g0 .. g1 - 1 of G input channels. x is [M, ldx]
// bf16, 16-byte aligned (rows >= M read as zeros); qw int32 [K/8, N];
// scales, zs f32 [K/G, N]; at G < 128 a last chunk of fewer than 128 / G
// groups reads zeros past g1. Fragment (mt, nt, q) of warp (wm, wn) holds
// row wm*16*MT + mt*16 + g + 8*(q >= 2) and column wn*32 + nt*8 + 2*tq +
// (q & 1), with g = lane / 4, tq = lane % 4.
template <int MT, int G = kG>
__device__ __forceinline__ void mma_groups(
    const bf16* __restrict__ x, int ldx, int M,
    const uint32_t* __restrict__ qw, const float* __restrict__ scales,
    const float* __restrict__ zs, int N, int m0, int n0, int g0, int g1,
    unsigned char* smem, float (&acc)[MT][4][4]) {
  constexpr int BM = 32 * MT;
  constexpr int CG = kG / G;      // groups per 128-channel chunk
  constexpr int SLAB = G / kPack;  // packed rows per group
  static_assert(CG * G == kG && SLAB % 2 == 0, "G must be 32, 64 or 128");
  bf16* As = reinterpret_cast<bf16*>(smem);  // [BM rows][kLd], k contiguous
  bf16* Bs = As + BM * kLd;                  // [128 cols][kLd], k contiguous
  float* xsum_s = reinterpret_cast<float*>(Bs + kBN * kLd);  // [CG][BM]
  float* s_s = xsum_s + CG * BM;                             // [CG][128]
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
    // activations: BM rows x 128 k in 16-byte chunks
    for (int c = tid; c < BM * (kG / 8); c += kMmaThreads) {
      const int r = c / (kG / 8), k8 = (c % (kG / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && (CG == 1 || grp * G + k8 < g1 * G))
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * ldx + grp * G + k8);
      *reinterpret_cast<uint4*>(As + r * kLd + k8) = v;
    }
    // codes: lane -> (8 columns) x (4 packed-row pairs), conflict-free stores
#pragma unroll
    for (int i = 0; i < (kSlab / 2) * kBN / kMmaThreads; ++i) {
      const int idx = i * kMmaThreads + tid;
      const int l = idx & 31, q32 = idx >> 5;
      const int n = (q32 % (kBN / 8)) * 8 + (l & 7);
      const int r = ((q32 / (kBN / 8)) * 4 + (l >> 3)) * 2;
      const int gn = n0 + n;
      uint32_t w0 = 0u, w1 = 0u;
      if (gn < N && (CG == 1 || grp * SLAB + r < g1 * SLAB)) {
        w0 = __ldg(qw + (size_t)(grp * SLAB + r) * N + gn);
        w1 = __ldg(qw + (size_t)(grp * SLAB + r + 1) * N + gn);
      }
      // k of nibble j of packed row r within the chunk
      const int kr = CG == 1 ? r : (r / SLAB) * G + r % SLAB;
      uint32_t* brow = reinterpret_cast<uint32_t*>(Bs + n * kLd);
#pragma unroll
      for (int j = 0; j < kPack; ++j) {
        __nv_bfloat162 p = __floats2bfloat162_rn(code_f32(w0, j), code_f32(w1, j));
        brow[(j * SLAB + kr) / 2] = *reinterpret_cast<uint32_t*>(&p);
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

    // xsum of each group's rows: 4 threads a row, 32 channels each, summed
    // over the 128 / CG channels of a group
    if (BM * 4 >= kMmaThreads || tid < BM * 4) {
      const int r = tid >> 2, part = tid & 3;
      float sum = 0.f;
      for (int k = part * (kG / 4); k < (part + 1) * (kG / 4); ++k)
        sum += bf2f(As[r * kLd + k]);
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
      float dot[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) dot[mt][nt][q] = 0.f;
#pragma unroll
      for (int kk = c * G; kk < (c + 1) * G; kk += 16) {
        uint32_t a[MT][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* ap = As + (wm * 16 * MT + mt * 16 + g) * kLd + kk + 2 * tq;
          a[mt][0] = ld_u32(ap);
          a[mt][1] = ld_u32(ap + 8 * kLd);
          a[mt][2] = ld_u32(ap + 8);
          a[mt][3] = ld_u32(ap + 8 * kLd + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bf16* bp = Bs + (wn * 32 + nt * 8 + g) * kLd + kk + 2 * tq;
          b[nt][0] = ld_u32(bp);
          b[nt][1] = ld_u32(bp + 8);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(dot[mt][nt], a[mt], b[nt]);
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
            acc[mt][nt][q] += dot[mt][nt][q] * s_s[c * kBN + n] - xsum_s[c * BM + m] * z_s[c * kBN + n];
          }
    }
    __syncthreads();  // shared tiles are restaged by the next chunk
  }
}

// Write the block's tile: f32 into partial [M, N] where it is given (a
// split-K slice), else bf16 into out [M, N]; rows >= M and columns >= N
// are skipped.
template <int MT>
__device__ __forceinline__ void mma_store(const float (&acc)[MT][4][4], int M,
                                          int N, int m0, int n0,
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
        const int m = m0 + wm * 16 * MT + mt * 16 + g + (q >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + nt * 8 + 2 * tq + (q & 1);
        if (m >= M || n >= N) continue;
        const size_t o = (size_t)m * N + n;
        if (partial != nullptr) {
          partial[o] = acc[mt][nt][q];
        } else {
          out[o] = __float2bfloat16_rn(acc[mt][nt][q]);
        }
      }
}

}  // namespace
