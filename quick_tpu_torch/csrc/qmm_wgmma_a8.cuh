// The W4A8 GEMM body of K11 and K11f (quantized_matmul_a8.cu) on Hopper's
// int8 warpgroup tensor-core instruction, with the weight's codes taken
// straight from the QTPU words into wgmma's register operand. It follows
// K1's body (qmm_wgmma.cuh) and shares its building blocks
// (wgmma_common.cuh); the row-sum kernel and the register operand that
// K12 runs too are in qmm_a8_operand.cuh.
//
// A first small kernel gives the body each group's row sums, which the
// zero-point term needs. K11 (int8 codes and row scales from the wrapper's
// quantize_activations): a8_rowsum_kernel sums each group's codes. K11f
// (bf16 x, G = 128): a8_quant_kernel quantizes each row once, one block a
// row: the row's absmax, sx = max(amax / 127, 1e-8) with a true division,
// the int8 codes clamp(rint(x / sx), -127, 127) (round half to even), sx,
// and the row sums: quantize_activations' arithmetic (quant_code,
// row_scale). At M = 512 the codes are a few MB and stay in L2 for the
// main kernel.
//
// The output tile is computed transposed, out^T[channels, tokens] =
// W^T xq^T: wgmma.mma_async m64nBTk32 (s8 x s8 -> s32; integer wgmma takes
// both operands K-major, and A may come from registers), A = 64 channels x
// 32 depths of codes (0..15, exact in s8), B = the BT x 32 slice of the
// int8 codes in shared memory. One stage is 128 depths, 128 / G groups:
// BT x 128 codes, one 128-byte swizzled row per token; k32 step j of the
// stage starts 32 bytes further along the rows.
//
// Fragment map without a repack: code k = g*G + j*(G/8) + r sits in nibble
// j of word [g*G/8 + r, n]. A k32 s8 A fragment gives lane (g, t) of warp w
// channels 16w + g and 16w + g + 8, depths 4t .. 4t+3 of the step in
// registers 0 / 1 and 16 + 4t .. 16 + 4t+3 in registers 2 / 3, one depth a
// byte. A lane reads 4 words a channel and group, transposes their bytes
// (six prmt: byte b of the 4 words into register b) and masks nibbles:
//   G = 128 (4 steps): words r = 4t .. 4t+3; step s is nibbles 2s and
//     2s + 1, the low and high nibbles of byte s;
//   G = 64 (2 steps): words r = 4(t%2) .. +3, shifted right by 4(t/2);
//     step s is nibbles 4s and 4s + 2, the low nibbles of bytes 2s, 2s + 1;
//   G = 32 (1 step): words r = 0 .. 3 (the four lanes t read the same
//     words), shifted right by 4t; the low nibbles of bytes 0 and 2
// (tests/test_torch_wgmma_fragments.py models the three maps).
//
// Numerics (_quantized_matmul_a8_jnp): each group's exact int32 dot goes
// into its own accumulator (its k32 steps, the first with scale-d = 0),
// then acc += f32(dot) * s[g, n] - rowsum_g[m] * zs[g, n] (the dot, below
// 2^22 in magnitude, becomes f32 exactly through the exponent of
// 1.5 * 2^23), group after group in order; the row scale sx[m] multiplies
// once before the single bf16 rounding, or in the split-K reduce. K11 and
// K11f run this body with the same plan (a8_plan: the token width, and K
// split in chunks of 128 channels), so on the same x their outputs are
// equal bit for bit.
//
// Block: 2 consumer warpgroups (256 threads), 64 channels each, BT tokens
// (16, 32, 64 or 128). A ring of 6 stages (codes, 16 rows of words, the
// groups' scales, zeros_x_scales and row sums), brought by the Tensor
// Memory Accelerator from thread 0 on "full" mbarriers and released on
// "empty" ones; the two warpgroups share no other barrier in the loop.
// Ragged M and N, and a last stage past K (K need only be a multiple of
// G: DeepSeek-V2-Lite's K = 10944 is 85.5 stages at G = 64), are
// zero-filled by the copies; the store masks M and N, and the groups past
// K are skipped. N must be a multiple of 4 (the wrapper pads other
// widths).
#pragma once

#include "qmm_a8_operand.cuh"

namespace {
namespace qwa {

using namespace qwg;

constexpr int kThreads = 256;
constexpr int kStages = 6;

template <int BT, int G>
struct Layout {
  static constexpr int kCG = kKC / G;        // groups per stage
  static constexpr int kX = BT * kKC;        // int8 codes
  static constexpr int kW = kSlab * kBN * 4; // packed words
  static constexpr int kS = kCG * kBN * 4;   // scales; zeros_x_scales follow
  static constexpr int kRs = kCG * BT * 4;   // the groups' row sums
  static constexpr int kBytesIn = kX + kW + 2 * kS + kRs;  // a stage's copies
  static constexpr int kStage = (kBytesIn + 1023) / 1024 * 1024;
  static constexpr int kOutLd = kBN + 8;     // epilogue tile row (bf16)
  static constexpr size_t kBytes = (size_t)kStages * kStage + 16 * kStages + 1024;
  static_assert(BT * kOutLd * 2 <= kStages * kStage, "the epilogue tile fits the ring");
};

// codes [M, K] int8 in 128 x BT boxes, 128-byte swizzled; qweight [K/8, N]
// int32 in 128 x 16 boxes; scales / zeros_x_scales [K/G, N] f32 in
// 128 x (128/G); row sums [K/G, M] f32 in BT x (128/G)
struct Maps {
  CUtensorMap x, w, s, z, rs;
};

// int8 code of x against row scale sx: quantize_activations' arithmetic
__device__ __forceinline__ int quant_code(float x, float sx) {
  const int q = __float2int_rn(__fdiv_rn(x, sx));
  return max(-127, min(127, q));
}

// row scale from the row's absmax: max(amax / 127, 1e-8), true division
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
}

// codes[m, :], sx[m] and rowsumT[g, m] (G = 128) of row m = blockIdx.x
// (bf16 x [M, K], K % 128 == 0, 16-byte aligned rows): one block a row,
// 8 channels a thread, 16 threads a group
__global__ void __launch_bounds__(256)
a8_quant_kernel(const bf16* __restrict__ x, int K, int ldrs, int8_t* __restrict__ codes,
                float* __restrict__ sx, float* __restrict__ rowsumT) {
  __shared__ float red[8];
  const int m = blockIdx.x, tid = threadIdx.x;
  const bf16* row = x + (size_t)m * K;
  float amax = 0.f;
  for (int k = tid * 8; k < K; k += 256 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  amax = warp_max(amax);
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < 8; ++w) amax = fmaxf(amax, red[w]);
  const float s = row_scale(amax);
  if (tid == 0) sx[m] = s;
  for (int k0 = 0; k0 < K; k0 += 256 * 8) {
    const int k = k0 + tid * 8;
    int sum = 0;
    if (k < K) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + k);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
      uint32_t w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 f0 = __bfloat1622float2(h[2 * i]);
        const float2 f1 = __bfloat1622float2(h[2 * i + 1]);
        const int q0 = quant_code(f0.x, s), q1 = quant_code(f0.y, s);
        const int q2 = quant_code(f1.x, s), q3 = quant_code(f1.y, s);
        sum += (q0 + q1) + (q2 + q3);
        w[i] = (uint32_t)(q0 & 0xFF) | ((uint32_t)(q1 & 0xFF) << 8) |
               ((uint32_t)(q2 & 0xFF) << 16) | ((uint32_t)(q3 & 0xFF) << 24);
      }
      *reinterpret_cast<uint2*>(codes + (size_t)m * K + k) = make_uint2(w[0], w[1]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if ((tid & 15) == 0 && k < K) rowsumT[(size_t)(k / kKC) * ldrs + m] = (float)sum;
  }
}

// out[m0:m0+BT, n0:n0+128] over the stages s0 .. s0 + cps - 1 (128 depths
// each): unscaled f32 partials into partial [splits, M, N] where partial is
// given, else bf16(acc * sx[m]) into out [M, N]
template <int BT, int G>
__global__ void __launch_bounds__(kThreads, BT <= 32 ? 2 : 1)
a8_wgmma_kernel(const __grid_constant__ Maps maps, int M, int K, int N, int cps,
                const float* __restrict__ sx, float* __restrict__ partial,
                bf16* __restrict__ out) {
  using L = Layout<BT, G>;
  constexpr int kNR = BT / 2;  // accumulator registers a lane
  constexpr int kCG = L::kCG;
  constexpr int kSteps = G / 32;  // k32 steps a group
  static_assert(G == 128 || G == 64 || G == 32, "K11 takes G = 128, 64 or 32");
  extern __shared__ unsigned char qwa_smem[];
  unsigned char* smem = qwa_smem + ((1024 - (smem_u32(qwa_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + kStages * L::kStage;  // full[s] = full + 8s
  const uint32_t empty = full + 8 * kStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = wgi * 64 + warp * 16 + g;  // the lane's channels c0, c0 + 8
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * kBN;
  const int s0 = blockIdx.z * cps;
  const int nst = G == kKC ? K / kKC : (K + kKC - 1) / kKC;  // stages, a last part one too
  const int nit = min(nst, s0 + cps) - s0;

  auto load = [&](int j) {
    const int sl = j % kStages, st = s0 + j;
    if (j >= kStages) mbar_wait(empty + 8 * sl, ((j / kStages) - 1) & 1);
    const uint32_t bar = full + 8 * sl;
    const uint32_t xs = sbase + sl * L::kStage;
    mbar_arrive_expect_tx(bar, L::kBytesIn);
    tma_load(xs, &maps.x, st * kKC, m0, bar);
    tma_load(xs + L::kX, &maps.w, n0, st * kSlab, bar);
    tma_load(xs + L::kX + L::kW, &maps.s, n0, st * kCG, bar);
    tma_load(xs + L::kX + L::kW + L::kS, &maps.z, n0, st * kCG, bar);
    tma_load(xs + L::kX + L::kW + 2 * L::kS, &maps.rs, m0, st * kCG, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < kStages - 1 && j < nit; ++j) load(j);

  float acc[kNR];
  int dot[kNR];
#pragma unroll
  for (int i = 0; i < kNR; ++i) {
    acc[i] = 0.f;
    dot[i] = 0;
  }

  for (int it = 0; it < nit; ++it) {
    if (tid == 0 && it + kStages - 1 < nit) load(it + kStages - 1);
    const int sl = it % kStages;
    mbar_wait(full + 8 * sl, (it / kStages) & 1);
    const unsigned char* sp = smem + sl * L::kStage;
    const uint32_t* wsm = reinterpret_cast<const uint32_t*>(sp + L::kX);
    // groups of this stage that lie inside K (all but in a last part stage)
    const int ngs = kCG == 1 ? 1 : min(kCG, K / G - (s0 + it) * kCG);
#pragma unroll
    for (int c = 0; c < kCG; ++c) {
      if (kCG > 1 && c >= ngs) break;
      uint32_t a[kSteps][4];  // step s: {c0, c0+8} x {depths 4t.., 16+4t..}
      a_fragments<G>(wsm, c, c0, t, a);
      hold(dot);
      wgmma_fence();
      const uint32_t xb = sbase + sl * L::kStage;
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        WgmmaS8<BT>::mma(dot, a[s], desc_b(xb + (c * kSteps + s) * 32), s > 0);
      wgmma_commit();
      wgmma_wait0();
      hold(dot);
      hold(a);
      const float* ssm = reinterpret_cast<const float*>(sp + L::kX + L::kW) + c * kBN;
      const float* rsm = reinterpret_cast<const float*>(sp + L::kX + L::kW + 2 * L::kS) + c * BT;
      const float s0c = ssm[c0], s1c = ssm[c0 + 8];
      const float z0 = ssm[kCG * kBN + c0], z1 = ssm[kCG * kBN + c0 + 8];
      // the group's fold, in the order and form of _quantized_matmul_a8_jnp
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        const float2 rs = *reinterpret_cast<const float2*>(rsm + 8 * i + 2 * t);
        acc[4 * i + 0] += small_i2f(dot[4 * i + 0]) * s0c - rs.x * z0;
        acc[4 * i + 1] += small_i2f(dot[4 * i + 1]) * s0c - rs.y * z0;
        acc[4 * i + 2] += small_i2f(dot[4 * i + 2]) * s1c - rs.x * z1;
        acc[4 * i + 3] += small_i2f(dot[4 * i + 3]) * s1c - rs.y * z1;
      }
    }
    mbar_arrive(empty + 8 * sl);
  }

  // accumulator register 4i + e: channel c0 + 8 * (e >= 2), token 8i + 2t + (e & 1)
  if (partial != nullptr) {
    float* p = partial + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int i = 0; i < BT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * i + 2 * t + (e & 1), n = n0 + c0 + (e >> 1) * 8;
        if (m < M && n < N) p[(size_t)m * N + n] = acc[4 * i + e];
      }
    return;
  }
  __syncthreads();  // the ring is free: every copy landed and was consumed
  bf16* tile = reinterpret_cast<bf16*>(smem);  // [BT][kOutLd]
#pragma unroll
  for (int i = 0; i < BT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * i + 2 * t + (e & 1);
      const float sxm = m0 + r < M ? sx[m0 + r] : 0.f;
      tile[r * L::kOutLd + c0 + (e >> 1) * 8] = __float2bfloat16_rn(acc[4 * i + e] * sxm);
    }
  __syncthreads();
  for (int idx = tid; idx < BT * (kBN / 8); idx += kThreads) {
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const bf16* src = tile + r * L::kOutLd + c;
    bf16* dst = out + (size_t)m * N + n;
    if ((N & 7) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// The BT-token body at group G over codes [M, K] and rowsumT [K/G, ldrs]
// (grid: token tiles x 128-channel tiles x splits of cps stages).
template <int BT, int G>
cudaError_t launch_bt(const int8_t* codes, const float* rowsumT, int ldrs, const uint32_t* qw,
                      const float* scales, const float* zs, const float* sx, int M, int K,
                      int N, int splits, int cps, float* partial, bf16* out, cudaStream_t st) {
  using L = Layout<BT, G>;
  const int ng = K / G;
  Maps maps;
  if (!encode(&maps.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, M, K, K, kKC, BT,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, qw, K / 8, N, N, kBN, kSlab,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, ng, N, N, kBN, L::kCG,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zs, ng, N, N, kBN, L::kCG,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.rs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rowsumT, ng, M, ldrs, BT, L::kCG,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(a8_wgmma_kernel<BT, G>, L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BT - 1) / BT, (N + kBN - 1) / kBN, splits);
  a8_wgmma_kernel<BT, G><<<grid, kThreads, L::kBytes, st>>>(maps, M, K, N, cps, sx,
                                                           splits > 1 ? partial : nullptr, out);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_g(int BT, const int8_t* codes, const float* rowsumT, int ldrs,
                     const uint32_t* qw, const float* scales, const float* zs, const float* sx,
                     int M, int K, int N, int splits, int cps, float* partial, bf16* out,
                     cudaStream_t st) {
#define QWA_LAUNCH(B) \
  launch_bt<B, G>(codes, rowsumT, ldrs, qw, scales, zs, sx, M, K, N, splits, cps, partial, out, st)
  switch (BT) {
    case 16: return QWA_LAUNCH(16);
    case 32: return QWA_LAUNCH(32);
    case 64: return QWA_LAUNCH(64);
    case 128: return QWA_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef QWA_LAUNCH
}

// K11f (x bf16, G = 128: a8_quant_kernel writes codes, sx and rowsumT) or
// K11 (x int8 codes with their row scales sx: a8_rowsum_kernel writes
// rowsumT), then the BT-token body. codes: int8 [M, K] scratch (K11f);
// rowsumT: f32 [K/G, (M + 3) & ~3] scratch, 16-byte aligned.
inline cudaError_t launch(bool fused, int BT, int G, const void* x, const uint32_t* qw,
                          const float* scales, const float* zs, int8_t* codes, float* rowsumT,
                          float* sx, int M, int K, int N, int splits, int cps, float* partial,
                          bf16* out, cudaStream_t st) {
  if (N % 4 != 0) return cudaErrorInvalidValue;  // 16-byte rows for the tensor copies
  const int ldrs = (M + 3) & ~3;
  if (fused) {
    a8_quant_kernel<<<M, 256, 0, st>>>(static_cast<const bf16*>(x), K, ldrs, codes, sx, rowsumT);
  } else {
    codes = static_cast<int8_t*>(const_cast<void*>(x));
    if (G == 128) a8_rowsum_kernel<128><<<M, 256, 0, st>>>(codes, K, ldrs, rowsumT);
    else if (G == 64) a8_rowsum_kernel<64><<<M, 256, 0, st>>>(codes, K, ldrs, rowsumT);
    else a8_rowsum_kernel<32><<<M, 256, 0, st>>>(codes, K, ldrs, rowsumT);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (G) {
    case 128: return launch_g<128>(BT, codes, rowsumT, ldrs, qw, scales, zs, sx, M, K, N, splits, cps, partial, out, st);
    case 64: return launch_g<64>(BT, codes, rowsumT, ldrs, qw, scales, zs, sx, M, K, N, splits, cps, partial, out, st);
    case 32: return launch_g<32>(BT, codes, rowsumT, ldrs, qw, scales, zs, sx, M, K, N, splits, cps, partial, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace qwa
}  // namespace
