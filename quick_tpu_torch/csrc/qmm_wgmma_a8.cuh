// K11f's body (quantized_matmul_a8.cu, QUICK_TPU_A8_FUSED at G = 128): the
// fused-quantization W4A8 GEMM on Hopper's int8 warpgroup tensor-core
// instruction, with the weight's codes taken straight from the QTPU words
// into wgmma's register operand. It follows K1's body (qmm_wgmma.cuh) and
// shares its building blocks (wgmma_common.cuh).
//
// Each row is quantized once: a first small kernel (a8_quant_kernel, one
// block a row) takes the row's absmax, sx = max(amax / 127, 1e-8) with a
// true division, and writes the int8 codes clamp(rint(x / sx), -127, 127)
// (round half to even), sx, and the integer sum of each group's codes,
// which the zero-point term needs: quantize_activations' arithmetic
// (qmm_mma_a8.cuh::quant_code, row_scale). At M = 512 the codes are a few
// MB and stay in L2 for the main kernel.
//
// The output tile is computed transposed, out^T[channels, tokens] =
// W^T xq^T: wgmma.mma_async m64nBTk32 (s8 x s8 -> s32; integer wgmma takes
// both operands K-major, and A may come from registers), A = 64 channels x
// 32 depths of codes (0..15, exact in s8), B = the BT x 32 slice of the
// int8 codes in shared memory. One stage is one group: BT x 128 codes, one
// 128-byte swizzled row per token; step s of the group starts 32 bytes
// further along the rows.
//
// Fragment map without a repack: at G = 128 code q[g*128 + j*16 + k8, n]
// sits in nibble j of word [g*16 + k8, n]. A k32 s8 A fragment gives lane
// (g, t) of warp w channels 16w + g and 16w + g + 8, depths 4t .. 4t+3 of
// the step in registers 0 / 1 and 16 + 4t .. 16 + 4t+3 in registers 2 / 3,
// one depth a byte. In step s those depths are nibbles 2s and 2s + 1 of the
// words k8 = 4t .. 4t+3, which are byte s of each. So a lane reads 4 words
// a channel and group, transposes their bytes (six prmt: byte s of the 4
// words into one register) and masks low and high nibbles into the two
// registers of each step (tests/test_torch_wgmma_fragments.py models it).
//
// Numerics (_quantized_matmul_a8_jnp): each group's exact int32 dot goes
// into its own accumulator (4 k32 steps, the first with scale-d = 0), then
// acc += f32(dot) * s[g, n] - rowsum_g[m] * zs[g, n] (the dot, below 2^22
// in magnitude, becomes f32 exactly through the exponent of 1.5 * 2^23);
// the row scale sx[m] multiplies once before the single bf16 rounding, or
// in the split-K reduce. With K11's expression, its group order and its
// split of K (the wrapper's plan), K11f's output equals K11's bit for bit.
//
// Block: 2 consumer warpgroups (256 threads), 64 channels each, BT tokens
// (16, 32, 64 or 128). A ring of 6 stages (codes, words, scales,
// zeros_x_scales, row sums), brought by the Tensor Memory Accelerator from
// thread 0 on "full" mbarriers and released on "empty" ones; the two
// warpgroups share no other barrier in the loop. Ragged M and N are
// zero-filled by the copies and masked on store. N must be a multiple of 4
// (the wrapper pads other widths).
#pragma once

#include "qmm_mma_a8.cuh"
#include "wgmma_common.cuh"

namespace {
namespace qwa {

using namespace qwg;

constexpr int kG = 128;       // quant group = one stage
constexpr int kSlab = 16;     // packed rows per group
constexpr int kBN = 128;      // output channels per block: 2 warpgroups x 64
constexpr int kThreads = 256;
constexpr int kStages = 6;

template <int BT>
struct Layout {
  static constexpr int kX = BT * kG;         // int8 codes
  static constexpr int kW = kSlab * kBN * 4; // packed words
  static constexpr int kS = kBN * 4;         // scales; zeros_x_scales follow
  static constexpr int kRs = BT * 4;         // the group's row sums
  static constexpr int kBytesIn = kX + kW + 2 * kS + kRs;  // a stage's copies
  static constexpr int kStage = (kBytesIn + 1023) / 1024 * 1024;
  static constexpr int kOutLd = kBN + 8;     // epilogue tile row (bf16)
  static constexpr size_t kBytes = (size_t)kStages * kStage + 16 * kStages + 1024;
  static_assert(BT * kOutLd * 2 <= kStages * kStage, "the epilogue tile fits the ring");
};

// codes [M, K] int8 in 128 x BT boxes, 128-byte swizzled; qweight [K/8, N]
// int32 in 128 x 16 boxes; scales / zeros_x_scales [K/128, N] f32 in
// 128 x 1; row sums [K/128, M] f32 in BT x 1
struct Maps {
  CUtensorMap x, w, s, z, rs;
};

// codes[m, :], sx[m] and rowsumT[g, m] of row m = blockIdx.x (bf16 x [M, K],
// K % 128 == 0, 16-byte aligned rows): one block a row, 8 channels a
// thread, 16 threads a group
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
  const float s = a8::row_scale(amax);
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
        const int q0 = a8::quant_code(f0.x, s), q1 = a8::quant_code(f0.y, s);
        const int q2 = a8::quant_code(f1.x, s), q3 = a8::quant_code(f1.y, s);
        sum += (q0 + q1) + (q2 + q3);
        w[i] = (uint32_t)(q0 & 0xFF) | ((uint32_t)(q1 & 0xFF) << 8) |
               ((uint32_t)(q2 & 0xFF) << 16) | ((uint32_t)(q3 & 0xFF) << 24);
      }
      *reinterpret_cast<uint2*>(codes + (size_t)m * K + k) = make_uint2(w[0], w[1]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if ((tid & 15) == 0 && k < K) rowsumT[(size_t)(k / kG) * ldrs + m] = (float)sum;
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

// out[m0:m0+BT, n0:n0+128] over groups g0 .. g0 + gps - 1: unscaled f32
// partials into partial [splits, M, N] where partial is given, else
// bf16(acc * sx[m]) into out [M, N]
template <int BT>
__global__ void __launch_bounds__(kThreads, BT <= 32 ? 2 : 1)
a8_wgmma_kernel(const __grid_constant__ Maps maps, int M, int K, int N, int gps,
                const float* __restrict__ sx, float* __restrict__ partial,
                bf16* __restrict__ out) {
  using L = Layout<BT>;
  constexpr int kNR = BT / 2;  // accumulator registers a lane
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
  const int g0 = blockIdx.z * gps;
  const int nit = min(K / kG, g0 + gps) - g0;

  auto load = [&](int j) {
    const int sl = j % kStages, grp = g0 + j;
    if (j >= kStages) mbar_wait(empty + 8 * sl, ((j / kStages) - 1) & 1);
    const uint32_t bar = full + 8 * sl;
    const uint32_t xs = sbase + sl * L::kStage;
    mbar_arrive_expect_tx(bar, L::kBytesIn);
    tma_load(xs, &maps.x, grp * kG, m0, bar);
    tma_load(xs + L::kX, &maps.w, n0, grp * kSlab, bar);
    tma_load(xs + L::kX + L::kW, &maps.s, n0, grp, bar);
    tma_load(xs + L::kX + L::kW + L::kS, &maps.z, n0, grp, bar);
    tma_load(xs + L::kX + L::kW + 2 * L::kS, &maps.rs, m0, grp, bar);
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
    uint32_t a[4][4];  // step s: {c0, c0+8} x {depths 4t.., 16+4t..}
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = wsm[(4 * t + i) * kBN + c0 + 8 * h];
      byte_transpose(w, b);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        a[s][h] = b[s] & 0x0F0F0F0Fu;             // nibble 2s: depths 32s + 4t + i
        a[s][2 + h] = (b[s] >> 4) & 0x0F0F0F0Fu;  // nibble 2s + 1: 32s + 16 + 4t + i
      }
    }
    hold(dot);
    wgmma_fence();
    const uint32_t xb = sbase + sl * L::kStage;
#pragma unroll
    for (int s = 0; s < 4; ++s) WgmmaS8<BT>::mma(dot, a[s], desc_b(xb + s * 32), s > 0);
    wgmma_commit();
    wgmma_wait0();
    hold(dot);
    hold(a);
    const float* ssm = reinterpret_cast<const float*>(sp + L::kX + L::kW);
    const float* rsm = ssm + 2 * kBN;
    const float s0 = ssm[c0], s1 = ssm[c0 + 8];
    const float z0 = ssm[kBN + c0], z1 = ssm[kBN + c0 + 8];
    // K11's expression (qmm_mma_a8.cuh), which the compiler contracts alike
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
      const float2 rs = *reinterpret_cast<const float2*>(rsm + 8 * i + 2 * t);
      acc[4 * i + 0] += small_i2f(dot[4 * i + 0]) * s0 - rs.x * z0;
      acc[4 * i + 1] += small_i2f(dot[4 * i + 1]) * s0 - rs.y * z0;
      acc[4 * i + 2] += small_i2f(dot[4 * i + 2]) * s1 - rs.x * z1;
      acc[4 * i + 3] += small_i2f(dot[4 * i + 3]) * s1 - rs.y * z1;
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

// Launch a8_quant_kernel, then the BT-token body (grid: token tiles x
// 128-channel tiles x splits). codes: int8 [M, K] scratch; rowsumT: f32
// [K/128, (M + 3) & ~3] scratch, 16-byte aligned; sx: f32 [M], written.
template <int BT>
cudaError_t launch_bt(const bf16* x, const uint32_t* qw, const float* scales, const float* zs,
                      int8_t* codes, float* rowsumT, float* sx, int M, int K, int N, int splits,
                      int gps, float* partial, bf16* out, cudaStream_t st) {
  using L = Layout<BT>;
  const int ng = K / kG, ldrs = (M + 3) & ~3;
  Maps maps;
  if (!encode(&maps.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, M, K, K, kG, BT,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, qw, K / 8, N, N, kBN, kSlab,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, ng, N, N, kBN, 1,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zs, ng, N, N, kBN, 1,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.rs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rowsumT, ng, M, ldrs, BT, 1,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(a8_wgmma_kernel<BT>, L::kBytes);
  if (err != cudaSuccess) return err;
  a8_quant_kernel<<<M, 256, 0, st>>>(x, K, ldrs, codes, sx, rowsumT);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dim3 grid((M + BT - 1) / BT, (N + kBN - 1) / kBN, splits);
  a8_wgmma_kernel<BT><<<grid, kThreads, L::kBytes, st>>>(maps, M, K, N, gps, sx,
                                                        splits > 1 ? partial : nullptr, out);
  return cudaGetLastError();
}

inline cudaError_t launch(int BT, const bf16* x, const uint32_t* qw, const float* scales,
                          const float* zs, int8_t* codes, float* rowsumT, float* sx, int M,
                          int K, int N, int splits, int gps, float* partial, bf16* out,
                          cudaStream_t st) {
  if (N % 4 != 0) return cudaErrorInvalidValue;  // 16-byte rows for the tensor copies
  switch (BT) {
    case 16: return launch_bt<16>(x, qw, scales, zs, codes, rowsumT, sx, M, K, N, splits, gps, partial, out, st);
    case 32: return launch_bt<32>(x, qw, scales, zs, codes, rowsumT, sx, M, K, N, splits, gps, partial, out, st);
    case 64: return launch_bt<64>(x, qw, scales, zs, codes, rowsumT, sx, M, K, N, splits, gps, partial, out, st);
    case 128: return launch_bt<128>(x, qw, scales, zs, codes, rowsumT, sx, M, K, N, splits, gps, partial, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace qwa
}  // namespace
