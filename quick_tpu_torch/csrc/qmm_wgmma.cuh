// K1's body for more than 8 rows (quantized_matmul.cu): a W4A16 GEMM on
// Hopper's warpgroup tensor-core instruction, with the weight dequantized
// straight from the QTPU words into wgmma's register operand.
//
// The output tile is computed transposed, out^T[channels, tokens] =
// W^T x^T, so that the weight is wgmma's A operand, which may come from
// registers: wgmma.mma_async m64nBTk16 (bf16 in, f32 accumulate), A = 64
// output channels x 16 depths of dequantized codes in registers, B = the
// BT x 16 activation slice in shared memory (x is [M, K] with k contiguous,
// the K-major B wgmma takes without a transpose; its rows are 128-byte
// swizzled and described by a matrix descriptor).
//
// Why no repack: QTPU puts code q[g*128 + j*16 + k8, n] in nibble j of word
// [g*16 + k8, n] (quick_tpu/quantize/packing.py). A k16 A fragment gives
// lane (g, t) of warp w rows 16w + g and 16w + g + 8 (here channels) and
// depths 2t, 2t+1, 2t+8, 2t+9, which in step j of a group are nibble j of
// the words at k8 = 2t, 2t+1, 2t+8, 2t+9. So a lane reads 8 words per group
// (4 k8 x its 2 channels) and builds its fragments for all 8 steps from
// them: prmt puts the byte holding nibble j of two words into the halves
// of one register, a mask (and a shift for odd j) leaves the nibbles under
// the bf16 exponent of 128 (0x4300 | q = 128 + q, exact), and a bf16x2
// subtraction of 128 gives the codes, exact. No dequantized weight is
// written to shared memory.
//
// Numerics (quick_tpu/ops/quantized_matmul.py::_quantized_matmul_jnp):
// each group's integer dot goes into its own accumulator (8 k16 steps, the
// first with scale-d = 0), then acc += s[g, n] * dot - xsum[g, m] * zs[g,
// n], xsum the f32 sum of the group's bf16 activations; the scale stays on
// the output side.
//
// Block: 2 warpgroups (256 threads), 64 channels each, BT tokens (16, 32,
// 64 or 128: the accumulator and the group's dot take BT / 2 registers
// each). A ring of 4 stages, each one group's activations (BT x 128 bf16,
// two 64-wide halves in 128-byte swizzled rows), its packed words (16 rows
// of 128 channels), scales, zeros_x_scales and the xsum of its BT rows, all
// brought by the Tensor Memory Accelerator: thread 0 issues 6 tensor copies
// a stage, 3 groups ahead, that complete on the stage's "full" mbarrier; no
// other thread spends an instruction on loads. xsum comes from a small
// first kernel (xsum_kernel: one warp a row and group, a fixed order). Each
// warpgroup waits on "full", builds its fragments, issues 8 wgmma, waits,
// folds (two FMAs an element) and arrives on the stage's "empty" mbarrier,
// which thread 0 waits on before it refills the stage; the warpgroups share
// no other barrier in the loop, so one folds and builds while the other's
// MMAs run. Tokens are the fastest grid dimension, so the blocks in flight
// share a weight column. Split-K (the wrapper's plan, only where the output
// tiles cannot fill the card) writes f32 partials that quantized_matmul.cu's
// reduce kernel sums in a fixed order. The epilogue stages the bf16 tile in
// shared memory and writes 16-byte rows. Ragged M and N are zero-filled by
// the tensor copies and masked on store. The tensor maps are encoded on the
// host at each launch (cuTensorMapEncodeTiled through the runtime's driver
// entry point; a captured graph keeps them with the launch); N must be a
// multiple of 4 (16-byte rows of words and scales).
#pragma once

#include "wgmma_common.cuh"

namespace {
namespace qwg {

constexpr int kG = 128;         // quant group: 16 packed rows x 8 nibbles
constexpr int kSlab = 16;       // packed rows per group
constexpr int kBN = 128;        // output channels per block: 2 warpgroups x 64
constexpr int kThreads = 256;
constexpr int kStages = 4;

template <int BT>
struct Layout {
  static constexpr int kX = BT * kG * 2;     // activations
  static constexpr int kW = kSlab * kBN * 4; // packed words
  static constexpr int kS = kBN * 4;         // scales; zeros_x_scales follow
  static constexpr int kXs = BT * 4;         // xsum
  static constexpr int kBytesIn = kX + kW + 2 * kS + kXs;  // a stage's copies
  static constexpr int kStage = (kBytesIn + 1023) / 1024 * 1024;
  static constexpr int kOutLd = kBN + 8;     // epilogue tile row (bf16)
  // the ring, its 2 x kStages mbarriers, and slack to align the ring
  static constexpr size_t kBytes = (size_t)kStages * kStage + 16 * kStages + 1024;
  static_assert(BT * kOutLd * 2 <= kStages * kStage, "the epilogue tile fits the ring");
};

// The tensor maps of one launch: x [M, K] bf16 in 64 x BT boxes, 128-byte
// swizzled; qweight [K/8, N] int32, scales / zeros_x_scales [K/128, N] f32 in
// 128-column boxes of 16 / 1 rows; xsum [K/128, M] f32 in BT-column boxes.
struct Maps {
  CUtensorMap x, w, s, z, xs;
};

// xsumT[g, m] = f32 sum of x[m, g*128 .. g*128 + 127] (bf16), row stride
// ldxs: one warp a (row, group), lanes 4 channels each, a fixed shuffle tree.
__global__ void __launch_bounds__(256)
xsum_kernel(const bf16* __restrict__ x, int ldx, int M, int ng, int ldxs,
            float* __restrict__ xsumT) {
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (w >= M * ng) return;
  const int m = w / ng, g = w % ng;
  const uint2 v = *reinterpret_cast<const uint2*>(x + (size_t)m * ldx + g * kG + lane * 4);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  float sum = (a.x + a.y) + (b.x + b.y);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) xsumT[(size_t)g * ldxs + m] = sum;
}

// out[m0:m0+BT, n0:n0+128] of x @ dequant(qw) over groups g0 .. g0 + gps - 1
// (a split-K slice into partial [splits, M, N] f32 where partial is given,
// else the whole K into out [M, N] bf16); the operands come through `maps`.
template <int BT>
__global__ void __launch_bounds__(kThreads, BT <= 32 ? 2 : 1)
qmm_wgmma_kernel(const __grid_constant__ Maps maps, int M, int K, int N, int gps,
                 float* __restrict__ partial, bf16* __restrict__ out) {
  using L = Layout<BT>;
  constexpr int kNR = BT / 2;  // accumulator registers a lane
  extern __shared__ unsigned char qwg_smem[];
  unsigned char* smem = qwg_smem + ((1024 - (smem_u32(qwg_smem) & 1023)) & 1023);
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

  // thread 0: the copies of group g0 + j into stage j % kStages, once the
  // stage's previous group has been released by both warpgroups
  auto load = [&](int j) {
    const int st = j % kStages, grp = g0 + j;
    if (j >= kStages) mbar_wait(empty + 8 * st, ((j / kStages) - 1) & 1);
    const uint32_t bar = full + 8 * st;
    const uint32_t xs = sbase + st * L::kStage;
    mbar_arrive_expect_tx(bar, L::kBytesIn);
    tma_load(xs, &maps.x, grp * kG, m0, bar);
    tma_load(xs + BT * 128, &maps.x, grp * kG + 64, m0, bar);
    tma_load(xs + L::kX, &maps.w, n0, grp * kSlab, bar);
    tma_load(xs + L::kX + L::kW, &maps.s, n0, grp, bar);
    tma_load(xs + L::kX + L::kW + L::kS, &maps.z, n0, grp, bar);
    tma_load(xs + L::kX + L::kW + 2 * L::kS, &maps.xs, m0, grp, bar);
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

  float acc[kNR], dot[kNR];
#pragma unroll
  for (int i = 0; i < kNR; ++i) acc[i] = dot[i] = 0.f;

  for (int it = 0; it < nit; ++it) {
    if (tid == 0 && it + kStages - 1 < nit) load(it + kStages - 1);
    const int st = it % kStages;
    mbar_wait(full + 8 * st, (it / kStages) & 1);
    unsigned char* sp = smem + st * L::kStage;
    const uint32_t* wsm = reinterpret_cast<const uint32_t*>(sp + L::kX);
    uint32_t w[4][2];  // packed rows 2t, 2t + 1, 2t + 8, 2t + 9 x channels c0, c0 + 8
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * t + (i & 1) + (i >> 1) * 8;
      w[i][0] = wsm[r * kBN + c0];
      w[i][1] = wsm[r * kBN + c0 + 8];
    }
    uint32_t a[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j][0] = code_pair(w[0][0], w[1][0], j);  // channel c0, depths 2t, 2t + 1
      a[j][1] = code_pair(w[0][1], w[1][1], j);  // channel c0 + 8
      a[j][2] = code_pair(w[2][0], w[3][0], j);  // channel c0, depths 2t + 8, 2t + 9
      a[j][3] = code_pair(w[2][1], w[3][1], j);
    }
    hold(dot);
    wgmma_fence();
    const uint32_t xb = sbase + st * L::kStage;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Wgmma<BT>::mma(dot, a[j], desc_b(xb + (j >> 2) * (BT * 128) + (j & 3) * 32), j > 0);
    wgmma_commit();
    wgmma_wait0();
    hold(dot);
    hold(a);
    const float* ssm = reinterpret_cast<const float*>(sp + L::kX + L::kW);
    const float* xsm = ssm + 2 * kBN;
    const float s0 = ssm[c0], s1 = ssm[c0 + 8];
    const float z0 = -ssm[kBN + c0], z1 = -ssm[kBN + c0 + 8];
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
      const float2 xv = *reinterpret_cast<const float2*>(xsm + 8 * i + 2 * t);
      acc[4 * i + 0] = fmaf(xv.x, z0, fmaf(dot[4 * i + 0], s0, acc[4 * i + 0]));
      acc[4 * i + 1] = fmaf(xv.y, z0, fmaf(dot[4 * i + 1], s0, acc[4 * i + 1]));
      acc[4 * i + 2] = fmaf(xv.x, z1, fmaf(dot[4 * i + 2], s1, acc[4 * i + 2]));
      acc[4 * i + 3] = fmaf(xv.y, z1, fmaf(dot[4 * i + 3], s1, acc[4 * i + 3]));
    }
    mbar_arrive(empty + 8 * st);
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
    for (int e = 0; e < 4; ++e)
      tile[(8 * i + 2 * t + (e & 1)) * L::kOutLd + c0 + (e >> 1) * 8] =
          __float2bfloat16_rn(acc[4 * i + e]);
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

// Launch xsum_kernel, then the BT-token body (grid: token tiles x
// 128-channel tiles x splits). xsumT: f32 scratch [K/128, (M + 3) & ~3].
template <int BT>
cudaError_t launch_bt(const bf16* x, int ldx, const uint32_t* qw, const float* scales,
                      const float* zs, float* xsumT, int M, int K, int N, int splits,
                      int gps, float* partial, bf16* out, cudaStream_t st) {
  constexpr size_t smem = Layout<BT>::kBytes;
  const int ng = K / kG, ldxs = (M + 3) & ~3;
  Maps maps;
  if (!encode(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, ldx, 64, BT,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, qw, K / 8, N, N, kBN, kSlab,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, ng, N, N, kBN, 1,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zs, ng, N, N, kBN, 1,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xsumT, ng, M, ldxs, BT, 1,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(qmm_wgmma_kernel<BT>, smem);
  if (err != cudaSuccess) return err;
  xsum_kernel<<<(M * ng + 7) / 8, 256, 0, st>>>(x, ldx, M, ng, ldxs, xsumT);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dim3 grid((M + BT - 1) / BT, (N + kBN - 1) / kBN, splits);
  qmm_wgmma_kernel<BT><<<grid, kThreads, smem, st>>>(maps, M, K, N, gps,
                                                     splits > 1 ? partial : nullptr, out);
  return cudaGetLastError();
}

inline cudaError_t launch(int BT, const bf16* x, int ldx, const uint32_t* qw,
                          const float* scales, const float* zs, float* xsumT, int M, int K,
                          int N, int splits, int gps, float* partial, bf16* out,
                          cudaStream_t st) {
  if (N % 4 != 0) return cudaErrorInvalidValue;  // 16-byte rows for the tensor copies
  switch (BT) {
    case 16: return launch_bt<16>(x, ldx, qw, scales, zs, xsumT, M, K, N, splits, gps, partial, out, st);
    case 32: return launch_bt<32>(x, ldx, qw, scales, zs, xsumT, M, K, N, splits, gps, partial, out, st);
    case 64: return launch_bt<64>(x, ldx, qw, scales, zs, xsumT, M, K, N, splits, gps, partial, out, st);
    case 128: return launch_bt<128>(x, ldx, qw, scales, zs, xsumT, M, K, N, splits, gps, partial, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace qwg
}  // namespace
