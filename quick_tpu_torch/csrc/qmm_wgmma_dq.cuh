// K9's body (quantized_matmul_dequant.cu): the small-group (G = 32 or 64)
// W4A16 GEMM on Hopper's warpgroup tensor-core instruction, each weight
// dequantized to bf16 straight from the QTPU words into wgmma's register
// operand, at every row count (BT = 8 for the decode rows, 16-128 above).
// It follows K1's body (qmm_wgmma.cuh) and shares its building blocks
// (wgmma_common.cuh).
//
// The output tile is computed transposed, out^T[channels, tokens] =
// W^T x^T, so that the weight is the A operand, which may come from
// registers: wgmma.mma_async m64nBTk16 (bf16 in, f32 accumulate), A = 64
// output channels x 16 depths of dequantized weights, B = the BT x 16
// activation slice in 128-byte swizzled shared memory (x is [M, K] with k
// contiguous: the K-major B).
//
// Numerics (the TPU kernel's, _make_kernel_dequant): w = bf16(code * s -
// zs), the product and the difference each rounded in f32, then one f32
// accumulator across K. The product is taken as fma(2^23 + code, s,
// -2^23 * s): the exact value is code * s and the FMA rounds it once, so it
// equals the rounded product (__fmul_rn), in one instruction from the
// code's float (2^23 + code is the word's nibble under the exponent of
// 2^23, exact). The difference is __fsub_rn, never contracted. No group
// fold exists: each k16 step lies inside one group, whose s and zs are the
// lane's for the step.
//
// Fragment map without a repack: at G, code k = g*G + j*(G/8) + r sits in
// nibble j of word [g*G/8 + r, n]. A k16 A fragment gives lane (g, t) of
// warp w channels 16w + g and 16w + g + 8 and depths 2t, 2t+1, 2t+8, 2t+9 of
// the step. At G = 64 (slab 8) a group is 4 steps: in step st those depths
// are nibbles 2st (2t, 2t+1) and 2st + 1 (2t+8, 2t+9) of the words r = 2t,
// 2t+1, so a lane reads 2 words a channel and group and uses all 16
// nibbles. At G = 32 (slab 4) a group is 2 steps: nibbles t/2 + 4st (2t,
// 2t+1) and t/2 + 4st + 2 (2t+8, 2t+9) of the words r = 2(t%2), 2(t%2) + 1;
// a lane shifts its words by 4 (t/2) once and uses nibbles 0, 2, 4, 6 of
// them (tests/test_torch_wgmma_fragments.py models both maps).
//
// Block: 2 consumer warpgroups (256 threads), 64 channels each, BT tokens
// (8, 16, 32, 64 or 128). A ring of 4 stages (6 at BT = 8), each 128
// depths (128 / G whole groups): the activations (two 64-wide halves in
// 128-byte swizzled rows), 16 rows of packed words, and the groups'
// scales and zeros_x_scales, all brought by the Tensor Memory
// Accelerator: thread 0 issues 5 tensor copies a stage, a ring less one
// stages ahead, completing on the stage's "full" mbarrier. Each warpgroup
// keeps two fragment buffers: it issues a stage's 8 wgmma, then waits on
// the next stage's "full" and dequantizes its fragments while those MMAs
// run, waits for them and arrives on the stage's "empty"; the two
// warpgroups are coupled only through those barriers. K need only be a
// multiple of G: the copies zero-fill past K (zero activations, words,
// scales, zeros), as they do ragged M and N, which the store masks.
// Split-K (the wrapper's plan, only where the output tiles cannot fill the
// card) writes f32 partials that quantized_matmul_dequant.cu's reduce
// kernel sums in a fixed order. N must be a multiple of 4 (16-byte rows of
// words and scales; the wrapper pads other widths).
//
// The decode rows (M <= 8, BT = 8: m64n8k16; the 8-row B tile of a 64-wide
// half is one 1024-byte swizzle atom, rows >= M zero-filled by the copy):
// the weight stream is all the work; the tensor core takes the multiply-
// adds the CUDA-core body did per weight and row. A stage is 2 KB of
// activations and 12 or 14 KB of words, scales and zeros, so the ring is 6
// stages deep (5 ahead) at two blocks an SM: 80 KB of words in flight an
// SM. The plan splits K over blocks until the card is full (DeepSeek's
// kv_a has 5 column tiles), at most 16 splits. The last block of an output
// tile to finish (one acq_rel atomic on a counter, which it resets for the
// next launch, so a captured launch replays) copies every split's f32
// partials of the tile into its shared memory at once and sums them in
// split order into the bf16 tile: no second launch. At DeepSeek's widths a
// launch is a few microseconds, so its fixed costs count: it is launched as
// a programmatic dependent of the kernel before it (its blocks set up
// their barriers and prefetch the four tensor maps while that kernel
// finishes, then wait on it before the first copy), and the merge is one
// atomic and one batch of copies (the splits of a tile as one thread block
// cluster, merged through distributed shared memory, ran slower).
#pragma once

#include "wgmma_common.cuh"

namespace {
namespace qwd {

using namespace qwg;

constexpr int kKC = 128;      // depths per stage
constexpr int kWRows = 16;    // packed rows per stage
constexpr int kBN = 128;      // output channels per block: 2 warpgroups x 64
constexpr int kThreads = 256;
constexpr int kMaxSplits = 16;  // K splits of the 8-token tile (its merge stages them all)

// 16 bytes global (L2) -> shared, zero-filled when !ok (src must still be
// valid); then wait for all of this thread's copies
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int BT, int G>
struct Layout {
  static constexpr int kStages = BT == 8 ? 6 : 4;
  static constexpr int kCG = kKC / G;         // groups per stage
  static constexpr int kX = BT * kKC * 2;     // activations
  static constexpr int kW = kWRows * kBN * 4; // packed words
  static constexpr int kS = kCG * kBN * 4;    // scales; zeros_x_scales follow
  static constexpr int kBytesIn = kX + kW + 2 * kS;  // a stage's copies
  static constexpr int kStage = (kBytesIn + 1023) / 1024 * 1024;
  static constexpr int kOutLd = kBN + 8;      // epilogue tile row (bf16)
  static constexpr size_t kBytes = (size_t)kStages * kStage + 16 * kStages + 1024;
  static_assert(BT * kOutLd * 2 <= kStages * kStage, "the epilogue tile fits the ring");
  static_assert(BT != 8 || 16 + kMaxSplits * BT * kBN * 4 <= kStages * kStage,
                "the decode rows' merge stages every split's partials in the ring");
};

// x [M, K] bf16 in 64 x BT boxes, 128-byte swizzled; qweight [K/8, N] int32
// in 128 x 16 boxes; scales / zeros_x_scales [K/G, N] f32 in 128 x (128/G)
struct Maps {
  CUtensorMap x, w, s, z;
};

// bf16x2 {w of nibble at bit sh of lo, of hi}: bf16(code * s - zs) each,
// with c = -2^23 * s (see the header comment)
__device__ __forceinline__ uint32_t dq_pair(uint32_t lo, uint32_t hi, int sh, float s, float c,
                                            float zs) {
  const float flo = __uint_as_float(((lo >> sh) & 0xFu) | 0x4B000000u);
  const float fhi = __uint_as_float(((hi >> sh) & 0xFu) | 0x4B000000u);
  __nv_bfloat162 r = __floats2bfloat162_rn(__fsub_rn(fmaf(flo, s, c), zs),
                                           __fsub_rn(fmaf(fhi, s, c), zs));
  return *reinterpret_cast<uint32_t*>(&r);
}

// The end of an 8-token tile (the decode rows, one token tile; grid (1,
// column tiles, splits)), shared with K1's decode rows (quantized_matmul.cu):
// acc register e holds channel c0 + 8 * (e >> 1), token 2t + (e & 1). With
// K split (partial given: f32 [splits, M, N]), the block writes its
// partials, and the last block of the column tile to finish sums every
// split's partials in split order into out and resets counters[tile] for
// the next launch; unsplit, the bf16 tile goes out through shared memory
// in 16-byte rows. smem: the block's ring, 1024-aligned, every copy landed
// and consumed, at least 16 + splits * 8 * 128 * 4 bytes.
__device__ __forceinline__ void decode_store(const float (&acc)[4], unsigned char* smem, int M,
                                             int N, int n0, int c0, int t, int tid,
                                             float* __restrict__ partial, bf16* __restrict__ out,
                                             int* __restrict__ counters) {
  constexpr int BT = 8, kOutLd = kBN + 8;
  if (partial != nullptr) {
    float* p = partial + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * t + (e & 1), n = n0 + c0 + (e >> 1) * 8;
      if (m < M && n < N) p[(size_t)m * N + n] = acc[e];
    }
    // the last split of this output tile to finish sums the splits' partials
    // in split order (the reduce kernel's order) and resets the counter
    int* flag = reinterpret_cast<int*>(smem);
    __syncthreads();  // every partial of this block is written; the ring is free
    if (tid == 0) {
      // one acq_rel atomic releases the block's partials (the barrier
      // orders every thread's stores before it) and acquires the others'
      int* cnt = counters + blockIdx.y;
      int done;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(done) : "l"(cnt) : "memory");
      *flag = done == (int)gridDim.z - 1;
      if (*flag) *cnt = 0;
    }
    __syncthreads();
    if (!*flag) return;
    // every split's partials of the tile into shared memory at once
    // (16-byte copies from L2, after the flag), then each output summed in
    // split order
    float* sums = reinterpret_cast<float*>(smem + 16);  // [splits][BT][kBN]
    const int nz = gridDim.z, rows = min(BT, M);
    for (int c = tid; c < nz * rows * (kBN / 4); c += kThreads) {
      const int z = c / (rows * (kBN / 4)), r = c / (kBN / 4) % rows, c4 = 4 * (c % (kBN / 4));
      const bool ok = n0 + c4 < N;  // N % 4 == 0: a 16-byte chunk is whole or past N
      const float* src = partial + ((size_t)z * M + r) * N + (ok ? n0 + c4 : 0);
      cp_async16(smem_u32(sums + (z * BT + r) * kBN + c4), src, ok);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int idx = tid; idx < rows * kBN; idx += kThreads) {
      const int m = idx / kBN, n = n0 + idx % kBN;
      if (n >= N) continue;
      float sum = 0.f;
      for (int z = 0; z < nz; ++z) sum += sums[z * BT * kBN + idx];
      out[(size_t)m * N + n] = __float2bfloat16_rn(sum);
    }
    return;
  }
  __syncthreads();  // the ring is free: every copy landed and was consumed
  bf16* tile = reinterpret_cast<bf16*>(smem);  // [BT][kOutLd]
#pragma unroll
  for (int e = 0; e < 4; ++e)
    tile[(2 * t + (e & 1)) * kOutLd + c0 + (e >> 1) * 8] = __float2bfloat16_rn(acc[e]);
  __syncthreads();
  for (int idx = tid; idx < BT * (kBN / 8); idx += kThreads) {
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    const int n = n0 + c;
    if (r >= M || n >= N) continue;
    const bf16* src = tile + r * kOutLd + c;
    bf16* dst = out + (size_t)r * N + n;
    if ((N & 7) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// out[m0:m0+BT, n0:n0+128] of x @ dequant(qw) over the stages (128 depths)
// c0 .. c0 + cps - 1 (a split-K slice into partial [splits, M, N] f32 where
// partial is given, else the whole K into out [M, N] bf16; at BT = 8 the
// last split of a tile to finish sums the partials into out, counting on
// counters[tile], which it leaves at zero)
template <int BT, int G>
__global__ void __launch_bounds__(kThreads, BT <= 32 ? 2 : 1)
dq_wgmma_kernel(const __grid_constant__ Maps maps, int M, int K, int N, int cps,
                float* __restrict__ partial, bf16* __restrict__ out,
                int* __restrict__ counters) {
  using L = Layout<BT, G>;
  constexpr int kStages = L::kStages;
  constexpr int kNR = BT / 2;  // accumulator registers a lane
  constexpr int kCG = L::kCG;
  constexpr int kSlabG = G / 8;
  static_assert(G == 32 || G == 64, "K9 takes G = 32 or 64");
  extern __shared__ unsigned char qwd_smem[];
  unsigned char* smem = qwd_smem + ((1024 - (smem_u32(qwd_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + kStages * L::kStage;  // full[s] = full + 8s
  const uint32_t empty = full + 8 * kStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = wgi * 64 + warp * 16 + g;  // the lane's channels c0, c0 + 8
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * kBN;
  const int s0 = blockIdx.z * cps;
  const int nit = min((K + kKC - 1) / kKC, s0 + cps) - s0;

  // thread 0: the copies of stage s0 + j into ring slot j % kStages, once
  // the slot's previous stage has been released by both warpgroups
  auto load = [&](int j) {
    const int sl = j % kStages, ck = s0 + j;
    if (j >= kStages) mbar_wait(empty + 8 * sl, ((j / kStages) - 1) & 1);
    const uint32_t bar = full + 8 * sl;
    const uint32_t xs = sbase + sl * L::kStage;
    mbar_arrive_expect_tx(bar, L::kBytesIn);
    tma_load(xs, &maps.x, ck * kKC, m0, bar);
    tma_load(xs + BT * 128, &maps.x, ck * kKC + 64, m0, bar);
    tma_load(xs + L::kX, &maps.w, n0, ck * kWRows, bar);
    tma_load(xs + L::kX + L::kW, &maps.s, n0, ck * kCG, bar);
    tma_load(xs + L::kX + L::kW + L::kS, &maps.z, n0, ck * kCG, bar);
  };
  if constexpr (BT == 8) {  // the decode rows' launches are short: fetch the maps at once
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.x) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.w) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.s) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.z) : "memory");
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (BT == 8)  // a programmatic dependent launch: wait for the kernel before
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0)
    for (int j = 0; j < kStages - 1 && j < nit; ++j) load(j);

  float acc[kNR];
#pragma unroll
  for (int i = 0; i < kNR; ++i) acc[i] = 0.f;

  // stage `it`'s 8 fragments, dequantized once its copies have landed:
  // step q * (8 / kCG) + st, registers {c0, c0 + 8} x {2t.., 2t+8..}
  auto build = [&](int it, uint32_t (&a)[8][4]) {
    const int sl = it % kStages;
    mbar_wait(full + 8 * sl, (it / kStages) & 1);
    const unsigned char* sp = smem + sl * L::kStage;
    const uint32_t* wsm = reinterpret_cast<const uint32_t*>(sp + L::kX);
    const float* ssm = reinterpret_cast<const float*>(sp + L::kX + L::kW);
    const float* zsm = ssm + kCG * kBN;
#pragma unroll
    for (int q = 0; q < kCG; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = c0 + 8 * h;
        const float s = ssm[q * kBN + ch], zs = zsm[q * kBN + ch];
        const float c = -8388608.f * s;
        if constexpr (G == 64) {
          const uint32_t lo = wsm[(q * kSlabG + 2 * t) * kBN + ch];
          const uint32_t hi = wsm[(q * kSlabG + 2 * t + 1) * kBN + ch];
#pragma unroll
          for (int st = 0; st < 4; ++st) {
            a[q * 4 + st][h] = dq_pair(lo, hi, 8 * st, s, c, zs);
            a[q * 4 + st][2 + h] = dq_pair(lo, hi, 8 * st + 4, s, c, zs);
          }
        } else {
          const int sh = 4 * (t >> 1);
          const uint32_t lo = wsm[(q * kSlabG + 2 * (t & 1)) * kBN + ch] >> sh;
          const uint32_t hi = wsm[(q * kSlabG + 2 * (t & 1) + 1) * kBN + ch] >> sh;
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            a[q * 2 + st][h] = dq_pair(lo, hi, 16 * st, s, c, zs);
            a[q * 2 + st][2 + h] = dq_pair(lo, hi, 16 * st + 8, s, c, zs);
          }
        }
      }
  };
  // stage `it`'s 8 MMAs on fragments a, one commit group
  auto issue = [&](int it, const uint32_t (&a)[8][4]) {
    if (tid == 0 && it + kStages - 1 < nit) load(it + kStages - 1);
    const uint32_t xb = sbase + (it % kStages) * L::kStage;
    hold(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Wgmma<BT>::mma(acc, a[j], desc_b(xb + (j >> 2) * (BT * 128) + (j & 3) * 32), 1);
    wgmma_commit();
  };
  // wait for stage `it`'s MMAs (a is theirs until then) and release its slot
  auto retire = [&](int it, uint32_t (&a)[8][4]) {
    wgmma_wait0();
    hold(acc);
    hold(a);
    mbar_arrive(empty + 8 * (it % kStages));
  };
  // two fragment buffers: the next stage is dequantized while this one's
  // MMAs run
  uint32_t a0[8][4], a1[8][4];
  if (nit > 0) build(0, a0);
  for (int it = 0; it < nit; it += 2) {
    issue(it, a0);
    if (it + 1 < nit) build(it + 1, a1);
    retire(it, a0);
    if (it + 1 == nit) break;
    issue(it + 1, a1);
    if (it + 2 < nit) build(it + 2, a0);
    retire(it + 1, a1);
  }

  if constexpr (BT == 8) {
    decode_store(acc, smem, M, N, n0, c0, t, tid, partial, out, counters);
    return;
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

// The BT-token body at group G (grid: token tiles x 128-channel tiles x
// splits of cps stages).
template <int BT, int G>
cudaError_t launch_bt(const bf16* x, const uint32_t* qw, const float* scales, const float* zs,
                      int M, int K, int N, int splits, int cps, float* partial, bf16* out,
                      int* counters, cudaStream_t st) {
  using L = Layout<BT, G>;
  Maps maps;
  if (!encode(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, K, 64, BT,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, qw, K / 8, N, N, kBN, kWRows,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, K / G, N, N, kBN, L::kCG,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zs, K / G, N, N, kBN, L::kCG,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dq_wgmma_kernel<BT, G>, L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BT - 1) / BT, (N + kBN - 1) / kBN, splits);
  if constexpr (BT == 8) {
    // programmatic stream serialization: the blocks may start, and set up
    // their barriers and maps, while the kernel before finishes; they wait
    // for it before the first copy (griddepcontrol.wait)
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = L::kBytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, dq_wgmma_kernel<BT, G>, maps, M, K, N, cps,
                             splits > 1 ? partial : nullptr, out, counters);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  dq_wgmma_kernel<BT, G><<<grid, kThreads, L::kBytes, st>>>(
      maps, M, K, N, cps, splits > 1 ? partial : nullptr, out, counters);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch(int BT, const bf16* x, const uint32_t* qw, const float* scales,
                   const float* zs, int M, int K, int N, int splits, int cps, float* partial,
                   bf16* out, int* counters, cudaStream_t st) {
  if (N % 4 != 0) return cudaErrorInvalidValue;  // 16-byte rows for the tensor copies
#define QWD_LAUNCH(B) \
  launch_bt<B, G>(x, qw, scales, zs, M, K, N, splits, cps, partial, out, counters, st)
  switch (BT) {
    case 8: return M <= 8 && splits <= kMaxSplits ? QWD_LAUNCH(8) : cudaErrorInvalidValue;
    case 16: return QWD_LAUNCH(16);
    case 32: return QWD_LAUNCH(32);
    case 64: return QWD_LAUNCH(64);
    case 128: return QWD_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef QWD_LAUNCH
}

}  // namespace qwd
}  // namespace
