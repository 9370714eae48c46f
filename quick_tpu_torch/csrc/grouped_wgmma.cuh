// The skeleton of the grouped (ragged) MoE GEMMs on Hopper's warpgroup
// instruction, shared by K8 (grouped_matmul.cu: bf16 rows, bf16 wgmma) and
// K12 (grouped_matmul_a8.cu: int8 codes, s8 wgmma). A body type B gives
// what differs: the activations' bytes a depth, a stage's register
// operands, MMAs and folds, group by group, the first kernel (the rows'
// group sums) and whether a row scale multiplies the output.
//
// A block is one (128-channel column tile, expert, K slice). It finds its
// expert's live tiles itself, by a warp's ballot scan of tile_expert and
// tile_live (the host never reads them), and takes them in passes of up to
// PR rows (PR = 64 for bm = 32 or 64, 128 for bm = 128): a pass streams the
// expert's words, scales and zeros_x_scales once, through a ring of stages
// (128 depths each) brought by the Tensor Memory Accelerator on full /
// empty mbarriers, together with the pass's tiles' activation rows (one
// tensor copy per tile and 128-byte wide slice, at the tile's row read on
// the card) and their group sums. So an expert's weights are read once per
// column tile and pass, not once per token tile: at decode, where each
// routed (token, expert) pair owns a 32-row tile, an expert chosen by two
// tokens is streamed once. Blocks of an expert with no live tile exit at
// once. The product runs transposed, out^T = W^T x^T, with A, 64 channels
// of codes, built by each lane straight from the QTPU words in registers,
// and B the pass's rows in shared memory (128-byte swizzled, K-major); the
// instruction's token width follows the live rows of the pass (32 or 64 at
// PR = 64). Each group's dot has its own accumulator, folded into the f32
// output accumulator group by group in order. A last stage past K (K need
// only be a multiple of G) skips its missing groups. Where the column
// tiles times the experts cannot fill the card, K is split over blocks
// (the wrapper's plan, from the shapes alone) into f32 partials that a
// last kernel sums in split order (then times the row scale, where there
// is one), writing zeros for the dead tiles; otherwise the blocks of
// expert i % E write dead tile i as zeros, and a pass's output goes
// through shared memory to 16-byte rows at its tiles' rows. The tensor
// maps are encoded on the host at each launch (a captured graph keeps
// them); N must be a multiple of 4 (the wrappers pad others).
#pragma once

#include "wgmma_common.cuh"

namespace {
namespace qgm {

using namespace qwg;

constexpr int kKC = 128;     // depths per stage
constexpr int kSlab = 16;    // packed rows per stage
constexpr int kBN = 128;     // output channels per block: 2 warpgroups x 64
constexpr int kThreads = 256;

// x [Mp, K] in 128-byte x bm boxes, 128-byte swizzled; qweight [E*K/8, N]
// int32 in 128 x 16 boxes; scales / zeros_x_scales [E*K/G, N] f32 in
// 128 x (128/G); the group sums [K/G, Mp] f32 in bm x 1
struct Maps {
  CUtensorMap x, w, s, z, xs;
};

// the most stages, up to `most` and at least 3, that leave two blocks an SM
// (<= 113 KB each)
constexpr int ring_stages(int stage, int most) {
  return most <= 3 || most * stage + 16 * most + 1024 <= 113 * 1024
             ? most
             : ring_stages(stage, most - 1);
}

template <class B, int PR, int G>
struct Layout {
  static constexpr int kCG = kKC / G;                 // groups per stage
  static constexpr int kX = PR * kKC * B::kXBytes;    // the pass's rows, 128-byte slices
  static constexpr int kW = kSlab * kBN * 4;          // packed words
  static constexpr int kS = kCG * kBN * 4;            // scales; zeros_x_scales follow
  static constexpr int kXs = kCG * PR * 4;            // the rows' group sums, [kCG][PR]
  static constexpr int kStage = (kX + kW + 2 * kS + kXs + 1023) / 1024 * 1024;
  // PR = 64 holds two blocks an SM, PR = 128 one
  static constexpr int kStages = PR == 128 ? 4 : ring_stages(kStage, B::kMaxStages);
  static constexpr int kOutLd = kBN + 8;              // epilogue tile row (bf16)
  static constexpr size_t kBytes = (size_t)kStages * kStage + 16 * kStages + 1024;
  static_assert(PR * kOutLd * 2 <= kStages * kStage, "the epilogue tile fits the ring");
};

// out[tile rows, n0:n0+128] of expert blockIdx.y's live tiles over the
// stages s0 .. s0 + cps - 1 of blockIdx.z (f32 into partial [splits, Mp, N]
// where given, else bf16 into out [Mp, N], times sx[row] under
// B::kRowScale, with the dead tiles i % E == blockIdx.y written as zeros);
// the operands come through `maps`.
template <class B, int PR, int G>
__global__ void __launch_bounds__(kThreads, PR == 64 ? 2 : 1)
grouped_wgmma_kernel(const __grid_constant__ Maps maps, const int* __restrict__ tile_expert,
                     const int* __restrict__ tile_live, int Mp, int K, int N, int bm, int cps,
                     const float* __restrict__ sx, float* __restrict__ partial,
                     bf16* __restrict__ out) {
  using L = Layout<B, PR, G>;
  constexpr int kNR = PR / 2;  // accumulator registers a lane
  constexpr int kCG = L::kCG;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char qgm_smem[];
  __shared__ int tiles_s[PR / 32];  // the pass's tiles
  __shared__ int np_s;              // and how many
  __shared__ float sx_s[B::kRowScale ? PR : 1];  // the pass's row scales
  unsigned char* smem = qgm_smem + ((1024 - (smem_u32(qgm_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + kStages * L::kStage;  // full[s] = full + 8s
  const uint32_t empty = full + 8 * kStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = wgi * 64 + warp * 16 + g;  // the lane's channels c0, c0 + 8
  const int n0 = blockIdx.x * kBN, e = blockIdx.y, E = gridDim.y;
  const int ntiles = Mp / bm, P = PR / bm;
  const int ng = K / G, s0 = blockIdx.z * cps;
  const int nit = min((K + kKC - 1) / kKC, s0 + cps) - s0;

  if (partial == nullptr) {  // dead tiles: zeros (the reduce kernel writes them after a split)
    const int ncol = min(kBN, N - n0);
    for (int i = e; i < ntiles; i += E) {
      if (tile_live[i] != 0) continue;
      for (int idx = tid; idx < bm * ncol; idx += kThreads)
        out[(size_t)(i * bm + idx / ncol) * N + n0 + idx % ncol] = __float2bfloat16_rn(0.f);
    }
  }

  // warp 0: the next up-to-P live tiles of expert e, in tile order
  int cursor = 0;
  auto scan = [&]() {
    if (tid < 32) {
      int found = 0, next = ntiles;
      for (int i0 = cursor; i0 < ntiles && found < P; i0 += 32) {
        const int i = i0 + lane;
        const bool hit = i < ntiles && tile_live[i] != 0 && tile_expert[i] == e;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        const int rank = found + __popc(m & ((1u << lane) - 1u));
        if (hit && rank < P) tiles_s[rank] = i;
        if (hit && rank == P - 1) next = i + 1;
        found += __popc(m);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) next = min(next, __shfl_xor_sync(0xffffffffu, next, o));
      cursor = next;
      if (lane == 0) np_s = min(found, P);
    }
    __syncthreads();
  };
  scan();
  if (np_s == 0) return;  // no live tile of this expert

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int gi = 0;  // stages run by earlier passes: ring slot and phase of stage j are (gi + j)'s
  for (int np = np_s; np > 0; np = np_s) {
    const int nrow = np * bm;
    if constexpr (B::kRowScale)  // read by the epilogue, after its barrier
      for (int r = tid; r < nrow; r += kThreads) sx_s[r] = sx[tiles_s[r / bm] * bm + r % bm];
    // thread 0: stage j of this pass into its ring slot, once the slot's
    // previous stage has been released by both warpgroups
    auto load = [&](int j) {
      const int gj = gi + j, sl = gj % kStages, st = s0 + j;
      if (gj >= kStages) mbar_wait(empty + 8 * sl, ((gj / kStages) - 1) & 1);
      const uint32_t bar = full + 8 * sl;
      const uint32_t xs = sbase + sl * L::kStage;
      const uint32_t xsum = xs + L::kX + L::kW + 2 * L::kS;
      mbar_arrive_expect_tx(bar, np * bm * (kKC * B::kXBytes + kCG * 4) + L::kW + 2 * L::kS);
      for (int p = 0; p < np; ++p) {
        const int row = tiles_s[p] * bm;
        tma_load(xs + p * bm * 128, &maps.x, st * kKC, row, bar);
        if constexpr (B::kXBytes == 2)  // bf16 rows: depths 64 .. 127 in a second slice
          tma_load(xs + PR * 128 + p * bm * 128, &maps.x, st * kKC + 64, row, bar);
#pragma unroll
        for (int c = 0; c < kCG; ++c)
          tma_load(xsum + (c * PR + p * bm) * 4, &maps.xs, row, st * kCG + c, bar);
      }
      tma_load(xs + L::kX, &maps.w, n0, e * (K / 8) + st * kSlab, bar);
      tma_load(xs + L::kX + L::kW, &maps.s, n0, e * ng + st * kCG, bar);
      tma_load(xs + L::kX + L::kW + L::kS, &maps.z, n0, e * ng + st * kCG, bar);
    };
    if (tid == 0)
      for (int j = 0; j < kStages - 1 && j < nit; ++j) load(j);

    float acc[kNR];
    typename B::Dot dot[kNR];
#pragma unroll
    for (int i = 0; i < kNR; ++i) acc[i] = dot[i] = 0;

    for (int it = 0; it < nit; ++it) {
      if (tid == 0 && it + kStages - 1 < nit) load(it + kStages - 1);
      const int gj = gi + it, sl = gj % kStages;
      mbar_wait(full + 8 * sl, (gj / kStages) & 1);
      const unsigned char* sp = smem + sl * L::kStage;
      // groups of this stage that lie inside K (all but in a last part stage)
      const int ngs = kCG == 1 ? 1 : min(kCG, ng - (s0 + it) * kCG);
      B::template stage<PR, G>(acc, dot, sbase + sl * L::kStage, sp, ngs, c0, t, nrow);
      mbar_arrive(empty + 8 * sl);
    }
    gi += nit;

    // accumulator register 4i + e: channel c0 + 8 * (e >= 2), pass row
    // 8i + 2t + (e & 1), which is row r % bm of tile tiles_s[r / bm]
    if (partial != nullptr) {
      float* pz = partial + (size_t)blockIdx.z * Mp * N;
#pragma unroll
      for (int i = 0; i < PR / 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 8 * i + 2 * t + (q & 1), n = n0 + c0 + (q >> 1) * 8;
          if (r < nrow && n < N)
            pz[(size_t)(tiles_s[r / bm] * bm + r % bm) * N + n] = acc[4 * i + q];
        }
    } else {
      __syncthreads();  // every stage of the pass consumed: the ring is free
      bf16* tile = reinterpret_cast<bf16*>(smem);  // [PR][kOutLd]
#pragma unroll
      for (int i = 0; i < PR / 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 8 * i + 2 * t + (q & 1);
          float v = acc[4 * i + q];
          if constexpr (B::kRowScale) v *= r < nrow ? sx_s[r] : 0.f;
          tile[r * L::kOutLd + c0 + (q >> 1) * 8] = __float2bfloat16_rn(v);
        }
      __syncthreads();
      for (int idx = tid; idx < nrow * (kBN / 8); idx += kThreads) {
        const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8, n = n0 + c;
        if (n >= N) continue;
        const bf16* src = tile + r * L::kOutLd + c;
        bf16* dst = out + (size_t)(tiles_s[r / bm] * bm + r % bm) * N + n;
        if ((N & 7) == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int q = 0; q < 8 && n + q < N; ++q) dst[q] = src[q];
        }
      }
      // the next pass's tensor copies write where these generic accesses were
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();  // the pass's tiles are read no more
    scan();
  }
}

// out[m, :] = the split partials of row m summed in split order (times
// sx[m] under kRowScale), as bf16; rows of dead tiles are zeros
template <bool kRowScale>
__global__ void __launch_bounds__(256)
grouped_reduce_kernel(const float* __restrict__ partial, int splits, int Mp, int N, int bm,
                      const int* __restrict__ tile_live, const float* __restrict__ sx,
                      bf16* __restrict__ out) {
  const size_t mn = (size_t)Mp * N;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  if (tile_live[(int)(i / N) / bm] != 0) {
    for (int z = 0; z < splits; ++z) v += partial[(size_t)z * mn + i];
    if constexpr (kRowScale) v *= sx[i / N];
  }
  out[i] = __float2bfloat16_rn(v);
}

// B's first kernel (the rows' group sums into xsumT [K/G, (Mp + 3) & ~3]),
// the PR-row body at group G (grid: column tiles x experts x splits of cps
// stages), then, after a split, the reduce.
template <class B, int PR, int G>
cudaError_t launch_pg(const void* x, const uint32_t* qw, const float* scales, const float* zs,
                      const int* te, const int* live, const float* sx, float* xsumT,
                      float* partial, int Mp, int K, int N, int E, int bm, int splits, int cps,
                      bf16* out, cudaStream_t st) {
  using L = Layout<B, PR, G>;
  const int ng = K / G, ldxs = (Mp + 3) & ~3;
  Maps maps;
  if (!encode(&maps.x, B::kXType, B::kXBytes, x, Mp, K, K, 128 / B::kXBytes, bm,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, qw, E * (K / 8), N, N, kBN, kSlab,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, E * ng, N, N, kBN, L::kCG,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zs, E * ng, N, N, kBN, L::kCG,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&maps.xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xsumT, ng, Mp, ldxs, bm, 1,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(grouped_wgmma_kernel<B, PR, G>, L::kBytes);
  if (err != cudaSuccess) return err;
  if ((err = B::template first<G>(x, Mp, K, ldxs, xsumT, st)) != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, E, splits);
  grouped_wgmma_kernel<B, PR, G><<<grid, kThreads, L::kBytes, st>>>(
      maps, te, live, Mp, K, N, bm, cps, sx, splits > 1 ? partial : nullptr, out);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)Mp * N;
  grouped_reduce_kernel<B::kRowScale><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      partial, splits, Mp, N, bm, live, sx, out);
  return cudaGetLastError();
}

// 128-row passes at bm = 128, 64-row passes at bm = 32 or 64
template <class B, int G>
cudaError_t launch_g(const void* x, const uint32_t* qw, const float* s, const float* zs,
                     const int* te, const int* live, const float* sx, float* xsumT,
                     float* partial, int Mp, int K, int N, int E, int bm, int splits, int cps,
                     bf16* out, cudaStream_t st) {
  if (bm == 128)
    return launch_pg<B, 128, G>(x, qw, s, zs, te, live, sx, xsumT, partial, Mp, K, N, E, bm,
                                splits, cps, out, st);
  return launch_pg<B, 64, G>(x, qw, s, zs, te, live, sx, xsumT, partial, Mp, K, N, E, bm,
                             splits, cps, out, st);
}

// the arguments both entry points check: bm a pass takes, the split plan
// covering K's stages of 128 once
inline bool plan_ok(int Mp, int K, int N, int E, int bm, int G, int splits, int cps) {
  const int nst = (K + kKC - 1) / kKC;
  return Mp > 0 && K > 0 && N > 0 && N % 4 == 0 && E > 0 && E <= 65535 &&
         (bm == 32 || bm == 64 || bm == 128) && Mp % bm == 0 && K % G == 0 && splits > 0 &&
         splits <= 65535 && cps > 0 && (long long)splits * cps >= nst &&
         (long long)(splits - 1) * cps < nst;
}

}  // namespace qgm
}  // namespace
