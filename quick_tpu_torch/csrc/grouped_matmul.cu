// K8: grouped (ragged) W4A16 GEMM for MoE experts over expert-sorted
// bm-row tiles, on Hopper's warpgroup tensor-core instruction.
//
// Replaces the Pallas kernel of quick_tpu/ops/grouped_matmul.py:
//   _make_grouped_kernel (:48), launched from quantized_matmul_grouped
//   (:205, pallas_call :274); at G = 64 and 32, the output-side form of
//   _grouped_fallback (:146-196), which the JAX package runs there.
//
// What it computes: for every bm-row tile i of x [Mp, K] bf16 (rows sorted
// by expert, build_routing), the tile's rows times dequant(qweight[e]) with
// e = tile_expert[i], read on the card, with K1's numerics: per quant group
// of G input channels, the bf16 activations times the integer codes summed
// in f32, then acc += s[g, n] * dot - xsum_g * zeros_x_scales[g, n], xsum_g
// the f32 sum of the group's bf16 activations, the sum over K in f32,
// written as bf16. Every row of a live tile is computed, padding rows
// included; tiles with tile_live[i] == 0 are written as zeros, as the
// Pallas kernel writes them (:84-88). Weights are the per-expert QTPU
// layout: qweight int32 [E, K/8, N], scales and zeros_x_scales f32
// [E, K/G, N].
//
// What bounds it on the H100: at decode the bytes of the distinct experts
// the routing touches (K*N/2 of codes plus 8*(K/G)*N of f32 scales each)
// against 3.35 TB/s; at prefill the routed multiply-adds (2 * T * topk * K
// * N) against the bf16 tensor-core rate.
//
// Design: K1's body (qmm_wgmma.cuh) with the expert as a grid dimension.
// A block is one (128-channel column tile, expert, K slice). It finds its
// expert's live tiles itself, by a warp's ballot scan of tile_expert and
// tile_live (the host never reads them), and takes them in passes of up to
// PR rows (PR = 64 for bm = 32 or 64, 128 for bm = 128): a pass streams the
// expert's words, scales and zeros_x_scales once, through a ring of stages
// (128 depths each) brought by the Tensor Memory Accelerator on full /
// empty mbarriers, together with the pass's tiles' activation rows (one
// tensor copy per tile and 64-wide half, at the tile's row read on the
// card) and their group sums. So an expert's weights are read once per
// column tile and pass, not once per token tile: at decode, where each
// routed (token, expert) pair owns a 32-row tile, an expert chosen by two
// tokens is streamed once. Blocks of an expert with no live tile exit at
// once. The product runs transposed, out^T = W^T x^T, on wgmma.mma_async
// m64nWk16 with A, the 64 channels x 16 depths of codes, built by each lane
// straight from the QTPU words in registers (K1's prmt / mask / bf16x2
// subtraction at G = 128; K9's fragment map at G = 64 and 32), and B the
// pass's rows in shared memory; W, the instruction's token width, follows
// the live rows of the pass (32 or 64 at PR = 64). Each group's dot has its
// own f32 accumulator (its k16 steps, the first with scale-d = 0), folded
// into the output accumulator group by group in order. A last stage past K
// (K need only be a multiple of G) skips its missing groups. The group
// sums come from a first kernel, once per row and group. Where the column
// tiles times the experts cannot fill the card, K is split over blocks
// (the wrapper's plan, from the shapes alone) into f32 partials that a
// last kernel sums in split order, writing zeros for the dead tiles;
// otherwise the blocks of expert i % E write dead tile i as zeros, and a
// pass's output goes through shared memory to 16-byte rows at its tiles'
// rows. The tensor maps are encoded on the host at each launch (a captured
// graph keeps them); N must be a multiple of 4 (the wrapper pads others).
//
// Not carried over from the TPU: the VMEM-sized (bn, gpb) tile pickers,
// the scalar-prefetched BlockSpec index maps.
#include "wgmma_common.cuh"

namespace {
namespace qgm {

using namespace qwg;

constexpr int kKC = 128;     // depths per stage
constexpr int kSlab = 16;    // packed rows per stage
constexpr int kBN = 128;     // output channels per block: 2 warpgroups x 64
constexpr int kThreads = 256;

// x [Mp, K] bf16 in 64 x bm boxes, 128-byte swizzled; qweight [E*K/8, N]
// int32 in 128 x 16 boxes; scales / zeros_x_scales [E*K/G, N] f32 in
// 128 x (128/G); the group sums [K/G, Mp] f32 in bm x 1
struct Maps {
  CUtensorMap x, w, s, z, xs;
};

template <int PR, int G>
struct Layout {
  static constexpr int kCG = kKC / G;         // groups per stage
  static constexpr int kX = PR * kKC * 2;     // the pass's rows: two 64-wide halves
  static constexpr int kW = kSlab * kBN * 4;  // packed words
  static constexpr int kS = kCG * kBN * 4;    // scales; zeros_x_scales follow
  static constexpr int kXs = kCG * PR * 4;    // the rows' group sums, [kCG][PR]
  static constexpr int kStage = (kX + kW + 2 * kS + kXs + 1023) / 1024 * 1024;
  // PR = 64 holds two blocks an SM (<= 113 KB each), PR = 128 one
  static constexpr int kStages = PR == 128 || 4 * kStage + 1088 <= 113 * 1024 ? 4 : 3;
  static constexpr int kOutLd = kBN + 8;      // epilogue tile row (bf16)
  static constexpr size_t kBytes = (size_t)kStages * kStage + 16 * kStages + 1024;
  static_assert(PR * kOutLd * 2 <= kStages * kStage, "the epilogue tile fits the ring");
};

// xsumT[g, m] = f32 sum of x[m, g*G .. g*G + G - 1] (bf16): one warp a row
// and 128 channels, lanes 4 channels each, a fixed shuffle tree over the
// G / 4 lanes of a group
template <int G>
__global__ void __launch_bounds__(256)
grouped_xsum_kernel(const bf16* __restrict__ x, int M, int K, int ldxs,
                    float* __restrict__ xsumT) {
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int nch = (K + kKC - 1) / kKC;
  if (w >= M * nch) return;
  const int m = w / nch, k = (w % nch) * kKC + lane * 4;
  float sum = 0.f;
  if (k < K) {
    const uint2 v = *reinterpret_cast<const uint2*>(x + (size_t)m * K + k);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    sum = (a.x + a.y) + (b.x + b.y);
  }
#pragma unroll
  for (int o = G / 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane % (G / 4) == 0 && k < K) xsumT[(size_t)(k / G) * ldxs + m] = sum;
}

// The lane's A fragments of one stage (8 k16 steps, 16 packed rows of words
// wsm [16][kBN]) for channels c0 (registers 0, 2) and c0 + 8 (1, 3),
// depths 2t, 2t+1 (registers 0, 1) and 2t+8, 2t+9 (2, 3) of each step.
// Code k = g*G + j*(G/8) + r sits in nibble j of word [g*G/8 + r, n]:
//   G = 128: words 2t, 2t+1, 2t+8, 2t+9; step j is nibble j;
//   G = 64: words q*8 + 2t, +1 of group q; step q*4 + s is nibbles 2s
//     (depths 2t..) and 2s + 1 (2t + 8..);
//   G = 32: words q*4 + 2(t%2), +1, shifted right by 4(t/2); step q*2 + s
//     is nibbles 4s and 4s + 2 of the shifted words.
template <int G>
__device__ __forceinline__ void a_fragments(const uint32_t* wsm, int c0, int t,
                                            uint32_t (&a)[8][4]) {
  if constexpr (G == 128) {
    uint32_t w[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * t + (i & 1) + (i >> 1) * 8;
      w[i][0] = wsm[r * kBN + c0];
      w[i][1] = wsm[r * kBN + c0 + 8];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j][0] = code_pair(w[0][0], w[1][0], j);
      a[j][1] = code_pair(w[0][1], w[1][1], j);
      a[j][2] = code_pair(w[2][0], w[3][0], j);
      a[j][3] = code_pair(w[2][1], w[3][1], j);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kKC / G; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = c0 + 8 * h;
        if constexpr (G == 64) {
          const uint32_t lo = wsm[(q * 8 + 2 * t) * kBN + ch];
          const uint32_t hi = wsm[(q * 8 + 2 * t + 1) * kBN + ch];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            a[q * 4 + s][h] = code_pair(lo, hi, 2 * s);
            a[q * 4 + s][2 + h] = code_pair(lo, hi, 2 * s + 1);
          }
        } else {
          const int sh = 4 * (t >> 1);
          const uint32_t lo = wsm[(q * 4 + 2 * (t & 1)) * kBN + ch] >> sh;
          const uint32_t hi = wsm[(q * 4 + 2 * (t & 1) + 1) * kBN + ch] >> sh;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            a[q * 2 + s][h] = code_pair(lo, hi, 4 * s);
            a[q * 2 + s][2 + h] = code_pair(lo, hi, 4 * s + 2);
          }
        }
      }
  }
}

// group c's k16 steps on the first W tokens of the pass: dot = A * B
template <int W, int PR, int G, int NR>
__device__ __forceinline__ void mma_group(float (&dot)[NR], const uint32_t (&a)[8][4],
                                          uint32_t xb, int c) {
  constexpr int kSteps = G / 16;
  float (&d)[W / 2] = *reinterpret_cast<float (*)[W / 2]>(&dot[0]);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int j = c * kSteps + s;
    Wgmma<W>::mma(d, a[j], desc_b(xb + (j >> 2) * (PR * 128) + (j & 3) * 32), s > 0);
  }
}

// out[tile rows, n0:n0+128] of expert blockIdx.y's live tiles over the
// stages s0 .. s0 + cps - 1 of blockIdx.z (f32 into partial [splits, Mp, N]
// where given, else bf16 into out [Mp, N], with the dead tiles i % E ==
// blockIdx.y written as zeros); the operands come through `maps`.
template <int PR, int G>
__global__ void __launch_bounds__(kThreads, PR == 64 ? 2 : 1)
grouped_wgmma_kernel(const __grid_constant__ Maps maps, const int* __restrict__ tile_expert,
                     const int* __restrict__ tile_live, int Mp, int K, int N, int bm, int cps,
                     float* __restrict__ partial, bf16* __restrict__ out) {
  using L = Layout<PR, G>;
  constexpr int kNR = PR / 2;  // accumulator registers a lane
  constexpr int kCG = L::kCG;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char qgm_smem[];
  __shared__ int tiles_s[PR / 32];  // the pass's tiles
  __shared__ int np_s;              // and how many
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
    // thread 0: stage j of this pass into its ring slot, once the slot's
    // previous stage has been released by both warpgroups
    auto load = [&](int j) {
      const int gj = gi + j, sl = gj % kStages, st = s0 + j;
      if (gj >= kStages) mbar_wait(empty + 8 * sl, ((gj / kStages) - 1) & 1);
      const uint32_t bar = full + 8 * sl;
      const uint32_t xs = sbase + sl * L::kStage;
      const uint32_t xsum = xs + L::kX + L::kW + 2 * L::kS;
      mbar_arrive_expect_tx(bar, np * bm * (kKC * 2 + kCG * 4) + L::kW + 2 * L::kS);
      for (int p = 0; p < np; ++p) {
        const int row = tiles_s[p] * bm;
        tma_load(xs + p * bm * 128, &maps.x, st * kKC, row, bar);
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

    float acc[kNR], dot[kNR];
#pragma unroll
    for (int i = 0; i < kNR; ++i) acc[i] = dot[i] = 0.f;

    for (int it = 0; it < nit; ++it) {
      if (tid == 0 && it + kStages - 1 < nit) load(it + kStages - 1);
      const int gj = gi + it, sl = gj % kStages;
      mbar_wait(full + 8 * sl, (gj / kStages) & 1);
      const unsigned char* sp = smem + sl * L::kStage;
      uint32_t a[8][4];
      a_fragments<G>(reinterpret_cast<const uint32_t*>(sp + L::kX), c0, t, a);
      // groups of this stage that lie inside K (all but in a last part stage)
      const int ngs = kCG == 1 ? 1 : min(kCG, ng - (s0 + it) * kCG);
      const uint32_t xb = sbase + sl * L::kStage;
      const float* ssm = reinterpret_cast<const float*>(sp + L::kX + L::kW);
#pragma unroll
      for (int c = 0; c < kCG; ++c) {
        if (kCG > 1 && c >= ngs) break;
        hold(dot);
        wgmma_fence();
        if (PR == 64 && nrow <= 32) {
          mma_group<32, PR, G>(dot, a, xb, c);
        } else {
          mma_group<PR, PR, G>(dot, a, xb, c);
        }
        wgmma_commit();
        wgmma_wait0();
        hold(dot);
        hold(a);
        const float s0c = ssm[c * kBN + c0], s1c = ssm[c * kBN + c0 + 8];
        const float z0 = -ssm[(kCG + c) * kBN + c0], z1 = -ssm[(kCG + c) * kBN + c0 + 8];
        const float* xsm = ssm + 2 * kCG * kBN + c * PR;
#pragma unroll
        for (int i = 0; i < PR / 8; ++i) {
          if (8 * i >= nrow) break;
          const float2 xv = *reinterpret_cast<const float2*>(xsm + 8 * i + 2 * t);
          acc[4 * i + 0] = fmaf(xv.x, z0, fmaf(dot[4 * i + 0], s0c, acc[4 * i + 0]));
          acc[4 * i + 1] = fmaf(xv.y, z0, fmaf(dot[4 * i + 1], s0c, acc[4 * i + 1]));
          acc[4 * i + 2] = fmaf(xv.x, z1, fmaf(dot[4 * i + 2], s1c, acc[4 * i + 2]));
          acc[4 * i + 3] = fmaf(xv.y, z1, fmaf(dot[4 * i + 3], s1c, acc[4 * i + 3]));
        }
      }
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
        for (int q = 0; q < 4; ++q)
          tile[(8 * i + 2 * t + (q & 1)) * L::kOutLd + c0 + (q >> 1) * 8] =
              __float2bfloat16_rn(acc[4 * i + q]);
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

// out[m, :] = the split partials of row m summed in split order, as bf16;
// rows of dead tiles are zeros
__global__ void __launch_bounds__(256)
grouped_reduce_kernel(const float* __restrict__ partial, int splits, int Mp, int N, int bm,
                      const int* __restrict__ tile_live, bf16* __restrict__ out) {
  const size_t mn = (size_t)Mp * N;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  if (tile_live[(int)(i / N) / bm] != 0)
    for (int z = 0; z < splits; ++z) v += partial[(size_t)z * mn + i];
  out[i] = __float2bfloat16_rn(v);
}

// The group-sum kernel, the PR-row body at group G (grid: column tiles x
// experts x splits of cps stages), then, after a split, the reduce.
template <int PR, int G>
cudaError_t launch_pg(const bf16* x, const uint32_t* qw, const float* scales, const float* zs,
                      const int* te, const int* live, float* xsumT, float* partial, int Mp,
                      int K, int N, int E, int bm, int splits, int cps, bf16* out,
                      cudaStream_t st) {
  using L = Layout<PR, G>;
  const int ng = K / G, ldxs = (Mp + 3) & ~3;
  Maps maps;
  if (!encode(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, Mp, K, K, 64, bm,
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
  cudaError_t err = allow_smem(grouped_wgmma_kernel<PR, G>, L::kBytes);
  if (err != cudaSuccess) return err;
  const int nch = (K + kKC - 1) / kKC;
  grouped_xsum_kernel<G><<<(Mp * nch + 7) / 8, 256, 0, st>>>(x, Mp, K, ldxs, xsumT);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, E, splits);
  grouped_wgmma_kernel<PR, G><<<grid, kThreads, L::kBytes, st>>>(
      maps, te, live, Mp, K, N, bm, cps, splits > 1 ? partial : nullptr, out);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)Mp * N;
  grouped_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(partial, splits, Mp, N,
                                                                      bm, live, out);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_g(const bf16* x, const uint32_t* qw, const float* s, const float* zs,
                     const int* te, const int* live, float* xsumT, float* partial, int Mp,
                     int K, int N, int E, int bm, int splits, int cps, bf16* out,
                     cudaStream_t st) {
  if (bm == 128)
    return launch_pg<128, G>(x, qw, s, zs, te, live, xsumT, partial, Mp, K, N, E, bm, splits,
                             cps, out, st);
  return launch_pg<64, G>(x, qw, s, zs, te, live, xsumT, partial, Mp, K, N, E, bm, splits, cps,
                          out, st);
}

}  // namespace qgm
}  // namespace

// x: [Mp, K] bf16, 16-byte aligned, rows sorted by expert in bm-row tiles;
// qweight: int32 [E, K/8, N]; scales, zeros_x_scales: f32 [E, K/G, N] (all
// 16-byte aligned); tile_expert, tile_live: int32 [Mp/bm] (device); xsum:
// f32 [K/G, (Mp + 3) & ~3] scratch, 16-byte aligned; partial: f32 [splits,
// Mp, N] scratch (splits > 1 only); out: [Mp, N] bf16. G = 128, 64 or 32;
// bm = 32, 64 or 128; Mp % bm == 0, K % G == 0, N % 4 == 0; K is cut into
// splits slices of cps stages of 128 (the wrapper's plan).
extern "C" int qtt_grouped_matmul(const void* x, const void* qweight, const void* scales,
                                  const void* zeros_x_scales, const void* tile_expert,
                                  const void* tile_live, void* xsum, void* partial, int Mp,
                                  int K, int N, int E, int bm, int G, int splits, int cps,
                                  void* out, void* stream) {
  using namespace qgm;
  const int nst = (K + kKC - 1) / kKC;
  if (Mp <= 0 || K <= 0 || N <= 0 || N % 4 != 0 || E <= 0 || E > 65535 ||
      (bm != 32 && bm != 64 && bm != 128) || Mp % bm != 0 ||
      (G != 128 && G != 64 && G != 32) || K % G != 0 || splits <= 0 || splits > 65535 ||
      cps <= 0 || (long long)splits * cps < nst || (long long)(splits - 1) * cps >= nst ||
      xsum == nullptr || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto qw = static_cast<const uint32_t*>(qweight);
  auto s = static_cast<const float*>(scales);
  auto zs = static_cast<const float*>(zeros_x_scales);
  auto te = static_cast<const int*>(tile_expert);
  auto live = static_cast<const int*>(tile_live);
  auto xs = static_cast<float*>(xsum);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<bf16*>(out);
  switch (G) {
    case 128: return launch_g<128>(xb, qw, s, zs, te, live, xs, part, Mp, K, N, E, bm, splits, cps, o, st);
    case 64: return launch_g<64>(xb, qw, s, zs, te, live, xs, part, Mp, K, N, E, bm, splits, cps, o, st);
    default: return launch_g<32>(xb, qw, s, zs, te, live, xs, part, Mp, K, N, E, bm, splits, cps, o, st);
  }
}
