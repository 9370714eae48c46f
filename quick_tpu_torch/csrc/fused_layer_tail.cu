// K14: the decode layer tail — o-proj GEMM, residual add, MLP RMSNorm,
// gate_up GEMM, SiLU * up, down GEMM and the second residual add of a
// llama-family layer, for M <= 8 rows, in one launch.
//
// Replaces the Pallas kernel quick_tpu/ops/fused_layer_tail.py::
// _make_tail_kernel (:70), launched by fused_layer_tail (:198).
//
// What it computes, with the Pallas kernel's cast points (:125-192):
//   h  = bf16(bf16(attn_out @ W_o) + x_resid)
//   xn = bf16(h * rsqrt(mean(h^2) + eps) * bf16(norm_w))   (f32 math)
//   gu = bf16(xn @ W_gu)                                     [M, 2I]
//   x2 = bf16(g * sigmoid(g) * u)                            (f32 math)
//   y  = bf16(bf16(x2 @ W_dn) + h)
// each GEMM over G = 128 QTPU-packed int4 codes with K1's numerics: per
// group, the bf16 activations times the codes summed in f32, scaled on the
// output side, minus xsum_g * zeros_x_scales.
//
// What bounds it on the H100: the packed weights of the three GEMMs (codes
// K*N/2 bytes, f32 scales and zero terms K*N/16 bytes each), read once:
// 108.5 MB at Mistral-7B width, 32.4 us at 3.35 TB/s. Rows are at most 8,
// so the operations are negligible.
//
// Design. The phases depend on each other across the whole row (the norm
// needs every column of h, the down GEMM every column of gu), so one launch
// runs them with grid-wide barriers: a persistent grid of blocks that are
// all resident at once (the wrapper sizes it from the SM count; the
// launcher checks it against the occupancy the card reports) and a
// software barrier on a global counter (arrivals plus a generation word,
// left at zero arrivals after every barrier, so no reset between launches).
// A plain launch, unlike a cooperative one, is captured into CUDA graphs
// with the rest of the decode step.
// Each GEMM phase is a list of (128-column tile, K split) items taken
// round-robin by the blocks; an item runs the CUDA-core decode body
// (qmm_decode.cuh: the o projection plain, gate_up with K1's RMSNorm
// prologue over h, down with K1's SiLU-GLU prologue over gu) and writes its
// f32 partial. The block that completes a tile (a per-tile arrival counter,
// reset by that block) sums the tile's partials in split order, so the
// rounding never depends on timing, and applies the phase's epilogue: h
// with the row's sum of squares over the tile (o), gu (gate_up) or y
// (down). So the phases need two barriers: before gate_up (the norm reads
// every tile's sum of squares; each block then computes the row RMS) and
// before down. h, gu and the partials (at most ~2 MB each at 8 rows) stay
// in L2; values written inside the launch are read through L2 (__ldcg,
// never the non-coherent path: qmm_decode.cuh's load_act).
//
// Not carried over from the TPU: the flat clamped-index grid whose weight
// blocks stay resident across phase boundaries (_tail_tiles :47, its VMEM
// budget :214-217) — Mosaic's block pipelining, which the card does not
// have — and the 8-row padding. cp.async prefetch of the next phase's
// weights across a barrier, and TMA, are later work.
#include "qmm_decode.cuh"

namespace {

constexpr int kMaxRows = 8;
constexpr unsigned long long kBarrierTimeoutNs = 2000000000ull;

enum Epilogue { kEpiResid = 0, kEpiStore = 1, kEpiOut = 2 };

struct Gemm {
  const uint32_t* qw;  // [K/8, N]
  const float* s;      // [K/128, N]
  const float* zs;
  int K, N, splits, gps;
  float* part;     // [splits, M, N] f32
  unsigned* cnt;   // [N/128] tile arrivals, zero between launches
};

struct TailArgs {
  const bf16* ao;    // [M, K1] pre-o attention output
  const bf16* xres;  // [M, D]
  const bf16* nw;    // [D] bf16
  Gemm o, gu, dn;
  int M, D;
  float eps;
  bf16* h;        // [M, D] scratch
  bf16* gub;      // [M, 2I] scratch
  float* ssq;     // [D/128, 8] per-tile row sums of h^2
  unsigned* bar;  // [2]: arrivals, generation
  bf16* out;      // [M, D]
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block of the grid arrives before any leaves. All blocks must be
// resident (the launcher checks the grid against the occupancy); a wait
// past kBarrierTimeoutNs traps rather than hang the card.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t0 = global_ns();
      while (*gen == g) {
        __nanosleep(64);
        if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

template <int ROWS, int PRO, int EPI>
__device__ __forceinline__ void tail_phase(
    const TailArgs& a, const Gemm& w, const bf16* x, int ldx,
    const float* rstd, float (*red2)[kMaxRows], int* last) {
  const int M = a.M;
  const int tiles = (w.N + kBN - 1) / kBN;
  const int items = tiles * w.splits;
  const int ng = w.K / kG;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % tiles, sp = it / tiles;
    const int n = tile * kBN + t;
    const bool col_ok = n < w.N;
    const int g0 = sp * w.gps;
    const int g1 = min(ng, g0 + w.gps);
    float acc[ROWS];
    // x is h or gu, written by other blocks in this launch, from the
    // second phase on: read through L2
    qmm_decode_groups<ROWS, PRO, PRO != kNone>(x, ldx, w.qw, w.s, w.zs, a.nw,
                                               rstd, M, w.K, w.N, t, lane, warp,
                                               n, col_ok, 0, g0, g1, acc);
    if (col_ok) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        if (i < M) w.part[((size_t)sp * M + i) * w.N + n] = acc[i];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      *last = atomicAdd(w.cnt + tile, 1u) == (unsigned)(w.splits - 1);
    __syncthreads();
    if (*last) {
      __threadfence();
      // the tile's splits in a fixed order
      float v[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float s = 0.f;
        if (col_ok && i < M)
          for (int z = 0; z < w.splits; ++z)
            s += __ldcg(w.part + ((size_t)z * M + i) * w.N + n);
        v[i] = s;
      }
      if (EPI == kEpiResid) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          float hv = 0.f;
          if (col_ok && i < M) {
            hv = round_bf16(round_bf16(v[i]) + bf2f(a.xres[(size_t)i * a.D + n]));
            a.h[(size_t)i * a.D + n] = __float2bfloat16_rn(hv);
          }
          const float p = warp_sum(hv * hv);
          if (lane == 0) red2[warp][i] = p;
        }
        __syncthreads();
        if (threadIdx.x < M) {
          float tot = 0.f;
#pragma unroll
          for (int q = 0; q < kBN / 32; ++q) tot += red2[q][threadIdx.x];
          a.ssq[tile * kMaxRows + threadIdx.x] = tot;
        }
      } else if (EPI == kEpiStore) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          if (col_ok && i < M) a.gub[(size_t)i * w.N + n] = __float2bfloat16_rn(v[i]);
      } else {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          if (col_ok && i < M) {
            const size_t o = (size_t)i * a.D + n;
            a.out[o] = __float2bfloat16_rn(round_bf16(v[i]) + bf2f(__ldcg(a.h + o)));
          }
      }
      if (threadIdx.x == 0) w.cnt[tile] = 0u;  // ready for the next launch
    }
    __syncthreads();  // *last and red2 are reused by the next item
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kBN) tail_kernel(const TailArgs a) {
  __shared__ float red2[kBN / 32][kMaxRows];
  __shared__ float rstd[kMaxRows];
  __shared__ int last;

  tail_phase<ROWS, kNone, kEpiResid>(a, a.o, a.ao, a.o.K, nullptr, red2, &last);
  grid_barrier(a.bar);
  if (threadIdx.x < a.M) {
    float tot = 0.f;
    for (int t = 0; t < a.D / kBN; ++t) tot += __ldcg(a.ssq + t * kMaxRows + threadIdx.x);
    rstd[threadIdx.x] = rsqrtf(tot / (float)a.D + a.eps);
  }
  __syncthreads();
  tail_phase<ROWS, kRmsNorm, kEpiStore>(a, a.gu, a.h, a.D, rstd, red2, &last);
  grid_barrier(a.bar);
  tail_phase<ROWS, kSiluGlu, kEpiOut>(a, a.dn, a.gub, a.gu.N, nullptr, red2, &last);
}

template <int ROWS>
cudaError_t launch_tail(const TailArgs& a, int grid, cudaStream_t st) {
  static int max_grid = 0;  // resident blocks of this instantiation
  if (max_grid == 0) {
    int dev = 0, sms = 0, occ = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, tail_kernel<ROWS>, kBN, 0);
    if (err != cudaSuccess) return err;
    max_grid = occ * sms;
  }
  if (grid <= 0 || grid > max_grid) return cudaErrorCooperativeLaunchTooLarge;
  tail_kernel<ROWS><<<grid, kBN, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// attn_out: [M, K1] bf16; x_resid, out: [M, D] bf16; norm_w: [D] bf16;
// o_*: the o projection (qweight int32 [K1/8, D], scales and zeros_x_scales
// f32 [K1/128, D]); gu_*: gate_up ([D/8, 2I], [D/128, 2I]); dn_*: down
// ([I/8, D], [I/128, D]). rows (1, 2, 4, 8) >= M; (splits, groups per split)
// of each GEMM and grid come from the wrapper's plan; part_*: f32 [splits,
// M, N] scratch; h: bf16 [M, D], gu: bf16 [M, 2I], ssq: f32 [D/128, 8]
// scratch; sync: uint32 [2 + D/128 + 2I/128 + D/128], zero before the first
// launch and left zero by every launch.
extern "C" int qtt_fused_layer_tail(
    const void* attn_out, const void* x_resid, const void* norm_w,
    const void* o_qw, const void* o_s, const void* o_zs,
    const void* gu_qw, const void* gu_s, const void* gu_zs,
    const void* dn_qw, const void* dn_s, const void* dn_zs, float eps, int M,
    int K1, int D, int I, int rows, int o_splits, int o_gps, int gu_splits,
    int gu_gps, int dn_splits, int dn_gps, int grid, void* part_o,
    void* part_gu, void* part_dn, void* h, void* gu, void* ssq, void* sync,
    void* out, void* stream) {
  if (M <= 0 || M > rows || rows > kMaxRows || K1 % kG || D % kG || I % kG)
    return cudaErrorInvalidValue;
  unsigned* s = static_cast<unsigned*>(sync);
  TailArgs a;
  a.ao = static_cast<const bf16*>(attn_out);
  a.xres = static_cast<const bf16*>(x_resid);
  a.nw = static_cast<const bf16*>(norm_w);
  a.o = Gemm{static_cast<const uint32_t*>(o_qw), static_cast<const float*>(o_s),
             static_cast<const float*>(o_zs), K1, D, o_splits, o_gps,
             static_cast<float*>(part_o), s + 2};
  a.gu = Gemm{static_cast<const uint32_t*>(gu_qw), static_cast<const float*>(gu_s),
              static_cast<const float*>(gu_zs), D, 2 * I, gu_splits, gu_gps,
              static_cast<float*>(part_gu), s + 2 + D / kBN};
  a.dn = Gemm{static_cast<const uint32_t*>(dn_qw), static_cast<const float*>(dn_s),
              static_cast<const float*>(dn_zs), I, D, dn_splits, dn_gps,
              static_cast<float*>(part_dn), s + 2 + D / kBN + 2 * I / kBN};
  const Gemm* gemms[3] = {&a.o, &a.gu, &a.dn};
  for (const Gemm* g : gemms)
    if (g->splits <= 0 || g->gps <= 0 || (g->splits - 1) * g->gps >= g->K / kG)
      return cudaErrorInvalidValue;
  a.M = M;
  a.D = D;
  a.eps = eps;
  a.h = static_cast<bf16*>(h);
  a.gub = static_cast<bf16*>(gu);
  a.ssq = static_cast<float*>(ssq);
  a.bar = s;
  a.out = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch_tail<1>(a, grid, st);
    case 2: return launch_tail<2>(a, grid, st);
    case 4: return launch_tail<4>(a, grid, st);
    case 8: return launch_tail<8>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}
