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
// all resident at once (the wrapper sizes it from the resident count this
// library reports, qtt_fused_layer_tail_resident, and the launcher refuses
// more) and a software barrier on a global counter (arrivals plus a
// generation word, left at zero arrivals after every barrier, so no reset
// between launches). A plain launch, unlike a cooperative one, is captured
// into CUDA graphs with the rest of the decode step.
// Each GEMM is a list of (128-column tile, K split) items taken round-robin
// by the blocks (the wrapper's plan charges an item a few stages of fixed
// cost, so it splits a GEMM only where that shortens the busiest block's
// stream). An item runs K1's 8-token decode body (qmm_decode_rows.cuh:
// the o projection plain, gate_up with the RMSNorm prologue over h, down
// with the SiLU-GLU prologue over gu; m64n8k16 wgmma, rows past M staged as
// zeros). A block streams the weights of its whole work list (its o items,
// then its gate_up items, then its down items) through one 8-stage TMA
// ring: thread 0 walks that list (a table of the block's items in shared
// memory, made once) and counts the stages over it, so that the ring slot
// and the mbarrier phase come from the running count, and it keeps issuing
// the next item's and the next GEMM's stages while the current item's MMAs
// run, and before the block arrives at each grid barrier (the weights do
// not depend on h or gu; only the staging of the B tile waits for the
// barrier). The first stages of o's weights go out before the launch waits
// for the kernel before it (a programmatic dependent launch): the weights
// must not be written by that kernel; attn_out and x_resid are read after
// griddepcontrol.wait. K14 never triggers its own dependents early: one
// started before its last barrier could hold the shared memory of its own
// unscheduled blocks and wait on K14 forever.
// The block that completes a tile (one acq_rel atomic on a per-tile
// arrival counter, which that block resets) sums the tile's split partials
// in split order from L2, four splits' loads in flight at once (the ring is
// not free: it holds the next stages' weights), so the rounding never
// depends on timing, and applies the GEMM's epilogue: h with the
// rows' sums of squares over the tile (o), gu (gate_up) or y (down). An
// unsplit item's block keeps its sums in shared memory. So the phases need
// two barriers: before gate_up (the norm reads every tile's sum of squares;
// each block then computes the rows' rstd) and before down. h, gu and the
// partials (at most ~7 MB at 8 rows) stay in L2; values written inside the
// launch are read through L2 (__ldcg, never the non-coherent path).
//
// Not carried over from the TPU: the flat clamped-index grid whose weight
// blocks stay resident across phase boundaries (_tail_tiles :47, its VMEM
// budget :214-217) — here the stream runs on through the barriers instead —
// and the 8-row padding.
#include "qmm_decode_rows.cuh"

namespace {

using qwk::kBN;
using qwk::kG;
using qwk::kStages;
using qwk::kThreads;
using qwk::Layout;

constexpr int kMaxRows = 8;
constexpr int kPhases = 3;  // o, gate_up, down
// the producer runs at most kAhead GEMMs past the one the block consumes:
// 2 streams the whole work list through the barriers (0 would drain the
// ring at each barrier)
constexpr int kAhead = 2;
constexpr size_t kSmemBytes = Layout::kBytes;
constexpr unsigned long long kBarrierTimeoutNs = 2000000000ull;

enum Epilogue { kEpiResid = 0, kEpiStore = 1, kEpiOut = 2 };

struct Gemm {
  int K, N, tiles, splits, gps;
  float* part;    // [splits, M, N] f32 (splits > 1)
  unsigned* cnt;  // [tiles] arrivals, zero between launches
};

struct TailArgs {
  qwk::Maps maps[kPhases];
  Gemm w[kPhases];
  const bf16* ao;    // [M, K1] pre-o attention output
  const bf16* xres;  // [M, D]
  const bf16* nw;    // [D] bf16
  int M, D;
  float eps;
  bf16* h;        // [M, D] scratch
  bf16* gub;      // [M, 2I] scratch
  float* ssq;     // [D/128, 8] per-tile row sums of h^2
  unsigned* bar;  // [2]: arrivals, generation
  bf16* out;      // [M, D]
};

constexpr int kMaxItems = 32;  // a block's items over the three GEMMs

// one item of the block's work list: its GEMM, first column, first group
// and groups
struct Item {
  int phase, n0, g0, nit;
};

// thread 0's cursor over the block's stream (kept in shared memory, so the
// body's registers do not carry it): the item, the stage in that item, the
// stages issued so far, the block's items
struct Producer {
  int k, j, issued, items;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block of the grid arrives before any leaves. All blocks must be
// resident (the launcher checks the grid against the occupancy); a wait
// past kBarrierTimeoutNs traps rather than hang the card. The block
// barrier orders every thread's stores before thread 0's release (the
// arrival); its acquire (the generation's change) orders them before every
// thread's loads after the second block barrier.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned g, prev;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(g) : "l"(bar + 1) : "memory");
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(bar) : "memory");
    if (prev == gridDim.x - 1) {
      // the last to arrive: every other block has arrived (and read g)
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(bar), "r"(0u) : "memory");
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar + 1) : "memory");
    } else {
      const unsigned long long t0 = global_ns();
      unsigned now = g;
      while (now == g) {
        __nanosleep(32);
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(now) : "l"(bar + 1) : "memory");
        if (now == g && global_ns() - t0 > kBarrierTimeoutNs) __trap();
      }
    }
  }
  __syncthreads();
}

// thread 0, once: the block's work list in stream order (items b, b +
// grid, ... of each GEMM; item it is tile it % tiles, split it / tiles);
// false when it holds more than kMaxItems
__device__ __forceinline__ bool list_items(const TailArgs& a, Item* items, Producer& p) {
  int n = 0;
  for (int q = 0; q < kPhases; ++q) {
    const Gemm& w = a.w[q];
    for (int it = blockIdx.x; it < w.tiles * w.splits; it += gridDim.x) {
      if (n == kMaxItems) return false;
      const int g0 = it / w.tiles * w.gps;
      items[n++] = Item{q, it % w.tiles * kBN, g0, min(w.K / kG, g0 + w.gps) - g0};
    }
  }
  p = Producer{0, 0, 0, n};
  return true;
}

// thread 0: issue the block's stages up to number `target` of its running
// count, none of a GEMM past `limit`. A stage's slot was released when
// stage - kStages was consumed: callers never target further ahead.
__device__ __forceinline__ void produce(const TailArgs& a, const Item* items, Producer& p,
                                        uint32_t sbase, int target, int limit) {
  while (p.issued <= target && p.k < p.items) {
    const Item it = items[p.k];
    if (it.phase > limit) break;
    qwk::load_stage(a.maps[it.phase], sbase, p.issued, it.n0, it.g0 + p.j);
    ++p.issued;
    if (++p.j == it.nit) {
      p.j = 0;
      ++p.k;
    }
  }
}

// GEMM p's items of this block: the decode body on stages base .. of the
// block's stream, then the tile's merge and epilogue
template <int PRO, int EPI>
__device__ __forceinline__ void tail_phase(const TailArgs& a, int p, const bf16* x, int ldx,
                                           const float* rstd, unsigned char* smem,
                                           const Item* items, Producer& prod, int& k, int& base,
                                           float* stile, float (*red)[4], int& last) {
  const Gemm& w = a.w[p];
  const int M = a.M, N = w.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int c0 = (tid >> 7) * 64 + (warp & 3) * 16 + (lane >> 2);
  const uint32_t sbase = qwg::smem_u32(smem);
  // this GEMM's first stages, where the stream was held at the barrier
  // (issued already unless kAhead is 0)
  if (tid == 0) produce(a, items, prod, sbase, base + kStages - 2, p + kAhead);
  for (; k < prod.items && items[k].phase == p; ++k) {
    const Item item = items[k];
    const int n0 = item.n0, tile = n0 / kBN, sp = item.g0 / w.gps, b0 = base;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    // h and gu were written by other blocks of this launch: read through L2
    qwk::decode_rows<PRO, PRO != kNone>(smem, x, ldx, a.nw, rstd, M, w.K, item.g0, item.nit, b0,
                                        [&](int i) {
                                          if (tid == 0)
                                            produce(a, items, prod, sbase, b0 + i + kStages - 1,
                                                    p + kAhead);
                                        },
                                        acc);
    base += item.nit;
    // acc register e: channel c0 + 8 * (e >> 1), token 2t + (e & 1)
    if (w.splits > 1) {
      float* part = w.part + (size_t)sp * M * N;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 2 * t + (e & 1);
        if (m < M) part[(size_t)m * N + n0 + c0 + (e >> 1) * 8] = acc[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) stile[(2 * t + (e & 1)) * kBN + c0 + (e >> 1) * 8] = acc[e];
    }
    __syncthreads();  // every partial of this block is written
    if (tid == 0) {
      // one acq_rel atomic releases the block's partials (the barrier
      // orders every thread's stores before it) and acquires the others'
      int done = 0;
      if (w.splits > 1)
        asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                     : "=r"(done) : "l"(w.cnt + tile) : "memory");
      last = w.splits == 1 || done == w.splits - 1;
      if (last && w.splits > 1) w.cnt[tile] = 0u;  // ready for the next launch
    }
    __syncthreads();
    if (last) {
      // thread tid: column n, rows r0, r0 + 2, r0 + 4, r0 + 6; the tile's
      // splits summed in split order, four splits' loads in flight at once
      const int n = tid & (kBN - 1), r0 = tid >> 7;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (w.splits == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (r0 + 2 * i < M) v[i] = stile[(r0 + 2 * i) * kBN + n];
      } else {
        for (int z0 = 0; z0 < w.splits; z0 += 4) {
          float q[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int m = r0 + 2 * i, z = z0 + k;
              q[i][k] = m < M && z < w.splits
                            ? __ldcg(w.part + ((size_t)z * M + m) * N + n0 + n) : 0.f;
            }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (z0 + k < w.splits) v[i] += q[i][k];
        }
      }
      if (EPI == kEpiResid) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = r0 + 2 * i;
          float hv = 0.f;
          if (m < M) {
            const size_t o = (size_t)m * a.D + n0 + n;
            hv = round_bf16(round_bf16(v[i]) + bf2f(a.xres[o]));
            a.h[o] = __float2bfloat16_rn(hv);
          }
          const float sq = warp_sum(hv * hv);
          if (lane == 0) red[warp][i] = sq;
        }
        __syncthreads();
        if (tid < M) {  // row m: warps 4 (m & 1) .. 4 (m & 1) + 3, register m >> 1
          const int q = 4 * (tid & 1), i = tid >> 1;
          a.ssq[tile * kMaxRows + tid] = ((red[q][i] + red[q + 1][i]) + red[q + 2][i]) + red[q + 3][i];
        }
      } else if (EPI == kEpiStore) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = r0 + 2 * i;
          if (m < M) a.gub[(size_t)m * N + n0 + n] = __float2bfloat16_rn(v[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = r0 + 2 * i;
          if (m < M) {
            const size_t o = (size_t)m * a.D + n0 + n;
            a.out[o] = __float2bfloat16_rn(round_bf16(v[i]) + bf2f(__ldcg(a.h + o)));
          }
        }
      }
    }
    __syncthreads();  // last, red and stile are reused by the next item
  }
}

__global__ void __launch_bounds__(kThreads, 2) tail_kernel(const __grid_constant__ TailArgs a) {
  extern __shared__ unsigned char tail_smem[];
  __shared__ float stile[kMaxRows * kBN];  // an unsplit item's sums; the rows' tile sums
  __shared__ float red[kThreads / 32][4];
  __shared__ float rstd[kMaxRows];
  __shared__ int last;
  __shared__ Item items[kMaxItems];
  __shared__ Producer prod;
  unsigned char* smem = tail_smem + ((1024 - (qwg::smem_u32(tail_smem) & 1023)) & 1023);
  const uint32_t sbase = qwg::smem_u32(smem);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int p = 0; p < kPhases; ++p) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&a.maps[p].w) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&a.maps[p].s) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&a.maps[p].z) : "memory");
    }
    qwk::init_ring(sbase + Layout::oBar, sbase + Layout::oBar + 8 * kStages);
    if (!list_items(a, items, prod)) __trap();  // the launcher checks the count
    // the weights are not written by the kernel before: the first stages go
    // out before this launch waits for it
    produce(a, items, prod, sbase, kStages - 2, kAhead);
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  int base = 0, k = 0;  // the block's stages consumed so far, its next item
  tail_phase<kNone, kEpiResid>(a, 0, a.ao, a.w[0].K, nullptr, smem, items, prod, k, base, stile,
                               red, last);
  // every slot is free: the next GEMM's stages go out before the barrier
  if (tid == 0) produce(a, items, prod, sbase, base + kStages - 1, kAhead);
  grid_barrier(a.bar);
  // the rows' rstd from every tile's sums of squares: staged by all the
  // threads at once (one round trip), then summed in tile order
  for (int i = tid; i < a.D / kBN * kMaxRows; i += kThreads) stile[i] = __ldcg(a.ssq + i);
  __syncthreads();
  if (tid < a.M) {
    float tot = 0.f;
    for (int t = 0; t < a.D / kBN; ++t) tot += stile[t * kMaxRows + tid];
    rstd[tid] = rsqrtf(tot / (float)a.D + a.eps);
  }
  __syncthreads();
  tail_phase<kRmsNorm, kEpiStore>(a, 1, a.h, a.D, rstd, smem, items, prod, k, base, stile, red,
                                  last);
  if (tid == 0) produce(a, items, prod, sbase, base + kStages - 1, 1 + kAhead);
  grid_barrier(a.bar);
  tail_phase<kSiluGlu, kEpiOut>(a, 2, a.gub, 2 * a.w[2].K, nullptr, smem, items, prod, k, base,
                                stile, red, last);
}

// blocks of tail_kernel resident at once on this device (0 before the
// first query)
int g_resident = 0;

cudaError_t query_resident() {
  if (g_resident > 0) return cudaSuccess;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = allow_smem(tail_kernel, kSmemBytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, tail_kernel, kThreads, kSmemBytes);
  if (err == cudaSuccess) g_resident = occ * sms;
  return err;
}

}  // namespace

// The number of K14 blocks the card holds at once (the grid's bound), or
// minus a CUDA error code.
extern "C" int qtt_fused_layer_tail_resident() {
  const cudaError_t err = query_resident();
  return err == cudaSuccess ? g_resident : -static_cast<int>(err);
}

// attn_out: [M, K1] bf16; x_resid, out: [M, D] bf16; norm_w: [D] bf16;
// o_*: the o projection (qweight int32 [K1/8, D], scales and zeros_x_scales
// f32 [K1/128, D]); gu_*: gate_up ([D/8, 2I], [D/128, 2I]); dn_*: down
// ([I/8, D], [I/128, D]); all 16-byte aligned. M <= 8; (splits, groups per
// split) of each GEMM and grid (at most the resident count) come from the
// wrapper's plan; part_*: f32 [splits, M, N] scratch; h: bf16 [M, D], gu:
// bf16 [M, 2I], ssq: f32 [D/128, 8] scratch; sync: uint32 [2 + D/128 +
// 2I/128 + D/128], zero before the first launch and left zero by every
// launch.
extern "C" int qtt_fused_layer_tail(
    const void* attn_out, const void* x_resid, const void* norm_w,
    const void* o_qw, const void* o_s, const void* o_zs,
    const void* gu_qw, const void* gu_s, const void* gu_zs,
    const void* dn_qw, const void* dn_s, const void* dn_zs, float eps, int M,
    int K1, int D, int I, int o_splits, int o_gps, int gu_splits,
    int gu_gps, int dn_splits, int dn_gps, int grid, void* part_o,
    void* part_gu, void* part_dn, void* h, void* gu, void* ssq, void* sync,
    void* out, void* stream) {
  if (M <= 0 || M > kMaxRows || K1 % kG || D % kBN || I % kG || D / kBN > kBN)
    return cudaErrorInvalidValue;
  cudaError_t err = query_resident();
  if (err != cudaSuccess) return err;
  if (grid <= 0 || grid > g_resident) return cudaErrorCooperativeLaunchTooLarge;
  unsigned* s = static_cast<unsigned*>(sync);
  TailArgs a;
  const void* qw[kPhases] = {o_qw, gu_qw, dn_qw};
  const void* sc[kPhases] = {o_s, gu_s, dn_s};
  const void* zs[kPhases] = {o_zs, gu_zs, dn_zs};
  const int K[kPhases] = {K1, D, I}, N[kPhases] = {D, 2 * I, D};
  const int splits[kPhases] = {o_splits, gu_splits, dn_splits};
  const int gps[kPhases] = {o_gps, gu_gps, dn_gps};
  void* part[kPhases] = {part_o, part_gu, part_dn};
  unsigned* cnt = s + 2;
  int per_block = 0;  // the busiest block's items
  for (int p = 0; p < kPhases; ++p) {
    const int ng = K[p] / kG;
    if (splits[p] <= 0 || gps[p] <= 0 || (splits[p] - 1) * gps[p] >= ng || splits[p] * gps[p] < ng)
      return cudaErrorInvalidValue;
    if (!qwk::encode_maps(&a.maps[p], static_cast<const uint32_t*>(qw[p]),
                          static_cast<const float*>(sc[p]), static_cast<const float*>(zs[p]),
                          K[p], N[p]))
      return cudaErrorInvalidValue;
    a.w[p] = Gemm{K[p], N[p], N[p] / kBN, splits[p], gps[p], static_cast<float*>(part[p]), cnt};
    cnt += N[p] / kBN;
    per_block += (N[p] / kBN * splits[p] + grid - 1) / grid;
  }
  if (per_block > kMaxItems) return cudaErrorInvalidValue;
  a.ao = static_cast<const bf16*>(attn_out);
  a.xres = static_cast<const bf16*>(x_resid);
  a.nw = static_cast<const bf16*>(norm_w);
  a.M = M;
  a.D = D;
  a.eps = eps;
  a.h = static_cast<bf16*>(h);
  a.gub = static_cast<bf16*>(gu);
  a.ssq = static_cast<float*>(ssq);
  a.bar = s;
  a.out = static_cast<bf16*>(out);
  // programmatic stream serialization: the blocks may start, set up their
  // ring and issue their first weight copies while the kernel before
  // finishes; they wait for it before any other read or any write
  // (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, tail_kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}
