// K5 / K6: attention straight over the paged KV cache — single-query
// decode (K5) and chunked-prefill queries (K6).
//
// Replace the Pallas kernels quick_tpu/ops/paged_attention.py::_paged_kernel
// (:32, launched by paged_decode_attention :437) and ::_paged_chunk_kernel
// (:179, launched by paged_chunk_attention :291), bf16 pages only.
//
// What they compute. Keys live in pages [L, P, Hkv, page, D]; key t of slot
// b is row t % page of page block_table[b, t / page]. Query head hq reads kv
// head hq / (Hq / Hkv). The score is q . k * scale, then the tanh softcap,
// then the ALiBi bias slope * (t - qpos), then the mask: t <= qpos, and with
// a window t > qpos - window. K5: one query per slot at qpos =
// lengths[b] - 1. K6: S queries per slot, query i at qpos = starts[b] + i.
// Softmax in f32, online; p is rounded to bf16 before p @ v (the Pallas
// kernels' p.astype(v.dtype), :165-168); a row with no visible key gives 0.
// Keys past the block table (t >= n_pt * page) do not exist.
//
// What bounds them on the H100: bytes — the pages up to each slot's length
// (2 * length * Hkv * D * 2 bytes per slot) plus q and out. At the serving
// shapes (16 slots of a few hundred tokens) that is a few MB per call, so a
// call is bound by latency and by how many SMs stream the pages.
//
// K5's design is K3's (fused_decode_step.cu) over pages. The key range
// [0, n_pt * page) is split into `splits` chunks of `chunk` keys (whole
// 64-key tiles), from the shapes alone (the wrapper's plan: about two blocks
// an SM), never from the lengths, which each block reads on the card and
// clips its chunk to: [window start, min(length, n_pt * page)). So a
// captured launch stays right as the lengths move. Grid (kv head x head
// group, slot, split); a block owns up to 16 query heads of one kv head
// (one m16 tile; gq = 32 takes two blocks) and runs its key tiles through
// a two-stage cp.async ring of gathered page rows (128-byte swizzled): the
// page ids of the tile after next are read from the block table while this
// tile's products run, and the next tile's rows are copied meanwhile. Both
// products are mma.sync m16n8k16 (bf16 q and k; p rounded to bf16, f32
// accumulate), each warp taking 16 keys of a tile; the tile's row maxima go
// through shared memory, so that p is rounded against the block's running
// max. A block writes its partial (m, l, acc[D]) in f32; the last block of
// a (slot, head group) to finish (an atomic counter, which it resets for
// the next launch) merges the non-empty splits in split order. The output
// does not depend on block scheduling.
//
// K6 is the same design over a chunk of S queries. Its rows are the S x gq
// (chunk position, query head) pairs of one kv head; grid (kv head x row
// block of 64 rows, slot, split), so each page row is staged once per kv
// head and row block, not once per 16 rows. The key range is split as
// K5's (the wrapper's plan over the blocks of one split); a block reads
// its slot's start on the card and clips its chunk to [window start of its
// first row, its last row's position + 1), so a captured launch stays
// right as the starts move. Its key tiles go through K5's two-stage ring
// of gathered, swizzled page rows. Eight warps: two an m16 tile of rows,
// one a 32-key half of each tile, each running both products for its rows
// and keys on mma.sync m16n8k16 with its own running max (a row's keys of
// the half lie in the lane's quad), p rounded against it; the two halves'
// (m, l, o) are combined once, after the last tile (a single warp a row
// tile left the SM's schedulers idle on the softmax's dependent chains).
// Rows in one tile see different keys (the causal diagonal, the window),
// so the mask is each row's own [lo, hi) in registers. Only the splits
// holding a key of the row block's rows have work (a block finds that from
// the start it reads); where one does, its block writes the rows' outputs
// from registers; otherwise those blocks write partials, and the last of
// them to finish merges, row by row, the splits in which the row sees a
// key, in split order: a thread a row for the maxima and the denominators,
// then all threads on 4 dims of D / 16 rows each, split after split.
//
// Not carried over from the TPU: scalar prefetch and clamped index maps (a
// block reads its own block table), the static block-diagonal head mask (a
// block holds one kv head), and the pages-per-step and slots-per-step
// tuning.
#include "split_attention.cuh"

namespace {

constexpr int kWarps = 4;

// ---------------------------------------------------------------- K5 decode
namespace k5 {

constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;    // keys per tile; warp w takes keys 16w .. 16w + 15
constexpr int kRows = 16;  // query heads a block (one m16 tile)

template <int D>
struct Smem {
  static constexpr int kQ = kRows * D * 2;     // the bf16 q tile, swizzled
  static constexpr int kK = kBK * D * 2;       // a K tile, swizzled
  static constexpr int kV = kBK * D * 2;       // a V tile, swizzled
  static constexpr int oRing = kQ;
  static constexpr int oPid = oRing + 2 * (kK + kV);   // [3][kBK] page ids of three tiles
  static constexpr int oMax = oPid + 3 * kBK * 4;      // [kWarps][kRows] tile maxima
  static constexpr int oL = oMax + kWarps * kRows * 4;  // [kWarps][kRows] row sums
  static constexpr int oM = oL + kWarps * kRows * 4;    // [kRows] running maxima
  static constexpr int oFlag = oM + kRows * 4;
  static constexpr size_t kBytes = oFlag + 16;
  // the four warps' outputs [kWarps][kRows][D] f32 reuse the ring
  static_assert(kWarps * kRows * D * 4 <= 2 * (kK + kV), "the warps' outputs fit the ring");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                          const bf16* __restrict__ v_pages, const int* __restrict__ block_table,
                          const int* __restrict__ lengths, const float* __restrict__ slopes,
                          bf16* __restrict__ out, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int* __restrict__ counters, int Hq,
                          int Hkv, int gq, int ht_bits, int page, int P, int n_pt, int layer,
                          int chunk, float scale, int window, float softcap) {
  using L = Smem<D>;
  constexpr int kDPL = D / 32;  // output dims a lane in the merge
  constexpr int kNT = D / 8;    // n8 tiles of the output
  // blockIdx.x = (kv head, head group), 2^ht_bits groups a kv head
  const int h = blockIdx.x >> ht_bits, ht = blockIdx.x & ((1 << ht_bits) - 1);
  const int b = blockIdx.y, sp = blockIdx.z;
  const int splits = gridDim.z;
  const int nrows = min(kRows, gq - ht * kRows);  // query heads of this block
  const int hq0 = h * gq + ht * kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  int* pid = reinterpret_cast<int*>(smem + L::oPid);
  const uint32_t ks0 = qs + L::oRing, vs0 = ks0 + 2 * L::kK;
  float* smax = reinterpret_cast<float*>(smem + L::oMax);
  float* lsum = reinterpret_cast<float*>(smem + L::oL);
  float* mrow = reinterpret_cast<float*>(smem + L::oM);
  int* flag = reinterpret_cast<int*>(smem + L::oFlag);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  // the query at length - 1 sees [window start, min(length, n_pt * page))
  const int length = lengths[b];
  const int end = max(0, min(length, n_pt * page));
  const int wlo = window > 0 ? max(0, length - window) : 0;
  const Range rg = split_range(sp, chunk, end, wlo);
  const int t_begin = (rg.lo / kBK) * kBK;
  const int n_tiles = rg.lo < rg.hi ? (rg.hi - t_begin + kBK - 1) / kBK : 0;
  const int* bt = block_table + (size_t)b * n_pt;
  const size_t lp = (size_t)layer * P;

  // the page id of key tid of tile i (0 past the range: never read)
  auto page_of = [&](int i) {
    const int t = t_begin + i * kBK + tid;
    return t < rg.hi ? bt[t / page] : 0;
  };
  // copy tile i's keys [t0, t0 + kBK) of kv head h from their pages into a
  // stage; keys at or past rg.hi are zero-filled (never read from memory)
  auto load_kv = [&](int i, uint32_t ks, uint32_t vs) {
    const int t0 = t_begin + i * kBK;
    const int* ids = pid + (i % 3) * kBK;
    for (int c = tid; c < kBK * (D / 8); c += kThreads) {
      const int j = c / (D / 8), ch = c % (D / 8);
      const bool ok = t0 + j < rg.hi;
      const size_t off =
          ok ? (((lp + ids[j]) * Hkv + h) * page + (t0 + j) % page) * D + ch * 8 : 0;
      cp_async16(ks + swz<D>(j, ch), k_pages + off, ok);
      cp_async16(vs + swz<D>(j, ch), v_pages + off, ok);
    }
  };
  if (tid < kBK) {
    if (n_tiles > 0) pid[tid] = page_of(0);
    if (n_tiles > 1) pid[kBK + tid] = page_of(1);
  }
  // the q rows in bf16; rows past nrows are zeros
  bf16* qtile = reinterpret_cast<bf16*>(smem);
  for (int c = tid; c < kRows * D; c += kThreads) {
    const int r = c / D, d = c % D;
    const bf16 v = r < nrows ? q[((size_t)b * Hq + hq0 + r) * D + d] : __float2bfloat16_rn(0.f);
    qtile[(swz<D>(r, d >> 3) >> 1) + (d & 7)] = v;
  }
  __syncthreads();  // the page ids of tiles 0 and 1
  if (n_tiles > 0) load_kv(0, ks0, vs0);
  cp_async_commit();

  float slope[2];  // ALiBi slopes of the lane's rows g and g + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    slope[hh] = slopes != nullptr && r < nrows ? slopes[hq0 + r] : 0.f;
  }
  float o[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {QTT_NEG_INF, QTT_NEG_INF}, l[2] = {0.f, 0.f};
  const int qrow = ((lane >> 3) & 1) * 8 + (lane & 7);  // ldmatrix rows of the q tile
  const int qchunk = lane >> 4;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kBK;
    const int st = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; tile it - 1 is consumed (its stage is free)
    // tile it + 2's page ids: loaded now, stored after this tile's products
    const int pid_next = tid < kBK && it + 2 < n_tiles ? page_of(it + 2) : 0;
    if (it + 1 < n_tiles) load_kv(it + 1, ks0 + (st ^ 1) * L::kK, vs0 + (st ^ 1) * L::kV);
    cp_async_commit();
    const uint32_t ks = ks0 + st * L::kK, vs = vs0 + st * L::kV;
    // q k^T for the warp's 16 keys: two n8 tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], kb[4];
      ldsm_x4(a, qs + swz<D>(qrow, 2 * kk + qchunk));
      ldsm_x4(kb, ks + swz<D>(warp * 16 + (lane >> 4) * 8 + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
      mma16816(s[0], a, kb[0], kb[1]);
      mma16816(s[1], a, kb[2], kb[3]);
    }
    // scale, softcap, then ALiBi, then the mask; register e of tile nt: row
    // g + 8 * (e >> 1), key t0 + 16 * warp + 8 * nt + 2 * tq + (e & 1)
    float mx[2] = {QTT_NEG_INF, QTT_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + warp * 16 + nt * 8 + 2 * tq + (e & 1);
        float sc = s[nt][e] * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        sc += slope[e >> 1] * (float)(t - (length - 1));
        sc = t >= rg.lo && t < rg.hi ? sc : QTT_NEG_INF;
        s[nt][e] = sc;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
    if (tq == 0) {
      smax[warp * kRows + g] = mx[0];
      smax[warp * kRows + g + 8] = mx[1];
    }
    __syncthreads();  // the tile's row maxima of all four warps
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = smax[g + 8 * hh];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, smax[w * kRows + g + 8 * hh]);
      const float mn = fmaxf(m[hh], tm);
      const float alpha = expf(m[hh] - mn);
      m[hh] = mn;
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float p = s[nt][e] == QTT_NEG_INF ? 0.f : expf(s[nt][e] - mn);
          s[nt][e] = p;
          ps += p;
        }
      l[hh] = l[hh] * alpha + ps;  // the lane's part; the quad adds them at the end
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        o[i][2 * hh] *= alpha;
        o[i][2 * hh + 1] *= alpha;
      }
    }
    // p v: the two score tiles are the A fragment of one k16 step
    uint32_t a[4];
    a[0] = pack_bf16(s[0][0], s[0][1]);
    a[1] = pack_bf16(s[0][2], s[0][3]);
    a[2] = pack_bf16(s[1][0], s[1][1]);
    a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vs + swz<D>(warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                2 * np + (lane >> 4)));
      mma16816(o[2 * np], a, vb[0], vb[1]);
      mma16816(o[2 * np + 1], a, vb[2], vb[3]);
    }
    if (tid < kBK && it + 2 < n_tiles) pid[((it + 2) % 3) * kBK + tid] = pid_next;
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free

  // this split's partial: the four warps' outputs summed in warp order
  if (n_tiles > 0) {
    float* red = reinterpret_cast<float*>(smem + L::oRing);  // [kWarps][kRows][D]
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * kRows + g + 8 * (e >> 1)) * D + i * 8 + 2 * tq + (e & 1)] = o[i][e];
    if (tq == 0) {
      lsum[warp * kRows + g] = l[0];
      lsum[warp * kRows + g + 8] = l[1];
      if (warp == 0) {
        mrow[g] = m[0];
        mrow[g + 8] = m[1];
      }
    }
    __syncthreads();
    for (int c = tid; c < nrows * D; c += kThreads) {
      const int r = c / D, d = c % D;
      float v = red[r * D + d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[(w * kRows + r) * D + d];
      part_acc[(((size_t)b * Hq + hq0 + r) * splits + sp) * D + d] = v;
    }
    for (int r = tid; r < nrows; r += kThreads) {
      float lr = lsum[r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) lr += lsum[w * kRows + r];
      float* ml = part_ml + (((size_t)b * Hq + hq0 + r) * splits + sp) * 2;
      ml[0] = mrow[r];
      ml[1] = lr;
    }
  }

  // the last block of this (slot, head group) to finish merges
  if (splits > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* cnt = counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
      const int done = atomicAdd(cnt, 1);
      *flag = done == splits - 1;
      if (*flag) *cnt = 0;  // every block of this group has counted: ready for the next launch
    }
    __syncthreads();
    if (!*flag) return;
    __threadfence();
  } else {
    __syncthreads();
  }
  // O = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s,
  // over the non-empty splits in order; 0 where there is none
  for (int r = warp; r < nrows; r += kWarps) {
    const size_t row = (size_t)b * Hq + hq0 + r;
    const float2* ml = reinterpret_cast<const float2*>(part_ml) + row * splits;
    float M = QTT_NEG_INF;
    for (int s2 = lane; s2 < splits; s2 += 32) {
      const Range r2 = split_range(s2, chunk, end, wlo);
      if (r2.lo < r2.hi) M = fmaxf(M, __ldcg(ml + s2).x);
    }
    M = warp_max(M);
    float lt = 0.f, acc[kDPL];
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[e] = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 32) {
      const int s2 = s0 + lane;
      const Range r2 = split_range(s2, chunk, end, wlo);
      const bool live = s2 < splits && r2.lo < r2.hi;
      float w = 0.f, lw = 0.f;
      if (live) {
        const float2 v = __ldcg(ml + s2);
        w = expf(v.x - M);
        lw = v.y * w;
      }
      const unsigned lives = __ballot_sync(0xffffffffu, live);
      const int n = min(32, splits - s0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {  // in split order
        const float wj = __shfl_sync(0xffffffffu, w, j);
        const float lwj = __shfl_sync(0xffffffffu, lw, j);
        if (!((lives >> j) & 1u)) continue;  // an empty split wrote no partial
        lt += lwj;
        const float* pa = part_acc + (row * splits + s0 + j) * D + lane * kDPL;
#pragma unroll
        for (int e = 0; e < kDPL; ++e) acc[e] = fmaf(wj, __ldcg(pa + e), acc[e]);
      }
    }
    const float inv = lt == 0.f ? 1.f : lt;
    bf16* o_row = out + row * D + lane * kDPL;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) o_row[e] = __float2bfloat16_rn(acc[e] / inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* lengths, const void* slopes, void* out,
                   void* part_acc, void* part_ml, void* counters, int B, int Hq, int Hkv,
                   int page, int P, int n_pt, int layer, int chunk, int splits, float scale,
                   int window, float softcap, cudaStream_t st) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = allow_smem(paged_decode_split_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int gq = Hq / Hkv, ht_bits = gq > kRows ? 1 : 0;  // gq <= 32: one or two groups
  dim3 grid(Hkv << ht_bits, B, splits);
  paged_decode_split_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), Hq, Hkv, gq, ht_bits, page, P, n_pt, layer, chunk, scale,
      window, softcap);
  return cudaGetLastError();
}

}  // namespace k5

// ----------------------------------------------------------------- K6 chunk
namespace k6 {

constexpr int kRowTiles = 4;                 // m16 row tiles a block
constexpr int kThreads = 2 * kRowTiles * 32; // two warps a row tile, one a key half
constexpr int kBK = 64;                      // keys per tile
constexpr int kRows = kRowTiles * 16;        // (position, head) rows a block

template <int D>
struct Smem {
  static constexpr int kQ = kRows * D * 2;   // the bf16 q rows, swizzled
  static constexpr int kK = kBK * D * 2;     // a K tile, swizzled
  static constexpr int kV = kBK * D * 2;     // a V tile, swizzled
  static constexpr int oRing = kQ;
  static constexpr int oPid = oRing + 2 * (kK + kV);  // [3][kBK] page ids of three tiles
  static constexpr int oFlag = oPid + 3 * kBK * 4;
  static constexpr size_t kBytes = oFlag + 16;
  // after the tiles, the second key half's (o, m, l) [kRows][D + 2] f32 reuse the ring
  static_assert(kRows * (D + 2) * 4 <= 2 * (kK + kV), "the key halves' states fit the ring");
};

// Rows of one kv head h are the S x gq (chunk position i, head in group)
// pairs, row R = i * gq + head; block (h * n_rb + rb, b, sp) owns rows
// 64 rb .. 64 rb + 63 of slot b and the keys of split sp. Warp w takes rows
// 16 (w % 4) .. + 15 and keys 32 (w / 4) .. + 31 of each 64-key tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                         const bf16* __restrict__ v_pages, const int* __restrict__ block_table,
                         const int* __restrict__ starts, const float* __restrict__ slopes,
                         bf16* __restrict__ out, float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int* __restrict__ counters, int S, int Hq,
                         int Hkv, int gq, int n_rb, int page, int P, int n_pt, int layer,
                         int chunk, float scale, int window, float softcap) {
  using L = Smem<D>;
  constexpr int kNT = D / 8;  // n8 tiles of the output
  const int h = blockIdx.x / n_rb, rb = blockIdx.x % n_rb;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int splits = gridDim.z;
  const int n_rows = S * gq, r0 = rb * kRows;
  const int nrows = min(kRows, n_rows - r0);  // rows of this block
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  int* pid = reinterpret_cast<int*>(smem + L::oPid);
  const uint32_t ks0 = qs + L::oRing, vs0 = ks0 + 2 * L::kK;
  int* flag = reinterpret_cast<int*>(smem + L::oFlag);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = warp % kRowTiles, kh = warp / kRowTiles;  // row tile, key half
  const int g = lane >> 2, tq = lane & 3;
  const int n_keys = n_pt * page;

  // the block's keys: from its first row's window start to its last row's
  // position, clipped to the table and to this split
  const int start = starts[b];
  const int end = max(0, min(start + (r0 + nrows - 1) / gq + 1, n_keys));
  const int wlo = window > 0 ? max(0, start + r0 / gq - window + 1) : 0;
  // the splits holding a key of any row of the block: first .. first +
  // nlive - 1 (one, split 0, where none does; it writes the zeros). The
  // others' blocks have nothing to do; with one live split its block
  // writes the rows' outputs itself, with more the live blocks write
  // partials and the last of them merges
  const int first = wlo < end ? wlo / chunk : 0;
  const int nlive = wlo < end ? (end - 1) / chunk - first + 1 : 1;
  if (sp < first || sp >= first + nlive) return;
  const bool direct = nlive == 1;
  const Range rg = split_range(sp, chunk, end, wlo);
  const int t_begin = (rg.lo / kBK) * kBK;
  const int n_tiles = rg.lo < rg.hi ? (rg.hi - t_begin + kBK - 1) / kBK : 0;
  const int* bt = block_table + (size_t)b * n_pt;
  const size_t lp = (size_t)layer * P;

  // the lane's rows g and g + 8 of the warp's row tile: position, ALiBi
  // slope and visible keys [lo, hi) of this split (empty past the rows)
  int qpos[2];
  float slope[2];
  Range vis[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rt * 16 + g + 8 * hh, R = r0 + r;
    qpos[hh] = start + R / gq;
    slope[hh] = slopes != nullptr && r < nrows ? slopes[h * gq + R % gq] : 0.f;
    const int wr = window > 0 ? max(0, qpos[hh] - window + 1) : 0;
    vis[hh] = r < nrows ? split_range(sp, chunk, max(0, min(qpos[hh] + 1, n_keys)), wr)
                        : Range{0, 0};
  }
  float o[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {QTT_NEG_INF, QTT_NEG_INF}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    // the page id of key tid of tile i (0 past the range: never read)
    auto page_of = [&](int i) {
      const int t = t_begin + i * kBK + tid;
      return t < rg.hi ? bt[t / page] : 0;
    };
    // copy tile i's keys [t0, t0 + kBK) of kv head h from their pages into
    // a stage; keys at or past rg.hi are zero-filled (never read from memory)
    auto load_kv = [&](int i, uint32_t ks, uint32_t vs) {
      const int t0 = t_begin + i * kBK;
      const int* ids = pid + (i % 3) * kBK;
      for (int c = tid; c < kBK * (D / 8); c += kThreads) {
        const int j = c / (D / 8), ch = c % (D / 8);
        const bool ok = t0 + j < rg.hi;
        const size_t off =
            ok ? (((lp + ids[j]) * Hkv + h) * page + (t0 + j) % page) * D + ch * 8 : 0;
        cp_async16(ks + swz<D>(j, ch), k_pages + off, ok);
        cp_async16(vs + swz<D>(j, ch), v_pages + off, ok);
      }
    };
    if (tid < kBK) {
      pid[tid] = page_of(0);
      if (n_tiles > 1) pid[kBK + tid] = page_of(1);
    }
    // the block's q rows in bf16; rows past nrows are zeros
    for (int c = tid; c < kRows * (D / 8); c += kThreads) {
      const int r = c / (D / 8), ch = c % (D / 8), R = r0 + r;
      const bool ok = r < nrows;
      const size_t off = ok ? (((size_t)b * S + R / gq) * Hq + h * gq + R % gq) * D + ch * 8 : 0;
      cp_async16(qs + swz<D>(r, ch), q + off, ok);
    }
    __syncthreads();  // the page ids of tiles 0 and 1
    load_kv(0, ks0, vs0);
    cp_async_commit();

    const int qrow = rt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);  // ldmatrix rows of q
    const int qchunk = lane >> 4;
    for (int it = 0; it < n_tiles; ++it) {
      const int t0 = t_begin + it * kBK + 32 * kh;  // the warp's first key
      const int st = it & 1;
      cp_async_wait_all();
      __syncthreads();  // tile it landed; tile it - 1 is consumed (its stage is free)
      // tile it + 2's page ids: loaded now, stored after this tile's products
      const int pid_next = tid < kBK && it + 2 < n_tiles ? page_of(it + 2) : 0;
      if (it + 1 < n_tiles) load_kv(it + 1, ks0 + (st ^ 1) * L::kK, vs0 + (st ^ 1) * L::kV);
      cp_async_commit();
      const uint32_t ks = ks0 + st * L::kK, vs = vs0 + st * L::kV;
      // q k^T for the warp's 16 rows and its 32 keys: four n8 tiles
      float s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + swz<D>(qrow, 2 * kk + qchunk));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + swz<D>(32 * kh + 16 * j + (lane >> 4) * 8 + (lane & 7),
                                  2 * kk + ((lane >> 3) & 1)));
          mma16816(s[2 * j], a, kb[0], kb[1]);
          mma16816(s[2 * j + 1], a, kb[2], kb[3]);
        }
      }
      // scale, softcap, then ALiBi, then the row's mask; register e of tile
      // nt: row g + 8 * (e >> 1), key t0 + 8 * nt + 2 * tq + (e & 1)
      float mx[2] = {QTT_NEG_INF, QTT_NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + nt * 8 + 2 * tq + (e & 1), hh = e >> 1;
          float sc = s[nt][e] * scale;
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          sc += slope[hh] * (float)(t - qpos[hh]);
          sc = t >= vis[hh].lo && t < vis[hh].hi ? sc : QTT_NEG_INF;
          s[nt][e] = sc;
          mx[hh] = fmaxf(mx[hh], sc);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // the row's maximum over the warp's keys: they lie in the lane's quad
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float mn = fmaxf(m[hh], mx[hh]);
        const float alpha = expf(m[hh] - mn);
        m[hh] = mn;
        float ps = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
            const float p = s[nt][e] == QTT_NEG_INF ? 0.f : expf(s[nt][e] - mn);
            s[nt][e] = p;
            ps += p;
          }
        l[hh] = l[hh] * alpha + ps;  // the lane's part; the quad adds them at the end
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          o[i][2 * hh] *= alpha;
          o[i][2 * hh + 1] *= alpha;
        }
      }
      // p v: score tiles 2j and 2j + 1 are the A fragment of k16 step j
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vs + swz<D>(32 * kh + 16 * j + ((lane >> 3) & 1) * 8 + (lane & 7),
                                    2 * np + (lane >> 4)));
          mma16816(o[2 * np], a, vb[0], vb[1]);
          mma16816(o[2 * np + 1], a, vb[2], vb[3]);
        }
      }
      if (tid < kBK && it + 2 < n_tiles) pid[((it + 2) % 3) * kBK + tid] = pid_next;
    }
    cp_async_wait_all();
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }

  // the two key halves of each row combined: M = max(m0, m1), o = o0 e^(m0 - M)
  // + o1 e^(m1 - M), l likewise; the second half hands its state over
  // through the ring. Register e of o[i]: row g + 8 * (e >> 1), dim
  // 8i + 2tq + (e & 1)
  float* half = reinterpret_cast<float*>(smem + L::oRing);  // [kRows][D] o, then [kRows][2]
  __syncthreads();  // the ring is free
  if (n_tiles > 0 && kh == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rt * 16 + g + 8 * hh;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
        *reinterpret_cast<float2*>(half + r * D + 8 * i + 2 * tq) =
            make_float2(o[i][2 * hh], o[i][2 * hh + 1]);
      if (tq == 0) *reinterpret_cast<float2*>(half + kRows * D + 2 * r) = make_float2(m[hh], l[hh]);
    }
  }
  __syncthreads();
  if (kh == 0) {
    if (n_tiles > 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rt * 16 + g + 8 * hh;
        const float2 ml1 = *reinterpret_cast<const float2*>(half + kRows * D + 2 * r);
        const float mn = fmaxf(m[hh], ml1.x);
        const float a0 = expf(m[hh] - mn), a1 = expf(ml1.x - mn);
        m[hh] = mn;
        l[hh] = fmaf(ml1.y, a1, l[hh] * a0);
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          const float2 o1 = *reinterpret_cast<const float2*>(half + r * D + 8 * i + 2 * tq);
          o[i][2 * hh] = fmaf(o1.x, a1, o[i][2 * hh] * a0);
          o[i][2 * hh + 1] = fmaf(o1.y, a1, o[i][2 * hh + 1] * a0);
        }
      }
    }
    if (direct) {  // the one live split: the rows' outputs straight from registers
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rt * 16 + g + 8 * hh, R = r0 + r;
        if (r >= nrows) continue;
        const float inv = l[hh] == 0.f ? 1.f : l[hh];
        bf16* o_row = out + (((size_t)b * S + R / gq) * Hq + h * gq + R % gq) * D;
#pragma unroll
        for (int i = 0; i < kNT; ++i)
          *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * i + 2 * tq) =
              __floats2bfloat162_rn(o[i][2 * hh] / inv, o[i][2 * hh + 1] / inv);
      }
    }
  }
  if (direct) return;
  // this split's partial (m, l, acc) of each row
  const size_t row0 = ((size_t)b * Hkv + h) * n_rows + r0;  // partial row of local row 0
  if (n_tiles > 0 && kh == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rt * 16 + g + 8 * hh;
      if (r >= nrows) continue;
      const size_t pr = (row0 + r) * splits + sp;
      float* pa = part_acc + pr * D;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
        *reinterpret_cast<float2*>(pa + 8 * i + 2 * tq) = make_float2(o[i][2 * hh], o[i][2 * hh + 1]);
      if (tq == 0) *reinterpret_cast<float2*>(part_ml + pr * 2) = make_float2(m[hh], l[hh]);
    }
  }

  // the last live block of this (slot, kv head, row block) to finish merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const int done = atomicAdd(cnt, 1);
    *flag = done == nlive - 1;
    if (*flag) *cnt = 0;  // every live block has counted: ready for the next launch
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // O = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s,
  // over the splits in which the row sees a key, in order; 0 where none.
  // First a thread a row: M and the denominator; then every thread on 4
  // dims of D / 16 rows, split after split, the rows' loads in flight
  auto live = [&](int r, int s2) {  // row r sees a key of split s2
    const int qp = start + (r0 + r) / gq;
    const int wlo_r = window > 0 ? max(0, qp - window + 1) : 0;
    const Range r2 = split_range(s2, chunk, max(0, min(qp + 1, n_keys)), wlo_r);
    return r2.lo < r2.hi;
  };
  float* mrow = reinterpret_cast<float*>(smem + L::oRing);  // [kRows] M, then [kRows] sums
  const float2* ml0 = reinterpret_cast<const float2*>(part_ml);
  if (tid < nrows) {  // four splits' loads in flight at a time
    const float2* ml = ml0 + (row0 + tid) * splits;
    float M = QTT_NEG_INF, lt = 0.f;
    for (int s0 = first; s0 < first + nlive; s0 += 4) {
      float m4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m4[k] = s0 + k < first + nlive && live(tid, s0 + k) ? __ldcg(ml + s0 + k).x : QTT_NEG_INF;
#pragma unroll
      for (int k = 0; k < 4; ++k) M = fmaxf(M, m4[k]);
    }
    for (int s0 = first; s0 < first + nlive; s0 += 4) {
      bool lv[4];
      float2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lv[k] = s0 + k < first + nlive && live(tid, s0 + k);
        if (lv[k]) v[k] = __ldcg(ml + s0 + k);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)  // in split order
        if (lv[k]) lt += v[k].y * expf(v[k].x - M);
    }
    mrow[tid] = M;
    mrow[kRows + tid] = lt == 0.f ? 1.f : lt;
  }
  __syncthreads();
  constexpr int kQ = D / 4;                   // threads a row, 4 dims each
  constexpr int kRS = kThreads / kQ;          // rows apart
  constexpr int kRPT = kRows / kRS;           // rows a thread
  const int d = (tid % kQ) * 4, rq = tid / kQ;
  float4 acc[kRPT];
#pragma unroll
  for (int k = 0; k < kRPT; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s2 = first; s2 < first + nlive; ++s2) {  // in split order, the rows' loads in flight
    bool lv[kRPT];
    float mk[kRPT];
    float4 pa[kRPT];
#pragma unroll
    for (int k = 0; k < kRPT; ++k) {
      const int r = rq + k * kRS;
      lv[k] = r < nrows && live(r, s2);
      if (lv[k]) {
        const size_t pr = (row0 + r) * splits + s2;
        mk[k] = __ldcg(ml0 + pr).x;
        pa[k] = __ldcg(reinterpret_cast<const float4*>(part_acc + pr * D + d));
      }
    }
#pragma unroll
    for (int k = 0; k < kRPT; ++k) {
      if (!lv[k]) continue;
      const float w = expf(mk[k] - mrow[rq + k * kRS]);
      acc[k] = make_float4(fmaf(w, pa[k].x, acc[k].x), fmaf(w, pa[k].y, acc[k].y),
                           fmaf(w, pa[k].z, acc[k].z), fmaf(w, pa[k].w, acc[k].w));
    }
  }
#pragma unroll
  for (int k = 0; k < kRPT; ++k) {
    const int r = rq + k * kRS, R = r0 + r;
    if (r >= nrows) break;
    const float inv = mrow[kRows + r];
    __nv_bfloat162* o_row = reinterpret_cast<__nv_bfloat162*>(
        out + (((size_t)b * S + R / gq) * Hq + h * gq + R % gq) * D + d);
    o_row[0] = __floats2bfloat162_rn(acc[k].x / inv, acc[k].y / inv);
    o_row[1] = __floats2bfloat162_rn(acc[k].z / inv, acc[k].w / inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* starts, const void* slopes, void* out,
                   void* part_acc, void* part_ml, void* counters, int B, int S, int Hq, int Hkv,
                   int page, int P, int n_pt, int layer, int chunk, int splits, float scale,
                   int window, float softcap, cudaStream_t st) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = allow_smem(paged_chunk_split_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int gq = Hq / Hkv, n_rb = (S * gq + kRows - 1) / kRows;
  dim3 grid(Hkv * n_rb, B, splits);
  paged_chunk_split_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(starts), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), S, Hq, Hkv, gq, n_rb, page, P, n_pt, layer, chunk, scale,
      window, softcap);
  return cudaGetLastError();
}

}  // namespace k6

bool shapes_ok(int B, int Hq, int Hkv, int page, int P, int n_pt, int layer) {
  return B > 0 && Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv <= 32 && page > 0 &&
         P > 0 && n_pt > 0 && layer >= 0;
}

}  // namespace

// q, out: [B, Hq, D] bf16; k_pages, v_pages: [L, P, Hkv, page, D] bf16;
// block_table: int32 [B, n_pt] (entries in [0, P)); lengths: int32 [B]
// (keys per slot, the current token's included), read on the card;
// slopes: f32 [Hq] or null; window <= 0 and softcap <= 0 disable. The key
// range [0, n_pt * page) is cut into `splits` chunks of `chunk` keys (a
// multiple of 64, splits * chunk >= n_pt * page); part_acc f32 [B, Hq,
// splits, D] and part_ml f32 [B, Hq, splits, 2] are scratch; counters:
// int32 [B * Hkv * ceil(Hq / Hkv / 16)], zero before the launch and left at
// zero by it (one launch at a time).
extern "C" int qtt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, const void* slopes,
    void* out, void* part_acc, void* part_ml, void* counters, int B, int Hq, int Hkv,
    int page, int D, int P, int n_pt, int layer, int chunk, int splits, float scale,
    int window, float softcap, void* stream) {
  if (!shapes_ok(B, Hq, Hkv, page, P, n_pt, layer) || B > 65535 || chunk <= 0 ||
      chunk % k5::kBK != 0 || splits <= 0 || splits > 65535 ||
      (long long)splits * chunk < (long long)n_pt * page || part_acc == nullptr ||
      part_ml == nullptr || counters == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QTT_LAUNCH(DD)                                                                      \
  k5::launch<DD>(q, k_pages, v_pages, block_table, lengths, slopes, out, part_acc, part_ml, \
                 counters, B, Hq, Hkv, page, P, n_pt, layer, chunk, splits, scale, window,  \
                 softcap, st)
  switch (D) {
    case 64: return QTT_LAUNCH(64);
    case 128: return QTT_LAUNCH(128);
    case 256: return QTT_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef QTT_LAUNCH
}

// q, out: [B, S, Hq, D] bf16; starts: int32 [B] (keys cached before the
// chunk; the chunk's own keys must already be written), read on the card;
// the key range [0, n_pt * page) is cut into `splits` chunks of `chunk`
// keys as for K5; part_acc f32 [B, Hq * S, splits, D] and part_ml f32
// [B, Hq * S, splits, 2] are scratch; counters: int32 [B * Hkv *
// ceil(S * Hq / Hkv / 64)], zero before the launch and left at zero by it
// (one launch at a time); the rest as above.
extern "C" int qtt_paged_chunk_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* starts, const void* slopes,
    void* out, void* part_acc, void* part_ml, void* counters, int B, int S, int Hq, int Hkv,
    int page, int D, int P, int n_pt, int layer, int chunk, int splits, float scale,
    int window, float softcap, void* stream) {
  if (S <= 0 || !shapes_ok(B, Hq, Hkv, page, P, n_pt, layer) || B > 65535 || chunk <= 0 ||
      chunk % k6::kBK != 0 || splits <= 0 || splits > 65535 ||
      (long long)splits * chunk < (long long)n_pt * page || part_acc == nullptr ||
      part_ml == nullptr || counters == nullptr ||
      (long long)Hkv * ((S * (Hq / Hkv) + k6::kRows - 1) / k6::kRows) > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QTT_LAUNCH(DD)                                                                      \
  k6::launch<DD>(q, k_pages, v_pages, block_table, starts, slopes, out, part_acc, part_ml,  \
                 counters, B, S, Hq, Hkv, page, P, n_pt, layer, chunk, splits, scale, window, \
                 softcap, st)
  switch (D) {
    case 64: return QTT_LAUNCH(64);
    case 128: return QTT_LAUNCH(128);
    case 256: return QTT_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef QTT_LAUNCH
}
