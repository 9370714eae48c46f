// K5's single-query decode over a paged KV cache (paged_attention.cu) and
// K7's over the dense one (decode_attention.cu): one key-split kernel,
// K3's design (fused_decode_step.cu) over pages. A dense cache [L, B, Hkv,
// T, D] is a paged one with P = B pages of page = T keys, slot b's one page
// being page b: the compile-time kDense reads no block table (n_pt = 1).
//
// The key range [0, n_pt * page) is split into `splits` chunks of `chunk`
// keys (whole 64-key tiles) from the shapes alone, never from the lengths,
// which each block reads on the card and clips its chunk to: [window
// start, min(length, n_pt * page)). So a captured launch stays right as the
// lengths move. Grid (kv head x head group, slot, split); a block owns up
// to 16 query heads of one kv head (one m16 tile; gq = 32 takes two blocks)
// and runs its key tiles through a two-stage cp.async ring of gathered page
// rows (128-byte swizzled): the page ids of the tile after next are read
// from the block table while this tile's products run, and the next tile's
// rows are copied meanwhile; keys at or past the clipped end are
// zero-filled, never read. Both products are mma.sync m16n8k16 (bf16 q and
// k; p rounded to bf16, f32 accumulate), each warp taking 16 keys of a
// tile; the tile's row maxima go through shared memory, so that p is
// rounded against the block's running max. A block writes its partial (m,
// l, acc[D]) in f32; the last block of a (slot, head group) to finish (an
// atomic counter, which it resets for the next launch) merges the
// non-empty splits in split order. The output does not depend on block
// scheduling.
//
// K5q (paged_attention_int8.cu) is the same kernel over INT8 pages, the
// compile-time kI8 branches below; the bf16 instantiations are K5's and
// K7's code alone. What differs:
// - q is quantized per (slot, head) as the Pallas INT8 path does (sq =
//   max(max|q|, 1e-30) / 127, codes rint(q / sq)); the q tile holds the
//   codes. q . k^T runs on the int8 m16n8k32 product (exact s32); p v runs
//   on K5's bf16 m16n8k16 with f32 accumulation over p8 and v codes
//   converted exactly to bf16, exact as well: every partial sum is an
//   integer below 2^24 (127 * 127 * 16 a warp). The Pallas kernel's int32
//   dots exactly, then; p v stays on bf16 because sm_90 has no transposing
//   ldmatrix for 8-bit data.
// - p is quantized per (query head, page): ps = max(max|p v_scale|,
//   1e-30) / 127 over the page's visible keys, p8 = rint(p v_scale / ps),
//   and acc = acc alpha + (p8 . v8) ps. A quantization group is never cut:
//   the split plan's chunks are whole units of max(page, 64) keys (a page
//   of 16 or 32 keys is one or two warps' keys of a tile; a page of 128 or
//   256 spans two or four tiles), and the block finishes every score of a
//   unit, with its running max, before it quantizes any of them. The
//   page's codes do not change when p is multiplied by a constant, so a
//   split's codes equal the sequential walk's up to the f32 rounding of
//   exp; the merge weighs the splits as K5's.
// - The ring carries one plane at a time: a unit's K tiles, then its V
//   tiles, as 16-byte cp.async copies of the codes (half of K5's bytes)
//   two items ahead. q . k^T reads a K tile's raw codes (swizzled rows);
//   a V tile's codes are converted by the threads that copied them into a
//   bf16 stage (K6q's staging) for ldmatrix.trans; a K tile brings rows
//   0-1 of its pages' scale tiles (k and v scales). A split is at most kMaxChunk keys, and
//   its page ids are loaded once, before the first copy: no tile waits on
//   a block-table read. The unit's scores wait in shared memory (each
//   thread its own) for its maximum, and its p maxima are exchanged as the
//   tile maxima are. Only the splits holding a visible key run (the
//   others return at once); a single one writes the outputs, more the
//   last of them merges (K5q's own epilogue, paged_decode_int8_finish).
#pragma once

#include "int8_stage.cuh"

namespace {

namespace k5 {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;    // keys per tile; warp w takes keys 16w .. 16w + 15
constexpr int kRows = 16;  // query heads a block (one m16 tile)
constexpr int kUnitTiles = 4;   // INT8: tiles of a unit at most (a 256-key page)
constexpr int kScaleTiles = 8;  // INT8: scale slots, one a tile
constexpr int kMaxChunk = 1024;  // INT8: keys of a split at most
constexpr int kMaxPages = kMaxChunk / 16 + 1;  // INT8: pages of a split at most

template <int D, bool kI8 = false>
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

// INT8 pages (K5q): the q codes (int8, swizzled rows); two bf16 stages of
// a V tile; three raw stages of one plane's codes (a K tile is read from
// its raw stage); the k and v scales ([2][kBK] f32) of kScaleTiles tiles;
// the page ids of the split; the unit's tile maxima, its p maxima per (tile, 8-key
// group, row), the rows' sq * scale; then the unit's scores, each
// thread's own ([unit tiles][8][kThreads] f32, sized at launch)
template <int D>
struct Smem<D, true> {
  static constexpr int kQ = kRows * D;
  static constexpr int kK = kBK * D * 2;  // a bf16 stage
  static constexpr int kRaw = kBK * D;    // a raw stage
  static constexpr int oRing = kQ;
  static constexpr int oRaw = oRing + 2 * kK;
  static constexpr int oSc = oRaw + 3 * kRaw;
  static constexpr int oPid = oSc + kScaleTiles * 2 * kBK * 4;
  static constexpr int oMax = oPid + (kMaxPages + 3) / 4 * 16;
  static constexpr int oPm = oMax + kWarps * kRows * 4;
  static constexpr int oL = oPm + kUnitTiles * 8 * kRows * 4;
  static constexpr int oM = oL + kWarps * kRows * 4;
  static constexpr int oQm = oM + kRows * 4;
  static constexpr int oFlag = oQm + kRows * 4;
  static constexpr int oS = oFlag + 16;
  static constexpr size_t bytes(int unit_tiles) {
    return oS + (size_t)unit_tiles * 8 * kThreads * 4;
  }
  static_assert(kWarps * kRows * D * 4 <= 2 * kK, "the warps' outputs fit the bf16 stages");
};

template <int D>
__device__ __forceinline__ void paged_decode_int8_tiles(
    unsigned char* smem, const bf16* __restrict__ q, const int8_t* __restrict__ k_pages,
    const int8_t* __restrict__ v_pages, const float* __restrict__ kv_scales,
    const int* __restrict__ bt, Range rg, int t_begin, int n_tiles, int b, int Hq, int Hkv,
    int h, int hq0, int nrows, int page, size_t lp, int length, float scale, float softcap,
    const float (&slope)[2], float (&o)[D / 8][4], float (&m)[2], float (&l)[2]) {
  using L = Smem<D, true>;
  constexpr int kNT = D / 8;
  constexpr int kCPR = D / 16;  // 16-byte chunks of a code row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t qs = smem_u32(smem);
  int* pid = reinterpret_cast<int*>(smem + L::oPid);
  const float* sc_ring = reinterpret_cast<const float*>(smem + L::oSc);
  float* smax = reinterpret_cast<float*>(smem + L::oMax);
  float* pmx = reinterpret_cast<float*>(smem + L::oPm);
  float* qm = reinterpret_cast<float*>(smem + L::oQm);
  float* sbuf = reinterpret_cast<float*>(smem + L::oS) + tid;  // this thread's scores

  // the q rows of the warp, loaded first: their latency overlaps the page ids'
  float qv[kRows / kWarps][D / 32];
#pragma unroll
  for (int k = 0; k < kRows / kWarps; ++k) {
    const int r = warp + kWarps * k;
#pragma unroll
    for (int e = 0; e < D / 32; ++e)
      qv[k][e] = r < nrows ? bf2f(q[((size_t)b * Hq + hq0 + r) * D + lane + 32 * e]) : 0.f;
  }

  // the page ids of the split's pages, loaded once (pages are a power of
  // two: key t is row t & (page - 1) of page pid[(t >> sh) - fp])
  const int sh = 31 - __clz(page), fp = t_begin >> sh;
  const int n_pages = n_tiles > 0 ? ((rg.hi - 1) >> sh) - fp + 1 : 0;
  const int pid0 = tid < n_pages ? bt[fp + tid] : 0;
  // units: page-aligned runs of tiles (one tile where page <= kBK); items:
  // a unit's K tiles, then its V tiles
  const int us = max(sh - 6, 0), per_unit = 1 << us;  // tiles a unit (kBK = 2^6)
  const int n1 = min(n_tiles, per_unit - ((t_begin >> 6) & (per_unit - 1)));  // first unit's
  const int n_items = 2 * n_tiles;
  auto item = [&](int i) {  // 2 * tile + plane (0: K, 1: V) of item i
    int a = 0, nt = n1;
    if (i >= 2 * n1) {
      a = n1 + (((i - 2 * n1) >> (us + 1)) << us);
      nt = min(per_unit, n_tiles - a);
      i -= 2 * a;
    }
    return i < nt ? 2 * (a + i) : 2 * (a + i - nt) + 1;
  };
  // copy item i's codes into raw stage i % 3 (swizzled rows of D bytes;
  // zero-filled at or past rg.hi); a K item also brings its keys' k and v
  // scales (threads 0-63 the k scales, 64-127 the v scales) into its tile's
  // slot. This thread copies rows r0 + kRS k, chunk ch (the same swizzle for
  // every k); a plane's codes of kv head h start at h_off, a page's at p_off
  // further; the thread's scale row at s_off
  constexpr int kRS = kThreads / kCPR, kPer = kBK / kRS;  // rows apart, chunks a thread
  const int r0 = tid / kCPR, ch = tid % kCPR;
  const uint32_t dst0 = swz8<D>(r0, ch);
  const int T = Hkv * page;  // a scale tile's row
  const int p_off = T * D;
  const size_t h_off = (lp * Hkv + h) * page * D + ch * 16;
  const size_t s_off = (lp * 8 + tid / kBK) * T + (size_t)h * page;
  const int8_t* kh = k_pages + h_off;
  const int8_t* vh = v_pages + h_off;
  auto load_raw = [&](int i) {
    const int it = item(i), t0 = t_begin + (it >> 1) * kBK;
    const int8_t* src = (it & 1) ? vh : kh;
    const uint32_t raw = qs + L::oRaw + (i % 3) * L::kRaw + dst0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int t = t0 + r0 + kRS * k;
      const bool ok = t < rg.hi;
      const int8_t* from =
          ok ? src + (size_t)pid[(t >> sh) - fp] * p_off + (t & (page - 1)) * D : src;
      cp_async16(raw + kRS * k * D, from, ok);
    }
    if (!(it & 1)) {
      const int t = t0 + tid % kBK;
      const bool ok = t < rg.hi;
      const size_t off = ok ? s_off + (size_t)pid[(t >> sh) - fp] * 8 * T + (t & (page - 1)) : 0;
      cp_async4(qs + L::oSc + (((it >> 1) % kScaleTiles) * 2 * kBK + tid) * 4, kv_scales + off,
                ok);
    }
  };
  // the chunks of V item i this thread copied, converted into bf16 stage
  // i & 1 (K tiles are read as int8 codes)
  auto convert = [&](int i) {
    const unsigned char* raw = smem + L::oRaw + (i % 3) * L::kRaw + dst0;
    unsigned char* dst = smem + L::oRing + (i & 1) * L::kK;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = r0 + kRS * k;
      const uint4 w = *reinterpret_cast<const uint4*>(raw + kRS * k * D);
      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * ch)) = codes_bf16(w.x, w.y);
      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * ch + 1)) = codes_bf16(w.z, w.w);
    }
  };
  // q -> int8 codes per (slot, head): sq = max(max|q|, 1e-30) / 127, a warp a
  // row; rows past nrows are zeros
  int8_t* qt = reinterpret_cast<int8_t*>(smem);
#pragma unroll
  for (int k = 0; k < kRows / kWarps; ++k) {
    const int r = warp + kWarps * k;
    if (r >= nrows) {
#pragma unroll
      for (int e = 0; e < D / 32; ++e) qt[swz8<D>(r, (lane + 32 * e) >> 4) + (lane & 15)] = 0;
      if (lane == 0) qm[r] = 0.f;
      continue;
    }
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) amax = fmaxf(amax, fabsf(qv[k][e]));
    const float sq = __fdiv_rn(fmaxf(warp_max(amax), 1e-30f), 127.f);
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      const int d = lane + 32 * e;
      qt[swz8<D>(r, d >> 4) + (d & 15)] =
          static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(qv[k][e], sq)), -127.f), 127.f));
    }
    if (lane == 0) qm[r] = sq * scale;
  }
  if (tid < n_pages) pid[tid] = pid0;
  __syncthreads();  // the page ids; the q codes and scales
  const float qmul[2] = {qm[g], qm[g + 8]};
  if (n_items > 0) load_raw(0);
  cp_async_commit();
  if (n_items > 1) load_raw(1);
  cp_async_commit();

  // an item's start: its codes (a V item's in bf16) are whole and item i -
  // 1's stages are consumed; item i + 2's codes are copied meanwhile
  auto begin_item = [&](int i) {
    if (i == 0) cp_async_wait1();  // this thread's copies of item 0 landed
    __syncthreads();
    if (i + 2 < n_items) load_raw(i + 2);
    cp_async_commit();
  };
  auto end_item = [&](int i) {
    cp_async_wait1();  // this thread's copies of item i + 1 landed
    if (i + 1 < n_items && (item(i + 1) & 1)) convert(i + 1);
  };
  const int qrow = ((lane >> 3) & 1) * 8 + (lane & 7);  // ldmatrix rows of the q tile
  const int qchunk = lane >> 4;
  // 8-key groups of one page inside a tile, and the warp's first (page <= kBK)
  const int gk = min(page, kBK) / 8, c0 = (2 * warp) / gk * gk;

  int i = 0;
  for (int a = 0; a < n_tiles;) {
    const int nt = a == 0 ? n1 : min(per_unit, n_tiles - a);
    float mx[2] = {QTT_NEG_INF, QTT_NEG_INF};
    // the unit's K tiles: exact int8 scores of the warp's 16 keys of each
    // (m16n8k32 on the codes), scaled, softcapped, biased and masked as
    // K5's, into the unit's buffer
    for (int jj = 0; jj < nt; ++jj, ++i) {
      begin_item(i);
      const int j = a + jj, t0 = t_begin + j * kBK;
      const uint32_t kr = qs + L::oRaw + (i % 3) * L::kRaw;
      int si[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t qa[4], kb[4];
        ldsm_x4(qa, qs + swz8<D>(qrow, 2 * kk + qchunk));
        ldsm_x4(kb, kr + swz8<D>(warp * 16 + (lane >> 4) * 8 + (lane & 7),
                                 2 * kk + ((lane >> 3) & 1)));
        mma16832(si[0], qa, kb[0], kb[1]);
        mma16832(si[1], qa, kb[2], kb[3]);
      }
      const float* ksc = sc_ring + (j % kScaleTiles) * 2 * kBK + warp * 16 + 2 * tq;
#pragma unroll
      for (int nt8 = 0; nt8 < 2; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + warp * 16 + nt8 * 8 + 2 * tq + (e & 1);
          float sc = (float)si[nt8][e] * qmul[e >> 1] * ksc[nt8 * 8 + (e & 1)];
          if (softcap > 0.f) sc = softcap * tanhf(sc * (1.0f / softcap));
          sc += slope[e >> 1] * (float)(t - (length - 1));
          sc = t >= rg.lo && t < rg.hi ? sc : QTT_NEG_INF;
          sbuf[(jj * 8 + nt8 * 4 + e) * kThreads] = sc;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc);
        }
      end_item(i);
    }
    // the unit's row maxima of all four warps
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
    if (tq == 0) {
      smax[warp * kRows + g] = mx[0];
      smax[warp * kRows + g + 8] = mx[1];
    }
    __syncthreads();
    float mn[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = smax[g + 8 * hh];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, smax[w * kRows + g + 8 * hh]);
      mn[hh] = fmaxf(m[hh], tm);
      alpha[hh] = expf(m[hh] - mn[hh]);
      m[hh] = mn[hh];
      l[hh] *= alpha[hh];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row's max moved
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
    // p on visible keys (l sums it), then p * v_scale, whose maxima per
    // (tile, 8-key group, row) go to shared memory
    for (int jj = 0; jj < nt; ++jj) {
      const float* vsc = sc_ring + ((a + jj) % kScaleTiles) * 2 * kBK + kBK + warp * 16 + 2 * tq;
#pragma unroll
      for (int nt8 = 0; nt8 < 2; ++nt8) {
        float pm[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* sp = sbuf + (jj * 8 + nt8 * 4 + e) * kThreads;
          const float p = *sp == QTT_NEG_INF ? 0.f : expf(*sp - mn[e >> 1]);
          psum[e >> 1] += p;
          const float x = p * vsc[nt8 * 8 + (e & 1)];
          *sp = x;
          pm[e >> 1] = fmaxf(pm[e >> 1], fabsf(x));
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          pm[hh] = fmaxf(pm[hh], __shfl_xor_sync(0xffffffffu, pm[hh], 1));
          pm[hh] = fmaxf(pm[hh], __shfl_xor_sync(0xffffffffu, pm[hh], 2));
          if (tq == 0) pmx[(jj * 8 + 2 * warp + nt8) * kRows + g + 8 * hh] = pm[hh];
        }
      }
    }
    l[0] += psum[0];  // the lane's part; the quad adds them at the end
    l[1] += psum[1];
    // the unit's V tiles: p8 = rint(p v_scale / ps) per (row, page), then
    // o += (p8 . v8) ps over the warp's 16 keys
    float ps[2];
    for (int jj = 0; jj < nt; ++jj, ++i) {
      begin_item(i);  // also: every warp's p maxima are in shared memory
      if (jj == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pm = 0.f;
          for (int u = 0; u < nt; ++u)
            for (int cg = c0; cg < c0 + gk; ++cg)
              pm = fmaxf(pm, pmx[(u * 8 + cg) * kRows + g + 8 * hh]);
          ps[hh] = __fdiv_rn(fmaxf(pm, 1e-30f), 127.f);
        }
      }
      float c8[2][4];
#pragma unroll
      for (int nt8 = 0; nt8 < 2; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c8[nt8][e] = fminf(fmaxf(rintf(__fdiv_rn(sbuf[(jj * 8 + nt8 * 4 + e) * kThreads],
                                                   ps[e >> 1])), -127.f), 127.f);
      uint32_t pa[4];
      pa[0] = pack_bf16(c8[0][0], c8[0][1]);
      pa[1] = pack_bf16(c8[0][2], c8[0][3]);
      pa[2] = pack_bf16(c8[1][0], c8[1][1]);
      pa[3] = pack_bf16(c8[1][2], c8[1][3]);
      const uint32_t vs = qs + L::oRing + (i & 1) * L::kK;
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + swz<D>(warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                  2 * np + (lane >> 4)));
        float c0v[4] = {0.f, 0.f, 0.f, 0.f}, c1v[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(c0v, pa, vb[0], vb[1]);
        mma16816(c1v, pa, vb[2], vb[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[2 * np][e] = fmaf(c0v[e], ps[e >> 1], o[2 * np][e]);
          o[2 * np + 1][e] = fmaf(c1v[e], ps[e >> 1], o[2 * np + 1][e]);
        }
      }
      end_item(i);
    }
    a += nt;
  }
}

// K5q's epilogue: the four warps' parts of the block's rows summed through
// shared memory (rows past nrows skipped, rows padded against bank
// conflicts); with one live split the block writes the rows' outputs
// itself, else its partial, and the last of the nwait live blocks, splits
// first .. first + nwait - 1, merges them in split order (K5's merge)
template <int D>
__device__ __forceinline__ void paged_decode_int8_finish(
    unsigned char* smem, const float (&o)[D / 8][4], const float (&m)[2], float (&l)[2],
    int nrows, int first, int nwait, int sp, int splits, size_t row0, bf16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int* __restrict__ cnt) {
  using L = Smem<D, true>;
  constexpr int kNT = D / 8, kLd = D + 8, kDPL = D / 32;
  static_assert(kWarps * kRows * kLd * 4 <= L::oSc - L::oRing, "the warps' parts fit the stages");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  float* red = reinterpret_cast<float*>(smem + L::oRing);  // [kWarps][kRows][kLd]
  float* lsum = reinterpret_cast<float*>(smem + L::oL);   // [kWarps][kRows]
  float* mrow = reinterpret_cast<float*>(smem + L::oM);
  int* flag = reinterpret_cast<int*>(smem + L::oFlag);
  cp_async_wait_all();
  __syncthreads();  // the stages are free
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int r = g + 8 * hh;
    if (r >= nrows) continue;
#pragma unroll
    for (int i = 0; i < kNT; ++i)
      *reinterpret_cast<float2*>(red + (warp * kRows + r) * kLd + 8 * i + 2 * tq) =
          make_float2(o[i][2 * hh], o[i][2 * hh + 1]);
    if (tq == 0) {
      lsum[warp * kRows + r] = l[hh];
      if (warp == 0) mrow[r] = m[hh];
    }
  }
  __syncthreads();
  // a thread 4 dims of a row, the warps' parts added in warp order
  for (int c = tid; c < nrows * (D / 4); c += kThreads) {
    const int r = c / (D / 4), d = (c % (D / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(red + r * kLd + d);
    float lr = lsum[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(red + (w * kRows + r) * kLd + d);
      v = make_float4(v.x + x.x, v.y + x.y, v.z + x.z, v.w + x.w);
      lr += lsum[w * kRows + r];
    }
    const size_t row = row0 + r;
    if (nwait == 1) {
      const float inv = lr == 0.f ? 1.f : lr;
      __nv_bfloat162* o_row = reinterpret_cast<__nv_bfloat162*>(out + row * D + d);
      o_row[0] = __floats2bfloat162_rn(v.x / inv, v.y / inv);
      o_row[1] = __floats2bfloat162_rn(v.z / inv, v.w / inv);
    } else {
      *reinterpret_cast<float4*>(part_acc + (row * splits + sp) * D + d) = v;
      if (d == 0)
        *reinterpret_cast<float2*>(part_ml + (row * splits + sp) * 2) = make_float2(mrow[r], lr);
    }
  }
  if (nwait == 1) return;
  // the last live block of this (slot, head group) to finish merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(cnt, 1);
    *flag = done == nwait - 1;
    if (*flag) *cnt = 0;  // every live block has counted: ready for the next launch
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // O = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s, over
  // the live splits in order; a warp a row
  for (int r = warp; r < nrows; r += kWarps) {
    const size_t row = row0 + r;
    const float2* ml = reinterpret_cast<const float2*>(part_ml) + row * splits + first;
    float M = QTT_NEG_INF;
    for (int s2 = lane; s2 < nwait; s2 += 32) M = fmaxf(M, __ldcg(ml + s2).x);
    M = warp_max(M);
    float lt = 0.f, acc[kDPL];
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[e] = 0.f;
    for (int s0 = 0; s0 < nwait; s0 += 32) {
      float w = 0.f, lw = 0.f;
      if (s0 + lane < nwait) {
        const float2 v = __ldcg(ml + s0 + lane);
        w = expf(v.x - M);
        lw = v.y * w;
      }
      const int n = min(32, nwait - s0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {  // in split order
        const float wj = __shfl_sync(0xffffffffu, w, j);
        lt += __shfl_sync(0xffffffffu, lw, j);
        const float* pa = part_acc + (row * splits + first + s0 + j) * D + lane * kDPL;
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

template <int D, bool kDense, bool kI8 = false>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const bf16* __restrict__ q,
                          const typename PageCode<kI8>::T* __restrict__ k_pages,
                          const typename PageCode<kI8>::T* __restrict__ v_pages,
                          const int* __restrict__ block_table,
                          const int* __restrict__ lengths, const float* __restrict__ slopes,
                          bf16* __restrict__ out, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int* __restrict__ counters, int Hq,
                          int Hkv, int gq, int ht_bits, int page, int P, int n_pt, int layer,
                          int chunk, float scale, int window, float softcap,
                          const float* __restrict__ kv_scales) {
  static_assert(!(kDense && kI8), "INT8 pages are paged");
  using L = Smem<D, kI8>;
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
  // the blocks of this (slot, head group) that count before the merge: all
  // splits; INT8, only the splits holding a visible key (one, split 0, where
  // none does: it writes the zeros), the others having nothing to do
  int nwait = splits;
  if constexpr (kI8) {
    const int first = wlo < end ? wlo / chunk : 0;
    nwait = wlo < end ? (end - 1) / chunk - first + 1 : 1;
    if (sp < first || sp >= first + nwait) return;
  }
  const int* bt = kDense ? nullptr : block_table + (size_t)b * n_pt;
  const size_t lp = (size_t)layer * P;

  // the page id of key tid of tile i (0 past the range: never read); a
  // dense cache is slot b's one page
  auto page_of = [&](int i) {
    const int t = t_begin + i * kBK + tid;
    return t < rg.hi ? (kDense ? b : bt[t / page]) : 0;
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
          ok ? (((lp + ids[j]) * Hkv + h) * page + (kDense ? t0 + j : (t0 + j) % page)) * D +
                   ch * 8
             : 0;
      cp_async16(ks + swz<D>(j, ch), k_pages + off, ok);
      cp_async16(vs + swz<D>(j, ch), v_pages + off, ok);
    }
  };
  if constexpr (!kI8) {
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
  }

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

  if constexpr (kI8) {
    paged_decode_int8_tiles<D>(smem, q, k_pages, v_pages, kv_scales, bt, rg, t_begin, n_tiles,
                               b, Hq, Hkv, h, hq0, nrows, page, lp, length, scale, softcap,
                               slope, o, m, l);
    paged_decode_int8_finish<D>(smem, o, m, l, nrows, wlo < end ? wlo / chunk : 0, nwait, sp,
                                splits, (size_t)b * Hq + hq0, out, part_acc, part_ml,
                                counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x);
    return;
  } else {
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
        ldsm_x4(kb, ks + swz<D>(warp * 16 + (lane >> 4) * 8 + (lane & 7),
                                2 * kk + ((lane >> 3) & 1)));
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
  if (nwait > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* cnt = counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
      const int done = atomicAdd(cnt, 1);
      *flag = done == nwait - 1;
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

// kv_scales: INT8 pages' scale tiles (kI8; null for bf16 pages)
template <int D, bool kDense, bool kI8 = false>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* lengths, const void* slopes, void* out,
                   void* part_acc, void* part_ml, void* counters, int B, int Hq, int Hkv,
                   int page, int P, int n_pt, int layer, int chunk, int splits, float scale,
                   int window, float softcap, cudaStream_t st, const void* kv_scales = nullptr) {
  using T = typename PageCode<kI8>::T;
  const auto kernel = paged_decode_split_kernel<D, kDense, kI8>;
  const size_t smem = kI8 ? Smem<D, true>::bytes(page > kBK ? page / kBK : 1)
                          : Smem<D>::kBytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int gq = Hq / Hkv, ht_bits = gq > kRows ? 1 : 0;  // gq <= 32: one or two groups
  dim3 grid(Hkv << ht_bits, B, splits);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), Hq, Hkv, gq, ht_bits, page, P, n_pt, layer, chunk, scale,
      window, softcap, static_cast<const float*>(kv_scales));
  return cudaGetLastError();
}

}  // namespace k5

}  // namespace
