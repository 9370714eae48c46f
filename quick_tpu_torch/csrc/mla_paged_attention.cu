// K10 / K10q: paged MLA decode attention (DeepSeek-V2 / V3) over the latent
// pages, bf16 pages (K10) or INT8 codes with their scale tiles (K10q).
//
// Replaces the Pallas kernel quick_tpu/ops/mla_paged_attention.py::
// _mla_paged_kernel (:41, launched by mla_paged_decode_attention through
// pallas_call :199), both of its branches (float pages, and INT8 pages
// :96-120). One kernel template over the page dtype, two instantiations;
// the wrapper counts them apart.
//
// What it computes. MLA caches one latent stream per token, shared by every
// query head (MQA): the rope'd k_pe [L, P, 1, page, DR] in the k plane and
// the normed latent c [L, P, 1, page, R] in the v plane, read at `layer`
// through block_table [B, n_pt]; lengths [B] count each slot's tokens, the
// current one included. For every query head, with the absorbed queries
// q_c [B, Hq, R] and q_pe [B, Hq, DR]:
//   s_t = (q_c . c_t + q_pe . k_pe_t) * scale, for t < length;
//   out = sum_t softmax(s)_t c_t, returned [B, Hq, R] in bf16.
// Softmax in f32, online over the tokens; p is rounded to bf16 before the
// p @ c product (the Pallas kernel's p.astype(c.dtype)); the running sum l
// keeps the unrounded p; a slot of length 0 returns 0 (l == 0 -> 1).
// INT8 pages: the codes convert exactly to bf16; with ks the page tile's
// row 0 (k_pe scales) and cs its row 1 (latent scales) at column `row`,
// s_t = (s_c * cs_t + s_pe * ks_t) * scale, and p_t is multiplied by cs_t
// BEFORE its bf16 rounding (:100, :115-120). q is not quantized (unlike
// K5q).
//
// What bounds it on the H100: bytes. Every valid token's latent and k_pe
// row is read once for all heads: (R + DR) * 2 bytes a token in bf16 (1152
// B), R + DR bytes plus two f32 scales in INT8 (584 B); q and out are small.
// At the Engine's decode (16 slots, up to 1024 tokens) that is at most
// 18.9 MB, 5.6 us at 3.35 TB/s.
//
// Design: a tensor-core key split. All heads share each token (MQA), so a
// block stages each token's rows once for a group of 16 query heads (one
// m16 tile; a grid over heads would read the latent 16 times). Blocks run
// over (split, slot, 16-head group), a partial last group where Hq is no
// multiple of 16; the split comes from the shapes
// (ops/mla_paged_attention.py::split_plan), each block clipping its chunk
// to the slot's length read on the card (a captured step replays it). The
// q_c and q_pe rows of the group wait in shared memory in bf16, beside the
// split's page ids (loaded once; a split spans at most kMaxPages pages and
// 1,024 tokens). Tiles of 64 tokens:
//  - K10 (bf16 pages, any page size) copies the latent and k_pe rows
//    straight into swizzled bf16 tiles with 16-byte cp.async, a two-stage
//    ring one tile ahead (2 x 73.7 KB); each tile's rows in the page stacks
//    come from a table that 64 threads fill two tiles ahead from the page
//    ids (one division by the page a token);
//  - K10q (INT8 pages, a power of two of 16 or more) copies raw codes (512
//    latent and 64 k_pe bytes a token, rows 0-1 of the pages' scale tiles
//    beside them) two tiles ahead through a two-stage ring, and each
//    thread converts the chunks it copied, exactly, into the tile's bf16
//    rows (one stage: 73.7 KB beside the 73.7 KB ring).
// Scores: s_c = q_c c^T and s_pe = q_pe k_pe^T on mma.sync m16n8k16, each
// warp 16 tokens, then s = (s_c + s_pe) scale, or (s_c cs + s_pe ks) scale
// on INT8 pages, per token. The tile's row maxima go through shared memory;
// l keeps the unrounded p; p (p cs on INT8 pages) is rounded to bf16 into a
// [16 x 64] tile, the A operand of the context [16 x 64] x [64 x 512]: each
// warp owns 128 of the 512 output columns over all 64 tokens, c read with
// ldmatrix.trans. Only the splits that hold a token of the slot work; where
// one does, its block writes the output from registers, otherwise the last
// live block to finish (an atomic counter it resets) merges the splits'
// partials in split order, staging them in its ring four splits at a time:
// the output does not depend on block scheduling. Not carried over from the
// TPU: the page-pair grid steps with clamped index maps (a block walks its
// own tokens) and the [Hq, R] x [R, page] dots over whole pages (64-token
// tiles of m16n8k16 products).
#include "int8_stage.cuh"

namespace {

namespace k10q {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;    // tokens a tile; warp w scores tokens 16w .. 16w + 15
constexpr int kRows = 16;  // query heads a block (one m16 tile)
constexpr int kMergeSplits = 4;  // splits' partials staged at a time by the merge
constexpr int kMaxChunk = 1024;  // tokens of a split at most
constexpr int kMaxPages = kMaxChunk / 16 + 2;  // pages of a split at most

// K10q's layout (INT8 pages)
template <int R, int DR, bool kI8>
struct Smem {
  static constexpr int kQc = kRows * R * 2;    // the q_c rows in bf16, swizzled
  static constexpr int kQp = kRows * DR * 2;   // the q_pe rows
  static constexpr int kC = kBK * R * 2;       // the tile's latent rows in bf16, swizzled
  static constexpr int kPe = kBK * DR * 2;     // its k_pe rows
  static constexpr int kRaw = kBK * (R + DR);  // a raw stage: latent codes, then k_pe codes
  static constexpr int oQp = kQc;
  static constexpr int oC = oQp + kQp;
  static constexpr int oPe = oC + kC;
  static constexpr int oRaw = oPe + kPe;
  static constexpr int oSc = oRaw + 2 * kRaw;          // [3][2][kBK] f32: ks, cs of three tiles
  static constexpr int oPid = oSc + 3 * 2 * kBK * 4;   // [kMaxPages] the split's page ids
  static constexpr int oP = oPid + (kMaxPages + 3) / 4 * 16;  // p cs [kRows][kBK] bf16, swizzled
  static constexpr int oMax = oP + kRows * kBK * 2;    // [kWarps][kRows] tile maxima
  static constexpr int oL = oMax + kWarps * kRows * 4;  // [kWarps][kRows] row sums
  static constexpr int oFlag = oL + kWarps * kRows * 4;
  static constexpr size_t kBytes = oFlag + 16;
  static_assert((size_t)kMergeSplits * kRows * R * 4 <= (size_t)oSc - oC,
                "the merge's staged partials fit the tile stages");
};

// K10's layout (bf16 pages): a two-stage ring of bf16 tiles
template <int R, int DR>
struct Smem<R, DR, false> {
  static constexpr int kQc = kRows * R * 2;
  static constexpr int kQp = kRows * DR * 2;
  static constexpr int kC = kBK * R * 2;
  static constexpr int kStage = kC + kBK * DR * 2;  // a stage: latent rows, then k_pe rows
  static constexpr int oQp = kQc;
  static constexpr int oC = oQp + kQp;              // stage s at oC + s * kStage
  static constexpr int oPe = oC + kC;
  static constexpr int oRow = oC + 2 * kStage;      // [2][kBK] the tiles' rows in the stacks
  static constexpr int oPid = oRow + 2 * kBK * 4;
  static constexpr int oP = oPid + (kMaxPages + 3) / 4 * 16;
  static constexpr int oMax = oP + kRows * kBK * 2;
  static constexpr int oL = oMax + kWarps * kRows * 4;
  static constexpr int oFlag = oL + kWarps * kRows * 4;
  static constexpr size_t kBytes = oFlag + 16;
  static_assert((size_t)kMergeSplits * kRows * R * 4 <= (size_t)oRow - oC,
                "the merge's staged partials fit the tile stages");
};

template <int R, int DR, bool kI8>
__global__ void __launch_bounds__(kThreads)
mla_split_kernel(const bf16* __restrict__ q_c, const bf16* __restrict__ q_pe,
                 const typename PageCode<kI8>::T* __restrict__ kpe_pages,
                 const typename PageCode<kI8>::T* __restrict__ c_pages,
                 const float* __restrict__ kv_scales, const int* __restrict__ block_table,
                 const int* __restrict__ lengths, bf16* __restrict__ out,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int* __restrict__ counters, int Hq, int P, int page, int n_pt, int layer,
                 int chunk, float scale) {
  using L = Smem<R, DR, kI8>;
  constexpr int kNT = R / kWarps / 8;  // n8 tiles of a warp's 128 output columns
  const int sp = blockIdx.x, b = blockIdx.y, hg = blockIdx.z;
  const int splits = gridDim.x;
  const int h0 = hg * kRows, nrows = min(kRows, Hq - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  int* pid = reinterpret_cast<int*>(smem + L::oPid);
  const float* sc_ring = nullptr;  // K10q: ks, cs of three tiles
  if constexpr (kI8) sc_ring = reinterpret_cast<const float*>(smem + L::oSc);
  float* smax = reinterpret_cast<float*>(smem + L::oMax);
  float* lsum = reinterpret_cast<float*>(smem + L::oL);
  int* flag = reinterpret_cast<int*>(smem + L::oFlag);

  // the splits holding a token of the slot: 0 .. nlive - 1 (one, split 0,
  // where none does: it writes the zeros); the others have nothing to do
  const int end = max(0, min(lengths[b], n_pt * page));
  const int nlive = end > 0 ? (end - 1) / chunk + 1 : 1;
  if (sp >= nlive) return;
  const bool direct = nlive == 1;
  const int t_begin = sp * chunk, t_end = min(end, t_begin + chunk);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kBK - 1) / kBK : 0;
  const int* bt = block_table + (size_t)b * n_pt;
  const size_t lp = (size_t)layer * P;

  // the page ids of the split's pages, loaded once: token t lies in row
  // t % page of page pid[t / page - fp] (INT8 pages are a power of two:
  // row t & (page - 1) of pid[(t >> sh) - fp])
  const int sh = 31 - __clz(page);
  const int fp = kI8 ? t_begin >> sh : t_begin / page;
  const int n_pages = n_tiles > 0 ? (kI8 ? (t_end - 1) >> sh : (t_end - 1) / page) - fp + 1 : 0;
  const int pid0 = tid < n_pages ? bt[fp + tid] : 0;
  // K10q: token t's row in the page stacks (one kv head)
  auto row_of = [&](int t) { return (lp + pid[(t >> sh) - fp]) * page + (t & (page - 1)); };
  // K10q: copy tile i's codes into raw stage i & 1 (zero-filled at or past
  // t_end) and its tokens' ks / cs (threads 0-63 / 64-127) into scale slot
  // i % 3. K10: copy tile i's bf16 rows into ring stage i & 1, at the rows
  // of table i & 1 (zero-filled at or past t_end)
  auto load = [&](int i) {
    const int t0 = t_begin + i * kBK;
    if constexpr (kI8) {
      const uint32_t raw = qs + L::oRaw + (i & 1) * L::kRaw;
      for (int c = tid; c < kBK * (R / 16); c += kThreads) {
        const int r = c / (R / 16), ch = c % (R / 16);
        const bool ok = t0 + r < t_end;
        const size_t off = ok ? row_of(t0 + r) * R + ch * 16 : 0;
        cp_async16(raw + r * R + ch * 16, c_pages + off, ok);
      }
      for (int c = tid; c < kBK * (DR / 16); c += kThreads) {
        const int r = c / (DR / 16), ch = c % (DR / 16);
        const bool ok = t0 + r < t_end;
        const size_t off = ok ? row_of(t0 + r) * DR + ch * 16 : 0;
        cp_async16(raw + kBK * R + r * DR + ch * 16, kpe_pages + off, ok);
      }
      const int t = t0 + tid % kBK;
      const bool ok = t < t_end;
      const size_t off = ok ? ((lp + pid[(t >> sh) - fp]) * 8 + tid / kBK) * page +
                                  (t & (page - 1))
                            : 0;
      cp_async4(qs + L::oSc + ((i % 3) * 2 * kBK + tid) * 4, kv_scales + off, ok);
    } else {
      const uint32_t st = qs + L::oC + (i & 1) * L::kStage;
      const uint32_t* rows = reinterpret_cast<const uint32_t*>(smem + L::oRow) + (i & 1) * kBK;
      for (int c = tid; c < kBK * (R / 8); c += kThreads) {
        const int r = c / (R / 8), ch = c % (R / 8);
        cp_async16(st + swz<R>(r, ch), c_pages + (size_t)rows[r] * R + ch * 8, t0 + r < t_end);
      }
      for (int c = tid; c < kBK * (DR / 8); c += kThreads) {
        const int r = c / (DR / 8), ch = c % (DR / 8);
        cp_async16(st + L::kC + swz<DR>(r, ch), kpe_pages + (size_t)rows[r] * DR + ch * 8,
                   t0 + r < t_end);
      }
    }
  };
  // K10: token j of tile i's row in the page stacks into table i & 1 (0
  // at or past t_end: its copy is zero-filled)
  auto set_row = [&](int i, int j) {
    if constexpr (!kI8) {
      const int t = t_begin + i * kBK + j;
      uint32_t row = 0;
      if (t < t_end) {
        const int pg = t / page;
        row = static_cast<uint32_t>((lp + pid[pg - fp]) * page + (t - pg * page));
      }
      reinterpret_cast<uint32_t*>(smem + L::oRow)[(i & 1) * kBK + j] = row;
    }
  };
  // K10q: the chunks of tile i this thread copied, converted into the bf16 rows
  auto convert = [&](int i) {
    if constexpr (kI8) {
      const unsigned char* raw = smem + L::oRaw + (i & 1) * L::kRaw;
      for (int c = tid; c < kBK * (R / 16); c += kThreads) {
        const int r = c / (R / 16), ch = c % (R / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(raw + r * R + ch * 16);
        *reinterpret_cast<uint4*>(smem + L::oC + swz<R>(r, 2 * ch)) = codes_bf16(w.x, w.y);
        *reinterpret_cast<uint4*>(smem + L::oC + swz<R>(r, 2 * ch + 1)) = codes_bf16(w.z, w.w);
      }
      for (int c = tid; c < kBK * (DR / 16); c += kThreads) {
        const int r = c / (DR / 16), ch = c % (DR / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(raw + kBK * R + r * DR + ch * 16);
        *reinterpret_cast<uint4*>(smem + L::oPe + swz<DR>(r, 2 * ch)) = codes_bf16(w.x, w.y);
        *reinterpret_cast<uint4*>(smem + L::oPe + swz<DR>(r, 2 * ch + 1)) = codes_bf16(w.z, w.w);
      }
    }
  };
  // the group's q rows in bf16; rows past nrows are zeros
  for (int c = tid; c < kRows * (R / 8); c += kThreads) {
    const int r = c / (R / 8), ch = c % (R / 8);
    const bool ok = r < nrows;
    cp_async16(qs + swz<R>(r, ch), q_c + (ok ? ((size_t)b * Hq + h0 + r) * R + ch * 8 : 0), ok);
  }
  for (int c = tid; c < kRows * (DR / 8); c += kThreads) {
    const int r = c / (DR / 8), ch = c % (DR / 8);
    const bool ok = r < nrows;
    cp_async16(qs + L::oQp + swz<DR>(r, ch),
               q_pe + (ok ? ((size_t)b * Hq + h0 + r) * DR + ch * 8 : 0), ok);
  }
  if (tid < n_pages) pid[tid] = pid0;
  __syncthreads();  // the page ids
  if constexpr (kI8) {
    if (n_tiles > 0) load(0);
    cp_async_commit();  // q and tile 0
    if (n_tiles > 1) load(1);
    cp_async_commit();
  } else {
    set_row(tid / kBK, tid % kBK);  // the tables of tiles 0 and 1
    __syncthreads();
    if (n_tiles > 0) load(0);
    cp_async_commit();  // q and tile 0
  }

  float o[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {QTT_NEG_INF, QTT_NEG_INF}, l[2] = {0.f, 0.f};
  const int qrow = ((lane >> 3) & 1) * 8 + (lane & 7);  // ldmatrix rows of q and p
  const int qchunk = lane >> 4;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kBK;
    // the tile's bf16 rows: K10q's one converted stage, K10's ring stage it & 1
    uint32_t c_st = qs + L::oC, pe_st = qs + L::oPe;
    if constexpr (kI8) {
      cp_async_wait1();  // this thread's copies of tile it (and q) landed
      __syncthreads();   // tile it - 1's products are done: its rows and p are free
      convert(it);
      if (it + 2 < n_tiles) load(it + 2);
      cp_async_commit();
      __syncthreads();  // the tile's bf16 rows (and q) are whole
    } else {
      cp_async_wait_all();  // this thread's copies of tile it (and q) landed
      __syncthreads();  // every thread's; tile it - 1's products are done: its stage is free
      if (it + 1 < n_tiles) load(it + 1);
      cp_async_commit();
      if (tid < kBK && it + 2 < n_tiles) set_row(it + 2, tid);  // table it & 1 is read
      c_st += (it & 1) * L::kStage;
      pe_st += (it & 1) * L::kStage;
    }
    // s_c and s_pe for the warp's 16 tokens: two n8 tiles each, even and
    // odd k steps in separate accumulators (shorter dependent chains)
    float sc[2][2][4] = {}, spe[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      uint32_t a[4], kb[4];
      ldsm_x4(a, qs + swz<R>(qrow, 2 * kk + qchunk));
      ldsm_x4(kb, c_st + swz<R>(warp * 16 + (lane >> 4) * 8 + (lane & 7),
                                2 * kk + ((lane >> 3) & 1)));
      mma16816(sc[kk & 1][0], a, kb[0], kb[1]);
      mma16816(sc[kk & 1][1], a, kb[2], kb[3]);
    }
#pragma unroll
    for (int kk = 0; kk < DR / 16; ++kk) {
      uint32_t a[4], kb[4];
      ldsm_x4(a, qs + L::oQp + swz<DR>(qrow, 2 * kk + qchunk));
      ldsm_x4(kb, pe_st + swz<DR>(warp * 16 + (lane >> 4) * 8 + (lane & 7),
                                  2 * kk + ((lane >> 3) & 1)));
      mma16816(spe[0], a, kb[0], kb[1]);
      mma16816(spe[1], a, kb[2], kb[3]);
    }
    // s = (s_c + s_pe) scale, on INT8 pages (s_c cs + s_pe ks) scale, the
    // Pallas order; register e of tile nt: row g + 8 * (e >> 1), token
    // t0 + 16 * warp + 8 * nt + 2 * tq + (e & 1)
    const float* scl = nullptr;  // K10q: ks [kBK], then cs [kBK]
    if constexpr (kI8) scl = sc_ring + (it % 3) * 2 * kBK;
    float s[2][4], mx[2] = {QTT_NEG_INF, QTT_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = warp * 16 + nt * 8 + 2 * tq + (e & 1);
        const float c = sc[0][nt][e] + sc[1][nt][e];
        float v;
        if constexpr (kI8)
          v = __fmul_rn(__fadd_rn(__fmul_rn(c, scl[kBK + j]), __fmul_rn(spe[nt][e], scl[j])),
                        scale);
        else
          v = __fmul_rn(__fadd_rn(c, spe[nt][e]), scale);
        s[nt][e] = t0 + j < t_end ? v : QTT_NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
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
    unsigned char* pt = smem + L::oP;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = smax[g + 8 * hh];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, smax[w * kRows + g + 8 * hh]);
      const float mn = fmaxf(m[hh], tm);
      const float alpha = expf(m[hh] - mn);
      m[hh] = mn;
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float pc[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float v = s[nt][2 * hh + k];
          const float p = v == QTT_NEG_INF ? 0.f : expf(v - mn);
          psum += p;  // l keeps the unrounded p
          if constexpr (kI8)
            pc[k] = p * scl[kBK + warp * 16 + nt * 8 + 2 * tq + k];
          else
            pc[k] = p;
        }
        *reinterpret_cast<uint32_t*>(pt + swz<kBK>(g + 8 * hh, 2 * warp + nt) + 4 * tq) =
            pack_bf16(pc[0], pc[1]);
      }
      l[hh] = l[hh] * alpha + psum;  // the lane's part; the quad adds them at the end
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        o[i][2 * hh] *= alpha;
        o[i][2 * hh + 1] *= alpha;
      }
    }
    __syncthreads();  // the tile's p (p cs) rows are whole
    // o += p c over the tile's 64 tokens, the warp's 128 columns
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + L::oP + swz<kBK>(qrow, 2 * kk + qchunk));
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, c_st + swz<R>(16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7),
                                    warp * (kNT) + 2 * np + (lane >> 4)));
        mma16816(o[2 * np], a, vb[0], vb[1]);
        mma16816(o[2 * np + 1], a, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait_all();

  // the rows' sums: the quads', then the four warps' in warp order
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  if (tq == 0) {
    lsum[warp * kRows + g] = l[0];
    lsum[warp * kRows + g + 8] = l[1];
  }
  __syncthreads();
  float lt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lt[hh] = lsum[g + 8 * hh];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) lt[hh] += lsum[w * kRows + g + 8 * hh];
  }
  // register e of o[i]: row g + 8 * (e >> 1), column 128 * warp + 8i + 2tq + (e & 1)
  const int col = warp * (R / kWarps) + 2 * tq;
  if (direct) {  // the one live split: the rows' outputs from registers
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh;
      if (r >= nrows) continue;
      const float inv = lt[hh] == 0.f ? 1.f : lt[hh];
      bf16* o_row = out + ((size_t)b * Hq + h0 + r) * R + col;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
        *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * i) =
            __floats2bfloat162_rn(o[i][2 * hh] / inv, o[i][2 * hh + 1] / inv);
    }
    return;
  }
  // this split's partial (m, l, acc) of each row
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    if (r >= nrows) continue;
    const size_t pr = ((size_t)b * Hq + h0 + r) * splits + sp;
    float* pa = part_acc + pr * R + col;
#pragma unroll
    for (int i = 0; i < kNT; ++i)
      *reinterpret_cast<float2*>(pa + 8 * i) = make_float2(o[i][2 * hh], o[i][2 * hh + 1]);
    if (warp == 0 && tq == 0)
      *reinterpret_cast<float2*>(part_ml + pr * 2) = make_float2(m[hh], lt[hh]);
  }
  // the last live block of this (slot, head group) to finish merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + (size_t)b * gridDim.z + hg;
    const int done = atomicAdd(cnt, 1);
    *flag = done == nlive - 1;
    if (*flag) *cnt = 0;  // every live block has counted: ready for the next launch
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // O = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s, over
  // the live splits in order. The partials come into the ring (free now)
  // kMergeSplits splits at a time, every row's 16-byte chunks in flight at
  // once; thread t folds row t / 8, float4 columns t % 8 + 8k
  float* stage = reinterpret_cast<float*>(smem + L::oC);  // [kMergeSplits][kRows][R]
  const int r = tid / 8, c4 = tid % 8;
  const size_t row0 = (size_t)b * Hq + h0;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + (row0 + min(r, nrows - 1)) * splits;
  float M = QTT_NEG_INF;
#pragma unroll 4
  for (int s2 = 0; s2 < nlive; ++s2) M = fmaxf(M, __ldcg(ml + s2).x);
  float lw = 0.f;
  float4 acc[R / 32];
#pragma unroll
  for (int k = 0; k < R / 32; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < nlive; s0 += kMergeSplits) {
    const int ns = min(kMergeSplits, nlive - s0);
    __syncthreads();  // the previous splits are folded (and, first, the ring is free)
    for (int c = tid; c < ns * nrows * (R / 4); c += kThreads) {
      const int sr = c / (R / 4), col = (c % (R / 4)) * 4;  // (split, row), column
      const int s2 = sr / nrows, rr = sr % nrows;
      cp_async16(smem_u32(stage + ((size_t)s2 * kRows + rr) * R + col),
                 part_acc + ((row0 + rr) * splits + s0 + s2) * R + col, true);
    }
    cp_async_commit();
    float2 v[kMergeSplits];
#pragma unroll
    for (int k = 0; k < kMergeSplits; ++k)
      v[k] = k < ns ? __ldcg(ml + s0 + k) : make_float2(0.f, 0.f);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMergeSplits; ++k) {  // in split order
      if (k >= ns) break;
      const float w = expf(v[k].x - M);
      lw += v[k].y * w;
      const float4* x = reinterpret_cast<const float4*>(stage + ((size_t)k * kRows + r) * R) + c4;
#pragma unroll
      for (int e = 0; e < R / 32; ++e) {
        const float4 y = x[8 * e];
        acc[e] = make_float4(fmaf(w, y.x, acc[e].x), fmaf(w, y.y, acc[e].y),
                             fmaf(w, y.z, acc[e].z), fmaf(w, y.w, acc[e].w));
      }
    }
  }
  if (r >= nrows) return;
  const float inv = lw == 0.f ? 1.f : lw;
  bf16* o_row = out + (row0 + r) * R + 4 * c4;
#pragma unroll
  for (int e = 0; e < R / 32; ++e) {
    *reinterpret_cast<__nv_bfloat162*>(o_row + 32 * e) =
        __floats2bfloat162_rn(acc[e].x / inv, acc[e].y / inv);
    *reinterpret_cast<__nv_bfloat162*>(o_row + 32 * e + 2) =
        __floats2bfloat162_rn(acc[e].z / inv, acc[e].w / inv);
  }
}

template <int R, int DR, bool kI8>
cudaError_t launch(const void* q_c, const void* q_pe, const void* kpe_pages,
                   const void* c_pages, const void* kv_scales, const void* block_table,
                   const void* lengths, void* out, void* part_acc, void* part_ml,
                   void* counters, int B, int Hq, int P, int page, int n_pt, int layer,
                   int splits, int chunk, float scale, cudaStream_t st) {
  using T = typename PageCode<kI8>::T;
  const auto kernel = mla_split_kernel<R, DR, kI8>;
  const size_t smem = Smem<R, DR, kI8>::kBytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(splits, B, (Hq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q_c), static_cast<const bf16*>(q_pe),
      static_cast<const T*>(kpe_pages), static_cast<const T*>(c_pages),
      static_cast<const float*>(kv_scales), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<bf16*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), static_cast<int*>(counters),
      Hq, P, page, n_pt, layer, chunk, scale);
  return cudaGetLastError();
}

}  // namespace k10q

}  // namespace

// q_c: bf16 [B, Hq, R]; q_pe: bf16 [B, Hq, DR]; kpe_pages: [L, P, 1, page,
// DR] and c_pages: [L, P, 1, page, R], both bf16 (int8 = 0, K10) or both
// int8 codes (int8 = 1, K10q, with kv_scales f32 [L, P, 8, page]; null
// otherwise); block_table: int32 [B, n_pt]; lengths: int32 [B], read on the
// card; out: bf16 [B, Hq, R]; part_acc: f32 [B, Hq, splits, R] and part_ml:
// f32 [B, Hq, splits, 2] (unused when splits == 1); counters: int32
// [B * ceil(Hq / 16)], zero before the launch and left at zero by it (one
// launch at a time); chunk: tokens per split, a multiple of 64 of at most
// 1,024 whose tokens lie on at most kMaxPages pages, with splits * chunk >=
// n_pt * page (K10q: pages a power of two of 16 or more). R = 512 and DR =
// 64.
extern "C" int qtt_mla_paged_decode(
    const void* q_c, const void* q_pe, const void* kpe_pages,
    const void* c_pages, const void* kv_scales, const void* block_table,
    const void* lengths, void* out, void* part_acc, void* part_ml, void* counters, int B,
    int Hq, int R, int DR, int L, int P, int page, int n_pt, int layer,
    int splits, int chunk, float scale, int int8, void* stream) {
  using namespace k10q;
  if (B <= 0 || B > 65535 || Hq <= 0 || P <= 0 || page <= 0 || n_pt <= 0 || layer < 0 ||
      layer >= L || splits <= 0 || chunk <= 0 || chunk % kBK != 0 || chunk > kMaxChunk ||
      (chunk - 1) / page + 2 > kMaxPages || counters == nullptr ||
      (long long)splits * chunk < (long long)n_pt * page ||
      (int8 && (kv_scales == nullptr || page < 16 || (page & (page - 1)) != 0)) ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  if (R != 512 || DR != 64) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8)
    return launch<512, 64, true>(q_c, q_pe, kpe_pages, c_pages, kv_scales, block_table, lengths,
                                 out, part_acc, part_ml, counters, B, Hq, P, page, n_pt, layer,
                                 splits, chunk, scale, st);
  return launch<512, 64, false>(q_c, q_pe, kpe_pages, c_pages, kv_scales, block_table, lengths,
                                out, part_acc, part_ml, counters, B, Hq, P, page, n_pt, layer,
                                splits, chunk, scale, st);
}
