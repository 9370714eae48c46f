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
// K5's design is K3's (fused_decode_step.cu) over pages: keys split over
// blocks from the shapes, each block clipping its chunk to the length it
// reads on the card, the last block of a (slot, head group) merging the
// splits in split order. Its kernel is in paged_decode.cuh, which K7
// (decode_attention.cu) instantiates over the dense cache.
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
// K6's kernel is one template over the page kind (paged_chunk.cuh), whose
// int8 instantiation is K6q (paged_attention_int8.cu); this file holds its
// bf16 instantiation.
//
// Not carried over from the TPU: scalar prefetch and clamped index maps (a
// block reads its own block table), the static block-diagonal head mask (a
// block holds one kv head), and the pages-per-step and slots-per-step
// tuning.
#include "paged_chunk.cuh"
#include "paged_decode.cuh"

namespace {

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
  k5::launch<DD, false>(q, k_pages, v_pages, block_table, lengths, slopes, out, part_acc,  \
                        part_ml, counters, B, Hq, Hkv, page, P, n_pt, layer, chunk, splits, \
                        scale, window, softcap, st)
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
  if (!shapes_ok(B, Hq, Hkv, page, P, n_pt, layer) ||
      !k6::plan_ok(B, S, Hq, Hkv, chunk, splits, page, n_pt, part_acc, part_ml, counters))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QTT_LAUNCH(DD)                                                                      \
  k6::launch<DD, false>(q, k_pages, v_pages, nullptr, block_table, starts, slopes, out,     \
                        part_acc, part_ml, counters, B, S, Hq, Hkv, page, P, n_pt, layer,   \
                        chunk, splits, scale, window, softcap, st)
  switch (D) {
    case 64: return QTT_LAUNCH(64);
    case 128: return QTT_LAUNCH(128);
    case 256: return QTT_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef QTT_LAUNCH
}
