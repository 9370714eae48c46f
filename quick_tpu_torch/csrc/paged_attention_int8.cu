// K5q / K6q: attention straight over INT8 pages of the paged KV cache —
// single-query decode (K5q) and chunked-prefill queries (K6q).
//
// Replace the INT8 branches of the Pallas kernels quick_tpu/ops/
// paged_attention.py::_paged_kernel (:32, INT8 :96-163, launched by
// paged_decode_attention :437, whose q quantization :528-538 K5q does
// itself) and ::_paged_chunk_kernel (:179, INT8 :225-262, launched by
// paged_chunk_attention :291).
//
// Layout. Codes live in int8 pages [L, P, Hkv, page, D]; key t of slot b is
// row t % page of page block_table[b, t / page]. Their f32 scales live in
// one tile per page, kv_scales [L, P, 8, Hkv * page]: row 0 holds the k
// scales, row 1 the v scales, at column h * page + (t % page).
//
// What K5q computes (the Pallas INT8 decode arithmetic, page by page in
// table order). q of (slot, head) is quantized: sq = max(max|q|, 1e-30) /
// 127, q8 = clip(rint(q / sq), -127, 127). For each page that holds a
// visible key: s = int32(q8 . k8) * (sq * scale) * k_scale[t], then the
// softcap, the ALiBi bias, the mask (t < length; with a window t >= length -
// window); m_new = max(m, max s); p = exp(s - m_new) on visible keys; l = l
// * alpha + sum p (alpha = exp(m - m_new)); p *= v_scale[t]; the page's p is
// quantized per query head: ps = max(max|p|, 1e-30) / 127, p8 = clip(rint(p
// / ps)); acc = acc * alpha + int32(p8 . v8) * ps. Out = acc / l (0 where l
// is 0). Both dots are exact integer dots, so only the float steps (exp,
// the sums of p and of the pages' contributions) can differ from the TPU
// kernel's.
//
// What K6q computes (the Pallas INT8 chunk arithmetic): codes convert
// exactly to bf16; s = (q_bf16 . k) * scale * k_scale[t]; probabilities are
// multiplied by v_scale[t] before they are rounded to bf16 for p @ v; the
// rest is K6.
//
// What bounds them on the H100: bytes — the codes up to each slot's length
// (2 * length * Hkv * D bytes per slot), rows 0-1 of each read page's scale
// tile, q and out. At the serving shapes (64 slots of a few hundred tokens)
// that is ~10 MB per call, a few microseconds of HBM time, so a call is
// latency-bound: by the longest chain of tiles a block walks.
//
// Design. K5q is K5's key-split kernel (paged_decode.cuh), its INT8
// instantiation: grid (kv head x head group, slot, split), keys split over
// blocks from the shapes (ops/paged_attention.py::int8_split_plan: chunks of
// whole units of max(page, 64) keys, so that no page's p quantization group
// is cut, at most INT8_DECODE_MAX_TILES tiles), codes staged with 16-byte
// cp.async at half of K5's bytes and converted exactly to bf16 in shared
// memory, both dots on mma.sync, the last block of a (slot, head group)
// merging the splits in split order with K5's counters. paged_decode.cuh
// describes the INT8 steps. K6q: K6's key-split tensor-core kernel, its
// int8 instantiation (paged_chunk.cuh): the same plan, rows, splits and
// merge as K6 over the codes, staged with 16-byte cp.async at half of K6's
// bytes and converted exactly to bf16 in shared memory, with each tile's
// k and v scales beside its page ids.
// Not carried over from the TPU: the static block-diagonal head mask (a
// block holds one kv head), the clamped index maps and the pages-per-step
// tuning; each block reads its own length / start and block-table row.
#include "paged_chunk.cuh"
#include "paged_decode.cuh"

namespace {

bool shapes_ok(int B, int Hq, int Hkv, int page, int P, int n_pt, int layer) {
  return B > 0 && Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv <= 32 && page > 0 &&
         page % 4 == 0 && page <= 256 && P > 0 && n_pt > 0 && layer >= 0;
}

}  // namespace

// q, out: [B, Hq, D] bf16; k_pages, v_pages: int8 [L, P, Hkv, page, D];
// kv_scales: f32 [L, P, 8, Hkv * page]; block_table: int32 [B, n_pt]
// (entries in [0, P)); lengths: int32 [B] (keys per slot, the current
// token's included), read on the card; slopes: f32 [Hq] or null; window <=
// 0 and softcap <= 0 disable. page is 16, 32, 64, 128 or 256 (a page lies
// inside one warp's keys, or spans whole 64-key tiles). The key range [0,
// n_pt * page) is cut into `splits` chunks of `chunk` keys (a multiple of
// max(page, 64), at most 1,024, splits * chunk >= n_pt * page); part_acc f32 [B, Hq,
// splits, D] and part_ml f32 [B, Hq, splits, 2] are scratch; counters as
// K5's (qtt_paged_decode_attention).
extern "C" int qtt_paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* kv_scales,
    const void* block_table, const void* lengths, const void* slopes, void* out,
    void* part_acc, void* part_ml, void* counters, int B, int Hq, int Hkv, int page, int D,
    int P, int n_pt, int layer, int chunk, int splits, float scale, int window, float softcap,
    void* stream) {
  const int unit = page > k5::kBK ? page : k5::kBK;
  if (!shapes_ok(B, Hq, Hkv, page, P, n_pt, layer) || kv_scales == nullptr || B > 65535 ||
      page < 16 || (page & (page - 1)) != 0 || chunk <= 0 || chunk % unit != 0 ||
      chunk > k5::kMaxChunk || splits <= 0 || splits > 65535 ||
      (long long)splits * chunk < (long long)n_pt * page || part_acc == nullptr ||
      part_ml == nullptr || counters == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QTT_LAUNCH(DD)                                                                     \
  k5::launch<DD, false, true>(q, k_pages, v_pages, block_table, lengths, slopes, out,     \
                              part_acc, part_ml, counters, B, Hq, Hkv, page, P, n_pt,     \
                              layer, chunk, splits, scale, window, softcap, st, kv_scales)
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
// keys, part_acc / part_ml are scratch and counters int32 [B * Hkv *
// ceil(S * Hq / Hkv / 64)] zero before the launch and left at zero by it,
// as for K6 (qtt_paged_chunk_attention); the rest as above.
extern "C" int qtt_paged_chunk_attention_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* kv_scales,
    const void* block_table, const void* starts, const void* slopes, void* out,
    void* part_acc, void* part_ml, void* counters, int B, int S, int Hq, int Hkv, int page,
    int D, int P, int n_pt, int layer, int chunk, int splits, float scale, int window,
    float softcap, void* stream) {
  if (!shapes_ok(B, Hq, Hkv, page, P, n_pt, layer) || kv_scales == nullptr ||
      !k6::plan_ok(B, S, Hq, Hkv, chunk, splits, page, n_pt, part_acc, part_ml, counters))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QTT_LAUNCH(DD)                                                                       \
  k6::launch<DD, true>(q, k_pages, v_pages, kv_scales, block_table, starts, slopes, out,     \
                       part_acc, part_ml, counters, B, S, Hq, Hkv, page, P, n_pt, layer,     \
                       chunk, splits, scale, window, softcap, st)
  switch (D) {
    case 64: return QTT_LAUNCH(64);
    case 128: return QTT_LAUNCH(128);
    case 256: return QTT_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef QTT_LAUNCH
}
