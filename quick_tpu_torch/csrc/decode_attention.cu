// K7: single-query decode attention over the dense head-major KV cache.
//
// Replaces the Pallas kernel quick_tpu/ops/decode_attention.py::_kernel
// (:46, launched by dense_decode_attention :230 through pallas_call :183).
//
// What it computes. q [B, Hq, D] bf16; the cache stacks K, V [L, B, Hkv, T,
// D] bf16, read at `layer`; lengths int32 [B] in device memory (keys per
// row, the current token's included). Query head hq reads kv head
// hq / (Hq / Hkv). The score is q . k * scale, then the tanh softcap, then
// the ALiBi bias slope * (t - (length - 1)), then the mask t < length
// (:81-95). Softmax in f32, online; p is rounded to bf16 before p @ v, as
// the Pallas kernel's p.astype(v.dtype) (:102-105); a row of length 0 gives
// 0 (:111). Keys at or past min(length, T) are never read.
//
// What bounds it on the H100: bytes — the valid K and V rows
// (2 * length * Hkv * D * 2 bytes per row) plus q and out, at 3.35 TB/s.
// At the decode of the 128/128 protocol (B=32, lengths 129-255) that is
// ~25 MB, ~7.5 us.
//
// Design: a dense cache is a paged cache with one T-key page per row, so
// K7 is the dense instantiation of K5's key-split kernel (paged_decode.cuh:
// P = B pages, page = T keys, slot b's page b, no block table): the key
// range split over blocks from the shapes (the wrapper's plan, about two
// blocks an SM), each block clipping its chunk to the row's length read on
// the card, so a captured decode step replays unchanged; both products on
// mma.sync; the last block of a (row, head group) merging the splits in
// split order, so greedy decoding stays deterministic. Not carried over
// from the TPU: the nb x c grid steps sized for 2 MB of VMEM, the int8
// block-diagonal head mask (a block holds one kv head), the in-chunk
// position row and the clamped index map.
#include "paged_decode.cuh"

// q, out: [B, Hq, D] bf16; k, v: [L, B, Hkv, T, D] bf16; lengths: int32 [B]
// (keys per row, the current token's included; the mask clamps them to
// [0, T]); slopes: f32 [Hq] or null; softcap <= 0 disables. The key range
// [0, T) is cut into `splits` chunks of `chunk` keys (a multiple of 64,
// splits * chunk >= T); part_acc f32 [B, Hq, splits, D] and part_ml f32
// [B, Hq, splits, 2] are scratch; counters: int32 [B * Hkv *
// ceil(Hq / Hkv / 16)], zero before the launch and left at zero by it (one
// launch at a time).
extern "C" int qtt_dense_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* slopes, void* out, void* part_acc, void* part_ml, void* counters, int B,
    int Hq, int Hkv, int T, int D, int L, int layer, int chunk, int splits,
    float scale, float softcap, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 32 || T <= 0 ||
      layer < 0 || layer >= L || chunk <= 0 || chunk % k5::kBK != 0 || splits <= 0 ||
      splits > 65535 || (long long)splits * chunk < T || part_acc == nullptr ||
      part_ml == nullptr || counters == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QTT_LAUNCH(DD)                                                                         \
  k5::launch<DD, true>(q, k, v, nullptr, lengths, slopes, out, part_acc, part_ml, counters, B, \
                       Hq, Hkv, T, B, 1, layer, chunk, splits, scale, 0, softcap, st)
  switch (D) {
    case 64: return QTT_LAUNCH(64);
    case 128: return QTT_LAUNCH(128);
    case 256: return QTT_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef QTT_LAUNCH
}
