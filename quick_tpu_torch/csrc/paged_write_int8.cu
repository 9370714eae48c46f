// K4q: INT8 paged KV cache writes — one decode token, or one prefill chunk,
// per slot, quantized and written in place into the int8 [L, P, Hkv, page, D]
// page stacks and the pages' shared f32 scale tiles [L, P, 8, Hkv * page].
//
// Replaces the Pallas kernels quick_tpu/ops/paged_write.py::
// _write_kernel_quant (:40, launched by paged_write_decode :92) and
// ::_chunk_write_kernel_quant (:262, launched by paged_write_chunk :304),
// together with the quantization quick_tpu/modules/paged_cache.py::
// _quantize_kv (:317) that PagedKVCache.update runs before them.
//
// What it computes. Token i of slot b (i < S, and i < valid[b] when valid is
// given) goes to in-page row r = offs[b] + i of page page_ids[b, 0] while
// r < page, else to row r - page of page_ids[b, 1] (the chunk kernel's span
// addressing, as K4). For each kv head h and each of k and v: from float
// rows (bf16 or f32), amax = max |x| over D, scale = max(amax / 127, 1e-8),
// code = clip(rint(x / scale), -127, 127) — _quantize_kv's numerics, IEEE
// division and round-half-to-even (the build has no fast-math flag), so the
// codes and scales are byte-equal to the JAX package's; from int8 codes with
// given scales (the JAX functions' own signature) the codes and scales are
// copied. The codes go to the page row, the scale to column h * page + row
// of row 0 (k) or row 1 (v) of the page's scale tile. Rows 2-7 of a tile are
// padding that nothing writes or reads. A row whose page id or in-page row
// falls outside the pool is not written (bad input: no write). Several
// slots may write the trash page 0 in one launch; those rows are never read.
//
// What bounds it on the H100: bytes — each written row read once and written
// once: at the serving decode shape (64 slots, Hkv 8, D 128) 256 KB of bf16
// in, 128 KB of codes and 4 KB of scales out, 0.12 us at 3.35 TB/s, so a
// call is bound by its launch and its chain of dependent memory round trips.
//
// The k and v planes may differ in width (Dk, Dv): DeepSeek's MLA latent
// pages hold the rope'd k_pe (Dk = 64) and the latent (Dv = 512) with
// Hkv = 1; each row's scale goes to its own tile row as above.
//
// Design: one global round trip before compute. A row (token, head, plane)
// belongs to a group of G lanes (a power of two up to 32), each lane holding
// up to kMaxUnits units of the row in registers: a unit is 8 values (one
// 16-byte load of bf16, two of f32) or 16 int8 codes (one load), and lane l
// holds units l, l + G, ... (ops/paged_write.py::int8_write_plan picks G and
// the units a lane: a 128-wide bf16 row is 16 lanes of one unit, DeepSeek's
// 64-wide k_pe 8 lanes, its 512-wide latent a warp of two units). Each lane
// starts all of its loads before it uses any: its units of x (their address
// depends on the token and the head alone), valid[b], offs[b], both page
// ids of the slot and, for codes, the row's scale. The absmax is reduced
// over the group with xor shuffles; the codes of a unit go out as one 8-byte
// store (16 for copied codes) and lane 0 writes the scale. A block holds the
// rows of T tokens x HB heads: the planes' rows in two regions, the plane
// with the wider groups first so that every group lies aligned inside a
// warp; T fits the block to ~256 lanes (one token of Mistral's 8 heads x
// two planes x 16 lanes; six DeepSeek latent tokens of 32 + 8 lanes). A
// width that fills no whole unit, a row of more than 32 x kMaxUnits units,
// or a pointer off 16 bytes takes the scalar path inside the kernel
// (shape-selected: a warp a row, lane-strided values read twice, byte
// stores). It is a programmatic dependent launch, as K9's decode rows: its
// blocks start while the kernel before finishes and wait for it
// (griddepcontrol.wait) before their first load. The body is
// csrc/paged_write_rows.cuh, shared with K4 (its copy kind, no scale tiles)
// since K4 moved onto it. Not carried over from the TPU: the aligned 32-row read-modify-write
// blocks with output aliasing, the one-hot dot that spreads per-head scales
// over the tile's lanes, and the rotation dot of the chunk kernel; here each
// code row and each scale is stored at its own address.
#include "paged_write_rows.cuh"

// k_pages: int8 [L, P, Hkv, page, Dk], v_pages: int8 [L, P, Hkv, page, Dv];
// kv_scales: f32 [L, P, 8, Hkv * page]; k_new: [B, S, Hkv, Dk], v_new:
// [B, S, Hkv, Dv], bf16 (in_kind 0), f32 (1) or int8 codes (2, with ks_new /
// vs_new f32 [B, S, Hkv]; null otherwise); page_ids: int32 [B, n_pg] (n_pg
// 1 or 2); offs: int32 [B]; valid: int32 [B] or null (all S tokens written).
// The plan (ops/paged_write.py::int8_write_plan): per plane log2 of the lanes
// a row (lgk, lgv) and the units a lane (vk, vv; 0: the scalar path, whose
// pointers need no alignment), T tokens and HB heads a block.
extern "C" int qtt_paged_write_int8(void* k_pages, void* v_pages, void* kv_scales,
                                    const void* k_new, const void* v_new, const void* ks_new,
                                    const void* vs_new, const void* page_ids, const void* offs,
                                    const void* valid, int B, int S, int Hkv, int page, int Dk,
                                    int Dv, int P, int layer, int n_pg, int L, int in_kind,
                                    int lgk, int vk, int lgv, int vv, int T, int HB,
                                    void* stream) {
  if (B <= 0 || S <= 0 || S > page || Hkv <= 0 || Dk <= 0 || Dv <= 0 || layer < 0 ||
      layer >= L || n_pg < 1 || n_pg > 2 || in_kind < 0 || in_kind > 2 ||
      (in_kind == 2 && (ks_new == nullptr || vs_new == nullptr)))
    return cudaErrorInvalidValue;
  const int values = in_kind == 2 ? 16 : 8;
  const long long tokens = (long long)B * S;
  const long long lanes = (long long)T * HB * ((1LL << lgk) + (1LL << lgv));
  if (!plane_fits(Dk, lgk, vk, values) || !plane_fits(Dv, lgv, vv, values) || T <= 0 ||
      HB <= 0 || HB > Hkv || tokens > 0x7fffffffLL || lanes > 1024 ||
      (Hkv + HB - 1) / HB > 65535)
    return cudaErrorInvalidValue;
  const int threads = (int)((lanes + 31) / 32 * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(k_pages, v_pages, kv_scales, k_new, v_new, ks_new, vs_new, page_ids,
                         offs, valid, S, Hkv, page, Dk, Dv, P, layer, n_pg, (int)tokens, lgk,
                         vk, lgv, vv, T, HB, threads, 1, st);
  };
  if (in_kind == 0) return go(&launch<0>);
  if (in_kind == 1) return go(&launch<1>);
  return go(&launch<2>);
}
