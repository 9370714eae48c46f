// K4: paged KV cache writes — one decode token, or one prefill chunk, per
// slot, written in place into the [L, P, Hkv, page, D] page stacks.
//
// Replaces the Pallas kernels quick_tpu/ops/paged_write.py::_write_kernel
// (:76, launched by paged_write_decode :92) and ::_chunk_write_kernel
// (:211, launched by paged_write_chunk :304). Both entry points are this
// one kernel: the decode entry passes one page column and no valid count.
//
// What it computes: token i of slot b (i < S, and i < valid[b] when valid
// is given) goes to in-page row r = offs[b] + i of page page_ids[b, 0]
// while r < page, else to row r - page of page_ids[b, 1] — the Pallas
// chunk kernel's span addressing. Each token's Hkv rows are copied for k
// (Dk values) and for v (Dv values; DeepSeek's MLA latent pages hold the
// rope'd k_pe, Dk = 64, in the k plane and the latent, Dv = 512, in the v
// plane, with Hkv = 1). The page dtype does not matter: a row is copied as
// `k_row_bytes` / `v_row_bytes` bytes. A row whose page id or in-page row
// falls outside the pool is not written (bad input: no write).
//
// What bounds it on the H100: bytes — each written row is read once from
// k_new / v_new and written once into the pages, 2 * 2 * B * S * Hkv * D * 2
// bytes in bf16 (128 KB at the serving decode shape B=16, Hkv=8, D=128;
// 18 KB at DeepSeek's latent pages, B=16, Dk + Dv = 576), so the call is
// bound by its launch and its chain of dependent memory round trips.
//
// Design: K4q's row body (csrc/paged_write_rows.cuh) in its copy kind, with
// no scale tile. A row (token, head, plane) goes to a group of 2^lg lanes,
// each holding up to four 16-byte units in registers
// (ops/paged_write.py::copy_write_plan: a 128-wide bf16 row is 16 lanes of
// one unit, so one Mistral token of 8 heads x two planes fills a block of
// 256 lanes; DeepSeek's 64-wide k_pe 8 lanes and its 512-wide latent a warp
// of two units, six tokens a block). Every load of a lane (its units,
// valid[b], offs[b], both page ids) is started before any is used, stores
// are 16 bytes, and no lane divides per chunk. It is a programmatic
// dependent launch: its blocks start while the kernel before finishes (the
// qkv projection or rope that wrote k_new / v_new) and wait for it with
// griddepcontrol.wait before their first load; it does not trigger its own
// dependents early (the attention kernels after it read the pages it
// writes). A width of no whole 16 bytes, a row of more than 128 units or a
// pointer off 16 bytes takes the body's scalar path (a warp a row, byte
// copies). Not carried over from the TPU: the aligned 16-row read-modify-
// write groups with output aliasing (a TPU block cannot address one row)
// and the chunk kernel's one-hot rotation dot (a TPU vector cannot be
// rotated by a dynamic amount in bf16); here each row is stored at its own
// address. Several slots may write the trash page 0 in one launch; those
// rows are never read.
#include "paged_write_rows.cuh"

// k_pages: [L, P, Hkv, page, Dk], v_pages: [L, P, Hkv, page, Dv] (any
// dtype, rows of k_row_bytes = Dk * element size and v_row_bytes = Dv *
// element size); k_new: [B, S, Hkv, Dk], v_new: [B, S, Hkv, Dv] of the same
// dtype; page_ids: int32 [B, n_pg] (n_pg 1 or 2); offs: int32 [B]; valid:
// int32 [B] or null (all S tokens written). The plan
// (ops/paged_write.py::copy_write_plan, over the rows' bytes): per plane
// log2 of the lanes a row (lgk, lgv) and the 16-byte units a lane (vk, vv;
// 0: the scalar path, whose pointers need no alignment), T tokens and HB
// heads a block; pdl 0 launches it plainly (a measurement's comparison).
extern "C" int qtt_paged_write(void* k_pages, void* v_pages, const void* k_new,
                               const void* v_new, const void* page_ids,
                               const void* offs, const void* valid, int B,
                               int S, int Hkv, int page, int k_row_bytes,
                               int v_row_bytes, int P, int layer, int n_pg,
                               int L, int lgk, int vk, int lgv, int vv, int T,
                               int HB, int pdl, void* stream) {
  if (B <= 0 || S <= 0 || S > page || Hkv <= 0 || k_row_bytes <= 0 ||
      v_row_bytes <= 0 || layer < 0 || layer >= L || n_pg < 1 || n_pg > 2)
    return cudaErrorInvalidValue;
  const long long tokens = (long long)B * S;
  const long long lanes = (long long)T * HB * ((1LL << lgk) + (1LL << lgv));
  if (!plane_fits(k_row_bytes, lgk, vk, 16) || !plane_fits(v_row_bytes, lgv, vv, 16) ||
      T <= 0 || HB <= 0 || HB > Hkv || tokens > 0x7fffffffLL || lanes > 1024 ||
      (Hkv + HB - 1) / HB > 65535)
    return cudaErrorInvalidValue;
  const int threads = (int)((lanes + 31) / 32 * 32);
  return launch<kCopy>(k_pages, v_pages, nullptr, k_new, v_new, nullptr, nullptr, page_ids,
                       offs, valid, S, Hkv, page, k_row_bytes, v_row_bytes, P, layer, n_pg,
                       (int)tokens, lgk, vk, lgv, vv, T, HB, threads, pdl,
                       static_cast<cudaStream_t>(stream));
}
