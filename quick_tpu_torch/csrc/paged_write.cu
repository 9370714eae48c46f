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
// `k_row_bytes` / `v_row_bytes` bytes in 16-byte chunks.
//
// What bounds it on the H100: bytes — each written row is read once from
// k_new / v_new and written once into the pages, 2 * 2 * B * S * Hkv * D * 2
// bytes in bf16 (128 KB at the serving decode shape B=16, Hkv=8, D=128;
// 18 KB at DeepSeek's latent pages, B=16, Dk + Dv = 576), so the call is
// launch-bound.
//
// Design. One block per (token, slot); its threads copy the token's Hkv x D
// row of k and of v with 16-byte loads and stores. Not carried over from
// the TPU: the aligned 16-row read-modify-write groups with output aliasing
// (a TPU block cannot address one row) and the chunk kernel's one-hot
// rotation dot (a TPU vector cannot be rotated by a dynamic amount in bf16);
// here each row is stored at its own address. Several slots may write the
// trash page 0 in one launch; those rows are never read.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
paged_write_kernel(uint8_t* __restrict__ k_pages, uint8_t* __restrict__ v_pages,
                   const uint8_t* __restrict__ k_new,
                   const uint8_t* __restrict__ v_new,
                   const int* __restrict__ page_ids, const int* __restrict__ offs,
                   const int* __restrict__ valid, int S, int Hkv, int page,
                   int k_row_bytes, int v_row_bytes, int P, int layer,
                   int n_pg) {
  const int i = blockIdx.x, b = blockIdx.y;
  if (valid != nullptr && i >= valid[b]) return;
  const int r = offs[b] + i;
  const int second = r >= page ? 1 : 0;
  const int pg = page_ids[b * n_pg + min(second, n_pg - 1)];
  const int row = r - second * page;
  if (pg < 0 || pg >= P || row < 0 || row >= page) return;  // bad input: no write
  const size_t head_row = (((size_t)layer * P + pg) * Hkv) * page + row;
  // k rows, then v rows: one 16-byte chunk per thread and step
  const int kc = k_row_bytes / 16, vc = v_row_bytes / 16;
  for (int c = threadIdx.x; c < Hkv * (kc + vc); c += blockDim.x) {
    const bool is_k = c < Hkv * kc;
    const int cc = is_k ? c : c - Hkv * kc;
    const int chunks = is_k ? kc : vc;
    const int row_bytes = is_k ? k_row_bytes : v_row_bytes;
    const int h = cc / chunks, o = (cc % chunks) * 16;
    const size_t dst = (head_row + (size_t)h * page) * row_bytes + o;
    const size_t s = (((size_t)b * S + i) * Hkv + h) * row_bytes + o;
    *reinterpret_cast<uint4*>((is_k ? k_pages : v_pages) + dst) =
        *reinterpret_cast<const uint4*>((is_k ? k_new : v_new) + s);
  }
}

}  // namespace

// k_pages: [L, P, Hkv, page, Dk], v_pages: [L, P, Hkv, page, Dv] (any 2-
// or 4-byte dtype, rows of k_row_bytes = Dk * element size and v_row_bytes
// = Dv * element size, multiples of 16); k_new: [B, S, Hkv, Dk], v_new:
// [B, S, Hkv, Dv] of the same dtype; page_ids: int32 [B, n_pg] (n_pg 1 or
// 2); offs: int32 [B]; valid: int32 [B] or null (all S tokens written).
extern "C" int qtt_paged_write(void* k_pages, void* v_pages, const void* k_new,
                               const void* v_new, const void* page_ids,
                               const void* offs, const void* valid, int B,
                               int S, int Hkv, int page, int k_row_bytes,
                               int v_row_bytes, int P, int layer, int n_pg,
                               int L, void* stream) {
  if (B <= 0 || S <= 0 || S > page || Hkv <= 0 || k_row_bytes <= 0 ||
      v_row_bytes <= 0 || k_row_bytes % 16 != 0 || v_row_bytes % 16 != 0 ||
      layer < 0 || layer >= L || n_pg < 1 || n_pg > 2)
    return cudaErrorInvalidValue;
  dim3 grid(S, B);
  paged_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(k_pages), static_cast<uint8_t*>(v_pages),
      static_cast<const uint8_t*>(k_new), static_cast<const uint8_t*>(v_new),
      static_cast<const int*>(page_ids), static_cast<const int*>(offs),
      static_cast<const int*>(valid), S, Hkv, page, k_row_bytes, v_row_bytes,
      P, layer, n_pg);
  return cudaGetLastError();
}
