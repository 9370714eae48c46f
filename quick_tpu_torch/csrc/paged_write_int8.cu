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
// padding that nothing writes or reads.
//
// What bounds it on the H100: bytes — each written row read once and written
// once: at the serving decode shape (64 slots, Hkv 8, D 128) 256 KB of bf16
// in, 128 KB of codes and 4 KB of scales out, so a call is launch-bound.
//
// The k and v planes may differ in width (Dk, Dv): DeepSeek's MLA latent
// pages hold the rope'd k_pe (Dk = 64) and the latent (Dv = 512) with
// Hkv = 1; each row's scale goes to its own tile row as above.
//
// Design. One block per (token, slot); one warp per (head, k or v) row: the
// lanes read the row's D values, take the absmax with a warp reduction and
// write the codes (32 consecutive bytes per step) and the one scale. Not
// carried over from the TPU: the aligned 32-row read-modify-write blocks with
// output aliasing, the one-hot dot that spreads per-head scales over the
// tile's lanes, and the rotation dot of the chunk kernel; here each code row
// and each scale is stored at its own address. Several slots may write the
// trash page 0 in one launch; those rows are never read.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

// in_kind: 0 bf16 rows, 1 f32 rows (both quantized here), 2 int8 codes with
// f32 scales ks_new / vs_new [B, S, Hkv] (copied)
__global__ void __launch_bounds__(kWarps * 32)
paged_write_int8_kernel(int8_t* __restrict__ k_pages, int8_t* __restrict__ v_pages,
                        float* __restrict__ kv_scales,
                        const void* __restrict__ k_new,
                        const void* __restrict__ v_new,
                        const float* __restrict__ ks_new,
                        const float* __restrict__ vs_new,
                        const int* __restrict__ page_ids,
                        const int* __restrict__ offs,
                        const int* __restrict__ valid, int S, int Hkv,
                        int page, int Dk, int Dv, int P, int layer, int n_pg,
                        int in_kind) {
  const int i = blockIdx.x, b = blockIdx.y;
  if (valid != nullptr && i >= valid[b]) return;
  const int r = offs[b] + i;
  const int second = r >= page ? 1 : 0;
  const int pg = page_ids[b * n_pg + min(second, n_pg - 1)];
  const int row = r - second * page;
  if (pg < 0 || pg >= P || row < 0 || row >= page) return;  // bad input: no write
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t page_base = (size_t)layer * P + pg;
  for (int u = warp; u < 2 * Hkv; u += kWarps) {
    const int plane = u / Hkv, h = u % Hkv;  // plane 0: k, 1: v
    const int D = plane == 0 ? Dk : Dv;
    const size_t src = (((size_t)b * S + i) * Hkv + h) * D;
    int8_t* dst = (plane == 0 ? k_pages : v_pages) +
                  ((page_base * Hkv + h) * page + row) * D;
    const void* xin = plane == 0 ? k_new : v_new;
    float scale;
    if (in_kind == 2) {
      const int8_t* c = static_cast<const int8_t*>(xin) + src;
      for (int d = lane; d < D; d += 32) dst[d] = c[d];
      scale = (plane == 0 ? ks_new : vs_new)[((size_t)b * S + i) * Hkv + h];
    } else {
      const bf16* xb = static_cast<const bf16*>(xin) + src;
      const float* xf = static_cast<const float*>(xin) + src;
      float amax = 0.f;
      for (int d = lane; d < D; d += 32)
        amax = fmaxf(amax, fabsf(in_kind == 0 ? bf2f(xb[d]) : xf[d]));
      amax = warp_max(amax);
      scale = fmaxf(amax / 127.0f, 1e-8f);
      for (int d = lane; d < D; d += 32) {
        const float x = in_kind == 0 ? bf2f(xb[d]) : xf[d];
        const float c = fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
        dst[d] = static_cast<int8_t>(c);
      }
    }
    if (lane == 0)
      kv_scales[(page_base * 8 + plane) * ((size_t)Hkv * page) + (size_t)h * page + row] =
          scale;
  }
}

}  // namespace

// k_pages: int8 [L, P, Hkv, page, Dk], v_pages: int8 [L, P, Hkv, page, Dv];
// kv_scales: f32 [L, P, 8, Hkv * page]; k_new: [B, S, Hkv, Dk], v_new:
// [B, S, Hkv, Dv], bf16 (in_kind 0), f32 (1) or int8 codes (2, with ks_new /
// vs_new f32 [B, S, Hkv]; null otherwise); page_ids: int32 [B, n_pg] (n_pg
// 1 or 2); offs: int32 [B]; valid: int32 [B] or null (all S tokens written).
extern "C" int qtt_paged_write_int8(void* k_pages, void* v_pages,
                                    void* kv_scales, const void* k_new,
                                    const void* v_new, const void* ks_new,
                                    const void* vs_new, const void* page_ids,
                                    const void* offs, const void* valid, int B,
                                    int S, int Hkv, int page, int Dk, int Dv,
                                    int P, int layer, int n_pg, int L,
                                    int in_kind, void* stream) {
  if (B <= 0 || S <= 0 || S > page || Hkv <= 0 || Dk <= 0 || Dv <= 0 || layer < 0 ||
      layer >= L || n_pg < 1 || n_pg > 2 || in_kind < 0 || in_kind > 2 ||
      (in_kind == 2 && (ks_new == nullptr || vs_new == nullptr)))
    return cudaErrorInvalidValue;
  dim3 grid(S, B);
  paged_write_int8_kernel<<<grid, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(k_pages), static_cast<int8_t*>(v_pages),
      static_cast<float*>(kv_scales), k_new, v_new,
      static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
      static_cast<const int*>(page_ids), static_cast<const int*>(offs),
      static_cast<const int*>(valid), S, Hkv, page, Dk, Dv, P, layer, n_pg,
      in_kind);
  return cudaGetLastError();
}
