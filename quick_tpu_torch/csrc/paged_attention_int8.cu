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
// is 0). Both dots are integer dots (__dp4a), exact in any order, so only
// the float steps (exp, sums of p) can differ from the TPU kernel's.
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
// latency-bound.
//
// Design. K5q: one block per (kv head, slot) walks the slot's pages in
// order (the p quantization is per page against the running max at that
// page, so keys cannot be split over blocks without changing the result).
// Per page it stages the k codes row-major (rows padded by one word, so the
// lanes of a warp read different banks) and the v codes transposed [D,
// page] (so the context dot also runs along dp4a's four bytes), scores
// every (query head, key) pair with dp4a, lets one warp per query head run
// the softmax and the p quantization, then accumulates (query head, dim)
// outputs with dp4a. K6q: K6's key-split tensor-core kernel, its int8
// instantiation (paged_chunk.cuh): the same plan, rows, splits and merge
// as K6 over the codes, staged with 16-byte cp.async at half of K6's
// bytes and converted exactly to bf16 in shared memory, with each tile's
// k and v scales beside its page ids.
// Not carried over from the TPU: the static block-diagonal head mask (a
// block holds one kv head), the clamped index maps and the pages-per-step
// tuning; each block reads its own length / start and block-table row.
#include "paged_chunk.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPage = 256;                     // K5q: page / 32 <= 8 per lane

__device__ __forceinline__ int8_t quantize_i8(float x, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared-memory carve-up of K5q for gq query heads, head dim D, page size.
struct DecodeSmem {
  size_t q8, kw, vt, ksc, vsc, s, p8, qmul, m, l, alpha, ps, acc, total;
  __host__ __device__ DecodeSmem(int gq, int D, int page) {
    size_t o = 0;
    q8 = o;    o += align16((size_t)gq * D);                     // int8 [gq][D]
    kw = o;    o += align16((size_t)page * (D / 4 + 1) * 4);     // int32 [page][D/4+1]
    vt = o;    o += align16((size_t)D * (page / 4 + 1) * 4);     // int32 [D][page/4+1]
    ksc = o;   o += align16((size_t)page * 4);
    vsc = o;   o += align16((size_t)page * 4);
    s = o;     o += align16((size_t)gq * page * 4);              // f32 [gq][page]
    p8 = o;    o += align16((size_t)gq * page);                  // int8 [gq][page]
    qmul = o;  o += align16((size_t)gq * 4);
    m = o;     o += align16((size_t)gq * 4);
    l = o;     o += align16((size_t)gq * 4);
    alpha = o; o += align16((size_t)gq * 4);
    ps = o;    o += align16((size_t)gq * 4);
    acc = o;   o += align16((size_t)gq * D * 4);                 // f32 [gq][D]
    total = o;
  }
};

// ---------------------------------------------------------------- K5q decode
template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_int8_kernel(const bf16* __restrict__ q,
                         const int8_t* __restrict__ k_pages,
                         const int8_t* __restrict__ v_pages,
                         const float* __restrict__ kv_scales,
                         const int* __restrict__ block_table,
                         const int* __restrict__ lengths,
                         const float* __restrict__ slopes,
                         bf16* __restrict__ out, int Hq, int Hkv, int page,
                         int P, int n_pt, int layer, float scale, int window,
                         float softcap) {
  constexpr int kW = D / 4;  // int32 words of a code row
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int gq = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const DecodeSmem L(gq, D, page);
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + L.q8);
  int* kw = reinterpret_cast<int*>(smem + L.kw);
  int8_t* vt = reinterpret_cast<int8_t*>(smem + L.vt);
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.vsc);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  int8_t* p8 = reinterpret_cast<int8_t*>(smem + L.p8);
  float* qmul = reinterpret_cast<float*>(smem + L.qmul);
  float* mrow = reinterpret_cast<float*>(smem + L.m);
  float* lrow = reinterpret_cast<float*>(smem + L.l);
  float* arow = reinterpret_cast<float*>(smem + L.alpha);
  float* psrow = reinterpret_cast<float*>(smem + L.ps);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  const int vt_row = (page / 4 + 1) * 4;  // bytes of a transposed v row

  // q of this kv head's gq query heads -> int8 codes (one warp per head)
  for (int r = warp; r < gq; r += kWarps) {
    const bf16* qr = q + ((size_t)b * Hq + h * gq + r) * D;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(bf2f(qr[d])));
    const float sq = fmaxf(warp_max(amax), 1e-30f) / 127.0f;
    for (int d = lane; d < D; d += 32) q8[r * D + d] = quantize_i8(bf2f(qr[d]), sq);
    if (lane == 0) {
      qmul[r] = sq * scale;
      mrow[r] = QTT_NEG_INF;
      lrow[r] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < gq * D; i += kThreads) acc[i] = 0.f;

  const int length = lengths[b];
  const int lo = window > 0 ? length - window : 0;
  const int j_first = lo > 0 ? lo / page : 0;
  const int j_last = length > 0 ? min((length - 1) / page, n_pt - 1) : -1;
  const int* bt = block_table + (size_t)b * n_pt;
  const int T = Hkv * page;
  const int* q8w = reinterpret_cast<const int*>(q8);
  const int* p8w = reinterpret_cast<const int*>(p8);
  const int* vtw = reinterpret_cast<const int*>(vt);
  for (int j = j_first; j <= j_last; ++j) {
    const int base = j * page;
    const size_t pg = (size_t)layer * P + bt[j];
    __syncthreads();  // the previous page is consumed (and q staged)
    // stage the page's codes: k row-major (padded), v transposed
    const int8_t* kp = k_pages + (pg * Hkv + h) * page * D;
    const int8_t* vp = v_pages + (pg * Hkv + h) * page * D;
    for (int c = threadIdx.x; c < page * (D / 16); c += kThreads) {
      const int t = c / (D / 16), d16 = (c % (D / 16)) * 16;
      const uint4 k4 = *reinterpret_cast<const uint4*>(kp + (size_t)t * D + d16);
      int* kr = kw + t * (kW + 1) + d16 / 4;
      kr[0] = (int)k4.x; kr[1] = (int)k4.y; kr[2] = (int)k4.z; kr[3] = (int)k4.w;
      const uint4 v4 = *reinterpret_cast<const uint4*>(vp + (size_t)t * D + d16);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&v4);
#pragma unroll
      for (int e = 0; e < 16; ++e) vt[(d16 + e) * vt_row + t] = vb[e];
    }
    const float* tile = kv_scales + pg * 8 * T + (size_t)h * page;
    for (int t = threadIdx.x; t < page; t += kThreads) {
      ksc[t] = tile[t];
      vsc[t] = tile[T + t];
    }
    __syncthreads();
    // scores of every (query head, key) pair
    for (int idx = threadIdx.x; idx < gq * page; idx += kThreads) {
      const int r = idx / page, t = idx % page;
      const int* qr = q8w + r * kW;
      const int* kr = kw + t * (kW + 1);
      int si = 0;
#pragma unroll 8
      for (int i = 0; i < kW; ++i) si = __dp4a(qr[i], kr[i], si);
      float sc = (float)si * qmul[r] * ksc[t];
      if (softcap > 0.f) sc = softcap * tanhf(sc * (1.0f / softcap));
      const int pos = base + t;
      if (slopes != nullptr) sc += slopes[h * gq + r] * (float)(pos - (length - 1));
      const bool ok = pos < length && (window <= 0 || pos >= lo);
      ss[idx] = ok ? sc : QTT_NEG_INF;
    }
    __syncthreads();
    // online softmax and p quantization, one warp per query head
    for (int r = warp; r < gq; r += kWarps) {
      float pv[kMaxPage / 32];
      float tmax = QTT_NEG_INF;
      for (int t = lane; t < page; t += 32) tmax = fmaxf(tmax, ss[r * page + t]);
      const float m_prev = mrow[r];
      const float m_new = fmaxf(m_prev, warp_max(tmax));
      float psum = 0.f, pmax = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxPage / 32; ++e) {
        const int t = lane + 32 * e;
        float p = 0.f;
        if (t < page) {
          const int pos = base + t;
          const bool ok = pos < length && (window <= 0 || pos >= lo);
          p = ok ? expf(ss[r * page + t] - m_new) : 0.f;
          psum += p;
          p *= vsc[t];
          pmax = fmaxf(pmax, fabsf(p));
        }
        pv[e] = p;
      }
      const float alpha = expf(m_prev - m_new);
      psum = warp_sum(psum);
      const float ps = fmaxf(warp_max(pmax), 1e-30f) / 127.0f;
#pragma unroll
      for (int e = 0; e < kMaxPage / 32; ++e) {
        const int t = lane + 32 * e;
        if (t < page) p8[r * page + t] = quantize_i8(pv[e], ps);
      }
      if (lane == 0) {
        lrow[r] = lrow[r] * alpha + psum;
        mrow[r] = m_new;
        arow[r] = alpha;
        psrow[r] = ps;
      }
    }
    __syncthreads();
    // context: acc = acc * alpha + int32(p8 . v8) * ps, (query head, dim) pairs
    for (int idx = threadIdx.x; idx < gq * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int* pr = p8w + r * (page / 4);
      const int* vr = vtw + d * (vt_row / 4);
      int ci = 0;
#pragma unroll 4
      for (int i = 0; i < page / 4; ++i) ci = __dp4a(pr[i], vr[i], ci);
      acc[idx] = acc[idx] * arow[r] + (float)ci * psrow[r];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gq * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const float l = lrow[r] == 0.f ? 1.f : lrow[r];
    out[((size_t)b * Hq + h * gq + r) * D + d] = __float2bfloat16_rn(acc[idx] / l);
  }
}

template <int D>
cudaError_t launch_decode(const void* q, const void* k_pages, const void* v_pages,
                          const void* kv_scales, const void* block_table,
                          const void* lengths, const void* slopes, void* out, int B,
                          int Hq, int Hkv, int page, int P, int n_pt, int layer,
                          float scale, int window, float softcap, cudaStream_t st) {
  const size_t smem = DecodeSmem(Hq / Hkv, D, page).total;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(paged_decode_int8_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  paged_decode_int8_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k_pages),
      static_cast<const int8_t*>(v_pages), static_cast<const float*>(kv_scales),
      static_cast<const int*>(block_table), static_cast<const int*>(lengths),
      static_cast<const float*>(slopes), static_cast<bf16*>(out), Hq, Hkv, page, P,
      n_pt, layer, scale, window, softcap);
  return cudaGetLastError();
}

bool shapes_ok(int B, int Hq, int Hkv, int page, int P, int n_pt, int layer) {
  return B > 0 && Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv <= 32 && page > 0 &&
         page % 4 == 0 && page <= kMaxPage && P > 0 && n_pt > 0 && layer >= 0;
}

}  // namespace

// q, out: [B, Hq, D] bf16; k_pages, v_pages: int8 [L, P, Hkv, page, D];
// kv_scales: f32 [L, P, 8, Hkv * page]; block_table: int32 [B, n_pt]
// (entries in [0, P)); lengths: int32 [B] (keys per slot, the current
// token's included); slopes: f32 [Hq] or null; window <= 0 and softcap <= 0
// disable.
extern "C" int qtt_paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* kv_scales,
    const void* block_table, const void* lengths, const void* slopes, void* out,
    int B, int Hq, int Hkv, int page, int D, int P, int n_pt, int layer, float scale,
    int window, float softcap, void* stream) {
  if (!shapes_ok(B, Hq, Hkv, page, P, n_pt, layer)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_decode<64>(q, k_pages, v_pages, kv_scales, block_table, lengths, slopes, out, B, Hq, Hkv, page, P, n_pt, layer, scale, window, softcap, st);
    case 128: return launch_decode<128>(q, k_pages, v_pages, kv_scales, block_table, lengths, slopes, out, B, Hq, Hkv, page, P, n_pt, layer, scale, window, softcap, st);
    case 256: return launch_decode<256>(q, k_pages, v_pages, kv_scales, block_table, lengths, slopes, out, B, Hq, Hkv, page, P, n_pt, layer, scale, window, softcap, st);
    default: return cudaErrorInvalidValue;
  }
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
