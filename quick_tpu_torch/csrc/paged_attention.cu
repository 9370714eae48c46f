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
// call is latency- and launch-bound; this version runs the dots on the CUDA
// cores with the online-softmax tile of attention_tile.cuh.
//
// Design. K5: one block per (kv head, slot) serves that head's Hq / Hkv
// query heads (four warps, R heads each), so every staged page row is read
// once for all of them. K6: one block per (16 query rows, kv head, slot),
// the rows being (chunk position, query head) pairs of that kv head, so the
// chunk's queries of one kv head share every staged tile. Each block reads
// its slot's length or start from device memory (never a launch argument:
// the host does not have to know it), walks the block-table row in tiles of
// 64 keys from the window's first key to the last visible key, and gathers
// each key's row from its page while staging. Not carried over from the
// TPU: scalar prefetch and clamped index maps (a block reads its own block
// table), the static block-diagonal head mask (a block holds one kv head),
// and the pages-per-step and slots-per-step tuning.
#include "attention_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kChunkRowsPerWarp = 4;
constexpr int kBQ = kWarps * kChunkRowsPerWarp;  // K6 query rows per block

// Stage keys [t0, t0 + kBK) of kv head h of one slot (block-table row bt)
// into shared memory, as attn::stage_kv does for a dense head; keys at or
// past t_end are zero-filled.
template <int D>
__device__ __forceinline__ void stage_paged(const bf16* __restrict__ k_pages,
                                            const bf16* __restrict__ v_pages,
                                            const int* __restrict__ bt,
                                            size_t layer_pages, int Hkv, int h,
                                            int page, int t0, int t_end,
                                            uint32_t* ks, bf16* vs) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < attn::kBK * kChunks; c += blockDim.x) {
    const int j = c / kChunks, d8 = (c % kChunks) * 8;
    const int t = t0 + j;
    uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
    if (t < t_end) {
      const size_t pg = layer_pages + bt[t / page];
      const size_t off = ((pg * Hkv + h) * page + t % page) * D + d8;
      kv4 = *reinterpret_cast<const uint4*>(k_pages + off);
      vv4 = *reinterpret_cast<const uint4*>(v_pages + off);
    }
    uint32_t* kr = ks + j * attn::Tile<D>::kStride + d8 / 2;
    kr[0] = kv4.x; kr[1] = kv4.y; kr[2] = kv4.z; kr[3] = kv4.w;
    *reinterpret_cast<uint4*>(vs + j * D + d8) = vv4;
  }
}

template <int D>
constexpr size_t tile_bytes() {
  return attn::Tile<D>::kKBytes + attn::Tile<D>::kVBytes;
}

// ---------------------------------------------------------------- K5 decode
template <int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                    const bf16* __restrict__ v_pages,
                    const int* __restrict__ block_table,
                    const int* __restrict__ lengths,
                    const float* __restrict__ slopes, bf16* __restrict__ out,
                    int Hq, int Hkv, int page, int P, int n_pt, int layer,
                    float scale, int window, float softcap) {
  constexpr int kRows = kWarps * R;
  constexpr int kDPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kRows][D]
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem + (size_t)kRows * D * 4);
  bf16* vs = reinterpret_cast<bf16*>(smem + (size_t)kRows * D * 4 +
                                     attn::Tile<D>::kKBytes);
  const int h = blockIdx.x, b = blockIdx.y;
  const int gq = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < kRows * D; c += blockDim.x) {
    const int r = c / D, d = c % D;
    qs[c] = r < gq ? bf2f(q[((size_t)b * Hq + h * gq + r) * D + d]) : 0.f;
  }
  const int length = lengths[b];
  const int t_end = min(length, n_pt * page);
  int t_begin = window > 0 ? max(0, length - window) : 0;
  t_begin = (t_begin / attn::kBK) * attn::kBK;

  const bool active = warp * R < gq;
  attn::RowRule rule[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int hq = min(h * gq + warp * R + r, Hq - 1);
    rule[r] = attn::RowRule{length - 1, t_end, window,
                            slopes != nullptr ? slopes[hq] : 0.f};
  }
  attn::RowState<D, R> st;
  st.init();
  const int* bt = block_table + (size_t)b * n_pt;
  for (int t0 = t_begin; t0 < t_end; t0 += attn::kBK) {
    __syncthreads();  // the previous tile is consumed (and q staged)
    stage_paged<D>(k_pages, v_pages, bt, (size_t)layer * P, Hkv, h, page, t0,
                   t_end, ks, vs);
    __syncthreads();
    if (active)
      attn::attend_tile<D, R>(st, qs + warp * R * D, rule, ks, vs, t0, scale,
                              softcap, lane);
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = warp * R + r;
    if (i >= gq) break;
    const float l = st.l[r] == 0.f ? 1.f : st.l[r];
    bf16* o = out + ((size_t)b * Hq + h * gq + i) * D + lane * kDPL;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) o[e] = __float2bfloat16_rn(st.acc[r][e] / l);
  }
}

// ----------------------------------------------------------------- K6 chunk
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_chunk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                   const bf16* __restrict__ v_pages,
                   const int* __restrict__ block_table,
                   const int* __restrict__ starts,
                   const float* __restrict__ slopes, bf16* __restrict__ out,
                   int S, int Hq, int Hkv, int page, int P, int n_pt, int layer,
                   float scale, int window, float softcap) {
  constexpr int R = kChunkRowsPerWarp;
  constexpr int kDPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kBQ][D]
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem + (size_t)kBQ * D * 4);
  bf16* vs = reinterpret_cast<bf16*>(smem + (size_t)kBQ * D * 4 +
                                     attn::Tile<D>::kKBytes);
  const int h = blockIdx.y, b = blockIdx.z;
  const int gq = Hq / Hkv;
  const int n_rows = S * gq;  // row = chunk position * gq + head in group
  const int r0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < kBQ * D; c += blockDim.x) {
    const int row = r0 + c / D, d = c % D;
    float v = 0.f;
    if (row < n_rows) {
      const int i = row / gq, g = row % gq;
      v = bf2f(q[(((size_t)b * S + i) * Hq + h * gq + g) * D + d]);
    }
    qs[c] = v;
  }
  const int start = starts[b];
  const int i_first = r0 / gq;
  const int i_last = (min(r0 + kBQ, n_rows) - 1) / gq;
  const int t_end = min(start + i_last + 1, n_pt * page);
  int t_begin = window > 0 ? max(0, start + i_first - window + 1) : 0;
  t_begin = (t_begin / attn::kBK) * attn::kBK;

  attn::RowRule rule[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(r0 + warp * R + r, n_rows - 1);
    const int hq = h * gq + row % gq;
    rule[r] = attn::RowRule{start + row / gq, t_end, window,
                            slopes != nullptr ? slopes[hq] : 0.f};
  }
  attn::RowState<D, R> st;
  st.init();
  const int* bt = block_table + (size_t)b * n_pt;
  for (int t0 = t_begin; t0 < t_end; t0 += attn::kBK) {
    __syncthreads();  // the previous tile is consumed (and q staged)
    stage_paged<D>(k_pages, v_pages, bt, (size_t)layer * P, Hkv, h, page, t0,
                   t_end, ks, vs);
    __syncthreads();
    attn::attend_tile<D, R>(st, qs + warp * R * D, rule, ks, vs, t0, scale,
                            softcap, lane);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + warp * R + r;
    if (row >= n_rows) break;
    const int i = row / gq, g = row % gq;
    const float l = st.l[r] == 0.f ? 1.f : st.l[r];
    bf16* o = out + (((size_t)b * S + i) * Hq + h * gq + g) * D + lane * kDPL;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) o[e] = __float2bfloat16_rn(st.acc[r][e] / l);
  }
}

template <int D, int R>
cudaError_t launch_decode(const void* q, const void* k_pages,
                          const void* v_pages, const void* block_table,
                          const void* lengths, const void* slopes, void* out,
                          int B, int Hq, int Hkv, int page, int P, int n_pt,
                          int layer, float scale, int window, float softcap,
                          cudaStream_t st) {
  const size_t smem = (size_t)kWarps * R * D * 4 + tile_bytes<D>();
  cudaError_t err = allow_smem(paged_decode_kernel<D, R>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  paged_decode_kernel<D, R><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), Hq, Hkv, page, P, n_pt, layer, scale, window,
      softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t decode_r(int R, const void* q, const void* k_pages,
                     const void* v_pages, const void* block_table,
                     const void* lengths, const void* slopes, void* out, int B,
                     int Hq, int Hkv, int page, int P, int n_pt, int layer,
                     float scale, int window, float softcap, cudaStream_t st) {
#define QTT_LAUNCH(RR)                                                        \
  launch_decode<D, RR>(q, k_pages, v_pages, block_table, lengths, slopes, out, \
                       B, Hq, Hkv, page, P, n_pt, layer, scale, window,        \
                       softcap, st)
  switch (R) {
    case 1: return QTT_LAUNCH(1);
    case 2: return QTT_LAUNCH(2);
    case 4: return QTT_LAUNCH(4);
    case 8: return QTT_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef QTT_LAUNCH
}

template <int D>
cudaError_t launch_chunk(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_table,
                         const void* starts, const void* slopes, void* out,
                         int B, int S, int Hq, int Hkv, int page, int P,
                         int n_pt, int layer, float scale, int window,
                         float softcap, cudaStream_t st) {
  const size_t smem = (size_t)kBQ * D * 4 + tile_bytes<D>();
  cudaError_t err = allow_smem(paged_chunk_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int n_rows = S * (Hq / Hkv);
  dim3 grid((n_rows + kBQ - 1) / kBQ, Hkv, B);
  paged_chunk_kernel<D><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(starts), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), S, Hq, Hkv, page, P, n_pt, layer, scale,
      window, softcap);
  return cudaGetLastError();
}

bool shapes_ok(int B, int Hq, int Hkv, int page, int P, int n_pt, int layer) {
  return B > 0 && Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv <= 32 && page > 0 &&
         P > 0 && n_pt > 0 && layer >= 0;
}

}  // namespace

// q, out: [B, Hq, D] bf16; k_pages, v_pages: [L, P, Hkv, page, D] bf16;
// block_table: int32 [B, n_pt] (entries in [0, P)); lengths: int32 [B]
// (keys per slot, the current token's included); slopes: f32 [Hq] or null;
// window <= 0 and softcap <= 0 disable.
extern "C" int qtt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, const void* slopes,
    void* out, int B, int Hq, int Hkv, int page, int D, int P, int n_pt,
    int layer, float scale, int window, float softcap, void* stream) {
  if (!shapes_ok(B, Hq, Hkv, page, P, n_pt, layer)) return cudaErrorInvalidValue;
  const int gq = Hq / Hkv;
  const int R = gq <= 4 ? 1 : gq <= 8 ? 2 : gq <= 16 ? 4 : 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return decode_r<64>(R, q, k_pages, v_pages, block_table, lengths, slopes, out, B, Hq, Hkv, page, P, n_pt, layer, scale, window, softcap, st);
    case 128: return decode_r<128>(R, q, k_pages, v_pages, block_table, lengths, slopes, out, B, Hq, Hkv, page, P, n_pt, layer, scale, window, softcap, st);
    case 256: return decode_r<256>(R, q, k_pages, v_pages, block_table, lengths, slopes, out, B, Hq, Hkv, page, P, n_pt, layer, scale, window, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

// q, out: [B, S, Hq, D] bf16; starts: int32 [B] (keys cached before the
// chunk; the chunk's own keys must already be written); the rest as above.
extern "C" int qtt_paged_chunk_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* starts, const void* slopes,
    void* out, int B, int S, int Hq, int Hkv, int page, int D, int P, int n_pt,
    int layer, float scale, int window, float softcap, void* stream) {
  if (S <= 0 || !shapes_ok(B, Hq, Hkv, page, P, n_pt, layer))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_chunk<64>(q, k_pages, v_pages, block_table, starts, slopes, out, B, S, Hq, Hkv, page, P, n_pt, layer, scale, window, softcap, st);
    case 128: return launch_chunk<128>(q, k_pages, v_pages, block_table, starts, slopes, out, B, S, Hq, Hkv, page, P, n_pt, layer, scale, window, softcap, st);
    case 256: return launch_chunk<256>(q, k_pages, v_pages, block_table, starts, slopes, out, B, S, Hq, Hkv, page, P, n_pt, layer, scale, window, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}
