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
// 0 (:111). Keys at or past a row's length are never read.
//
// What bounds it on the H100: bytes — the valid K and V rows
// (2 * length * Hkv * D * 2 bytes per row) plus q and out, at 3.35 TB/s.
// At the decode of the 128/128 protocol (B=32, lengths 129-255) that is
// ~25 MB, ~7.5 us.
//
// Design. A dense cache is a paged cache with one T-row page per row, so
// K5's design carries over: one block of four warps per (kv head, row)
// serves that head's Hq / Hkv query heads, so every staged K / V row is
// read once for all of them, and each block reads its row's length from
// device memory (never a launch argument: a captured decode step can be
// replayed unchanged). B x Hkv blocks are too few to fill 132 SMs at small
// batches (32 at B=4), so the key range is split into `splits` chunks of
// `chunk` keys (the host picks both from T and B x Hkv, never from the
// lengths): each block folds its chunk into f32 partial sums (m, l, acc),
// and a second kernel merges the splits of each (row, query head) in split
// order, so the output does not depend on block scheduling and greedy
// decoding stays deterministic. With one split the first kernel writes the
// output itself. Not carried over from the TPU: the nb x c grid steps sized
// for 2 MB of VMEM, the int8 block-diagonal head mask (a block holds one kv
// head), the in-chunk position row and the clamped index map (a block past
// its row's length stages nothing).
#include "attention_tile.cuh"

namespace {

constexpr int kWarps = 4;

template <int D, int R, bool kFinal>
__global__ void __launch_bounds__(kWarps * 32)
dense_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lengths,
                    const float* __restrict__ slopes, bf16* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int B, int Hq, int Hkv, int T, int layer, int chunk,
                    float scale, float softcap) {
  constexpr int kRows = kWarps * R;
  constexpr int kDPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kRows][D]
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem + (size_t)kRows * D * 4);
  bf16* vs = reinterpret_cast<bf16*>(smem + (size_t)kRows * D * 4 +
                                     attn::Tile<D>::kKBytes);
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int gq = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < kRows * D; c += blockDim.x) {
    const int r = c / D, d = c % D;
    qs[c] = r < gq ? bf2f(q[((size_t)b * Hq + h * gq + r) * D + d]) : 0.f;
  }
  const int length = max(0, min(lengths[b], T));
  const int t_begin = split * chunk;
  const int t_end = min(length, t_begin + chunk);

  const bool active = warp * R < gq;
  attn::RowRule rule[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int hq = min(h * gq + warp * R + r, Hq - 1);
    rule[r] = attn::RowRule{length - 1, t_end, 0,
                            slopes != nullptr ? slopes[hq] : 0.f};
  }
  attn::RowState<D, R> st;
  st.init();
  const size_t head = (((size_t)layer * B + b) * Hkv + h) * (size_t)T * D;
  for (int t0 = t_begin; t0 < t_end; t0 += attn::kBK) {
    __syncthreads();  // the previous tile is consumed (and q staged)
    attn::stage_kv<D>(k + head, v + head, t0, t_end, ks, vs);
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
    const size_t row = (size_t)b * Hq + h * gq + i;
    if (kFinal) {
      const float l = st.l[r] == 0.f ? 1.f : st.l[r];
      bf16* o = out + row * D + lane * kDPL;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) o[e] = __float2bfloat16_rn(st.acc[r][e] / l);
    } else {
      const size_t slot = row * splits + split;
      float* a = part_acc + slot * D + lane * kDPL;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) a[e] = st.acc[r][e];
      if (lane == 0) {
        part_ml[2 * slot] = st.m[r];
        part_ml[2 * slot + 1] = st.l[r];
      }
    }
  }
}

// Merge the splits of each (row, query head), one warp per pair, in split
// order: O = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
merge_splits_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, bf16* __restrict__ out,
                    int rows, int splits) {
  constexpr int kDPL = D / 32;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part_ml + (size_t)row * splits * 2;
  float M = QTT_NEG_INF;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f, acc[kDPL];
#pragma unroll
  for (int e = 0; e < kDPL; ++e) acc[e] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(ml[2 * s] - M);
    L += ml[2 * s + 1] * w;
    const float* a = part_acc + ((size_t)row * splits + s) * D + lane * kDPL;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[e] = fmaf(w, a[e], acc[e]);
  }
  L = L == 0.f ? 1.f : L;
  bf16* o = out + (size_t)row * D + lane * kDPL;
#pragma unroll
  for (int e = 0; e < kDPL; ++e) o[e] = __float2bfloat16_rn(acc[e] / L);
}

template <int D, int R, bool kFinal>
cudaError_t launch_pass(const void* q, const void* k, const void* v,
                        const void* lengths, const void* slopes, void* out,
                        void* part_acc, void* part_ml, int B, int Hq, int Hkv,
                        int T, int layer, int chunk, int splits, float scale,
                        float softcap, cudaStream_t st) {
  const size_t smem = (size_t)kWarps * R * D * 4 + attn::Tile<D>::kKBytes +
                      attn::Tile<D>::kVBytes;
  cudaError_t err = allow_smem(dense_decode_kernel<D, R, kFinal>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, splits);
  dense_decode_kernel<D, R, kFinal><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<const float*>(slopes), static_cast<bf16*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), B, Hq, Hkv,
      T, layer, chunk, scale, softcap);
  return cudaGetLastError();
}

template <int D, int R>
cudaError_t launch_d_r(const void* q, const void* k, const void* v,
                       const void* lengths, const void* slopes, void* out,
                       void* part_acc, void* part_ml, int B, int Hq, int Hkv,
                       int T, int layer, int chunk, int splits, float scale,
                       float softcap, cudaStream_t st) {
  if (splits == 1)
    return launch_pass<D, R, true>(q, k, v, lengths, slopes, out, nullptr,
                                   nullptr, B, Hq, Hkv, T, layer, chunk, 1,
                                   scale, softcap, st);
  cudaError_t err = launch_pass<D, R, false>(
      q, k, v, lengths, slopes, out, part_acc, part_ml, B, Hq, Hkv, T, layer,
      chunk, splits, scale, softcap, st);
  if (err != cudaSuccess) return err;
  const int rows = B * Hq;
  merge_splits_kernel<D><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), rows, splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int R, const void* q, const void* k, const void* v,
                     const void* lengths, const void* slopes, void* out,
                     void* part_acc, void* part_ml, int B, int Hq, int Hkv,
                     int T, int layer, int chunk, int splits, float scale,
                     float softcap, cudaStream_t st) {
#define QTT_LAUNCH(RR)                                                       \
  launch_d_r<D, RR>(q, k, v, lengths, slopes, out, part_acc, part_ml, B, Hq, \
                    Hkv, T, layer, chunk, splits, scale, softcap, st)
  switch (R) {
    case 1: return QTT_LAUNCH(1);
    case 2: return QTT_LAUNCH(2);
    case 4: return QTT_LAUNCH(4);
    case 8: return QTT_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef QTT_LAUNCH
}

}  // namespace

// q, out: [B, Hq, D] bf16; k, v: [L, B, Hkv, T, D] bf16; lengths: int32 [B]
// (keys per row, the current token's included; clamped to T); slopes: f32
// [Hq] or null; softcap <= 0 disables. The key range [0, T) is cut into
// `splits` chunks of `chunk` keys (a multiple of 64, splits * chunk >= T);
// with splits > 1, part_acc (f32 [B, Hq, splits, D]) and part_ml (f32
// [B, Hq, splits, 2]) hold the partial sums for the merge.
extern "C" int qtt_dense_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* slopes, void* out, void* part_acc, void* part_ml, int B,
    int Hq, int Hkv, int T, int D, int L, int layer, int chunk, int splits,
    float scale, float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 32 || T <= 0 ||
      layer < 0 || layer >= L || chunk <= 0 || chunk % attn::kBK != 0 ||
      splits <= 0 || (long long)splits * chunk < T || B > 65535 ||
      splits > 65535 || (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const int gq = Hq / Hkv;
  const int R = gq <= 4 ? 1 : gq <= 8 ? 2 : gq <= 16 ? 4 : 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_d<64>(R, q, k, v, lengths, slopes, out, part_acc, part_ml, B, Hq, Hkv, T, layer, chunk, splits, scale, softcap, st);
    case 128: return launch_d<128>(R, q, k, v, lengths, slopes, out, part_acc, part_ml, B, Hq, Hkv, T, layer, chunk, splits, scale, softcap, st);
    case 256: return launch_d<256>(R, q, k, v, lengths, slopes, out, part_acc, part_ml, B, Hq, Hkv, T, layer, chunk, splits, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}
