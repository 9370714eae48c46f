// K3: fused decode step — RoPE on q/k, the new k/v row written into the
// dense cache, attention over the cache plus the new token, in one kernel.
//
// Replaces the Pallas kernel quick_tpu/ops/fused_decode_step.py::_kernel
// (:45), launched by fused_decode_attention (:164).
//
// What it computes, for one new token per batch row at position `length`:
// q and k_new rotated (rotate-half, full-width duplicated cos/sin rows)
// and rounded to bf16; k_new and v_new written at `length` of layer `layer`
// of the [L, B, Hkv, S, D] caches (in place); q scaled by `scale` in f32;
// scores against the cached positions [0, length) use the bf16-rounded
// scaled q, the new token's score uses the f32 one (the Pallas kernel's
// side dot, :125-131). Softcap, ALiBi and the sliding window apply as in
// the Pallas kernel; p for cached positions is rounded to bf16 before
// p @ v, the new token's p stays f32.
//
// What bounds it on the H100: the cache read, 2 * length * D * 2 bytes per
// (batch row, kv head); a few MB per layer at the slice's shapes, so the
// call is latency- and launch-bound.
//
// Design. One block per (kv head, batch row); its gq = Hq / Hkv query
// heads share every staged K/V tile (four warps, R heads each). The block
// first rotates and writes the new row and stages the scaled queries, then
// runs the online softmax of attention_tile.cuh over the cached prefix,
// then folds in the new token from registers. Not carried over from the
// TPU: the static [D, D] rotate-half matrix (a lane index does it here),
// the aliased 8/16-row group read-modify-write of the cache (a plain store
// of one row) and the masked-column overlay (the loop stops before the
// new position).
#include "attention_tile.cuh"

namespace {

constexpr int kWarps = 4;

template <int D, int R>
constexpr size_t smem_bytes() {
  return (size_t)2 * kWarps * R * D * 4 + 2 * (size_t)D * 4 +
         attn::Tile<D>::kKBytes + attn::Tile<D>::kVBytes;
}

template <int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
fused_step_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                  const bf16* __restrict__ v_new, bf16* __restrict__ k_cache,
                  bf16* __restrict__ v_cache, const float* __restrict__ cos_row,
                  const float* __restrict__ sin_row,
                  const float* __restrict__ slopes, bf16* __restrict__ out,
                  int B, int Hq, int Hkv, int S, int layer,
                  const int* __restrict__ length_ptr, float scale, int window,
                  float softcap, int use_rope) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int gq = Hq / Hkv;
  const int length = *length_ptr;
  if (length < 0 || length >= S) {  // outside the cache: no write, NaN out
    for (int i = threadIdx.x; i < gq * D; i += blockDim.x)
      out[((size_t)b * Hq + h * gq) * D + i] = __float2bfloat16_rn(__int_as_float(0x7fc00000));
    return;
  }
  constexpr int kDPL = D / 32;
  constexpr int kRows = kWarps * R;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem);  // [kRows][D] q * scale, f32
  float* qb = qf + kRows * D;                  // [kRows][D] bf16-rounded
  float* kn = qb + kRows * D;                  // [D] roped k_new (bf16 value)
  float* vn = kn + D;                          // [D] v_new
  uint32_t* ks = reinterpret_cast<uint32_t*>(vn + D);
  bf16* vs = reinterpret_cast<bf16*>(smem + (size_t)2 * kRows * D * 4 +
                                     2 * (size_t)D * 4 + attn::Tile<D>::kKBytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t head = (((size_t)layer * B + b) * Hkv + h) * S * D;
  const float* cr = cos_row + (size_t)b * D;
  const float* sr = sin_row + (size_t)b * D;

  // rotate-half: x*cos + rot(x)*sin, rot(x)[d] = -x[d + D/2] | x[d - D/2]
  auto rope = [&](const bf16* x, int d) {
    const float xv = bf2f(x[d]);
    if (!use_rope) return xv;
    const float rot = d < D / 2 ? -bf2f(x[d + D / 2]) : bf2f(x[d - D / 2]);
    return xv * cr[d] + rot * sr[d];
  };
  const bf16* kr = k_new + ((size_t)b * Hkv + h) * D;
  const bf16* vr = v_new + ((size_t)b * Hkv + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const bf16 kb = __float2bfloat16_rn(rope(kr, d));
    k_cache[head + (size_t)length * D + d] = kb;
    kn[d] = bf2f(kb);
    v_cache[head + (size_t)length * D + d] = vr[d];
    vn[d] = bf2f(vr[d]);
    for (int i = 0; i < kRows; ++i) {
      float qs = 0.f;
      if (i < gq) qs = round_bf16(rope(q + ((size_t)b * Hq + h * gq + i) * D, d)) * scale;
      qf[i * D + d] = qs;
      qb[i * D + d] = round_bf16(qs);
    }
  }

  const bool active = warp * R < gq;
  attn::RowRule rule[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int hq = min(h * gq + warp * R + r, Hq - 1);
    rule[r] = attn::RowRule{length, length, window,
                            slopes != nullptr ? slopes[hq] : 0.f};
  }
  attn::RowState<D, R> st;
  st.init();
  int t_begin = window > 0 ? max(0, length - window + 1) : 0;
  t_begin = (t_begin / attn::kBK) * attn::kBK;
  const bf16* kh = k_cache + head;
  const bf16* vh = v_cache + head;
  for (int t0 = t_begin; t0 < length; t0 += attn::kBK) {
    __syncthreads();  // the previous tile is consumed (and q/kn/vn staged)
    attn::stage_kv<D>(kh, vh, t0, length, ks, vs);
    __syncthreads();
    if (active)
      attn::attend_tile<D, R>(st, qb + warp * R * D, rule, ks, vs, t0, 1.f,
                              softcap, lane);
  }
  __syncthreads();  // q/kn/vn visible when no tile ran
  if (!active) return;

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = warp * R + r;
    if (i >= gq) break;
    // the new token: f32 q . f32 k_new, no ALiBi bias (its distance is 0)
    float sn = 0.f;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = lane * kDPL + e;
      sn = fmaf(qf[i * D + d], kn[d], sn);
    }
    sn = warp_sum(sn);
    if (softcap > 0.f) sn = softcap * tanhf(sn / softcap);
    const float m = fmaxf(st.m[r], sn);
    const float alpha = expf(st.m[r] - m);
    const float pn = expf(sn - m);
    const float l = st.l[r] * alpha + pn;
    bf16* o = out + ((size_t)b * Hq + h * gq + i) * D + lane * kDPL;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const float a = st.acc[r][e] * alpha + pn * vn[lane * kDPL + e];
      o[e] = __float2bfloat16_rn(a / l);
    }
  }
}

template <int D, int R>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_cache, void* v_cache, const void* cos_row,
                   const void* sin_row, const void* slopes, void* out, int B,
                   int Hq, int Hkv, int S, int layer, const int* length, float scale,
                   int window, float softcap, int use_rope, cudaStream_t st) {
  const size_t smem = smem_bytes<D, R>();
  cudaError_t err = allow_smem(fused_step_kernel<D, R>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  fused_step_kernel<D, R><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<bf16*>(k_cache),
      static_cast<bf16*>(v_cache), static_cast<const float*>(cos_row),
      static_cast<const float*>(sin_row), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), B, Hq, Hkv, S, layer, length, scale, window,
      softcap, use_rope);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_r(int R, const void* q, const void* k_new,
                       const void* v_new, void* k_cache, void* v_cache,
                       const void* cos_row, const void* sin_row,
                       const void* slopes, void* out, int B, int Hq, int Hkv,
                       int S, int layer, const int* length, float scale, int window,
                       float softcap, int use_rope, cudaStream_t st) {
#define QTT_LAUNCH(RR)                                                       \
  launch<D, RR>(q, k_new, v_new, k_cache, v_cache, cos_row, sin_row, slopes, \
                out, B, Hq, Hkv, S, layer, length, scale, window, softcap,   \
                use_rope, st)
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

// q, out: [B, Hq, D] bf16 (q pre-rope); k_new, v_new: [B, Hkv, D] bf16;
// k_cache, v_cache: [L, B, Hkv, S, D] bf16, written at [layer, :, :, length];
// cos_row, sin_row: f32 [B, D]; slopes: f32 [Hq] or null; window <= 0 and
// softcap <= 0 disable; use_rope = 0 passes q/k through unrotated. length:
// int32 [1] on the card, read by the kernel (a captured launch stays right
// as the length moves); for a length outside [0, S) it writes no cache row
// and NaN to out (the callers check the length on the host).
extern "C" int qtt_fused_decode_step(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, const void* cos_row, const void* sin_row,
    const void* slopes, void* out, int B, int Hq, int Hkv, int S, int D,
    int layer, const void* length, float scale, int window, float softcap,
    int use_rope, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || length == nullptr)
    return cudaErrorInvalidValue;
  const int gq = Hq / Hkv;
  const int R = gq <= 4 ? 1 : gq <= 8 ? 2 : gq <= 16 ? 4 : gq <= 32 ? 8 : 0;
  const int* len = static_cast<const int*>(length);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return dispatch_r<64>(R, q, k_new, v_new, k_cache, v_cache, cos_row, sin_row, slopes, out, B, Hq, Hkv, S, layer, len, scale, window, softcap, use_rope, st);
    case 128: return dispatch_r<128>(R, q, k_new, v_new, k_cache, v_cache, cos_row, sin_row, slopes, out, B, Hq, Hkv, S, layer, len, scale, window, softcap, use_rope, st);
    case 256: return dispatch_r<256>(R, q, k_new, v_new, k_cache, v_cache, cos_row, sin_row, slopes, out, B, Hq, Hkv, S, layer, len, scale, window, softcap, use_rope, st);
    default: return cudaErrorInvalidValue;
  }
}
