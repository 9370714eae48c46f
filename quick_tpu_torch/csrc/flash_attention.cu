// K2: causal GQA flash attention for prefill.
//
// Replaces the Pallas kernel quick_tpu/ops/flash_attention.py::_flash_kernel
// (:40), launched by _flash_bhsd (:169) from flash_attention (:248).
//
// What it computes: softmax(q k^T * scale [softcap] [+ ALiBi] [mask]) v for
// q [B, S, Hq, D] against a head-major K [B, Hkv, T, D] and V [B, Hkv, T, DV]
// (the dense cache layout), with query head h reading kv head h / (Hq / Hkv).
// DV is D, or 128 at D = 192: DeepSeek's MLA expanded prefill (q / k =
// [nope 128 | rope 64], v 128; the Pallas kernel tiles Q / K at D and V / O
// at Dv, :187-236). Query row s of
// batch b sits at absolute position qoff[b] + s; key t is visible iff
// t <= position, t < klen[b] and, with a window, t > position - window.
// Rows with no visible key return 0, as in the Pallas kernel.
//
// What bounds it on the H100: at prefill lengths the q k^T and p v
// products (4 * S * T_visible * D per head); at the slice's S = 128 the
// whole call is small and launch-bound. This version runs the products on
// the CUDA cores; tensor cores (mma / wgmma) are later work.
//
// Design. One block per (16 query rows, query head, batch), four warps of
// four rows each. K/V tiles of 64 keys are staged in shared memory and
// shared by the 16 rows; the loop over tiles starts at the window's first
// key and stops at the last key any row of the block can see, so tiles past
// the causal edge, the kv length or below the window are never read (the
// TPU kernel needs clamped index maps and a static diagonal-bias tile for
// the same effect; here it is a loop bound). The online softmax keeps the
// Pallas kernel's rounding of p to bf16 before p @ v.
#include "attention_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block

template <int D, int DV = D>
constexpr size_t smem_bytes() {
  return (size_t)kBQ * D * 4 + attn::Tile<D, DV>::kKBytes +
         attn::Tile<D, DV>::kVBytes;
}

template <int D, int DV = D>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const int* __restrict__ qoff,
             const int* __restrict__ klen, const float* __restrict__ slopes,
             bf16* __restrict__ out, int S, int T, int Hq, int Hkv,
             float scale, int window, float softcap) {
  constexpr int R = kRowsPerWarp;
  constexpr int kDPL = DV / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem + (size_t)kBQ * D * 4);
  bf16* vs = reinterpret_cast<bf16*>(smem + (size_t)kBQ * D * 4 +
                                     attn::Tile<D, DV>::kKBytes);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int off = qoff[b];
  const int kl = min(klen[b], T);

  for (int c = threadIdx.x; c < kBQ * D; c += blockDim.x) {
    const int r = c / D, d = c % D, srow = q0 + r;
    qs[c] = srow < S ? bf2f(q[(((size_t)b * S + srow) * Hq + h) * D + d]) : 0.f;
  }
  const int q_first = off + q0;
  const int q_last = off + min(q0 + kBQ, S) - 1;
  const int t_end = min(kl, q_last + 1);
  int t_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  t_begin = (t_begin / attn::kBK) * attn::kBK;

  attn::RowRule rule[R];
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    rule[r] = attn::RowRule{q_first + warp * R + r, kl, window, slope};
  attn::RowState<DV, R> st;
  st.init();

  const bf16* kh = k + ((size_t)b * Hkv + hk) * T * D;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * T * DV;
  for (int t0 = t_begin; t0 < t_end; t0 += attn::kBK) {
    __syncthreads();  // the previous tile is consumed
    attn::stage_kv<D, DV>(kh, vh, t0, t_end, ks, vs);
    __syncthreads();
    attn::attend_tile<D, R, false, DV>(st, qs + warp * R * D, rule, ks, vs,
                                       t0, scale, softcap, lane);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int srow = q0 + warp * R + r;
    if (srow >= S) break;
    const float l = st.l[r] == 0.f ? 1.f : st.l[r];
    bf16* o = out + (((size_t)b * S + srow) * Hq + h) * DV + lane * kDPL;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) o[i] = __float2bfloat16_rn(st.acc[r][i] / l);
  }
}

template <int D, int DV = D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qoff, const void* klen, const void* slopes,
                   void* out, int B, int S, int T, int Hq, int Hkv,
                   float scale, int window, float softcap, cudaStream_t st) {
  const size_t smem = smem_bytes<D, DV>();
  cudaError_t err = allow_smem(flash_kernel<D, DV>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<D, DV><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(qoff),
      static_cast<const int*>(klen), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), S, T, Hq, Hkv, scale, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// q: [B, S, Hq, D] bf16; k: [B, Hkv, T, D] bf16; v: [B, Hkv, T, Dv] bf16;
// out: [B, S, Hq, Dv] bf16; qoff, klen: int32 [B]; slopes: f32 [Hq] or
// null; window <= 0 and softcap <= 0 disable. Dv == D (64, 128, 256), or
// D = 192 with Dv = 128.
extern "C" int qtt_flash_attention(const void* q, const void* k,
                                   const void* v, const void* qoff,
                                   const void* klen, const void* slopes,
                                   void* out, int B, int S, int T, int Hq,
                                   int Hkv, int D, int Dv, float scale,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 192 && Dv == 128)
    return launch<192, 128>(q, k, v, qoff, klen, slopes, out, B, S, T, Hq, Hkv, scale, window, softcap, st);
  if (Dv != D) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch<64>(q, k, v, qoff, klen, slopes, out, B, S, T, Hq, Hkv, scale, window, softcap, st);
    case 128: return launch<128>(q, k, v, qoff, klen, slopes, out, B, S, T, Hq, Hkv, scale, window, softcap, st);
    case 256: return launch<256>(q, k, v, qoff, klen, slopes, out, B, S, T, Hq, Hkv, scale, window, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}
