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
// products (2 * S * T_visible * (D + DV) flops per head) against the bf16
// tensor-core rate; at S = 128 the whole call is a few microseconds of
// bytes and launch. On mma.sync with 8 warps an SM the body is bound by
// latency (measured: without the softmax it still takes ~0.8 of its time at
// S = 1900); wgmma (q k^T from shared memory, p v with p in registers) is
// the next step.
//
// Design: both products on the tensor cores with mma.sync m16n8k16 (bf16
// in, f32 accumulate), P kept in registers.
//   - A block of 4 warps owns 64 * MT rows, each warp 16 * MT (MT = 2, two
//     m16 row tiles, at D = 128 and HG = 4 for prompts of 512 and more when
//     that grid still fills the card, so that each K / V fragment read from
//     shared memory feeds twice the MMAs; else MT = 1). A row is a (query
//     position, query head) pair of one kv head: HG = 1, 2 or 4 heads of the
//     kv head's group times 64 * MT / HG positions, so each K/V tile staged
//     once serves HG heads (GQA packing; HG = the largest of 4, 2, 1 that
//     divides Hq / Hkv). Warp w takes head w / (4 / HG) and 16 * MT
//     positions.
//   - Q is staged once. At MT = 1 and D <= 192 each warp keeps its ldmatrix
//     fragments in registers for the whole key loop; at MT = 2 or D = 256,
//     where the output accumulators take 128 registers a thread, it re-reads
//     them from shared memory.
//   - K / V tiles of 64 keys go through a ring of two stages filled by
//     cp.async: the next tile's copy overlaps this tile's products. Shared
//     rows are 128-byte swizzled (16-byte chunk c of row r at c ^ (r & 7)),
//     so ldmatrix (K as the B operand of q k^T) and ldmatrix.trans (V as the
//     B operand of p v) are free of bank conflicts.
//   - The score fragment gets scale, softcap, ALiBi and the mask by its row
//     and column in registers (the softmax runs in base 2: exp2 of the score
//     times log2 e, on ex2.approx); a row's max and sum go over the 4 lanes
//     that share it, and (up to DV = 128) the output is rescaled only when a
//     row's max moved.
//     p is rounded to bf16 in place (the Pallas kernel's p.astype(v.dtype))
//     and a pair of n8 score tiles is one k16 A fragment of p v, so p never
//     leaves the registers. The running sum l keeps the f32 p.
//   - The key loop starts at the window's first tile and stops at the last
//     key any row of the block sees (the TPU kernel needs clamped index maps
//     for that; here it is a loop bound); a warp skips tiles none of its rows
//     sees, and only tiles on the diagonal, the kv length or the window edge
//     are masked.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src must still be valid)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D += A (16 x 16, row) * B (16 x 8, col): bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; subnormal results flush to 0 (such a p
// is 0 in the bf16 p v anyway, and l gains nothing from it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of W-wide rows
template <int W>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * W * 2 + ((c ^ (r & 7)) << 4));
}

template <int D, int DV, int MT>
struct Smem {
  static constexpr int kBK = 64;  // keys per tile
  static constexpr int kQ = kWarps * 16 * MT * D * 2;
  static constexpr int kK = kBK * D * 2;
  static constexpr int kV = kBK * DV * 2;
  static constexpr size_t kBytes = (size_t)kQ + kStages * (kK + kV);
};

// Copy keys [t0, t0 + kBK) of one head's K [T, D] and V [T, DV] into a
// stage; keys at or past t_end are zero-filled (never read from memory).
template <int D, int DV, int kBK>
__device__ __forceinline__ void load_kv(const bf16* __restrict__ kh,
                                        const bf16* __restrict__ vh, int t0,
                                        int t_end, uint32_t ks, uint32_t vs) {
  for (int c = threadIdx.x; c < kBK * (D / 8); c += kWarps * 32) {
    const int j = c / (D / 8), ch = c % (D / 8);
    const bool ok = t0 + j < t_end;
    cp_async16(ks + swz<D>(j, ch), ok ? kh + (size_t)(t0 + j) * D + ch * 8 : kh, ok);
  }
  for (int c = threadIdx.x; c < kBK * (DV / 8); c += kWarps * 32) {
    const int j = c / (DV / 8), ch = c % (DV / 8);
    const bool ok = t0 + j < t_end;
    cp_async16(vs + swz<DV>(j, ch), ok ? vh + (size_t)(t0 + j) * DV + ch * 8 : vh, ok);
  }
}

// The masking and bias rules of a warp's rows.
struct Rows {
  int kl, window;
  float mul;       // the score's factor into the base-2 exponent
  float scale, softcap, slope;
  bool bias;       // softcap or ALiBi: transformed in natural units first
};

// Online softmax of one m16 x kBK score tile of a lane whose rows g and
// g + 8 sit at positions pos0 and pos0 + 8 (scores in s, on return the f32
// probabilities): scale, softcap, ALiBi, then (kMasked) the mask; the row
// maxima m (base 2) and partial sums l are updated and the output rows o
// rescaled. Keys outside a row's view get p = 0.
template <bool kMasked, int kNT, int kBK>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 8][4], float (&o)[kNT][4],
                                             float (&m)[2], float (&l)[2], int t0, int tq,
                                             int pos0, const Rows& rw) {
  uint32_t ok[2] = {0xffffu, 0xffffu};  // bit 2 * nt + (e & 1): key visible
  float mx[2] = {QTT_NEG_INF, QTT_NEG_INF};
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + nt * 8 + 2 * tq + (e & 1);
      const int pos = pos0 + (e >> 1) * 8;
      float sc = s[nt][e];
      if (rw.bias) {  // else the scale rides in mul
        sc *= rw.scale;
        if (rw.softcap > 0.f) sc = rw.softcap * tanhf(sc / rw.softcap);
        sc += rw.slope * (float)(t - pos);
      }
      if constexpr (kMasked) {
        const bool vis = t <= pos && t < rw.kl && (rw.window <= 0 || t > pos - rw.window);
        if (!vis) {
          sc = QTT_NEG_INF;
          ok[e >> 1] &= ~(1u << (2 * nt + (e & 1)));
        }
      }
      s[nt][e] = sc;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o2));
    const float mn = fmaxf(m[h], mx[h] * rw.mul);
    const float alpha = ex2(m[h] - mn);
    m[h] = mn;
    float ps = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        float p = ex2(fmaf(s[nt][e], rw.mul, -mn));
        if constexpr (kMasked) p = ((ok[h] >> (2 * nt + (e & 1))) & 1u) ? p : 0.f;
        s[nt][e] = p;
        ps += p;
      }
    }
    l[h] = l[h] * alpha + ps;  // per-lane partial sums; the quad adds them at the end
    // up to 128 wide, skip the rescale when no row of the warp moved its max
    // (at 256 the vote costs spills: the 128 output registers fill the file)
    if (kNT > 16 || __any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        o[i][2 * h] *= alpha;
        o[i][2 * h + 1] *= alpha;
      }
    }
  }
}

template <int D, int DV, int HG, int MT>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const int* __restrict__ qoff,
             const int* __restrict__ klen, const float* __restrict__ slopes,
             bf16* __restrict__ out, int S, int T, int Hq, int Hkv,
             float scale, int window, float softcap) {
  constexpr int kWR = 16 * MT;                  // rows per warp
  constexpr int P = kWarps * kWR / HG;          // positions per block
  constexpr int kWPH = kWarps / HG;             // warps per head
  constexpr bool kQRegs = MT == 1 && D <= 192;  // Q fragments held in registers
  constexpr int kKS = D / 16;                   // k16 steps of q k^T
  constexpr int kNT = DV / 8;                   // n8 tiles of the output
  using L = Smem<D, DV, MT>;
  constexpr int kBK = L::kBK;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t ks0 = qs + L::kQ;
  const uint32_t vs0 = ks0 + kStages * L::kK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int hk = blockIdx.y / (group / HG);
  const int head0 = hk * group + (blockIdx.y % (group / HG)) * HG;
  const int q0 = blockIdx.x * P;
  const int off = qoff[b];
  const int kl = min(klen[b], T);

  // this warp's head and first position (relative to the prompt)
  const int head = head0 + warp / kWPH;
  const int wq0 = q0 + (warp % kWPH) * kWR;

  // Q rows: block row r = warp' * kWR + i -> (head0 + warp' / kWPH, q0 +
  // (warp' % kWPH) * kWR + i); rows past S are zero-filled
  for (int c = tid; c < kWarps * kWR * (D / 8); c += kWarps * 32) {
    const int r = c / (D / 8), ch = c % (D / 8);
    const int w = r / kWR, s = q0 + (w % kWPH) * kWR + r % kWR;
    const bool ok = s < S;
    const bf16* src = ok ? q + (((size_t)b * S + s) * Hq + head0 + w / kWPH) * D + ch * 8 : q;
    cp_async16(qs + swz<D>(r, ch), src, ok);
  }

  const int q_first = off + q0;
  const int q_last = off + min(q0 + P, S) - 1;
  const int t_end = min(kl, q_last + 1);
  int t_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  t_begin = (t_begin / kBK) * kBK;
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kBK - 1) / kBK : 0;

  const bf16* kh = k + ((size_t)b * Hkv + hk) * T * D;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * T * DV;
  if (n_tiles > 0) load_kv<D, DV, kBK>(kh, vh, t_begin, t_end, ks0, vs0);
  cp_async_commit();

  // the warp's rows: positions p_lo .. p_lo + kWR - 1 (rows past S included:
  // they compute on zeros and are not written)
  const int p_lo = off + wq0;
  const float slope = slopes != nullptr ? slopes[head] : 0.f;
  const bool bias = softcap > 0.f || slope != 0.f;
  const Rows rw{kl, window, bias ? kLog2e : scale * kLog2e, scale, softcap, slope, bias};

  uint32_t qf[kQRegs ? kKS : 1][4];
  float o[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < kNT; ++i) o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = QTT_NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // ldmatrix row of this lane for the warp's Q rows (tile mt adds 16)
  const int qrow = warp * kWR + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int qchunk = lane >> 4;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kBK;
    const int st = it & 1;
    if (it + 1 < n_tiles)
      load_kv<D, DV, kBK>(kh, vh, t0 + kBK, t_end, ks0 + (st ^ 1) * L::kK,
                     vs0 + (st ^ 1) * L::kV);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) ldsm_x4(qf[kk], qs + swz<D>(qrow, 2 * kk + qchunk));
      }
    }
    // tiles none of this warp's rows sees: past its last row, or wholly
    // below the window of its first
    const bool skip = t0 > p_lo + kWR - 1 || (window > 0 && t0 + kBK - 1 <= p_lo - window);
    if (!skip) {
      const uint32_t ks = ks0 + st * L::kK, vs = vs0 + st * L::kV;
      float s[MT][kBK / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i) s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (kQRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[mt][i] = qf[kk][i];
          } else {
            ldsm_x4(a[mt], qs + swz<D>(qrow + mt * 16, 2 * kk + qchunk));
          }
        }
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + swz<D>(np * 16 + (lane >> 4) * 8 + (lane & 7),
                                  2 * kk + ((lane >> 3) & 1)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(s[mt][2 * np], a[mt], kb[0], kb[1]);
            mma16816(s[mt][2 * np + 1], a[mt], kb[2], kb[3]);
          }
        }
      }
      // only tiles on the diagonal, the kv length or the window edge mask
      const bool masked = t0 + kBK - 1 > p_lo || t0 + kBK > kl ||
                          (window > 0 && t0 <= p_lo + kWR - 1 - window);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int pos0 = p_lo + mt * 16 + g;
        if (masked) softmax_tile<true, kNT, kBK>(s[mt], o[mt], m[mt], l[mt], t0, tq, pos0, rw);
        else softmax_tile<false, kNT, kBK>(s[mt], o[mt], m[mt], l[mt], t0, tq, pos0, rw);
      }
      // p v: score tiles 2kk and 2kk + 1 are the A fragment of k16 step kk
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vs + swz<DV>(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                     2 * np + (lane >> 4)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(o[mt][2 * np], a[mt], vb[0], vb[1]);
            mma16816(o[mt][2 * np + 1], a[mt], vb[2], vb[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[mt][h];
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) lh += __shfl_xor_sync(0xffffffffu, lh, o2);
      const float d = lh == 0.f ? 1.f : lh;
      const int sr = wq0 + mt * 16 + g + 8 * h;
      if (sr >= S) continue;
      bf16* orow = out + (((size_t)b * S + sr) * Hq + head) * DV + 2 * tq;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
        *reinterpret_cast<uint32_t*>(orow + i * 8) =
            pack_bf16(o[mt][i][2 * h] / d, o[mt][i][2 * h + 1] / d);
    }
  }
}

template <int D, int DV, int HG, int MT>
cudaError_t launch_hg(const void* q, const void* k, const void* v,
                      const void* qoff, const void* klen, const void* slopes,
                      void* out, int B, int S, int T, int Hq, int Hkv,
                      float scale, int window, float softcap, cudaStream_t st) {
  constexpr size_t smem = Smem<D, DV, MT>::kBytes;
  cudaError_t err = allow_smem(flash_kernel<D, DV, HG, MT>, smem);
  if (err != cudaSuccess) return err;
  constexpr int P = kWarps * 16 * MT / HG;
  dim3 grid((S + P - 1) / P, Hkv * (Hq / Hkv / HG), B);
  flash_kernel<D, DV, HG, MT><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(qoff),
      static_cast<const int*>(klen), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), S, T, Hq, Hkv, scale, window, softcap);
  return cudaGetLastError();
}

template <int D, int DV, int MT>
cudaError_t launch_mt(const void* q, const void* k, const void* v,
                      const void* qoff, const void* klen, const void* slopes,
                      void* out, int B, int S, int T, int Hq, int Hkv,
                      float scale, int window, float softcap, cudaStream_t st) {
  const int group = Hq / Hkv;
  if (group % 4 == 0)
    return launch_hg<D, DV, 4, MT>(q, k, v, qoff, klen, slopes, out, B, S, T, Hq, Hkv, scale, window, softcap, st);
  if (group % 2 == 0)
    return launch_hg<D, DV, 2, MT>(q, k, v, qoff, klen, slopes, out, B, S, T, Hq, Hkv, scale, window, softcap, st);
  return launch_hg<D, DV, 1, MT>(q, k, v, qoff, klen, slopes, out, B, S, T, Hq, Hkv, scale, window, softcap, st);
}

// Two row tiles a warp where that was measured faster on the H100: D = 128
// with four query heads a kv head (HG = 4, ptxas: 20 bytes of spills; at
// HG = 1 / 2 the two-tile build spills 308), prompts of 512 and more (at
// 128 one tile was faster), and a grid of 128-row blocks that still gives
// every SM two blocks; else one.
template <int D, int DV = D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qoff, const void* klen, const void* slopes,
                   void* out, int B, int S, int T, int Hq, int Hkv,
                   float scale, int window, float softcap, cudaStream_t st) {
  if constexpr (D == 128 && DV == 128) {
    if ((Hq / Hkv) % 4 == 0 && S >= 512) {
      int dev = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      if ((long)((S + 31) / 32) * (Hq / 4) * B >= 2L * sms)
        return launch_hg<D, DV, 4, 2>(q, k, v, qoff, klen, slopes, out, B, S, T, Hq, Hkv, scale, window, softcap, st);
    }
  }
  return launch_mt<D, DV, 1>(q, k, v, qoff, klen, slopes, out, B, S, T, Hq, Hkv, scale, window, softcap, st);
}

}  // namespace

// q: [B, S, Hq, D] bf16; k: [B, Hkv, T, D] bf16; v: [B, Hkv, T, Dv] bf16;
// out: [B, S, Hq, Dv] bf16; qoff, klen: int32 [B]; slopes: f32 [Hq] or
// null; window <= 0 and softcap <= 0 disable. Dv == D (64, 128, 256), or
// D = 192 with Dv = 128. Every pointer 16-byte aligned.
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
