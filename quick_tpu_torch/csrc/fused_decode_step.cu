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
// the Pallas kernel; p for cached positions is rounded to bf16 (against
// the running max of its block) before p @ v, the new token's p stays f32.
//
// What bounds it on the H100: the cache read, 2 * length * D * 2 bytes per
// (batch row, kv head); a few MB per layer at the decode shapes, so the
// call is bound by latency and by how many SMs stream the cache.
//
// Design. The key range [0, S) is split into `splits` chunks of `chunk`
// keys (whole 64-key tiles), from the shapes alone (the wrapper's plan:
// about two blocks an SM), never from the length, which the kernel reads on
// the card: a captured launch stays right as the length moves. Grid
// (kv head x head group, batch row, split); a block owns up to 16 query
// heads of one kv head (one m16 tile; gq = 32 takes two blocks) and the
// keys of its chunk inside [window start, length). It stages the roped,
// scaled q rows once, then runs its key tiles through a two-stage cp.async
// ring (the next tile's copy overlaps this tile's products) in 128-byte
// swizzled rows. Both products are mma.sync m16n8k16 (bf16 in, f32
// accumulate; bf16 q and k, and p rounded to bf16, are exactly the
// operands of the numerics above), each warp taking 16 keys of a tile;
// the tile's row maxima go through shared memory, so that p is rounded
// against the block's running max, and the four warps' partial outputs are
// summed in warp order at the end. A block writes its partial (m, l,
// acc[D]) in f32; the last block of a (batch row, head group) to finish
// (an atomic counter, which it resets for the next launch) merges the
// non-empty splits in split order, then folds in the new token from the
// f32 q and the f32 k_new / v_new. The output does not depend on block
// scheduling. Exactly one block writes the new row; no block reads
// position `length`.
//
// Why mma.sync and not CUDA cores: with 4 to 8 heads a kv head the tile's
// q k^T and p v are ~2 x 64 x 8 x D multiply-adds a head, which on CUDA
// cores take a few thousand instructions a warp per tile out of shared
// memory; as 16-row tensor-core tiles (rows past gq are zero) they are 32
// mma.sync a warp, so a tile costs about its copy.
//
// Not carried over from the TPU: the static [D, D] rotate-half matrix (a
// lane index does it here), the aliased 8/16-row group read-modify-write
// of the cache (a plain store of one row), the masked-column overlay (the
// key range stops before the new position) and the sequential walk of
// one block over the whole cache.
#include "split_attention.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;    // keys per tile; warp w takes keys 16w .. 16w + 15
constexpr int kRows = 16;  // query heads a block (one m16 tile)

template <int D>
struct Smem {
  static constexpr int kQ = kRows * D * 2;     // the bf16 q tile, swizzled
  static constexpr int kQf = kRows * D * 4;    // f32 q * scale (the new token's score)
  static constexpr int kK = kBK * D * 2;       // a K tile, swizzled
  static constexpr int kV = kBK * D * 2;       // a V tile, swizzled
  static constexpr int oQf = kQ;
  static constexpr int oKn = oQf + kQf;        // f32 roped k_new, then v_new
  static constexpr int oRing = oKn + 2 * D * 4;
  static constexpr int oMax = oRing + 2 * (kK + kV);  // [kWarps][kRows] tile maxima
  static constexpr int oL = oMax + kWarps * kRows * 4;  // [kWarps][kRows] row sums
  static constexpr int oM = oL + kWarps * kRows * 4;    // [kRows] running maxima
  static constexpr int oFlag = oM + kRows * 4;
  static constexpr size_t kBytes = oFlag + 16;
  // the four warps' outputs [kWarps][kRows][D] f32 reuse the ring
  static_assert(kWarps * kRows * D * 4 <= 2 * (kK + kV), "the warps' outputs fit the ring");
};

// copy keys [t0, t0 + kBK) of one head's K and V [S, D] into a stage; keys
// at or past t_end are zero-filled (never read from memory)
template <int D>
__device__ __forceinline__ void load_kv(const bf16* __restrict__ kh, const bf16* __restrict__ vh,
                                        int t0, int t_end, uint32_t ks, uint32_t vs) {
  for (int c = threadIdx.x; c < kBK * (D / 8); c += kThreads) {
    const int j = c / (D / 8), ch = c % (D / 8);
    const bool ok = t0 + j < t_end;
    const size_t off = ok ? (size_t)(t0 + j) * D + ch * 8 : 0;
    cp_async16(ks + swz<D>(j, ch), kh + off, ok);
    cp_async16(vs + swz<D>(j, ch), vh + off, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                  const bf16* __restrict__ v_new, bf16* __restrict__ k_cache,
                  bf16* __restrict__ v_cache, const float* __restrict__ cos_row,
                  const float* __restrict__ sin_row, const float* __restrict__ slopes,
                  bf16* __restrict__ out, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ counters, int B, int Hq,
                  int Hkv, int gq, int ht_bits, int S, int layer,
                  const int* __restrict__ length_ptr, int chunk, float scale, int window,
                  float softcap, int use_rope) {
  using L = Smem<D>;
  constexpr int kDPL = D / 32;  // output dims a lane in the merge
  constexpr int kNT = D / 8;    // n8 tiles of the output
  // blockIdx.x = (kv head, head group), 2^ht_bits groups a kv head
  const int h = blockIdx.x >> ht_bits, ht = blockIdx.x & ((1 << ht_bits) - 1);
  const int b = blockIdx.y, sp = blockIdx.z;
  const int splits = gridDim.z;
  const int nrows = min(kRows, gq - ht * kRows);  // query heads of this block
  const int hq0 = h * gq + ht * kRows;
  const int length = *length_ptr;
  if (length < 0 || length >= S) {  // outside the cache: no write, NaN out
    if (sp == 0)
      for (int i = threadIdx.x; i < nrows * D; i += kThreads)
        out[((size_t)b * Hq + hq0) * D + i] = __float2bfloat16_rn(__int_as_float(0x7fc00000));
    return;
  }
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  float* qf = reinterpret_cast<float*>(smem + L::oQf);
  float* kn = reinterpret_cast<float*>(smem + L::oKn);
  float* vn = kn + D;
  const uint32_t ks0 = qs + L::oRing, vs0 = ks0 + 2 * L::kK;
  float* smax = reinterpret_cast<float*>(smem + L::oMax);
  float* lsum = reinterpret_cast<float*>(smem + L::oL);
  float* mrow = reinterpret_cast<float*>(smem + L::oM);
  int* flag = reinterpret_cast<int*>(smem + L::oFlag);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  const int wlo = window > 0 ? max(0, length - window + 1) : 0;
  const Range rg = split_range(sp, chunk, length, wlo);
  const int t_begin = (rg.lo / kBK) * kBK;
  const int n_tiles = rg.lo < rg.hi ? (rg.hi - t_begin + kBK - 1) / kBK : 0;
  const size_t head = (((size_t)layer * B + b) * Hkv + h) * S * D;
  const bf16* kh = k_cache + head;
  const bf16* vh = v_cache + head;
  if (n_tiles > 0) load_kv<D>(kh, vh, t_begin, rg.hi, ks0, vs0);
  cp_async_commit();

  const float* cr = cos_row + (size_t)b * D;
  const float* sr = sin_row + (size_t)b * D;
  // rotate-half: x*cos + rot(x)*sin, rot(x)[d] = -x[d + D/2] | x[d - D/2]
  auto rope = [&](const bf16* x, int d) {
    const float xv = bf2f(x[d]);
    if (!use_rope) return xv;
    const float rot = d < D / 2 ? -bf2f(x[d + D / 2]) : bf2f(x[d - D / 2]);
    return xv * cr[d] + rot * sr[d];
  };
  // the q rows: roped, rounded to bf16, times scale in f32 (qf), rounded
  // again into the bf16 q tile; rows past nrows are zeros
  bf16* qtile = reinterpret_cast<bf16*>(smem);
  for (int c = tid; c < kRows * D; c += kThreads) {
    const int r = c / D, d = c % D;
    float v = 0.f;
    if (r < nrows) v = round_bf16(rope(q + ((size_t)b * Hq + hq0 + r) * D, d)) * scale;
    qf[c] = v;
    qtile[(swz<D>(r, d >> 3) >> 1) + (d & 7)] = __float2bfloat16_rn(v);
  }
  const bf16* kr = k_new + ((size_t)b * Hkv + h) * D;
  const bf16* vr = v_new + ((size_t)b * Hkv + h) * D;
  const bool writer = sp == 0 && ht == 0;  // the one block that writes the new row
  for (int d = tid; d < D; d += kThreads) {
    const bf16 kb = __float2bfloat16_rn(rope(kr, d));
    kn[d] = bf2f(kb);
    vn[d] = bf2f(vr[d]);
    if (writer) {
      k_cache[head + (size_t)length * D + d] = kb;
      v_cache[head + (size_t)length * D + d] = vr[d];
    }
  }

  float slope[2];  // ALiBi slopes of the lane's rows g and g + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    slope[hh] = slopes != nullptr && r < nrows ? slopes[hq0 + r] : 0.f;
  }
  float o[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {QTT_NEG_INF, QTT_NEG_INF}, l[2] = {0.f, 0.f};
  const int qrow = ((lane >> 3) & 1) * 8 + (lane & 7);  // ldmatrix rows of the q tile
  const int qchunk = lane >> 4;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kBK;
    const int st = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; tile it - 1 is consumed (its stage is free)
    if (it + 1 < n_tiles)
      load_kv<D>(kh, vh, t0 + kBK, rg.hi, ks0 + (st ^ 1) * L::kK, vs0 + (st ^ 1) * L::kV);
    cp_async_commit();
    const uint32_t ks = ks0 + st * L::kK, vs = vs0 + st * L::kV;
    // q k^T for the warp's 16 keys: two n8 tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], kb[4];
      ldsm_x4(a, qs + swz<D>(qrow, 2 * kk + qchunk));
      ldsm_x4(kb, ks + swz<D>(warp * 16 + (lane >> 4) * 8 + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
      mma16816(s[0], a, kb[0], kb[1]);
      mma16816(s[1], a, kb[2], kb[3]);
    }
    // softcap, then ALiBi, then the mask; register e of tile nt: row
    // g + 8 * (e >> 1), key t0 + 16 * warp + 8 * nt + 2 * tq + (e & 1)
    float mx[2] = {QTT_NEG_INF, QTT_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + warp * 16 + nt * 8 + 2 * tq + (e & 1);
        float sc = s[nt][e];
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        sc += slope[e >> 1] * (float)(t - length);
        sc = t >= rg.lo && t < rg.hi ? sc : QTT_NEG_INF;
        s[nt][e] = sc;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
    if (tq == 0) {
      smax[warp * kRows + g] = mx[0];
      smax[warp * kRows + g + 8] = mx[1];
    }
    __syncthreads();  // the tile's row maxima of all four warps
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = smax[g + 8 * hh];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, smax[w * kRows + g + 8 * hh]);
      const float mn = fmaxf(m[hh], tm);
      const float alpha = expf(m[hh] - mn);
      m[hh] = mn;
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float p = s[nt][e] == QTT_NEG_INF ? 0.f : expf(s[nt][e] - mn);
          s[nt][e] = p;
          ps += p;
        }
      l[hh] = l[hh] * alpha + ps;  // the lane's part; the quad adds them at the end
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        o[i][2 * hh] *= alpha;
        o[i][2 * hh + 1] *= alpha;
      }
    }
    // p v: the two score tiles are the A fragment of one k16 step
    uint32_t a[4];
    a[0] = pack_bf16(s[0][0], s[0][1]);
    a[1] = pack_bf16(s[0][2], s[0][3]);
    a[2] = pack_bf16(s[1][0], s[1][1]);
    a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vs + swz<D>(warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                2 * np + (lane >> 4)));
      mma16816(o[2 * np], a, vb[0], vb[1]);
      mma16816(o[2 * np + 1], a, vb[2], vb[3]);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free; q, kn and vn are visible

  // this split's partial: the four warps' outputs summed in warp order
  const bool work = n_tiles > 0;
  if (work) {
    float* red = reinterpret_cast<float*>(smem + L::oRing);  // [kWarps][kRows][D]
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * kRows + g + 8 * (e >> 1)) * D + i * 8 + 2 * tq + (e & 1)] = o[i][e];
    if (tq == 0) {
      lsum[warp * kRows + g] = l[0];
      lsum[warp * kRows + g + 8] = l[1];
      if (warp == 0) {
        mrow[g] = m[0];
        mrow[g + 8] = m[1];
      }
    }
    __syncthreads();
    for (int c = tid; c < nrows * D; c += kThreads) {
      const int r = c / D, d = c % D;
      float v = red[r * D + d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[(w * kRows + r) * D + d];
      part_acc[(((size_t)b * Hq + hq0 + r) * splits + sp) * D + d] = v;
    }
    for (int r = tid; r < nrows; r += kThreads) {
      float lr = lsum[r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) lr += lsum[w * kRows + r];
      float* ml = part_ml + (((size_t)b * Hq + hq0 + r) * splits + sp) * 2;
      ml[0] = mrow[r];
      ml[1] = lr;
    }
  }

  // the last block of this (batch row, head group) to finish merges
  if (splits > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* cnt = counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
      const int done = atomicAdd(cnt, 1);
      *flag = done == splits - 1;
      if (*flag) *cnt = 0;  // every block of this group has counted: ready for the next launch
    }
    __syncthreads();
    if (!*flag) return;
    __threadfence();
  } else {
    __syncthreads();
  }
  // O = (sum_s acc_s e^(m_s - M) + p_n v_n) / (sum_s l_s e^(m_s - M) + p_n),
  // M = max(max_s m_s, s_n), over the non-empty splits in order; s_n =
  // f32 q . f32 k_new with no ALiBi bias (its distance is 0)
  for (int r = warp; r < nrows; r += kWarps) {
    float sn = 0.f;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = lane * kDPL + e;
      sn = fmaf(qf[r * D + d], kn[d], sn);
    }
    sn = warp_sum(sn);
    if (softcap > 0.f) sn = softcap * tanhf(sn / softcap);
    const size_t row = (size_t)b * Hq + hq0 + r;
    const float2* ml = reinterpret_cast<const float2*>(part_ml) + row * splits;
    // lane j holds split s0 + j's (m, l) of each pass of 32, loaded at once
    float M = sn;
    for (int s2 = lane; s2 < splits; s2 += 32) {
      const Range r2 = split_range(s2, chunk, length, wlo);
      if (r2.lo < r2.hi) M = fmaxf(M, __ldcg(ml + s2).x);
    }
    M = warp_max(M);
    float lt = 0.f, acc[kDPL];
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[e] = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 32) {
      const int s2 = s0 + lane;
      const Range r2 = split_range(s2, chunk, length, wlo);
      const bool live = s2 < splits && r2.lo < r2.hi;
      float w = 0.f, lw = 0.f;
      if (live) {
        const float2 v = __ldcg(ml + s2);
        w = expf(v.x - M);
        lw = v.y * w;
      }
      const unsigned lives = __ballot_sync(0xffffffffu, live);
      const int n = min(32, splits - s0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {  // in split order
        const float wj = __shfl_sync(0xffffffffu, w, j);
        const float lwj = __shfl_sync(0xffffffffu, lw, j);
        if (!((lives >> j) & 1u)) continue;  // an empty split wrote no partial
        lt += lwj;
        const float* pa = part_acc + (row * splits + s0 + j) * D + lane * kDPL;
#pragma unroll
        for (int e = 0; e < kDPL; ++e) acc[e] = fmaf(wj, __ldcg(pa + e), acc[e]);
      }
    }
    const float pn = expf(sn - M);
    lt += pn;
    bf16* o_row = out + row * D + lane * kDPL;
#pragma unroll
    for (int e = 0; e < kDPL; ++e)
      o_row[e] = __float2bfloat16_rn((acc[e] + pn * vn[lane * kDPL + e]) / lt);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
                   void* v_cache, const void* cos_row, const void* sin_row, const void* slopes,
                   void* out, void* part_acc, void* part_ml, void* counters, int B, int Hq,
                   int Hkv, int S, int layer, const int* length, int chunk, int splits,
                   float scale, int window, float softcap, int use_rope, cudaStream_t st) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = allow_smem(fused_step_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int gq = Hq / Hkv, ht_bits = gq > kRows ? 1 : 0;  // gq <= 32: one or two groups
  dim3 grid(Hkv << ht_bits, B, splits);
  fused_step_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<bf16*>(k_cache),
      static_cast<bf16*>(v_cache), static_cast<const float*>(cos_row),
      static_cast<const float*>(sin_row), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), B, Hq, Hkv, gq, ht_bits, S, layer, length, chunk, scale,
      window, softcap, use_rope);
  return cudaGetLastError();
}

}  // namespace

// q, out: [B, Hq, D] bf16 (q pre-rope); k_new, v_new: [B, Hkv, D] bf16;
// k_cache, v_cache: [L, B, Hkv, S, D] bf16, written at [layer, :, :, length];
// cos_row, sin_row: f32 [B, D]; slopes: f32 [Hq] or null; window <= 0 and
// softcap <= 0 disable; use_rope = 0 passes q/k through unrotated. length:
// int32 [1] on the card, read by the kernel (a captured launch stays right
// as the length moves); for a length outside [0, S) it writes no cache row
// and NaN to out (the callers check the length on the host). The key range
// is cut into `splits` chunks of `chunk` keys (a multiple of 64, splits *
// chunk >= S); part_acc f32 [B, Hq, splits, D] and part_ml f32 [B, Hq,
// splits, 2] are scratch; counters: int32 [B * Hkv * ceil(Hq / Hkv / 16)],
// zero before the launch and left at zero by it (one launch at a time).
extern "C" int qtt_fused_decode_step(
    const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const void* cos_row, const void* sin_row, const void* slopes, void* out, void* part_acc,
    void* part_ml, void* counters, int B, int Hq, int Hkv, int S, int D, int layer,
    const void* length, int chunk, int splits, float scale, int window, float softcap,
    int use_rope, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 32 || length == nullptr ||
      chunk <= 0 || chunk % kBK != 0 || splits <= 0 || splits > 65535 ||
      (long long)splits * chunk < S || part_acc == nullptr || part_ml == nullptr ||
      counters == nullptr)
    return cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(length);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QTT_LAUNCH(DD)                                                                       \
  launch<DD>(q, k_new, v_new, k_cache, v_cache, cos_row, sin_row, slopes, out, part_acc,    \
             part_ml, counters, B, Hq, Hkv, S, layer, len, chunk, splits, scale, window,    \
             softcap, use_rope, st)
  switch (D) {
    case 64: return QTT_LAUNCH(64);
    case 128: return QTT_LAUNCH(128);
    case 256: return QTT_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef QTT_LAUNCH
}
