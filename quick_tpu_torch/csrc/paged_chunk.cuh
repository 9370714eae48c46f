// K6 / K6q: attention of a chunk of S queries straight over the paged KV
// cache, bf16 pages (K6, paged_attention.cu) or INT8 pages with their scale
// tiles (K6q, paged_attention_int8.cu): one kernel template over the page
// kind; the int8 parts are compile-time branches, so the bf16
// instantiation is K6's code alone. The design is described in
// paged_attention.cu (K6) and below (the int8 staging).
#pragma once

#include "split_attention.cuh"

namespace {
namespace k6 {

// 4 bytes global -> shared, zero-filled when !ok (src must still be valid)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// wait until at most the latest commit group of this thread is in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// the 8 int8 codes of words lo, hi as 8 bf16, exactly: each byte plus 128
// under the exponent of 2^23, minus 2^23 + 128, is the code in f32, whose
// high half is its bf16 (at most 8 significant bits)
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t u, int b) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + b)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}
__device__ __forceinline__ uint4 codes_bf16(uint32_t lo, uint32_t hi) {
  lo ^= 0x80808080u;
  hi ^= 0x80808080u;
  return make_uint4(codes_bf16x2(lo, 0), codes_bf16x2(lo, 2), codes_bf16x2(hi, 0),
                    codes_bf16x2(hi, 2));
}

constexpr int kRowTiles = 4;                 // m16 row tiles a block
constexpr int kThreads = 2 * kRowTiles * 32; // two warps a row tile, one a key half
constexpr int kBK = 64;                      // keys per tile
constexpr int kRows = kRowTiles * 16;        // (position, head) rows a block

// bf16 pages hold the codes themselves; int8 pages hold codes whose k and
// v scales lie in the pages' scale tiles
template <bool kI8>
struct PageCode {
  using T = bf16;
};
template <>
struct PageCode<true> {
  using T = int8_t;
};

template <int D, bool kI8 = false>
struct Smem {
  static constexpr int kQ = kRows * D * 2;   // the bf16 q rows, swizzled
  static constexpr int kK = kBK * D * 2;     // a K tile, swizzled
  static constexpr int kV = kBK * D * 2;     // a V tile, swizzled
  static constexpr int oRing = kQ;
  // int8: a two-stage ring of a tile's raw K and V codes, then the k and v
  // scales of three tiles ([3][2][kBK] f32)
  static constexpr int kRaw = kI8 ? 2 * kBK * D : 0;
  static constexpr int oRaw = oRing + 2 * (kK + kV);
  static constexpr int oSc = oRaw + 2 * kRaw;
  static constexpr int oPid = oSc + (kI8 ? 3 * 2 * kBK * 4 : 0);  // [3][kBK] page ids of three tiles
  static constexpr int oFlag = oPid + 3 * kBK * 4;
  static constexpr size_t kBytes = oFlag + 16;
  // after the tiles, the second key half's (o, m, l) [kRows][D + 2] f32 reuse the ring
  static_assert(kRows * (D + 2) * 4 <= 2 * (kK + kV), "the key halves' states fit the ring");
};

// Rows of one kv head h are the S x gq (chunk position i, head in group)
// pairs, row R = i * gq + head; block (h * n_rb + rb, b, sp) owns rows
// 64 rb .. 64 rb + 63 of slot b and the keys of split sp. Warp w takes rows
// 16 (w % 4) .. + 15 and keys 32 (w / 4) .. + 31 of each 64-key tile.
//
// int8 pages (K6q): a tile's codes come through a two-stage ring of raw
// codes (16-byte cp.async, half of K6's bytes), two tiles ahead, with the
// keys' k and v scales (kv_scales [L, P, 8, Hkv * page], rows 0 and 1);
// after a tile's products each thread converts the codes it copied of the
// next tile, exactly, into that tile's bf16 stage, so the products are
// K6's. s = (q . k) * scale * k_scale[t]; l sums the unscaled p; p *
// v_scale[t] is rounded to bf16 for p @ v (the Pallas INT8 chunk order).
template <int D, bool kI8>
__global__ void __launch_bounds__(kThreads)
paged_chunk_split_kernel(const bf16* __restrict__ q,
                         const typename PageCode<kI8>::T* __restrict__ k_pages,
                         const typename PageCode<kI8>::T* __restrict__ v_pages,
                         const int* __restrict__ block_table,
                         const int* __restrict__ starts, const float* __restrict__ slopes,
                         bf16* __restrict__ out, float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int* __restrict__ counters, int S, int Hq,
                         int Hkv, int gq, int n_rb, int page, int P, int n_pt, int layer,
                         int chunk, float scale, int window, float softcap,
                         const float* __restrict__ kv_scales) {
  using L = Smem<D, kI8>;
  constexpr int kNT = D / 8;  // n8 tiles of the output
  const int h = blockIdx.x / n_rb, rb = blockIdx.x % n_rb;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int splits = gridDim.z;
  const int n_rows = S * gq, r0 = rb * kRows;
  const int nrows = min(kRows, n_rows - r0);  // rows of this block
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  int* pid = reinterpret_cast<int*>(smem + L::oPid);
  const uint32_t ks0 = qs + L::oRing, vs0 = ks0 + 2 * L::kK;
  int* flag = reinterpret_cast<int*>(smem + L::oFlag);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = warp % kRowTiles, kh = warp / kRowTiles;  // row tile, key half
  const int g = lane >> 2, tq = lane & 3;
  const int n_keys = n_pt * page;

  // the block's keys: from its first row's window start to its last row's
  // position, clipped to the table and to this split
  const int start = starts[b];
  const int end = max(0, min(start + (r0 + nrows - 1) / gq + 1, n_keys));
  const int wlo = window > 0 ? max(0, start + r0 / gq - window + 1) : 0;
  // the splits holding a key of any row of the block: first .. first +
  // nlive - 1 (one, split 0, where none does; it writes the zeros). The
  // others' blocks have nothing to do; with one live split its block
  // writes the rows' outputs itself, with more the live blocks write
  // partials and the last of them merges
  const int first = wlo < end ? wlo / chunk : 0;
  const int nlive = wlo < end ? (end - 1) / chunk - first + 1 : 1;
  if (sp < first || sp >= first + nlive) return;
  const bool direct = nlive == 1;
  const Range rg = split_range(sp, chunk, end, wlo);
  const int t_begin = (rg.lo / kBK) * kBK;
  const int n_tiles = rg.lo < rg.hi ? (rg.hi - t_begin + kBK - 1) / kBK : 0;
  const int* bt = block_table + (size_t)b * n_pt;
  const size_t lp = (size_t)layer * P;

  // the lane's rows g and g + 8 of the warp's row tile: position, ALiBi
  // slope and visible keys [lo, hi) of this split (empty past the rows)
  int qpos[2];
  float slope[2];
  Range vis[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rt * 16 + g + 8 * hh, R = r0 + r;
    qpos[hh] = start + R / gq;
    slope[hh] = slopes != nullptr && r < nrows ? slopes[h * gq + R % gq] : 0.f;
    const int wr = window > 0 ? max(0, qpos[hh] - window + 1) : 0;
    vis[hh] = r < nrows ? split_range(sp, chunk, max(0, min(qpos[hh] + 1, n_keys)), wr)
                        : Range{0, 0};
  }
  float o[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {QTT_NEG_INF, QTT_NEG_INF}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    // the page id of key tid of tile i (0 past the range: never read)
    auto page_of = [&](int i) {
      const int t = t_begin + i * kBK + tid;
      return t < rg.hi ? bt[t / page] : 0;
    };
    // copy tile i's keys [t0, t0 + kBK) of kv head h from their pages into
    // a stage; keys at or past rg.hi are zero-filled (never read from memory)
    auto load_kv = [&](int i, uint32_t ks, uint32_t vs) {
      const int t0 = t_begin + i * kBK;
      const int* ids = pid + (i % 3) * kBK;
      for (int c = tid; c < kBK * (D / 8); c += kThreads) {
        const int j = c / (D / 8), ch = c % (D / 8);
        const bool ok = t0 + j < rg.hi;
        const size_t off =
            ok ? (((lp + ids[j]) * Hkv + h) * page + (t0 + j) % page) * D + ch * 8 : 0;
        cp_async16(ks + swz<D>(j, ch), k_pages + off, ok);
        cp_async16(vs + swz<D>(j, ch), v_pages + off, ok);
      }
    };
    // int8: copy tile i's codes [t0, t0 + kBK) into raw stage i % 2 (rows
    // of D bytes; zero-filled at or past rg.hi) and their k / v scales into
    // scale stage i % 3 (threads 0-63 the k scales, 64-127 the v scales)
    const int T = Hkv * page;  // a scale tile's row
    auto load_raw = [&](int i) {
      const int t0 = t_begin + i * kBK;
      const int* ids = pid + (i % 3) * kBK;
      const uint32_t rk = qs + L::oRaw + (i & 1) * L::kRaw, rv = rk + kBK * D;
      for (int c = tid; c < kBK * (D / 16); c += kThreads) {
        const int j = c / (D / 16), ch = c % (D / 16);
        const bool ok = t0 + j < rg.hi;
        const size_t off =
            ok ? (((lp + ids[j]) * Hkv + h) * page + (t0 + j) % page) * D + ch * 16 : 0;
        cp_async16(rk + j * D + ch * 16, k_pages + off, ok);
        cp_async16(rv + j * D + ch * 16, v_pages + off, ok);
      }
      if (tid < 2 * kBK) {
        const int j = tid % kBK;
        const bool ok = t0 + j < rg.hi;
        const size_t off = ok ? ((lp + ids[j]) * 8 + tid / kBK) * T + (size_t)h * page +
                                    (t0 + j) % page
                              : 0;
        cp_async4(qs + L::oSc + ((i % 3) * 2 * kBK + tid) * 4, kv_scales + off, ok);
      }
    };
    // int8: the chunks of tile i this thread copied, converted into bf16
    // stage st (the copies of this thread have landed)
    auto convert = [&](int i, int st) {
      const unsigned char* rk = smem + L::oRaw + (i & 1) * L::kRaw;
      unsigned char* kb = smem + L::oRing + st * L::kK;
      unsigned char* vb = smem + L::oRing + 2 * L::kK + st * L::kV;
      for (int c = tid; c < kBK * (D / 16); c += kThreads) {
        const int j = c / (D / 16), ch = c % (D / 16);
        const uint4 k4 = *reinterpret_cast<const uint4*>(rk + j * D + ch * 16);
        const uint4 v4 = *reinterpret_cast<const uint4*>(rk + kBK * D + j * D + ch * 16);
        *reinterpret_cast<uint4*>(kb + swz<D>(j, 2 * ch)) = codes_bf16(k4.x, k4.y);
        *reinterpret_cast<uint4*>(kb + swz<D>(j, 2 * ch + 1)) = codes_bf16(k4.z, k4.w);
        *reinterpret_cast<uint4*>(vb + swz<D>(j, 2 * ch)) = codes_bf16(v4.x, v4.y);
        *reinterpret_cast<uint4*>(vb + swz<D>(j, 2 * ch + 1)) = codes_bf16(v4.z, v4.w);
      }
    };
    if (tid < kBK) {
      pid[tid] = page_of(0);
      if (n_tiles > 1) pid[kBK + tid] = page_of(1);
      if constexpr (kI8)
        if (n_tiles > 2) pid[2 * kBK + tid] = page_of(2);
    }
    // the block's q rows in bf16; rows past nrows are zeros
    for (int c = tid; c < kRows * (D / 8); c += kThreads) {
      const int r = c / (D / 8), ch = c % (D / 8), R = r0 + r;
      const bool ok = r < nrows;
      const size_t off = ok ? (((size_t)b * S + R / gq) * Hq + h * gq + R % gq) * D + ch * 8 : 0;
      cp_async16(qs + swz<D>(r, ch), q + off, ok);
    }
    __syncthreads();  // the page ids of tiles 0 and 1 (and 2)
    if constexpr (kI8) {
      load_raw(0);
      cp_async_commit();  // q and tile 0
      if (n_tiles > 1) load_raw(1);
      cp_async_commit();
      cp_async_wait1();
      convert(0, 0);
    } else {
      load_kv(0, ks0, vs0);
      cp_async_commit();
    }

    const int qrow = rt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);  // ldmatrix rows of q
    const int qchunk = lane >> 4;
    for (int it = 0; it < n_tiles; ++it) {
      const int t0 = t_begin + it * kBK + 32 * kh;  // the warp's first key
      const int st = it & 1;
      if constexpr (!kI8) cp_async_wait_all();
      __syncthreads();  // tile it landed; tile it - 1 is consumed (its stage is free)
      // tile it + 2's page ids (int8: it + 3's): loaded now, stored after this
      // tile's products
      const int pid_next = tid < kBK && it + (kI8 ? 3 : 2) < n_tiles
                               ? page_of(it + (kI8 ? 3 : 2)) : 0;
      float2 ksc[4], vsc[4];  // int8: the scales of the warp's keys 2tq, 2tq + 1 of each n8 tile
      if constexpr (kI8) {
        if (it + 2 < n_tiles) load_raw(it + 2);
        cp_async_commit();
        const float* sc = reinterpret_cast<const float*>(smem + L::oSc) + (it % 3) * 2 * kBK +
                          32 * kh + 2 * tq;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          ksc[nt] = *reinterpret_cast<const float2*>(sc + 8 * nt);
          vsc[nt] = *reinterpret_cast<const float2*>(sc + kBK + 8 * nt);
        }
      } else {
        if (it + 1 < n_tiles) load_kv(it + 1, ks0 + (st ^ 1) * L::kK, vs0 + (st ^ 1) * L::kV);
        cp_async_commit();
      }
      const uint32_t ks = ks0 + st * L::kK, vs = vs0 + st * L::kV;
      // q k^T for the warp's 16 rows and its 32 keys: four n8 tiles
      float s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + swz<D>(qrow, 2 * kk + qchunk));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + swz<D>(32 * kh + 16 * j + (lane >> 4) * 8 + (lane & 7),
                                  2 * kk + ((lane >> 3) & 1)));
          mma16816(s[2 * j], a, kb[0], kb[1]);
          mma16816(s[2 * j + 1], a, kb[2], kb[3]);
        }
      }
      // scale, softcap, then ALiBi, then the row's mask; register e of tile
      // nt: row g + 8 * (e >> 1), key t0 + 8 * nt + 2 * tq + (e & 1)
      float mx[2] = {QTT_NEG_INF, QTT_NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + nt * 8 + 2 * tq + (e & 1), hh = e >> 1;
          float sc = s[nt][e] * scale;
          if constexpr (kI8) sc *= (e & 1) ? ksc[nt].y : ksc[nt].x;
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          sc += slope[hh] * (float)(t - qpos[hh]);
          sc = t >= vis[hh].lo && t < vis[hh].hi ? sc : QTT_NEG_INF;
          s[nt][e] = sc;
          mx[hh] = fmaxf(mx[hh], sc);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // the row's maximum over the warp's keys: they lie in the lane's quad
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float mn = fmaxf(m[hh], mx[hh]);
        const float alpha = expf(m[hh] - mn);
        m[hh] = mn;
        float ps = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
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
      if constexpr (kI8) {  // p * v_scale[t], rounded to bf16 below; l kept the unscaled p
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= (e & 1) ? vsc[nt].y : vsc[nt].x;
      }
      // p v: score tiles 2j and 2j + 1 are the A fragment of k16 step j
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vs + swz<D>(32 * kh + 16 * j + ((lane >> 3) & 1) * 8 + (lane & 7),
                                    2 * np + (lane >> 4)));
          mma16816(o[2 * np], a, vb[0], vb[1]);
          mma16816(o[2 * np + 1], a, vb[2], vb[3]);
        }
      }
      if constexpr (kI8) {
        cp_async_wait1();  // this thread's copies of tile it + 1 landed
        if (it + 1 < n_tiles) convert(it + 1, st ^ 1);
        if (tid < kBK && it + 3 < n_tiles) pid[(it % 3) * kBK + tid] = pid_next;
      } else {
        if (tid < kBK && it + 2 < n_tiles) pid[((it + 2) % 3) * kBK + tid] = pid_next;
      }
    }
    cp_async_wait_all();
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }

  // the two key halves of each row combined: M = max(m0, m1), o = o0 e^(m0 - M)
  // + o1 e^(m1 - M), l likewise; the second half hands its state over
  // through the ring. Register e of o[i]: row g + 8 * (e >> 1), dim
  // 8i + 2tq + (e & 1)
  float* half = reinterpret_cast<float*>(smem + L::oRing);  // [kRows][D] o, then [kRows][2]
  __syncthreads();  // the ring is free
  if (n_tiles > 0 && kh == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rt * 16 + g + 8 * hh;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
        *reinterpret_cast<float2*>(half + r * D + 8 * i + 2 * tq) =
            make_float2(o[i][2 * hh], o[i][2 * hh + 1]);
      if (tq == 0) *reinterpret_cast<float2*>(half + kRows * D + 2 * r) = make_float2(m[hh], l[hh]);
    }
  }
  __syncthreads();
  if (kh == 0) {
    if (n_tiles > 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rt * 16 + g + 8 * hh;
        const float2 ml1 = *reinterpret_cast<const float2*>(half + kRows * D + 2 * r);
        const float mn = fmaxf(m[hh], ml1.x);
        const float a0 = expf(m[hh] - mn), a1 = expf(ml1.x - mn);
        m[hh] = mn;
        l[hh] = fmaf(ml1.y, a1, l[hh] * a0);
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          const float2 o1 = *reinterpret_cast<const float2*>(half + r * D + 8 * i + 2 * tq);
          o[i][2 * hh] = fmaf(o1.x, a1, o[i][2 * hh] * a0);
          o[i][2 * hh + 1] = fmaf(o1.y, a1, o[i][2 * hh + 1] * a0);
        }
      }
    }
    if (direct) {  // the one live split: the rows' outputs straight from registers
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rt * 16 + g + 8 * hh, R = r0 + r;
        if (r >= nrows) continue;
        const float inv = l[hh] == 0.f ? 1.f : l[hh];
        bf16* o_row = out + (((size_t)b * S + R / gq) * Hq + h * gq + R % gq) * D;
#pragma unroll
        for (int i = 0; i < kNT; ++i)
          *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * i + 2 * tq) =
              __floats2bfloat162_rn(o[i][2 * hh] / inv, o[i][2 * hh + 1] / inv);
      }
    }
  }
  if (direct) return;
  // this split's partial (m, l, acc) of each row
  const size_t row0 = ((size_t)b * Hkv + h) * n_rows + r0;  // partial row of local row 0
  if (n_tiles > 0 && kh == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rt * 16 + g + 8 * hh;
      if (r >= nrows) continue;
      const size_t pr = (row0 + r) * splits + sp;
      float* pa = part_acc + pr * D;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
        *reinterpret_cast<float2*>(pa + 8 * i + 2 * tq) = make_float2(o[i][2 * hh], o[i][2 * hh + 1]);
      if (tq == 0) *reinterpret_cast<float2*>(part_ml + pr * 2) = make_float2(m[hh], l[hh]);
    }
  }

  // the last live block of this (slot, kv head, row block) to finish merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const int done = atomicAdd(cnt, 1);
    *flag = done == nlive - 1;
    if (*flag) *cnt = 0;  // every live block has counted: ready for the next launch
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // O = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s,
  // over the splits in which the row sees a key, in order; 0 where none.
  // First a thread a row: M and the denominator; then every thread on 4
  // dims of D / 16 rows, split after split, the rows' loads in flight
  auto live = [&](int r, int s2) {  // row r sees a key of split s2
    const int qp = start + (r0 + r) / gq;
    const int wlo_r = window > 0 ? max(0, qp - window + 1) : 0;
    const Range r2 = split_range(s2, chunk, max(0, min(qp + 1, n_keys)), wlo_r);
    return r2.lo < r2.hi;
  };
  float* mrow = reinterpret_cast<float*>(smem + L::oRing);  // [kRows] M, then [kRows] sums
  const float2* ml0 = reinterpret_cast<const float2*>(part_ml);
  if (tid < nrows) {  // four splits' loads in flight at a time
    const float2* ml = ml0 + (row0 + tid) * splits;
    float M = QTT_NEG_INF, lt = 0.f;
    for (int s0 = first; s0 < first + nlive; s0 += 4) {
      float m4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m4[k] = s0 + k < first + nlive && live(tid, s0 + k) ? __ldcg(ml + s0 + k).x : QTT_NEG_INF;
#pragma unroll
      for (int k = 0; k < 4; ++k) M = fmaxf(M, m4[k]);
    }
    for (int s0 = first; s0 < first + nlive; s0 += 4) {
      bool lv[4];
      float2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lv[k] = s0 + k < first + nlive && live(tid, s0 + k);
        if (lv[k]) v[k] = __ldcg(ml + s0 + k);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)  // in split order
        if (lv[k]) lt += v[k].y * expf(v[k].x - M);
    }
    mrow[tid] = M;
    mrow[kRows + tid] = lt == 0.f ? 1.f : lt;
  }
  __syncthreads();
  constexpr int kQ = D / 4;                   // threads a row, 4 dims each
  constexpr int kRS = kThreads / kQ;          // rows apart
  constexpr int kRPT = kRows / kRS;           // rows a thread
  const int d = (tid % kQ) * 4, rq = tid / kQ;
  float4 acc[kRPT];
#pragma unroll
  for (int k = 0; k < kRPT; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s2 = first; s2 < first + nlive; ++s2) {  // in split order, the rows' loads in flight
    bool lv[kRPT];
    float mk[kRPT];
    float4 pa[kRPT];
#pragma unroll
    for (int k = 0; k < kRPT; ++k) {
      const int r = rq + k * kRS;
      lv[k] = r < nrows && live(r, s2);
      if (lv[k]) {
        const size_t pr = (row0 + r) * splits + s2;
        mk[k] = __ldcg(ml0 + pr).x;
        pa[k] = __ldcg(reinterpret_cast<const float4*>(part_acc + pr * D + d));
      }
    }
#pragma unroll
    for (int k = 0; k < kRPT; ++k) {
      if (!lv[k]) continue;
      const float w = expf(mk[k] - mrow[rq + k * kRS]);
      acc[k] = make_float4(fmaf(w, pa[k].x, acc[k].x), fmaf(w, pa[k].y, acc[k].y),
                           fmaf(w, pa[k].z, acc[k].z), fmaf(w, pa[k].w, acc[k].w));
    }
  }
#pragma unroll
  for (int k = 0; k < kRPT; ++k) {
    const int r = rq + k * kRS, R = r0 + r;
    if (r >= nrows) break;
    const float inv = mrow[kRows + r];
    __nv_bfloat162* o_row = reinterpret_cast<__nv_bfloat162*>(
        out + (((size_t)b * S + R / gq) * Hq + h * gq + R % gq) * D + d);
    o_row[0] = __floats2bfloat162_rn(acc[k].x / inv, acc[k].y / inv);
    o_row[1] = __floats2bfloat162_rn(acc[k].z / inv, acc[k].w / inv);
  }
}

// kv_scales: int8 pages' scale tiles (null for bf16 pages)
template <int D, bool kI8>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* kv_scales, const void* block_table, const void* starts,
                   const void* slopes, void* out, void* part_acc, void* part_ml, void* counters,
                   int B, int S, int Hq, int Hkv, int page, int P, int n_pt, int layer,
                   int chunk, int splits, float scale, int window, float softcap,
                   cudaStream_t st) {
  using T = typename PageCode<kI8>::T;
  const size_t smem = Smem<D, kI8>::kBytes;
  cudaError_t err = allow_smem(paged_chunk_split_kernel<D, kI8>, smem);
  if (err != cudaSuccess) return err;
  const int gq = Hq / Hkv, n_rb = (S * gq + kRows - 1) / kRows;
  dim3 grid(Hkv * n_rb, B, splits);
  paged_chunk_split_kernel<D, kI8><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(starts), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), S, Hq, Hkv, gq, n_rb, page, P, n_pt, layer, chunk, scale,
      window, softcap, static_cast<const float*>(kv_scales));
  return cudaGetLastError();
}

// the checks of both entry points (qtt_paged_chunk_attention and its int8
// twin) beyond the pages' shapes
inline bool plan_ok(int B, int S, int Hq, int Hkv, int chunk, int splits, int page, int n_pt,
                    const void* part_acc, const void* part_ml, const void* counters) {
  return S > 0 && B <= 65535 && chunk > 0 && chunk % kBK == 0 && splits > 0 &&
         splits <= 65535 && (long long)splits * chunk >= (long long)n_pt * page &&
         part_acc != nullptr && part_ml != nullptr && counters != nullptr &&
         (long long)Hkv * ((S * (Hq / Hkv) + kRows - 1) / kRows) <= 0x7fffffff;
}

}  // namespace k6

}  // namespace
