// The row body of the paged KV cache writes K4 (csrc/paged_write.cu: bf16 /
// f32 pages, rows copied) and K4q (csrc/paged_write_int8.cu: int8 pages,
// rows quantized or codes copied, with scale tiles): one kernel template
// over the input kind, so that K4 is K4q's copy case without a scale tile.
//
// Token i of slot b (i < S, and i < valid[b] when valid is given) goes to
// in-page row r = offs[b] + i of page page_ids[b, 0] while r < page, else
// to row r - page of page_ids[b, 1] (the Pallas chunk kernel's span
// addressing). A row (token, head, plane) belongs to a group of G lanes (a
// power of two up to 32), each lane holding up to kMaxUnits 16-byte units
// of the row in registers, lane l units l, l + G, ...
// (ops/paged_write.py::int8_write_plan / copy_write_plan pick G, the units a
// lane and the rows a block). Each lane starts all of its loads (its units,
// valid[b], offs[b], both page ids, the row's scale for given codes) before
// it uses any, after griddepcontrol.wait: every one of them may be written
// by the kernel just before in a captured step (the rows by the qkv
// projection or rope; the Engine's window advances nothing on the card, but
// its table and lengths are written by copies queued in stream order). A
// row whose page id or in-page row falls outside the pool is not written.
// A width of no whole unit, a row of more than 32 x kMaxUnits units or a
// pointer off 16 bytes takes the scalar path (a warp a row, byte stores).
//
// For KIND kCopy the widths Dk / Dv are the rows' BYTES and the unit is 16
// bytes whatever the page dtype (8 bf16 or 4 f32 values).
#pragma once
#include "common.cuh"

namespace {

constexpr int kMaxUnits = 4;  // units a lane holds at most

// in_kind: 0 bf16 rows, 1 f32 rows (both quantized here), 2 int8 codes with
// f32 scales (copied); kCopy: K4's rows of any dtype copied as bytes into
// pages of the same dtype, no scale tiles
constexpr int kCopy = 3;
template <int KIND>
struct Unit {
  static constexpr int kValues = KIND >= 2 ? 16 : 8;  // values a unit
  static constexpr int kLoads = KIND == 1 ? 2 : 1;    // 16-byte loads a unit
  static constexpr int kBytes = KIND == 0 ? 2 : KIND == 1 ? 4 : 1;  // bytes a value
};

// max over the lane's group of G lanes (aligned in the warp): five xor
// steps on every lane, those at or above G discarded, so that every lane of
// the warp runs the same shuffles whatever its group's width
__device__ __forceinline__ float group_max(float v, int G) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    if (o < G) v = fmaxf(v, w);
  }
  return v;
}

__device__ __forceinline__ float quant(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return (uint32_t)(__float2int_rn(a) & 0xff) | ((uint32_t)(__float2int_rn(b) & 0xff) << 8) |
         ((uint32_t)(__float2int_rn(c) & 0xff) << 16) | ((uint32_t)__float2int_rn(d) << 24);
}

// the values of one unit (kValues 8 for float rows)
template <int KIND>
__device__ __forceinline__ void unpack(const uint4 (&w)[Unit<KIND>::kLoads], float (&f)[8]) {
  if constexpr (KIND == 0) {
    const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      f[4 * k] = __uint_as_float(w[k].x);
      f[4 * k + 1] = __uint_as_float(w[k].y);
      f[4 * k + 2] = __uint_as_float(w[k].z);
      f[4 * k + 3] = __uint_as_float(w[k].w);
    }
  }
}

template <int KIND>
__global__ void paged_write_rows_kernel(int8_t* __restrict__ k_pages, int8_t* __restrict__ v_pages,
                                        float* __restrict__ kv_scales,
                                        const void* __restrict__ k_new,
                                        const void* __restrict__ v_new,
                                        const float* __restrict__ ks_new,
                                        const float* __restrict__ vs_new,
                                        const int* __restrict__ page_ids,
                                        const int* __restrict__ offs,
                                        const int* __restrict__ valid, int S, int Hkv, int page,
                                        int Dk, int Dv, int P, int layer, int n_pg, int tokens,
                                        int lgk, int vk, int lgv, int vv, int T, int HB) {
  using U = Unit<KIND>;
  // this lane's row: region 0 holds the plane with the wider groups
  const int first = lgv >= lgk ? 1 : 0;
  const int lg_f = first ? lgv : lgk;
  const int n_first = (T * HB) << lg_f;
  int local = threadIdx.x, plane = first;
  if (local >= n_first) {
    local -= n_first;
    plane = 1 - first;
  }
  const int lg = plane ? lgv : lgk, V = plane ? vv : vk, D = plane ? Dv : Dk;
  const int G = 1 << lg, lane = local & (G - 1), task = local >> lg;
  const int tok = task / HB, hl = task - tok * HB;
  const int n_raw = blockIdx.x * T + tok, h_raw = blockIdx.y * HB + hl;
  const bool active = tok < T && n_raw < tokens && h_raw < Hkv;
  const int n = min(n_raw, tokens - 1), h = min(h_raw, Hkv - 1);  // in bounds when idle
  const int b = n / S, i = n - b * S;
  const size_t src = ((size_t)n * Hkv + h) * D;  // the row in k_new / v_new
  const unsigned char* x = static_cast<const unsigned char*>(plane ? v_new : k_new) +
                           src * U::kBytes;

  // a programmatic dependent launch: wait for the kernel before (the k / v
  // rows' producer) to finish, then every load before any use: x's units,
  // the slot's addressing, the scale
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int units = D / U::kValues;
  uint4 w[kMaxUnits][U::kLoads];
  if (V > 0) {
#pragma unroll
    for (int v = 0; v < kMaxUnits; ++v) {
      const int u = lane + (v << lg);
      if (v < V && u < units) {
#pragma unroll
        for (int k = 0; k < U::kLoads; ++k)
          w[v][k] = reinterpret_cast<const uint4*>(x)[u * U::kLoads + k];
      }
    }
  }
  const int* pids = page_ids + (size_t)b * n_pg;
  const int p0 = pids[0];
  const int p1 = n_pg > 1 ? pids[1] : p0;
  const int off = offs[b];
  const int vld = valid != nullptr ? valid[b] : S;
  float scale = 0.f;
  if constexpr (KIND == 2) scale = (plane ? vs_new : ks_new)[(size_t)n * Hkv + h];

  const int r = off + i;
  const int second = r >= page ? 1 : 0;
  const int pg = second && n_pg > 1 ? p1 : p0;
  const int row = r - second * page;
  const bool write = active && i < vld && pg >= 0 && pg < P && row >= 0 && row < page;
  const size_t page_base = (size_t)layer * P + (write ? pg : 0);
  const int wrow = write ? row : 0;  // in bounds when nothing is written
  int8_t* dst = (plane ? v_pages : k_pages) + ((page_base * Hkv + h) * page + wrow) * D;

  if (V > 0) {  // the row in registers: one read, vector stores
    if constexpr (KIND < 2) {
      float amax = 0.f;
#pragma unroll
      for (int v = 0; v < kMaxUnits; ++v) {
        if (v < V && lane + (v << lg) < units) {
          float f[8];
          unpack<KIND>(w[v], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
        }
      }
      scale = fmaxf(group_max(amax, G) / 127.0f, 1e-8f);
    }
#pragma unroll
    for (int v = 0; v < kMaxUnits; ++v) {
      const int u = lane + (v << lg);
      if (!write || v >= V || u >= units) continue;
      if constexpr (KIND >= 2) {
        reinterpret_cast<uint4*>(dst)[u] = w[v][0];
      } else {
        float f[8];
        unpack<KIND>(w[v], f);
        reinterpret_cast<uint2*>(dst)[u] =
            make_uint2(pack4(quant(f[0], scale), quant(f[1], scale), quant(f[2], scale),
                             quant(f[3], scale)),
                       pack4(quant(f[4], scale), quant(f[5], scale), quant(f[6], scale),
                             quant(f[7], scale)));
      }
    }
  } else {  // scalar path: the group strides over the row's values
    if constexpr (KIND >= 2) {
      for (int d = lane; d < D && write; d += G) dst[d] = reinterpret_cast<const int8_t*>(x)[d];
    } else {
      auto value = [&](int d) {
        return KIND == 0 ? bf2f(reinterpret_cast<const bf16*>(x)[d])
                         : reinterpret_cast<const float*>(x)[d];
      };
      float amax = 0.f;
      for (int d = lane; d < D; d += G) amax = fmaxf(amax, fabsf(value(d)));
      scale = fmaxf(group_max(amax, G) / 127.0f, 1e-8f);
      for (int d = lane; d < D && write; d += G)
        dst[d] = static_cast<int8_t>(quant(value(d), scale));
    }
  }
  if constexpr (KIND != kCopy) {
    if (write && lane == 0)
      kv_scales[(page_base * 8 + plane) * ((size_t)Hkv * page) + (size_t)h * page + wrow] = scale;
  }
}

template <int KIND>
cudaError_t launch(void* k_pages, void* v_pages, void* kv_scales, const void* k_new,
                   const void* v_new, const void* ks_new, const void* vs_new,
                   const void* page_ids, const void* offs, const void* valid, int S, int Hkv,
                   int page, int Dk, int Dv, int P, int layer, int n_pg, int tokens, int lgk,
                   int vk, int lgv, int vv, int T, int HB, int threads, int pdl,
                   cudaStream_t st) {
  // programmatic stream serialization: the blocks may start, and find their
  // rows, while the kernel before finishes; they wait for it before their
  // first load (griddepcontrol.wait). pdl 0: a plain launch (a measurement's)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tokens + T - 1) / T, (Hkv + HB - 1) / HB);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_write_rows_kernel<KIND>, static_cast<int8_t*>(k_pages),
      static_cast<int8_t*>(v_pages), static_cast<float*>(kv_scales), k_new, v_new, static_cast<const float*>(ks_new),
      static_cast<const float*>(vs_new), static_cast<const int*>(page_ids),
      static_cast<const int*>(offs), static_cast<const int*>(valid), S, Hkv, page, Dk, Dv, P,
      layer, n_pg, tokens, lgk, vk, lgv, vv, T, HB);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// does plane width D fit its (lg, V) of the plan: V units of 2^lg lanes
// covering whole units, or V = 0 (the scalar path, a warp a row)
bool plane_fits(int D, int lg, int V, int values) {
  if (V == 0) return lg == 5;
  return lg >= 0 && lg <= 5 && V <= kMaxUnits && D % values == 0 &&
         (long long)(V << lg) * values >= D && (long long)((V - 1) << lg) * values < D;
}

}  // namespace
