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
// padding that nothing writes or reads. A row whose page id or in-page row
// falls outside the pool is not written (bad input: no write). Several
// slots may write the trash page 0 in one launch; those rows are never read.
//
// What bounds it on the H100: bytes — each written row read once and written
// once: at the serving decode shape (64 slots, Hkv 8, D 128) 256 KB of bf16
// in, 128 KB of codes and 4 KB of scales out, 0.12 us at 3.35 TB/s, so a
// call is bound by its launch and its chain of dependent memory round trips.
//
// The k and v planes may differ in width (Dk, Dv): DeepSeek's MLA latent
// pages hold the rope'd k_pe (Dk = 64) and the latent (Dv = 512) with
// Hkv = 1; each row's scale goes to its own tile row as above.
//
// Design: one global round trip before compute. A row (token, head, plane)
// belongs to a group of G lanes (a power of two up to 32), each lane holding
// up to kMaxUnits units of the row in registers: a unit is 8 values (one
// 16-byte load of bf16, two of f32) or 16 int8 codes (one load), and lane l
// holds units l, l + G, ... (ops/paged_write.py::int8_write_plan picks G and
// the units a lane: a 128-wide bf16 row is 16 lanes of one unit, DeepSeek's
// 64-wide k_pe 8 lanes, its 512-wide latent a warp of two units). Each lane
// starts all of its loads before it uses any: its units of x (their address
// depends on the token and the head alone), valid[b], offs[b], both page
// ids of the slot and, for codes, the row's scale. The absmax is reduced
// over the group with xor shuffles; the codes of a unit go out as one 8-byte
// store (16 for copied codes) and lane 0 writes the scale. A block holds the
// rows of T tokens x HB heads: the planes' rows in two regions, the plane
// with the wider groups first so that every group lies aligned inside a
// warp; T fits the block to ~256 lanes (one token of Mistral's 8 heads x
// two planes x 16 lanes; six DeepSeek latent tokens of 32 + 8 lanes). A
// width that fills no whole unit, a row of more than 32 x kMaxUnits units,
// or a pointer off 16 bytes takes the scalar path inside the kernel
// (shape-selected: a warp a row, lane-strided values read twice, byte
// stores). It is a programmatic dependent launch, as K9's decode rows: its
// blocks start while the kernel before finishes and wait for it
// (griddepcontrol.wait) before their first load. Not carried over from the TPU: the aligned 32-row read-modify-write
// blocks with output aliasing, the one-hot dot that spreads per-head scales
// over the tile's lanes, and the rotation dot of the chunk kernel; here each
// code row and each scale is stored at its own address.
#include "common.cuh"

namespace {

constexpr int kMaxUnits = 4;  // units a lane holds at most

// in_kind: 0 bf16 rows, 1 f32 rows (both quantized here), 2 int8 codes with
// f32 scales (copied)
template <int KIND>
struct Unit {
  static constexpr int kValues = KIND == 2 ? 16 : 8;  // values a unit
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
__global__ void paged_write_int8_kernel(int8_t* __restrict__ k_pages, int8_t* __restrict__ v_pages,
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
    if constexpr (KIND != 2) {
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
      if constexpr (KIND == 2) {
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
    if constexpr (KIND == 2) {
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
  if (write && lane == 0)
    kv_scales[(page_base * 8 + plane) * ((size_t)Hkv * page) + (size_t)h * page + wrow] = scale;
}

template <int KIND>
cudaError_t launch(void* k_pages, void* v_pages, void* kv_scales, const void* k_new,
                   const void* v_new, const void* ks_new, const void* vs_new,
                   const void* page_ids, const void* offs, const void* valid, int S, int Hkv,
                   int page, int Dk, int Dv, int P, int layer, int n_pg, int tokens, int lgk,
                   int vk, int lgv, int vv, int T, int HB, int threads, cudaStream_t st) {
  // programmatic stream serialization: the blocks may start, and find their
  // rows, while the kernel before finishes; they wait for it before their
  // first load (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tokens + T - 1) / T, (Hkv + HB - 1) / HB);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_write_int8_kernel<KIND>, static_cast<int8_t*>(k_pages),
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

// k_pages: int8 [L, P, Hkv, page, Dk], v_pages: int8 [L, P, Hkv, page, Dv];
// kv_scales: f32 [L, P, 8, Hkv * page]; k_new: [B, S, Hkv, Dk], v_new:
// [B, S, Hkv, Dv], bf16 (in_kind 0), f32 (1) or int8 codes (2, with ks_new /
// vs_new f32 [B, S, Hkv]; null otherwise); page_ids: int32 [B, n_pg] (n_pg
// 1 or 2); offs: int32 [B]; valid: int32 [B] or null (all S tokens written).
// The plan (ops/paged_write.py::int8_write_plan): per plane log2 of the lanes
// a row (lgk, lgv) and the units a lane (vk, vv; 0: the scalar path, whose
// pointers need no alignment), T tokens and HB heads a block.
extern "C" int qtt_paged_write_int8(void* k_pages, void* v_pages, void* kv_scales,
                                    const void* k_new, const void* v_new, const void* ks_new,
                                    const void* vs_new, const void* page_ids, const void* offs,
                                    const void* valid, int B, int S, int Hkv, int page, int Dk,
                                    int Dv, int P, int layer, int n_pg, int L, int in_kind,
                                    int lgk, int vk, int lgv, int vv, int T, int HB,
                                    void* stream) {
  if (B <= 0 || S <= 0 || S > page || Hkv <= 0 || Dk <= 0 || Dv <= 0 || layer < 0 ||
      layer >= L || n_pg < 1 || n_pg > 2 || in_kind < 0 || in_kind > 2 ||
      (in_kind == 2 && (ks_new == nullptr || vs_new == nullptr)))
    return cudaErrorInvalidValue;
  const int values = in_kind == 2 ? 16 : 8;
  const long long tokens = (long long)B * S;
  const long long lanes = (long long)T * HB * ((1LL << lgk) + (1LL << lgv));
  if (!plane_fits(Dk, lgk, vk, values) || !plane_fits(Dv, lgv, vv, values) || T <= 0 ||
      HB <= 0 || HB > Hkv || tokens > 0x7fffffffLL || lanes > 1024 ||
      (Hkv + HB - 1) / HB > 65535)
    return cudaErrorInvalidValue;
  const int threads = (int)((lanes + 31) / 32 * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(k_pages, v_pages, kv_scales, k_new, v_new, ks_new, vs_new, page_ids,
                         offs, valid, S, Hkv, page, Dk, Dv, P, layer, n_pg, (int)tokens, lgk,
                         vk, lgv, vv, T, HB, threads, st);
  };
  if (in_kind == 0) return go(&launch<0>);
  if (in_kind == 1) return go(&launch<1>);
  return go(&launch<2>);
}
