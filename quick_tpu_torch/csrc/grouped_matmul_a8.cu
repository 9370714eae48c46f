// K12: grouped (ragged) W4A8 GEMM for MoE experts over expert-sorted
// bm-row tiles, on Hopper's int8 warpgroup tensor-core instruction.
//
// Replaces the Pallas kernel of quick_tpu/ops/grouped_matmul.py:
//   _make_grouped_kernel_a8 (:93), launched from quantized_matmul_grouped
//   (:205, pallas_call :274) under a8 (QUICK_TPU_MOE_A8=1).
//
// What it computes: for every bm-row tile i of the int8 codes xq [Mp, K]
// (rows sorted by expert, build_routing; codes and row scales sx [Mp] from
// quantize_activations), the tile's rows times the codes of expert
// e = tile_expert[i], read on the card: per quant group of 128 channels the
// integer dot in int32, as f32 times scales[e, g, n], minus
// rowsum(xq_g) * zeros_x_scales[e, g, n], summed over K in f32; then times
// sx and rounded once to bf16. The Pallas kernel writes the unscaled f32
// sum and XLA multiplies by sx outside it (:297; a [Mp, 1] operand pads
// 128x on the TPU); here the same f32 multiply runs in the epilogue (or in
// the split reduce) before the same single rounding. Tiles with
// tile_live[i] == 0 (past the last routed segment) are written as zeros,
// as the Pallas kernel writes them.
//
// What bounds it on the H100: at decode the bytes of the distinct experts
// the routing touches (K*N/2 of codes plus 8*(K/128)*N of f32 scales each)
// against 3.35 TB/s, the same weight stream as K8's; at prefill the routed
// multiply-adds against the int8 tensor-core rate (1,979 TOP/s dense),
// half K8's bf16 bound.
//
// Design: K8's skeleton (grouped_wgmma.cuh: blocks of (column tile,
// expert, K slice) that scan the tile layout on the card and stream their
// expert's weights once a pass of up to 64 or 128 rows, the K split from
// the wrapper's plan and its reduce) with K11's int8 body: a first kernel
// sums each group's codes (qmm_a8_operand.cuh: a8_rowsum_kernel), then
// wgmma.mma_async m64nWk32 (s8 x s8 -> s32) with A, the 64 channels x 32
// depths of codes, taken from the QTPU words in registers by K11's prmt /
// mask map (a_fragments at G = 128), and B the pass's int8 rows, one
// 128-byte swizzled row a token (k32 step s 32 bytes along it). Each
// group's exact int32 dot has its own accumulator and is folded in order
// as acc += f32(dot) * s[g, n] - rowsum_g[m] * zs[g, n]; sx[m] multiplies
// once before the bf16 rounding. Tiles of 32, 64 or 128 rows are the
// skeleton's; the wrapper hands other heights (any multiple of 32, which
// QUICK_TPU_MOE_BM reaches) over as 32- or 64-row sub-tiles carrying their
// tile's expert and live flag. Only G = 128 (the JAX package falls back to
// W4A16 at other groups or bm % 32 != 0, :233, and so does the wrapper).
//
// Not carried over from the TPU: the scalar-prefetched BlockSpec index maps,
// the VMEM-sized (bn, gpb) pickers.
#include "grouped_wgmma.cuh"
#include "qmm_a8_operand.cuh"

namespace {
namespace qgm {

using namespace qwg;

// group c's k32 steps on the first W tokens of the pass: dot = A * B
template <int W, int NR>
__device__ __forceinline__ void mma_group_s8(int (&dot)[NR], const uint32_t (&a)[4][4],
                                             uint32_t xb) {
  int (&d)[W / 2] = *reinterpret_cast<int (*)[W / 2]>(&dot[0]);
#pragma unroll
  for (int s = 0; s < 4; ++s) WgmmaS8<W>::mma(d, a[s], desc_b(xb + s * 32), s > 0);
}

// K12's body: int8 codes, s8 wgmma, the fold of K11, the row scale
struct S8Body {
  typedef int Dot;
  static constexpr int kXBytes = 1;
  static constexpr CUtensorMapDataType kXType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kMaxStages = 6;
  static constexpr bool kRowScale = true;

  // stage sp's one group (G = 128): its A fragments from the words, its
  // MMAs on the pass's codes at xb and the fold with the scales,
  // zeros_x_scales and row sums ([kBN], [kBN], [PR] after the codes and
  // words), read after the MMAs
  template <int PR, int G>
  static __device__ __forceinline__ void stage(float (&acc)[PR / 2], int (&dot)[PR / 2],
                                               uint32_t xb, const unsigned char* sp, int,
                                               int c0, int t, int nrow) {
    static_assert(G == 128, "K12 takes G = 128");
    uint32_t a[4][4];  // step s: {c0, c0+8} x {depths 4t.., 16+4t..}
    qwa::a_fragments<128>(reinterpret_cast<const uint32_t*>(sp + PR * kKC), 0, c0, t, a);
    hold(dot);
    wgmma_fence();
    if (PR == 64 && nrow <= 32) {
      mma_group_s8<32>(dot, a, xb);
    } else {
      mma_group_s8<PR>(dot, a, xb);
    }
    wgmma_commit();
    wgmma_wait0();
    hold(dot);
    hold(a);
    const float* ssm = reinterpret_cast<const float*>(sp + PR * kKC + kSlab * kBN * 4);
    const float s0c = ssm[c0], s1c = ssm[c0 + 8];
    const float z0 = ssm[kBN + c0], z1 = ssm[kBN + c0 + 8];
    const float* rsm = ssm + 2 * kBN;
    // the group's fold, in the order and form of _quantized_matmul_a8_jnp
#pragma unroll
    for (int i = 0; i < PR / 8; ++i) {
      if (8 * i >= nrow) break;
      const float2 rs = *reinterpret_cast<const float2*>(rsm + 8 * i + 2 * t);
      acc[4 * i + 0] += qwa::small_i2f(dot[4 * i + 0]) * s0c - rs.x * z0;
      acc[4 * i + 1] += qwa::small_i2f(dot[4 * i + 1]) * s0c - rs.y * z0;
      acc[4 * i + 2] += qwa::small_i2f(dot[4 * i + 2]) * s1c - rs.x * z1;
      acc[4 * i + 3] += qwa::small_i2f(dot[4 * i + 3]) * s1c - rs.y * z1;
    }
  }

  // the sums of each group's codes
  template <int G>
  static cudaError_t first(const void* x, int Mp, int K, int ldxs, float* xsumT,
                           cudaStream_t st) {
    qwa::a8_rowsum_kernel<G><<<Mp, 256, 0, st>>>(static_cast<const int8_t*>(x), K, ldxs, xsumT);
    return cudaGetLastError();
  }
};

}  // namespace qgm
}  // namespace

// xq: [Mp, K] int8 codes, 16-byte aligned, rows sorted by expert in
// bm-row tiles; sx: [Mp] f32 row scales; qweight: int32 [E, K/8, N];
// scales, zeros_x_scales: f32 [E, K/128, N] (all 16-byte aligned);
// tile_expert, tile_live: int32 [Mp/bm] (device); rowsum: f32 [K/128,
// (Mp + 3) & ~3] scratch, 16-byte aligned; partial: f32 [splits, Mp, N]
// scratch (splits > 1 only); out: [Mp, N] bf16. bm = 32, 64 or 128;
// Mp % bm == 0, K % 128 == 0, N % 4 == 0; K is cut into splits slices of
// cps stages of 128 (the wrapper's plan).
extern "C" int qtt_grouped_matmul_a8(const void* xq, const void* sx, const void* qweight,
                                     const void* scales, const void* zeros_x_scales,
                                     const void* tile_expert, const void* tile_live,
                                     void* rowsum, void* partial, int Mp, int K, int N, int E,
                                     int bm, int splits, int cps, void* out, void* stream) {
  using namespace qgm;
  if (!plan_ok(Mp, K, N, E, bm, 128, splits, cps) || sx == nullptr || rowsum == nullptr ||
      (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  return launch_g<S8Body, 128>(
      xq, static_cast<const uint32_t*>(qweight), static_cast<const float*>(scales),
      static_cast<const float*>(zeros_x_scales), static_cast<const int*>(tile_expert),
      static_cast<const int*>(tile_live), static_cast<const float*>(sx),
      static_cast<float*>(rowsum), static_cast<float*>(partial), Mp, K, N, E, bm, splits, cps,
      static_cast<bf16*>(out), static_cast<cudaStream_t>(stream));
}
