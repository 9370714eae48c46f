// K9: W4A16 GEMM for small quant groups (G = 32, GGUF's group, or 64) over
// QTPU-packed weights, dequantizing each weight before the dot.
//
// Replaces the Pallas kernel of quick_tpu/ops/quantized_matmul.py:
//   _make_kernel_dequant (:522), launched from _quantized_matmul_2d's
//   small-group branch (:721-847, pallas_call :870).
//
// What it computes: w[k, n] = bf16(code[k, n] * s[g, n] - zs[g, n]) with
// g = k / G, the product and the difference each rounded in f32 (no fused
// multiply-add, so the bf16 weight is the one XLA and the plain version
// round), then y = sum_k bf16(x[m, k]) * w[k, n] in f32, written as bf16.
// In the QTPU layout the code of k sits in nibble (k % G) / slab of packed
// row g * slab + k % slab, slab = G / 8: a 32-bit word holds 8 codes of one
// group at k-stride slab. The TPU kernel's x-column permutation
// (_small_g_perm :588) and its one-hot scale expansion (:560-571) are
// layout devices of the TPU and are not carried over.
//
// What bounds it on the H100: at decode (M <= 8) the weight stream, K*N/2
// bytes of codes plus 8*(K/G)*N bytes of f32 scales and zeros (at G = 32
// the scales are half the code bytes) against 3.35 TB/s; at prefill the
// multiply-adds against the bf16 tensor-core rate (989 TFLOP/s dense).
//
// Design: K walks in chunks of 128 (16 packed rows, 128 / G whole groups);
// a chunk past the end of K (K need only be a multiple of G) reads zeros.
// Decode (M <= 8): one thread owns one output column, issues the chunk's 16
// packed words and its groups' scales together, stages the chunk's bf16
// activations as f32 in shared memory (k-major, the ROWS values of one k
// are one vector load), dequantizes each code in registers and multiplies
// it into f32 sums; when the output tiles cannot fill the card, K is split
// over blocks and a second kernel sums the f32 partials in a fixed order.
// More than 8 rows (qmm_wgmma_dq.cuh): the output tile computed transposed
// on wgmma (m64nBTk16, bf16 in, f32 accumulate) with the weight as the
// register operand, dequantized straight from the QTPU words, the
// activations as the shared-memory operand, a 4-stage ring of 128-deep
// stages filled by the Tensor Memory Accelerator, BT = 16, 32, 64 or 128
// tokens a block from the wrapper's plan, one accumulator across K.
#include "qmm_mma.cuh"
#include "qmm_wgmma_dq.cuh"

namespace {

constexpr int kKC = 128;                // k per staged chunk
constexpr int kRowsPerChunk = kKC / kPack;  // 16 packed rows

// bf16(code * s - zs) with two rounded f32 operations, as XLA computes it
__device__ __forceinline__ float dequant(float code, float s, float zs) {
  return round_bf16(__fsub_rn(__fmul_rn(code, s), zs));
}

template <int ROWS, int G>
__global__ void __launch_bounds__(kBN)
dq_decode_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ qw,
                 const float* __restrict__ scales, const float* __restrict__ zs,
                 int M, int K, int N, int chunks_per_split,
                 float* __restrict__ partial, bf16* __restrict__ out) {
  constexpr int kSlabG = G / kPack;  // packed rows per group
  constexpr int kCG = kKC / G;       // groups per chunk
  __shared__ __align__(16) float xs[kKC * ROWS];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kBN + t;
  const bool col_ok = n < N;
  const int m0 = blockIdx.y * ROWS;
  const int nck = (K + kKC - 1) / kKC;
  const int c0 = blockIdx.z * chunks_per_split;
  const int c1 = min(nck, c0 + chunks_per_split);
  const int rows_total = K / kPack, ng = K / G;

  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;

  for (int c = c0; c < c1; ++c) {
    uint32_t w[kRowsPerChunk];
#pragma unroll
    for (int r = 0; r < kRowsPerChunk; ++r) {
      const int p = c * kRowsPerChunk + r;
      w[r] = col_ok && p < rows_total ? __ldg(qw + (size_t)p * N + n) : 0u;
    }
    float s[kCG], z[kCG];
#pragma unroll
    for (int q = 0; q < kCG; ++q) {
      const int g = c * kCG + q;
      const bool ok = col_ok && g < ng;
      s[q] = ok ? __ldg(scales + (size_t)g * N + n) : 0.f;
      z[q] = ok ? __ldg(zs + (size_t)g * N + n) : 0.f;
    }
    const int k = c * kKC + t;  // thread t stages k of every row
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int m = m0 + i;
      xs[t * ROWS + i] = m < M && k < K ? bf2f(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerChunk; ++r) {
      const int q = r / kSlabG, rr = r % kSlabG;
#pragma unroll
      for (int j = 0; j < kPack; ++j) {
        const float wv = dequant(code_f32(w[r], j), s[q], z[q]);
        const float* xk = xs + (q * G + j * kSlabG + rr) * ROWS;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i] = fmaf(xk[i], wv, acc[i]);
      }
    }
    __syncthreads();  // xs is restaged by the next chunk
  }

  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int m = m0 + i;
    if (m >= M) break;
    const size_t o = (size_t)m * N + n;
    if (partial != nullptr) {
      partial[(size_t)blockIdx.z * M * N + o] = acc[i];
    } else {
      out[o] = __float2bfloat16_rn(acc[i]);
    }
  }
}

__global__ void dq_splitk_reduce_kernel(const float* __restrict__ partial,
                                        int splits, size_t mn,
                                        bf16* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + i];
  out[i] = __float2bfloat16_rn(s);
}

struct Args {
  const bf16* x; const uint32_t* qw; const float* scales; const float* zs;
  int M, K, N, splits, cps; float* partial; bf16* out;
};

template <int ROWS, int G>
cudaError_t launch_decode(const Args& a, cudaStream_t st) {
  dim3 grid((a.N + kBN - 1) / kBN, (a.M + ROWS - 1) / ROWS, a.splits);
  dq_decode_kernel<ROWS, G><<<grid, kBN, 0, st>>>(
      a.x, a.qw, a.scales, a.zs, a.M, a.K, a.N, a.cps,
      a.splits > 1 ? a.partial : nullptr, a.out);
  return cudaGetLastError();
}

template <int G>
cudaError_t dispatch(int rows, const Args& a, cudaStream_t st) {
  switch (rows) {
    case 1: return launch_decode<1, G>(a, st);
    case 2: return launch_decode<2, G>(a, st);
    case 4: return launch_decode<4, G>(a, st);
    case 8: return launch_decode<8, G>(a, st);
    default:
      return qwd::launch<G>(rows, a.x, a.qw, a.scales, a.zs, a.M, a.K, a.N, a.splits, a.cps,
                            a.partial, a.out, st);
  }
}

}  // namespace

// x: [M, K] bf16, 16-byte aligned; qweight: int32 [K/8, N]; scales,
// zeros_x_scales: f32 [K/G, N]; partial: f32 [splits, M, N] scratch
// (splits > 1 only); out: [M, N] bf16. G = 32 or 64, K % G == 0. rows (1,
// 2, 4, 8: CUDA-core decode path; 16, 32, 64, 128: the wgmma body's tokens
// per block, N % 4 == 0, qweight, scales and zeros_x_scales 16-byte
// aligned), splits and chunks_per_split (chunks of 128 k) come from the
// wrapper's launch plan.
extern "C" int qtt_quantized_matmul_dequant(
    const void* x, const void* qweight, const void* scales,
    const void* zeros_x_scales, int M, int K, int N, int G, int rows,
    int splits, int chunks_per_split, void* partial, void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (G != 32 && G != 64) || K % G != 0 ||
      splits <= 0 || chunks_per_split <= 0)
    return cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const bf16*>(x), static_cast<const uint32_t*>(qweight),
         static_cast<const float*>(scales),
         static_cast<const float*>(zeros_x_scales), M, K, N, splits,
         chunks_per_split, static_cast<float*>(partial), static_cast<bf16*>(out)};
  cudaError_t err = G == 32 ? dispatch<32>(rows, a, st) : dispatch<64>(rows, a, st);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  dq_splitk_reduce_kernel<<<blocks, 256, 0, st>>>(a.partial, splits, mn, a.out);
  return cudaGetLastError();
}
