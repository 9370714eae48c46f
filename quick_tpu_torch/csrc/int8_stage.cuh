// Staging of INT8 KV codes for the tensor-core attention kernels (K5q, K6q,
// K10q): 4-byte cp.async copies for the scale tiles, the wait that leaves
// the latest copy group in flight, the exact conversion of staged int8
// codes to bf16 (so that K5's / K6's bf16 m16n8k16 products run on them),
// and the int8 m16n8k32 product on codes staged in swizzled rows.
#pragma once

#include "split_attention.cuh"

namespace {

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

// D += A (16 x 32, row) * B (32 x 8, col): s8 in, s32 accumulate (exact)
__device__ __forceinline__ void mma16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk c of row r in a tile of D-byte int8 rows,
// swizzled so that ldmatrix's eight rows of one chunk hit eight bank groups
template <int D>
__device__ __forceinline__ uint32_t swz8(int r, int c) {
  return static_cast<uint32_t>(r * D + ((c ^ (D >= 128 ? (r & 7) : ((r >> 1) & 3))) << 4));
}

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

}  // namespace
