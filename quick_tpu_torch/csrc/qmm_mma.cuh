// The W4A16 constants and the code-to-float helper shared by K1's
// CUDA-core decode body (qmm_decode.cuh, with K14) and K9's decode body
// (quantized_matmul_dequant.cu): the quant group and its 16 packed rows of
// 8 nibbles, 128 output columns a block, and code_f32, which turns nibble
// j of a QTPU word into its code as an exact f32 (the 2^23 exponent trick).
#pragma once

#include "common.cuh"

namespace {

constexpr int kG = 128;       // quant group: 16 packed rows x 8 nibbles
constexpr int kSlab = 16;     // packed rows per group
constexpr int kPack = 8;      // nibbles per word
constexpr int kBN = 128;      // columns per block

__device__ __forceinline__ float code_f32(uint32_t w, int j) {
  return __uint_as_float(((w >> (4 * j)) & 0xFu) | 0x4B000000u) - 8388608.f;
}

}  // namespace
