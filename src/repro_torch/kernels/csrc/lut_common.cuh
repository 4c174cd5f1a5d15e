// Shared device code of the fused LUT GEMV and GEMM kernels.
//
// Both kernels compute  Y[m, n] = sum_k T(x[m, k]) * codebook[code[k, n]]
// with T the Eq. 11 input transform, and both sum over k in ONE canonical
// order, so that a row's result is bit-identical whichever kernel serves it
// (the engine feeds a decoding slot through the GEMM on a mixed
// prefill/decode step and through the GEMV on a pure decode step, and its
// tokens must not depend on which):
//
//   * K is cut into k-blocks of KB = 8 input channels (a whole packing group
//     at every width: 4 packed rows at 4-bit, 3 at 3-bit, 2 at 2-bit);
//   * k-block b belongs to way  b mod WAYS;  a way folds its k-blocks in
//     increasing b, its channels in increasing k, into one running
//     fmaf chain that starts at +0;
//   * the output is the sum of the WAYS way results, taken in way order,
//     starting from +0.
//
// The GEMV gives every way to different threads (WAYS-fold split of K inside
// a thread block, then an ordered reduction through shared memory); the GEMM
// walks K way by way with two accumulators per output. No atomics anywhere.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lut {

constexpr int KB = 8;      // input channels per k-block
constexpr int WAYS = 64;   // interleaved K ways of the canonical order
constexpr int KC = 16;     // codebook capacity

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Eq. 11 input transform on one element: x * inv, and when quantizing
// round-half-to-even then the symmetric clip to [-127, 127].
template <bool QUANT>
__device__ __forceinline__ float transform(float x, float inv) {
  float xs = __fmul_rn(x, inv);
  if (QUANT) xs = fminf(fmaxf(rintf(xs), -127.0f), 127.0f);
  return xs;
}

// The packed word of one k-block of one column: NBITS packed rows, N bytes
// apart, little-endian. Code kk of the block is (word >> (NBITS*kk)) & mask
// at every width (core/lut.py layout). Rows past the end read as zero codes.
template <int NBITS>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ packed, int64_t n_cols,
                                              int packed_rows, int kblock, int col) {
  uint32_t word = 0;
#pragma unroll
  for (int r = 0; r < NBITS; ++r) {
    int row = kblock * NBITS + r;
    if (row < packed_rows) word |= (uint32_t)packed[(int64_t)row * n_cols + col] << (8 * r);
  }
  return word;
}

template <int NBITS>
__device__ __forceinline__ int code_of(uint32_t word, int kk) {
  return (word >> (NBITS * kk)) & ((1u << NBITS) - 1u);
}

}  // namespace lut
