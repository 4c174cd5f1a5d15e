// Shared device code of the fused LUT GEMV and GEMM kernels (solo and
// multi-projection).
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
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }

// What happens to an activation on its way into the contraction. The fused
// kernels (B1-B4) take a bool where a Mode is expected: false is SMOOTH,
// true is QUANT.
enum Mode : int {
  SMOOTH = 0,  // Eq. 11 without quantization: x * inv
  QUANT = 1,   // Eq. 11: rint(x * inv), then the symmetric clip to [-127, 127]
  NONE = 2,    // the activation as it is (B6: already smoothed; B7: int8 codes)
};

// The transform of one element; `inv` is not read in mode NONE.
template <int MODE>
__device__ __forceinline__ float transform(float x, float inv) {
  if constexpr (MODE == NONE) return x;
  float xs = __fmul_rn(x, inv);
  if constexpr (MODE == QUANT) xs = fminf(fmaxf(rintf(xs), -127.0f), 127.0f);
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

// The projections of one multi-projection GEMM launch (kernel B4; the GEMV
// has its own job, lut_gemv.cuh): P operand sets sharing x, passed to the
// kernel by value. The grid walks the
// column tiles of projection 0, then those of projection 1, and so on, so a
// tile never straddles two projections; tile0[p] is projection p's first
// tile, col0[p] its first column in the concatenated (M, n_total) output.
constexpr int MAX_PROJ = 8;

struct MultiDesc {
  const uint8_t* packed[MAX_PROJ];  // (K*nbits[p]/8, n[p]) u8 each
  int n[MAX_PROJ];
  int nbits[MAX_PROJ];
  int quantize[MAX_PROJ];
  int tile0[MAX_PROJ + 1];
  int col0[MAX_PROJ];
  int n_proj;
  int n_total;
};

// One projection's entries of the descriptor.
struct Proj {
  const uint8_t* packed;
  int n, nbits, quantize, tile0, col0, index;
};

// The projection column tile `tile` belongs to: the last p with
// tile0[p] <= tile. Every entry is read at a compile-time index (an unrolled
// select), which measured about 2 % faster on an H100 than indexing the
// descriptor with the projection number at run time.
__device__ __forceinline__ Proj proj_of(const MultiDesc& d, int tile) {
  Proj r{d.packed[0], d.n[0], d.nbits[0], d.quantize[0], d.tile0[0], d.col0[0], 0};
#pragma unroll
  for (int q = 1; q < MAX_PROJ; ++q)
    if (q < d.n_proj && tile >= d.tile0[q])
      r = Proj{d.packed[q], d.n[q], d.nbits[q], d.quantize[q], d.tile0[q], d.col0[q], q};
  return r;
}

// Host side: the descriptor of P projections tiled `tile_n` columns at a
// time. Returns the number of column tiles, or -1 for an argument the
// kernels do not take.
inline int make_desc(MultiDesc& d, const void* const* packed, const int* widths, const int* nbits,
                     const int* quantize, int P, int K, int tile_n) {
  if (P < 1 || P > MAX_PROJ) return -1;
  int tiles = 0, cols = 0;
  for (int p = 0; p < P; ++p) {
    if (widths[p] <= 0 || nbits[p] < 2 || nbits[p] > 4 || (K * nbits[p]) % 8) return -1;
    d.packed[p] = static_cast<const uint8_t*>(packed[p]);
    d.n[p] = widths[p];
    d.nbits[p] = nbits[p];
    d.quantize[p] = quantize[p] ? 1 : 0;
    d.tile0[p] = tiles;
    d.col0[p] = cols;
    tiles += (widths[p] + tile_n - 1) / tile_n;
    cols += widths[p];
  }
  d.tile0[P] = tiles;
  d.n_proj = P;
  d.n_total = cols;
  return tiles;
}

}  // namespace lut
