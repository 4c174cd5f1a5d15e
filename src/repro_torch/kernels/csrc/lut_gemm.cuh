// The thread-block body of the fused LUT GEMM, shared by the solo kernel
// (lut_gemm.cu, B2) and the multi-projection kernel (lut_multi_gemm.cu, B4).
//
// One call computes one BM x BN output tile of Y = T(x) @ codebook[codes],
// walking K way by way in the canonical order of lut_common.cuh. Both kernels
// run this same code for a tile, so a projection's columns carry the same
// bits whichever kernel served them. The caller owns the shared memory and
// says where the tile's columns land in its output (row stride, first column).
#pragma once

#include "lut_common.cuh"

namespace lut {
namespace gemm {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int TM = 8;               // rows per thread
constexpr int TN = 4;               // columns per thread
constexpr int THREADS = 256;        // 16 x 16 threads
constexpr int TB = 4;               // k-blocks of one way per shared-memory tile
constexpr int TK = TB * KB;         // 32 channels per tile

struct __align__(16) Smem {
  float xs[TK][BM];   // transformed activations
  float ws[TK][BN];   // decoded weights
  float cb[KC];
};

// Tile (nblock, mblock) of Y for one (x, inv, packed, cb) operand set of
// width N; its element (m, n) is written to y[m * y_stride + y_col0 + n],
// times *out_scale when that is given (one rounded multiply).
template <int NBITS, typename XT, int MODE>
__device__ __forceinline__ void tile(const XT* __restrict__ x, const float* __restrict__ inv,
                                     const uint8_t* __restrict__ packed,
                                     const float* __restrict__ cb, float* __restrict__ y, int M,
                                     int K, int N, int packed_rows, int nblock, int mblock,
                                     int64_t y_stride, int y_col0, Smem& sm,
                                     const float* __restrict__ out_scale = nullptr) {
  float(*xs)[BM] = sm.xs;
  float(*ws)[BN] = sm.ws;
  float* cb_s = sm.cb;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int m0 = mblock * BM;
  const int n0 = nblock * BN;
  const int nblk = (K + KB - 1) / KB;

  if (tid < KC) cb_s[tid] = cb[tid];

  float total[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) total[r][c] = 0.0f;

  for (int way = 0; way < WAYS; ++way) {
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

    for (int b0 = way; b0 < nblk; b0 += TB * WAYS) {
      __syncthreads();
      // activation tile: (row, k-block) pairs, 8 contiguous channels each
#pragma unroll
      for (int u = 0; u < (BM * TB) / THREADS; ++u) {
        const int p = tid + THREADS * u;
        const int row = p % BM;
        const int i = p / BM;
        const int b = b0 + i * WAYS;
        if (b < nblk) {
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) {
            const int k = b * KB + kk;
            float v = 0.0f;
            if (k < K && m0 + row < M)
              v = transform<MODE>(to_float(x[(int64_t)(m0 + row) * K + k]),
                                  MODE == NONE ? 0.0f : inv[k]);
            xs[i * KB + kk][row] = v;
          }
        }
      }
      // weight tile: one (k-block, column) pair per thread, decoded through the table
      {
        const int col = tid % BN;
        const int i = tid / BN;
        const int b = b0 + i * WAYS;
        if (b < nblk) {
          uint32_t word = 0;
          if (n0 + col < N) word = load_word<NBITS>(packed, N, packed_rows, b, n0 + col);
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) ws[i * KB + kk][col] = cb_s[code_of<NBITS>(word, kk)];
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < TB; ++i) {
        const int b = b0 + i * WAYS;
        if (b < nblk) {
          const int kvalid = min(KB, K - b * KB);
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) {
            if (kk < kvalid) {
              const int t = i * KB + kk;
              const float4 xa = *reinterpret_cast<const float4*>(&xs[t][ty * TM]);
              const float4 xb = *reinterpret_cast<const float4*>(&xs[t][ty * TM + 4]);
              const float4 wv = *reinterpret_cast<const float4*>(&ws[t][tx * TN]);
              const float xr[TM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
              const float wc[TN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int r = 0; r < TM; ++r)
#pragma unroll
                for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(xr[r], wc[c], acc[r][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) total[r][c] += acc[r][c];
  }

  const float sc = out_scale ? *out_scale : 1.0f;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty * TM + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = n0 + tx * TN + c;
      if (n < N)
        y[(int64_t)m * y_stride + y_col0 + n] =
            out_scale ? __fmul_rn(total[r][c], sc) : total[r][c];
    }
  }
}

}  // namespace gemm
}  // namespace lut
