// The thread-block body of the fused LUT GEMV, shared by the solo kernel
// (lut_gemv.cu, B1) and the multi-projection kernel (lut_multi_gemv.cu, B3).
//
// One call computes one strip of the output: MT rows by BN columns of
// Y = T(x) @ codebook[codes], K split WAYS ways inside the block and folded in
// the canonical order of lut_common.cuh. Both kernels run this same code for a
// strip, so a projection's columns carry the same bits whichever kernel
// served them. The caller owns the shared memory and says where the strip's
// columns land in its output (row stride, first column).
#pragma once

#include "lut_common.cuh"

namespace lut {
namespace gemv {

constexpr int MT = 8;              // rows per thread block
constexpr int CT = 4;              // columns per thread
constexpr int TN = 8;              // threads along N
constexpr int BN = TN * CT;        // 32 columns per thread block
constexpr int THREADS = TN * WAYS; // 512
constexpr int KROUND = WAYS * KB;  // 512 input channels per round
constexpr int RED_WAYS = 16;       // ways folded per reduction pass

struct __align__(16) Smem {
  float buf[MT * KROUND];  // x tile, then reduction scratch
  float cb[KC];
};

// Strip (nblock, mblock) of Y for one (x, inv, packed, cb) operand set of
// width N; its element (m, n) is written to y[m * y_stride + y_col0 + n],
// times *out_scale when that is given (one rounded multiply).
template <int NBITS, typename XT, int MODE>
__device__ __forceinline__ void strip(const XT* __restrict__ x, const float* __restrict__ inv,
                                      const uint8_t* __restrict__ packed,
                                      const float* __restrict__ cb, float* __restrict__ y, int M,
                                      int K, int N, int packed_rows, int vec_ok, int nblock,
                                      int mblock, int64_t y_stride, int y_col0, Smem& sm,
                                      const float* __restrict__ out_scale = nullptr) {
  float* buf = sm.buf;
  float* cb_s = sm.cb;
  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int tk = tid / TN;  // this thread's way
  const int m0 = mblock * MT;
  const int nblock0 = nblock * BN;
  const int n0 = nblock0 + tn * CT;
  const int nblk = (K + KB - 1) / KB;
  const int rounds = (nblk + WAYS - 1) / WAYS;

  if (tid < KC) cb_s[tid] = cb[tid];

  float acc[MT][CT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[m][c] = 0.0f;

  const bool vec = vec_ok && (n0 + CT <= N);

  // Operands of the NEXT round are fetched into registers before this round's
  // arithmetic, so that the latency of device memory hides behind it; nothing
  // is done to a fetched value before the round that uses it.
  XT xraw[MT];            // x[m0 + m, r*KROUND + tid]
  float iv = 0.0f;        // inv[r*KROUND + tid]
  uint32_t raw[NBITS];    // packed rows of this way's k-block, 4 columns each (vec)
  uint32_t wordn[CT];     // the same, column by column (ragged N or unaligned)
  auto fetch = [&](int r) {
    const int k = r * KROUND + tid;
    if (k < K) {
      if constexpr (MODE != NONE) iv = inv[k];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < M) xraw[m] = x[(int64_t)(m0 + m) * K + k];
    }
    const int b = r * WAYS + tk;
    if (b >= nblk) return;
    if (vec) {
#pragma unroll
      for (int rr = 0; rr < NBITS; ++rr) {
        const int row = b * NBITS + rr;
        raw[rr] = (row < packed_rows)
                      ? *reinterpret_cast<const uint32_t*>(packed + (int64_t)row * N + n0)
                      : 0u;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c)
        wordn[c] = (n0 + c < N) ? load_word<NBITS>(packed, N, packed_rows, b, n0 + c) : 0u;
    }
  };

  fetch(0);
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();
    {  // stage T(x) for channels [r*KROUND, (r+1)*KROUND): thread tid owns channel tid
      const int k = r * KROUND + tid;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float v = 0.0f;
        if (k < K && m0 + m < M) v = transform<MODE>(to_float(xraw[m]), iv);
        buf[m * KROUND + tid] = v;
      }
    }
    const int b = r * WAYS + tk;
    uint32_t word[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      word[c] = 0;
      if (b < nblk) {
        if (vec) {
#pragma unroll
          for (int rr = 0; rr < NBITS; ++rr) word[c] |= ((raw[rr] >> (8 * c)) & 0xFFu) << (8 * rr);
        } else {
          word[c] = wordn[c];
        }
      }
    }
    __syncthreads();
    if (r + 1 < rounds) fetch(r + 1);
    if (b >= nblk) continue;
    const int kvalid = min(KB, K - b * KB);

    float w[CT][KB];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) w[c][kk] = cb_s[code_of<NBITS>(word[c], kk)];

#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 xa = *reinterpret_cast<const float4*>(&buf[m * KROUND + tk * KB]);
      const float4 xb = *reinterpret_cast<const float4*>(&buf[m * KROUND + tk * KB + 4]);
      const float xv[KB] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      if (kvalid == KB) {
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) acc[m][c] = fmaf(xv[kk], w[c][kk], acc[m][c]);
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int kk = 0; kk < KB; ++kk)
            if (kk < kvalid) acc[m][c] = fmaf(xv[kk], w[c][kk], acc[m][c]);
      }
    }
  }

  // ordered fold of the WAYS way results: way 0 first, from +0
  float total = 0.0f;
  const int om = tid / BN;   // owner threads: tid < MT*BN
  const int oc = tid % BN;
  for (int p = 0; p < WAYS / RED_WAYS; ++p) {
    __syncthreads();
    if (tk / RED_WAYS == p) {
      const int j = tk % RED_WAYS;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CT; ++c) buf[(j * MT + m) * BN + tn * CT + c] = acc[m][c];
    }
    __syncthreads();
    if (tid < MT * BN) {
#pragma unroll
      for (int j = 0; j < RED_WAYS; ++j) total += buf[(j * MT + om) * BN + oc];
    }
  }
  if (tid < MT * BN && m0 + om < M && nblock0 + oc < N)
    y[(int64_t)(m0 + om) * y_stride + y_col0 + nblock0 + oc] =
        out_scale ? __fmul_rn(total, *out_scale) : total;
}

// 4-byte column loads need N % 4 == 0 and a 4-byte aligned code stream.
inline int vec_ok(const uint8_t* packed, int N) {
  return (N % 4 == 0) && (reinterpret_cast<uintptr_t>(packed) % 4 == 0);
}

}  // namespace gemv
}  // namespace lut
