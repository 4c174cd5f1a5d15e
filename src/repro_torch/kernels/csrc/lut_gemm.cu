// Fused smooth(+quant)+LUT GEMM for prefill widths (M >= 128 rows).
//
// Replaces the Pallas TPU kernel `lut_matmul_fused` of the JAX package
// (src/repro/kernels/lut_matmul.py): the same contraction as the GEMV,
// Y = T(x) @ codebook[codes], at widths where the arithmetic, not the code
// stream, is the cost.
//
// What bounds it on an H100: the contraction's 2*M*K*N operations, against
// which every packed code has to be decoded (a shift, a mask and a table
// read) once per 128 rows of M. This first version keeps the arithmetic on
// the CUDA cores in f32 (a 128x64 output tile per 256-thread block, 8x4
// outputs per thread, operands staged through shared memory already
// transformed and already decoded) and is therefore far from the tensor-core
// rate; what it fixes is the arithmetic contract. It walks K in the canonical
// order of lut_common.cuh (way by way, two accumulators per output), so each
// output row carries the same bits the GEMV kernel gives for that row, and
// the Pallas body's accumulator carried across a sequential K grid becomes a
// loop inside the block. Ragged M, N and the K tail are masked here.
#include "lut_common.cuh"

namespace {

using namespace lut;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int TM = 8;               // rows per thread
constexpr int TN = 4;               // columns per thread
constexpr int THREADS = 256;        // 16 x 16 threads
constexpr int TB = 4;               // k-blocks of one way per shared-memory tile
constexpr int TK = TB * KB;         // 32 channels per tile

template <int NBITS, typename XT, bool QUANT>
__global__ void __launch_bounds__(THREADS)
lut_gemm_kernel(const XT* __restrict__ x, const float* __restrict__ inv,
                const uint8_t* __restrict__ packed, const float* __restrict__ cb,
                float* __restrict__ y, int M, int K, int N, int packed_rows) {
  __shared__ float cb_s[KC];
  __shared__ __align__(16) float xs[TK][BM];
  __shared__ __align__(16) float ws[TK][BN];

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
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
              v = transform<QUANT>(to_float(x[(int64_t)(m0 + row) * K + k]), inv[k]);
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

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty * TM + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = n0 + tx * TN + c;
      if (n < N) y[(int64_t)m * N + n] = total[r][c];
    }
  }
}

template <int NBITS, typename XT>
void launch_q(const XT* x, const float* inv, const uint8_t* packed, const float* cb, float* y, int M,
              int K, int N, int packed_rows, int quantize, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (quantize)
    lut_gemm_kernel<NBITS, XT, true><<<grid, THREADS, 0, stream>>>(x, inv, packed, cb, y, M, K, N,
                                                                   packed_rows);
  else
    lut_gemm_kernel<NBITS, XT, false><<<grid, THREADS, 0, stream>>>(x, inv, packed, cb, y, M, K, N,
                                                                    packed_rows);
}

template <typename XT>
int launch_bits(const XT* x, const float* inv, const uint8_t* packed, const float* cb, float* y,
                int M, int K, int N, int packed_rows, int nbits, int quantize, cudaStream_t stream) {
  switch (nbits) {
    case 2: launch_q<2, XT>(x, inv, packed, cb, y, M, K, N, packed_rows, quantize, stream); break;
    case 3: launch_q<3, XT>(x, inv, packed, cb, y, M, K, N, packed_rows, quantize, stream); break;
    case 4: launch_q<4, XT>(x, inv, packed, cb, y, M, K, N, packed_rows, quantize, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Same operands as lut_gemv_launch; any M >= 1. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int lut_gemm_launch(const void* x, int x_is_bf16, const float* inv,
                               const uint8_t* packed, const float* cb, float* y, int M, int K,
                               int N, int packed_rows, int nbits, int quantize, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_bits(reinterpret_cast<const __nv_bfloat16*>(x), inv, packed, cb, y, M, K, N,
                       packed_rows, nbits, quantize, s);
  return launch_bits(reinterpret_cast<const float*>(x), inv, packed, cb, y, M, K, N, packed_rows,
                     nbits, quantize, s);
}
