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
// loop inside the block. Ragged M, N and the K tail are masked here. The
// body of a block is `lut::gemm::tile` (lut_gemm.cuh), which the
// multi-projection kernel (lut_multi_gemm.cu) runs too.
#include "lut_gemm.cuh"

namespace {

using namespace lut;
using namespace lut::gemm;

template <int NBITS, typename XT, bool QUANT>
__global__ void __launch_bounds__(THREADS)
lut_gemm_kernel(const XT* __restrict__ x, const float* __restrict__ inv,
                const uint8_t* __restrict__ packed, const float* __restrict__ cb,
                float* __restrict__ y, int M, int K, int N, int packed_rows) {
  __shared__ Smem sm;
  tile<NBITS, XT, QUANT>(x, inv, packed, cb, y, M, K, N, packed_rows, blockIdx.x, blockIdx.y, N,
                         0, sm);
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
