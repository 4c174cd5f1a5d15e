// Fused smooth(+quant)+LUT GEMV for decode (M < 128 rows).
//
// Replaces the Pallas TPU kernel `lut_matmul_fused_gemv` of the JAX package
// (src/repro/kernels/lut_matmul.py): Y = T(x) @ codebook[codes] with the
// Eq. 11 transform T applied on the fly and the weights streamed as packed
// 2/3/4-bit centroid codes.
//
// What bounds it on an H100: the packed-code bytes, K*N*nbits/8, which are
// read once from device memory; x, inv and the codebook are tiny beside them.
// The Pallas body carried an f32 accumulator across a sequential K grid; here
// K is split 64 ways INSIDE a thread block (lut_common.cuh, the canonical
// order), so that a 32-column strip of the output keeps 512 threads streaming
// codes, and the ways are folded in a fixed order through shared memory: no
// atomics, a row's result depends on that row alone and is the same bits the
// GEMM kernel gives. Threads run along N (4 columns each, one 4-byte load per
// packed row), the codebook lookup is a 16-entry shared-memory table read,
// and ragged M, N and the K tail are masked here. The body of a block is
// `lut::gemv::strip` (lut_gemv.cuh), which the multi-projection kernel
// (lut_multi_gemv.cu) runs too.
#include "lut_gemv.cuh"

namespace {

using namespace lut;
using namespace lut::gemv;

template <int NBITS, typename XT, bool QUANT>
__global__ void __launch_bounds__(THREADS)
lut_gemv_kernel(const XT* __restrict__ x, const float* __restrict__ inv,
                const uint8_t* __restrict__ packed, const float* __restrict__ cb,
                float* __restrict__ y, int M, int K, int N, int packed_rows, int vec_ok) {
  __shared__ Smem sm;
  strip<NBITS, XT, QUANT>(x, inv, packed, cb, y, M, K, N, packed_rows, vec_ok, blockIdx.x,
                          blockIdx.y, N, 0, sm);
}

template <int NBITS, typename XT>
void launch_q(const XT* x, const float* inv, const uint8_t* packed, const float* cb, float* y, int M,
              int K, int N, int packed_rows, int quantize, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  const int vec = gemv::vec_ok(packed, N);
  if (quantize)
    lut_gemv_kernel<NBITS, XT, true><<<grid, THREADS, 0, stream>>>(x, inv, packed, cb, y, M, K, N,
                                                                   packed_rows, vec);
  else
    lut_gemv_kernel<NBITS, XT, false><<<grid, THREADS, 0, stream>>>(x, inv, packed, cb, y, M, K, N,
                                                                    packed_rows, vec);
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

// x: (M, K) f32 or bf16, row-major; inv: (K,) f32; packed: (K*nbits/8, N) u8;
// cb: (16,) f32; y: (M, N) f32. Returns the launch's cudaError_t (0 = ok).
extern "C" int lut_gemv_launch(const void* x, int x_is_bf16, const float* inv,
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
