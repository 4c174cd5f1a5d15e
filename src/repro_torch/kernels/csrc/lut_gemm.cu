// Fused smooth(+quant)+LUT GEMM for prefill widths (M >= 128 rows).
//
// Replaces the Pallas TPU kernel `lut_matmul_fused` of the JAX package
// (src/repro/kernels/lut_matmul.py): the same contraction as the GEMV,
// Y = T(x) @ codebook[codes], at widths where the arithmetic, not the code
// stream, is the cost.
//
// What bounds it on an H100: the contraction's 2*M*K*N operations, against
// which every packed code has to be decoded (a shift, a mask and a table
// read) once per 128 rows of M. The canonical order of lut_common.cuh (way
// by way, one fmaf chain per way, the ways summed in order) fixes each
// output's arithmetic, so that each output row carries the same bits the
// GEMV kernel gives for that row; a tensor core cannot reproduce a fmaf
// chain, so the bound this order allows is the f32 CUDA-core rate, 67
// TFLOP/s (0.128 ms at M = 256, K = N = 4096). The Pallas body's
// accumulator carried across a sequential K grid becomes a loop inside the
// block. A launch is the pre-pass `lut_xt_kernel`, which writes T(x) once
// into a scratch the wrapper allocates, then the tiles; the body of a block
// is `lut::gemm::tile` (lut_gemm.cuh: way-major K walk, a cp.async ring of
// stages, decode once per stage, 8 x 8 outputs per thread), which the
// multi-projection kernel (lut_multi_gemm.cu) and the §4 layer's kernels run
// too; this file holds the grid. Ragged M, N and the K tail are masked
// there.
#include "lut_gemm.cuh"

namespace {

using namespace lut;
using namespace lut::gemm;

template <int NBITS>
__global__ void __launch_bounds__(THREADS)
lut_gemm_kernel(const float* __restrict__ xt, const uint8_t* __restrict__ packed,
                const float* __restrict__ cb, float* __restrict__ y, int M, int K, int N,
                int packed_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  tile<NBITS>(xt, packed, cb, y, M, K, N, packed_rows, blockIdx.x, blockIdx.y, N, 0, sm);
}

template <int NBITS>
int launch_k(const float* xt, const uint8_t* packed, const float* cb, float* y, int M, int K,
             int N, int packed_rows, cudaStream_t stream) {
  auto kernel = lut_gemm_kernel<NBITS>;
  if (int e = allow_smem(kernel)) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, sizeof(Smem), stream>>>(xt, packed, cb, y, M, K, N, packed_rows);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch(const XT* x, const float* inv, const uint8_t* packed, const float* cb, float* y, int M,
           int K, int N, int packed_rows, int nbits, int quantize, float* xt,
           cudaStream_t stream) {
  if (nbits < 2 || nbits > 4) return (int)cudaErrorInvalidValue;
  if (int e = launch_xt<XT, true>(x, inv, quantize ? 1 : 0, xt, M, K, 1, stream)) return e;
  switch (nbits) {
    case 2: return launch_k<2>(xt, packed, cb, y, M, K, N, packed_rows, stream);
    case 3: return launch_k<3>(xt, packed, cb, y, M, K, N, packed_rows, stream);
    default: return launch_k<4>(xt, packed, cb, y, M, K, N, packed_rows, stream);
  }
}

}  // namespace

// Floats of the scratch one operand set of an (M, K) GEMM launch needs
// (B2, B4 per projection, B6 / B7 from 128 rows on): the stage-tiled T(x).
extern "C" long long lut_gemm_scratch_floats(int M, int K) {
  return M > 0 && K > 0 ? (long long)xt_floats(M, K) : 0;
}

// Same operands as lut_gemv_launch, plus the scratch xt
// (lut_gemm_scratch_floats(M, K) floats); any M >= 1. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int lut_gemm_launch(const void* x, int x_is_bf16, const float* inv,
                               const uint8_t* packed, const float* cb, float* y, int M, int K,
                               int N, int packed_rows, int nbits, int quantize, float* xt,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(x), inv, packed, cb, y, M, K, N,
                  packed_rows, nbits, quantize, xt, s);
  return launch(reinterpret_cast<const float*>(x), inv, packed, cb, y, M, K, N, packed_rows,
                nbits, quantize, xt, s);
}
