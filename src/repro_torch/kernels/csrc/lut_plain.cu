// LUT GEMM over activations that need no transform: the paper's §4 layer.
//
//   lut_float_kernel  Y = x @ codebook[codes], x already smoothed (f32/bf16)
//   lut_codes_kernel  Y = s_q * (q @ codebook[codes]), q the int8 Eq. 11 codes
//
// Replaces the Pallas TPU kernels `lut_matmul_f32` and `lut_matmul_int8` of
// the JAX package (src/repro/kernels/lut_matmul.py), which ran one body,
// `_lut_matmul_kernel`, with and without an int8 activation cast.
//
// What bounds it on an H100 (either kernel): at decode widths (M < 128) the
// packed codes, K*N*nbits/8 bytes read once; at prefill widths the 2*M*K*N
// operations, here on the CUDA cores in f32. Design: both kernels run the
// block bodies the fused serving kernels run — `lut::gemv::strip` below 128 rows,
// `lut::gemm::tile` from 128 rows on — in transform mode NONE, so the
// activation enters the canonical K order of lut_common.cuh as it is: for
// the int8 kernel one byte per activation straight from device memory
// (no float copy made beforehand), converted in registers. Each output row
// therefore carries the bits the fused kernel (B1/B2) gives it on raw x
// whose Eq. 11 codes equal q: the "three passes become one" claim of the
// fused kernel, held bit for bit. The s_q rescale is one rounded multiply in
// the epilogue, read from device memory (no host round trip for s_q).
// Ragged M, N and the K tail are masked by the bodies.
#include <type_traits>

#include "lut_gemm.cuh"
#include "lut_gemv.cuh"

namespace {

using namespace lut;

template <int NBITS, typename XT, bool GEMV>
__global__ void __launch_bounds__(GEMV ? gemv::THREADS : gemm::THREADS)
lut_float_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ cb, float* __restrict__ y, int M, int K, int N,
                 int packed_rows, int vec_ok) {
  if constexpr (GEMV) {
    __shared__ gemv::Smem sm;
    gemv::strip<NBITS, XT, NONE>(x, nullptr, packed, cb, y, M, K, N, packed_rows, vec_ok,
                                 blockIdx.x, blockIdx.y, N, 0, sm);
  } else {
    __shared__ gemm::Smem sm;
    gemm::tile<NBITS, XT, NONE>(x, nullptr, packed, cb, y, M, K, N, packed_rows, blockIdx.x,
                                blockIdx.y, N, 0, sm);
  }
}

template <int NBITS, bool GEMV>
__global__ void __launch_bounds__(GEMV ? gemv::THREADS : gemm::THREADS)
lut_codes_kernel(const int8_t* __restrict__ q, const uint8_t* __restrict__ packed,
                 const float* __restrict__ cb, const float* __restrict__ s_q,
                 float* __restrict__ y, int M, int K, int N, int packed_rows, int vec_ok) {
  if constexpr (GEMV) {
    __shared__ gemv::Smem sm;
    gemv::strip<NBITS, int8_t, NONE>(q, nullptr, packed, cb, y, M, K, N, packed_rows, vec_ok,
                                     blockIdx.x, blockIdx.y, N, 0, sm, s_q);
  } else {
    __shared__ gemm::Smem sm;
    gemm::tile<NBITS, int8_t, NONE>(q, nullptr, packed, cb, y, M, K, N, packed_rows, blockIdx.x,
                                    blockIdx.y, N, 0, sm, s_q);
  }
}

// One launch of either kernel at a static width: the GEMV strip grid below
// 128 rows, the GEMM tile grid from 128 rows on.
template <int NBITS, typename XT>
void launch_w(const XT* x, const uint8_t* packed, const float* cb, const float* s_q, float* y,
              int M, int K, int N, int packed_rows, cudaStream_t stream) {
  const int vec = gemv::vec_ok(packed, N);
  if (M < 128) {
    dim3 grid((N + gemv::BN - 1) / gemv::BN, (M + gemv::MT - 1) / gemv::MT);
    if constexpr (std::is_same<XT, int8_t>::value)
      lut_codes_kernel<NBITS, true>
          <<<grid, gemv::THREADS, 0, stream>>>(x, packed, cb, s_q, y, M, K, N, packed_rows, vec);
    else
      lut_float_kernel<NBITS, XT, true>
          <<<grid, gemv::THREADS, 0, stream>>>(x, packed, cb, y, M, K, N, packed_rows, vec);
  } else {
    dim3 grid((N + gemm::BN - 1) / gemm::BN, (M + gemm::BM - 1) / gemm::BM);
    if constexpr (std::is_same<XT, int8_t>::value)
      lut_codes_kernel<NBITS, false>
          <<<grid, gemm::THREADS, 0, stream>>>(x, packed, cb, s_q, y, M, K, N, packed_rows, vec);
    else
      lut_float_kernel<NBITS, XT, false>
          <<<grid, gemm::THREADS, 0, stream>>>(x, packed, cb, y, M, K, N, packed_rows, vec);
  }
}

template <typename XT>
int launch(const XT* x, const uint8_t* packed, const float* cb, const float* s_q, float* y, int M,
           int K, int N, int packed_rows, int nbits, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  switch (nbits) {
    case 2: launch_w<2, XT>(x, packed, cb, s_q, y, M, K, N, packed_rows, stream); break;
    case 3: launch_w<3, XT>(x, packed, cb, s_q, y, M, K, N, packed_rows, stream); break;
    case 4: launch_w<4, XT>(x, packed, cb, s_q, y, M, K, N, packed_rows, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) f32 or bf16, row-major, already smoothed; packed: (K*nbits/8, N)
// u8; cb: (16,) f32; y: (M, N) f32. Returns the launch's cudaError_t.
extern "C" int lut_f32_launch(const void* x, int x_is_bf16, const uint8_t* packed,
                              const float* cb, float* y, int M, int K, int N, int packed_rows,
                              int nbits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(x), packed, cb, nullptr, y, M, K, N,
                  packed_rows, nbits, s);
  return launch(reinterpret_cast<const float*>(x), packed, cb, nullptr, y, M, K, N, packed_rows,
                nbits, s);
}

// q: (M, K) int8 Eq. 11 codes; s_q: one f32 in device memory; the rest as
// lut_f32_launch. Returns the launch's cudaError_t.
extern "C" int lut_int8_launch(const int8_t* q, const uint8_t* packed, const float* cb,
                               const float* s_q, float* y, int M, int K, int N, int packed_rows,
                               int nbits, void* stream) {
  if (s_q == nullptr) return (int)cudaErrorInvalidValue;
  return launch(q, packed, cb, s_q, y, M, K, N, packed_rows, nbits,
                reinterpret_cast<cudaStream_t>(stream));
}
