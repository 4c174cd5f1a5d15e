// LUT GEMM over activations that need no transform: the paper's §4 layer.
//
//   lut_float_kernel       Y = x @ codebook[codes], x already smoothed
//                          (f32/bf16), below 128 rows
//   lut_codes_kernel       Y = s_q * (q @ codebook[codes]), q the int8 Eq. 11
//                          codes, below 128 rows
//   lut_plain_tile_kernel  either, from 128 rows on
//
// Replaces the Pallas TPU kernels `lut_matmul_f32` and `lut_matmul_int8` of
// the JAX package (src/repro/kernels/lut_matmul.py), which ran one body,
// `_lut_matmul_kernel`, with and without an int8 activation cast.
//
// What bounds it on an H100 (either kernel): the 2*M*K*N operations on the
// CUDA cores in f32 (the canonical K order's bound) from M = 5 on, at M <= 4
// the packed codes, K*N*nbits/8 bytes read once. Design: the kernels run
// the block bodies the fused serving kernels run — `lut::gemv::run` (and
// its plan) below 128 rows, `lut::gemm::tile` after
// its pre-pass from 128 rows on — in transform mode NONE, so the activation
// enters the canonical K order of lut_common.cuh as it is: below 128 rows
// each stage's activations are converted to f32 once per block into the
// shared T(x) tile, from 128 rows on the pre-pass converts each
// activation to f32 once. Each output row therefore carries the bits the
// fused kernel (B1/B2) gives it on raw x whose Eq. 11 codes equal q: the
// "three passes become one" claim of the fused kernel, held bit for bit.
// The s_q rescale is one rounded multiply in the epilogue, read from device
// memory (no host round trip for s_q). Ragged M, N and the K tail are
// masked by the bodies.
#include <type_traits>

#include "lut_gemm.cuh"
#include "lut_gemv.cuh"

namespace {

using namespace lut;

// Below 128 rows: the GEMV body in transform mode NONE, on its plan's grid.
template <int NBITS, typename XT, int MT>
__global__ void __launch_bounds__(gemv::THREADS, 1) lut_float_kernel(const gemv::Job jb) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemv::run<NBITS, XT, NONE, MT>(jb, smem, blockIdx.x, gridDim.x);
}

template <int NBITS, int MT>
__global__ void __launch_bounds__(gemv::THREADS, 1) lut_codes_kernel(const gemv::Job jb) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemv::run<NBITS, int8_t, NONE, MT>(jb, smem, blockIdx.x, gridDim.x);
}

template <int NBITS, typename XT, int MT>
int launch_gemv(const gemv::Job& jb, const gemv::Plan& pl, cudaStream_t stream) {
  void (*kernel)(const gemv::Job);
  if constexpr (std::is_same<XT, int8_t>::value) kernel = lut_codes_kernel<NBITS, MT>;
  else kernel = lut_float_kernel<NBITS, XT, MT>;
  if (int e = gemv::allow_smem(kernel, pl.smem)) return e;
  kernel<<<pl.grid, gemv::THREADS, pl.smem, stream>>>(jb);
  return 0;
}

// From 128 rows on, either kernel: the GEMM tile over the pre-pass's
// stage-tiled activations (mode NONE: converted to f32 as they are), times
// s_q when that is given.
template <int NBITS>
__global__ void __launch_bounds__(gemm::THREADS)
lut_plain_tile_kernel(const float* __restrict__ xt, const uint8_t* __restrict__ packed,
                      const float* __restrict__ cb, const float* __restrict__ s_q,
                      float* __restrict__ y, int M, int K, int N, int packed_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<gemm::Smem*>(smem_raw);
  gemm::tile<NBITS>(xt, packed, cb, y, M, K, N, packed_rows, blockIdx.x, blockIdx.y, N, 0, sm,
                    s_q);
}

// One launch at a static width: the GEMV strip grid below 128 rows; from
// 128 rows on the pre-pass into the scratch xt, then the GEMM tile grid.
template <int NBITS, typename XT>
int launch_w(const XT* x, const uint8_t* packed, const float* cb, const float* s_q, float* y,
             int M, int K, int N, int packed_rows, float* xt, cudaStream_t stream) {
  if (M < 128) {
    const void* pk[1] = {packed};
    const int nb = NBITS, q = 0;
    gemv::Job jb;
    gemv::Plan pl;
    if (int e = gemv::make_job(jb, pl, x, (int)sizeof(XT), nullptr, cb, s_q, y, pk, &N, &nb, &q,
                               1, M, K))
      return e;
    return pl.mt == 4 ? launch_gemv<NBITS, XT, 4>(jb, pl, stream)
                      : launch_gemv<NBITS, XT, 8>(jb, pl, stream);
  }
  if (int e = gemm::launch_xt<XT, false>(x, nullptr, 0, xt, M, K, 1, stream)) return e;
  auto kernel = lut_plain_tile_kernel<NBITS>;
  if (int e = gemm::allow_smem(kernel)) return e;
  dim3 grid((N + gemm::BN - 1) / gemm::BN, (M + gemm::BM - 1) / gemm::BM);
  kernel<<<grid, gemm::THREADS, sizeof(gemm::Smem), stream>>>(xt, packed, cb, s_q, y, M, K, N,
                                                              packed_rows);
  return 0;
}

template <typename XT>
int launch(const XT* x, const uint8_t* packed, const float* cb, const float* s_q, float* y, int M,
           int K, int N, int packed_rows, int nbits, float* xt, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || packed_rows * 8 != K * nbits) return (int)cudaErrorInvalidValue;
  int e;
  switch (nbits) {
    case 2: e = launch_w<2, XT>(x, packed, cb, s_q, y, M, K, N, packed_rows, xt, stream); break;
    case 3: e = launch_w<3, XT>(x, packed, cb, s_q, y, M, K, N, packed_rows, xt, stream); break;
    case 4: e = launch_w<4, XT>(x, packed, cb, s_q, y, M, K, N, packed_rows, xt, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return e ? e : (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) f32 or bf16, row-major, already smoothed; packed: (K*nbits/8, N)
// u8; cb: (16,) f32; y: (M, N) f32; xt: the GEMM's scratch
// (lut_gemm_scratch_floats(M, K) floats; unread below 128 rows). Returns the
// launch's cudaError_t.
extern "C" int lut_f32_launch(const void* x, int x_is_bf16, const uint8_t* packed,
                              const float* cb, float* y, int M, int K, int N, int packed_rows,
                              int nbits, float* xt, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(x), packed, cb, nullptr, y, M, K, N,
                  packed_rows, nbits, xt, s);
  return launch(reinterpret_cast<const float*>(x), packed, cb, nullptr, y, M, K, N, packed_rows,
                nbits, xt, s);
}

// q: (M, K) int8 Eq. 11 codes; s_q: one f32 in device memory; the rest as
// lut_f32_launch. Returns the launch's cudaError_t.
extern "C" int lut_int8_launch(const int8_t* q, const uint8_t* packed, const float* cb,
                               const float* s_q, float* y, int M, int K, int N, int packed_rows,
                               int nbits, float* xt, void* stream) {
  if (s_q == nullptr) return (int)cudaErrorInvalidValue;
  return launch(q, packed, cb, s_q, y, M, K, N, packed_rows, nbits, xt,
                reinterpret_cast<cudaStream_t>(stream));
}
