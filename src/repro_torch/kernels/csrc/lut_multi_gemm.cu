// Fused smooth(+quant)+LUT GEMM over P projections that share one input, for
// prefill widths (M >= 128 rows): QKV and gate+up of a prefill step in one
// launch.
//
// Replaces the Pallas TPU kernel `lut_matmul_fused_multi` of the JAX package
// (src/repro/kernels/lut_matmul.py): Y = concat_p(T_p(x) @
// codebook_p[codes_p]), each projection with its own inv row, codebook,
// packing width (2/3/4-bit) and quantize flag; the caller applies each
// projection's trailing s_q rescale.
//
// What bounds it on an H100: the 2*M*K*sum(n_p) operations, as for the solo
// GEMM (lut_gemm.cu), whose tile body it shares; under the canonical K order
// the f32 CUDA-core rate (67 TFLOP/s) is the bound that order allows.
// Design: the grid walks the 64-column tiles of projection 0, then of
// projection 1, and so on (lut_common.cuh MultiDesc), so a tile never
// straddles two projections; a block finds its projection from its tile
// index and runs `lut::gemm::tile`, the very body the solo kernel runs,
// specialised to that projection's width, on that projection's T(x), which
// the pre-pass wrote with its inv row and quantize flag. A projection's
// columns are therefore the same bits as its solo launch (and, row by row,
// as the GEMV kernels give). Ragged widths are masked per projection; the
// output holds the true widths back to back.
#include "lut_gemm.cuh"

namespace {

using namespace lut;
using namespace lut::gemm;

__global__ void __launch_bounds__(THREADS)
lut_multi_gemm_kernel(const float* __restrict__ xt, const float* __restrict__ cb_stack,
                      const MultiDesc d, float* __restrict__ y, int M, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const Proj pr = proj_of(d, blockIdx.x);
  const int nblock = blockIdx.x - pr.tile0;
  const float* xtp = xt + pr.index * xt_floats(M, K);
  const float* cb = cb_stack + pr.index * KC;
  const int rows = K * pr.nbits / 8;
  const int64_t ys = d.n_total;
#define LUT_TILE(NB) \
  tile<NB>(xtp, pr.packed, cb, y, M, K, pr.n, rows, nblock, blockIdx.y, ys, pr.col0, sm)
  switch (pr.nbits) {  // one projection per block: no divergence
    case 2: LUT_TILE(2); break;
    case 3: LUT_TILE(3); break;
    case 4: LUT_TILE(4); break;
  }
#undef LUT_TILE
}

template <typename XT>
int launch(const XT* x, const float* inv_stack, const float* cb_stack, const MultiDesc& d,
           int tiles, float* y, int M, int K, float* xt, cudaStream_t stream) {
  int qmask = 0;
  for (int p = 0; p < d.n_proj; ++p) qmask |= d.quantize[p] << p;
  if (int e = launch_xt<XT, true>(x, inv_stack, qmask, xt, M, K, d.n_proj, stream)) return e;
  if (int e = allow_smem(lut_multi_gemm_kernel)) return e;
  dim3 grid(tiles, (M + BM - 1) / BM);
  lut_multi_gemm_kernel<<<grid, THREADS, sizeof(Smem), stream>>>(xt, cb_stack, d, y, M, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Same operands as lut_multi_gemv_launch, plus the scratch xt
// (n_proj * lut_gemm_scratch_floats(M, K) floats); any M >= 1. Returns the
// launch's cudaError_t (0 = ok).
extern "C" int lut_multi_gemm_launch(const void* x, int x_is_bf16, const float* inv_stack,
                                     const float* cb_stack, const void* const* packed,
                                     const int* widths, const int* nbits, const int* quantize,
                                     int n_proj, float* y, int M, int K, float* xt,
                                     void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  MultiDesc d{};
  const int tiles = make_desc(d, packed, widths, nbits, quantize, n_proj, K, BN);
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(x), inv_stack, cb_stack, d, tiles, y, M,
                  K, xt, s);
  return launch(reinterpret_cast<const float*>(x), inv_stack, cb_stack, d, tiles, y, M, K, xt, s);
}
