// Fused smooth(+quant)+LUT GEMV over P projections that share one input, for
// decode (M < 128 rows): QKV and gate+up of a decode step in one launch.
//
// Replaces the Pallas TPU kernel `lut_matmul_fused_multi_gemv` of the JAX
// package (src/repro/kernels/lut_matmul.py): Y = concat_p(T_p(x) @
// codebook_p[codes_p]), each projection with its own inv row, codebook,
// packing width (2/3/4-bit) and quantize flag; the caller applies each
// projection's trailing s_q rescale.
//
// What bounds it on an H100: the packed-code bytes of all P projections, read
// once; the shared activation row (at most 127 x K) stays in L2, so on this
// card fusing saves launches and their host-side wrapper work, not device
// bytes. Design: the grid walks the 32-column strips of projection 0, then of
// projection 1, and so on (lut_common.cuh MultiDesc), so a strip never
// straddles two projections; a block finds its projection from its strip
// index and runs `lut::gemv::strip`, the very body the solo kernel
// (lut_gemv.cu) runs, specialised to that projection's width and quantize
// flag. A projection's columns are therefore the same bits as its solo
// launch, whatever the other projections are, and without the tile-width
// agreement the TPU kernel needs. Ragged widths are masked per projection;
// the output holds the true widths back to back.
#include "lut_gemv.cuh"

namespace {

using namespace lut;
using namespace lut::gemv;

template <typename XT>
__global__ void __launch_bounds__(THREADS)
lut_multi_gemv_kernel(const XT* __restrict__ x, const float* __restrict__ inv_stack,
                      const float* __restrict__ cb_stack, const MultiDesc d,
                      float* __restrict__ y, int M, int K) {
  __shared__ Smem sm;
  const Proj pr = proj_of(d, blockIdx.x);
  const int nblock = blockIdx.x - pr.tile0;
  const float* inv = inv_stack + (int64_t)pr.index * K;
  const float* cb = cb_stack + pr.index * KC;
  const int rows = K * pr.nbits / 8;
  const int64_t ys = d.n_total;
#define LUT_STRIP(NB, Q)                                                                     \
  strip<NB, XT, Q>(x, inv, pr.packed, cb, y, M, K, pr.n, rows, pr.vec_ok, nblock, blockIdx.y, \
                   ys, pr.col0, sm)
  switch (pr.nbits * 2 + pr.quantize) {  // one projection per block: no divergence
    case 4: LUT_STRIP(2, false); break;
    case 5: LUT_STRIP(2, true); break;
    case 6: LUT_STRIP(3, false); break;
    case 7: LUT_STRIP(3, true); break;
    case 8: LUT_STRIP(4, false); break;
    case 9: LUT_STRIP(4, true); break;
  }
#undef LUT_STRIP
}

template <typename XT>
int launch(const XT* x, const float* inv_stack, const float* cb_stack, const MultiDesc& d,
           int tiles, float* y, int M, int K, cudaStream_t stream) {
  dim3 grid(tiles, (M + MT - 1) / MT);
  lut_multi_gemv_kernel<XT><<<grid, THREADS, 0, stream>>>(x, inv_stack, cb_stack, d, y, M, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) f32 or bf16, row-major; inv_stack: (P, K) f32; cb_stack: (P, 16)
// f32; packed[p]: (K*nbits[p]/8, widths[p]) u8; y: (M, sum widths) f32. The
// pointer and int arrays are host memory, P <= 8. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int lut_multi_gemv_launch(const void* x, int x_is_bf16, const float* inv_stack,
                                     const float* cb_stack, const void* const* packed,
                                     const int* widths, const int* nbits, const int* quantize,
                                     int n_proj, float* y, int M, int K, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  MultiDesc d{};
  const int tiles = make_desc(d, packed, widths, nbits, quantize, n_proj, K, BN);
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < n_proj; ++p) d.vec_ok[p] = gemv::vec_ok(d.packed[p], d.n[p]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(x), inv_stack, cb_stack, d, tiles, y, M,
                  K, s);
  return launch(reinterpret_cast<const float*>(x), inv_stack, cb_stack, d, tiles, y, M, K, s);
}
