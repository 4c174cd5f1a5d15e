// Fused smooth(+quant)+LUT GEMV over P projections that share one input, for
// decode (M < 128 rows): QKV and gate+up of a decode step in one launch.
//
// Replaces the Pallas TPU kernel `lut_matmul_fused_multi_gemv` of the JAX
// package (src/repro/kernels/lut_matmul.py): Y = concat_p(T_p(x) @
// codebook_p[codes_p]), each projection with its own inv row, codebook,
// packing width (2/3/4-bit) and quantize flag; the caller applies each
// projection's trailing s_q rescale.
//
// What bounds it on an H100: as for the solo kernel (lut_gemv.cu), at M = 8
// the 2*M*K*sum(n_p) operations on the CUDA cores in f32 (67 TFLOP/s), at M
// <= 4 the packed-code bytes of all P projections, read once at 3.35 TB/s;
// the shared activation rows stay in L2, so on this card fusing saves
// launches and their host-side work, not device bytes. Design: the units
// (32-column strip, row block) of projection 0 come first, then those of
// projection 1, and so on (lut_gemv.cuh Job), so a strip never straddles
// two projections, and a block runs `lut::gemv::run`, the very body the solo
// kernel runs (warp-specialised: producers stream codes and x by
// `cp.async`, consumers transform x and decode through a byte table).
// Where every projection has the same width and quantize flag (the served
// groups) the launch is one instance compiled for exactly those, on the solo
// kernel's persistent grid: a block's units may belong to several
// projections, and a block that moves to another projection rebuilds its
// decode table from that projection's codebook. A mixed group takes one
// block per unit and picks the body compiled for its unit's projection (MT =
// 8). Either way a projection's columns are the same bits as its solo
// launch: the canonical K order fixes every output's arithmetic whatever the
// grid, the rows a block holds or the neighbours.
// Ragged widths are masked per projection; the output holds the true widths
// back to back.
#include "lut_gemv.cuh"

namespace {

using namespace lut;
using namespace lut::gemv;

template <int NBITS, typename XT, bool QUANT, int MT>
__global__ void __launch_bounds__(THREADS, 1) lut_multi_gemv_kernel(const Job jb) {
  extern __shared__ __align__(16) unsigned char smem[];
  run<NBITS, XT, QUANT, MT>(jb, smem, blockIdx.x, gridDim.x);
}

// A group of mixed widths or transforms: block u runs unit u with the body
// of its projection's width and transform.
template <typename XT>
__global__ void __launch_bounds__(THREADS, 1) lut_multi_gemv_mixed_kernel(const Job jb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ProjRef r = proj_of_strip(jb, blockIdx.x / jb.mblocks);
  const int u = blockIdx.x, du = gridDim.x;
  switch (r.nbits * 2 + r.quantize) {  // one projection per block: no divergence
    case 4: run<2, XT, false, 8>(jb, smem, u, du); break;
    case 5: run<2, XT, true, 8>(jb, smem, u, du); break;
    case 6: run<3, XT, false, 8>(jb, smem, u, du); break;
    case 7: run<3, XT, true, 8>(jb, smem, u, du); break;
    case 8: run<4, XT, false, 8>(jb, smem, u, du); break;
    case 9: run<4, XT, true, 8>(jb, smem, u, du); break;
  }
}

template <auto Kernel>
int go(const Job& jb, const Plan& pl, cudaStream_t s) {
  if (int e = allow_smem(Kernel, pl.smem)) return e;
  Kernel<<<pl.grid, THREADS, pl.smem, s>>>(jb);
  return (int)cudaGetLastError();
}

template <typename XT, int MT>
int launch_mt(const Job& jb, const Plan& pl, cudaStream_t s) {
  switch (jb.nbits[0] * 2 + jb.quantize[0]) {
    case 4: return go<lut_multi_gemv_kernel<2, XT, false, MT>>(jb, pl, s);
    case 5: return go<lut_multi_gemv_kernel<2, XT, true, MT>>(jb, pl, s);
    case 6: return go<lut_multi_gemv_kernel<3, XT, false, MT>>(jb, pl, s);
    case 7: return go<lut_multi_gemv_kernel<3, XT, true, MT>>(jb, pl, s);
    case 8: return go<lut_multi_gemv_kernel<4, XT, false, MT>>(jb, pl, s);
    case 9: return go<lut_multi_gemv_kernel<4, XT, true, MT>>(jb, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename XT>
int launch(const Job& jb, const Plan& pl, cudaStream_t s) {
  if (!pl.uniform) return go<lut_multi_gemv_mixed_kernel<XT>>(jb, pl, s);
  return pl.mt == 4 ? launch_mt<XT, 4>(jb, pl, s) : launch_mt<XT, 8>(jb, pl, s);
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
  Job jb;
  Plan pl;
  if (int e = make_job(jb, pl, x, x_is_bf16 ? 2 : 4, inv_stack, cb_stack, nullptr, y, packed,
                       widths, nbits, quantize, n_proj, M, K))
    return e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(jb, pl, s) : launch<float>(jb, pl, s);
}
