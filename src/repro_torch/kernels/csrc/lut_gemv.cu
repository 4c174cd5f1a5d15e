// Fused smooth(+quant)+LUT GEMV for decode (M < 128 rows).
//
// Replaces the Pallas TPU kernel `lut_matmul_fused_gemv` of the JAX package
// (src/repro/kernels/lut_matmul.py): Y = T(x) @ codebook[codes] with the
// Eq. 11 transform T applied on the fly and the weights streamed as packed
// 2/3/4-bit centroid codes.
//
// What bounds it on an H100: at the engine's decode width M = 8 the 2*M*K*N
// operations on the CUDA cores (67 TFLOP/s in f32: the canonical K order of
// lut_common.cuh admits no tensor core), which at 4 bits exceed the
// packed-code bytes, K*N*nbits/8 read once at 3.35 TB/s, from M = 5 on; at
// M <= 4 those bytes. The Pallas body carried an f32 accumulator across a
// sequential K grid; here K is split 64 ways inside a thread block and the
// ways are folded in a fixed order, so a row's result depends on that row
// alone and is the bits the GEMM kernel gives. The block body and its plan
// are `lut::gemv` (lut_gemv.cuh): a persistent grid over (32-column strip,
// 4- or 8-row block) units; 4 producer warps stream codes, raw x and inv
// through a 4-entry `cp.async` ring under mbarriers; 8 consumer warps turn x
// into T(x) once per stage and decode two codes per shared load from a
// byte-indexed table into MT x 8 accumulators each. The multi-projection
// kernel (lut_multi_gemv.cu) and the §4 layer's kernels (lut_plain.cu) run
// the same body. One launch per call.
#include "lut_gemv.cuh"

namespace {

using namespace lut;
using namespace lut::gemv;

template <int NBITS, typename XT, bool QUANT, int MT>
__global__ void __launch_bounds__(THREADS, 1) lut_gemv_kernel(const Job jb) {
  extern __shared__ __align__(16) unsigned char smem[];
  run<NBITS, XT, QUANT, MT>(jb, smem, blockIdx.x, gridDim.x);
}

template <int NBITS, typename XT, bool QUANT, int MT>
int launch_k(const Job& jb, const Plan& pl, cudaStream_t s) {
  auto kernel = lut_gemv_kernel<NBITS, XT, QUANT, MT>;
  if (int e = allow_smem(kernel, pl.smem)) return e;
  kernel<<<pl.grid, THREADS, pl.smem, s>>>(jb);
  return (int)cudaGetLastError();
}

template <typename XT, int MT>
int launch_mt(const Job& jb, const Plan& pl, cudaStream_t s) {
  switch (jb.nbits[0] * 2 + jb.quantize[0]) {
    case 4: return launch_k<2, XT, false, MT>(jb, pl, s);
    case 5: return launch_k<2, XT, true, MT>(jb, pl, s);
    case 6: return launch_k<3, XT, false, MT>(jb, pl, s);
    case 7: return launch_k<3, XT, true, MT>(jb, pl, s);
    case 8: return launch_k<4, XT, false, MT>(jb, pl, s);
    case 9: return launch_k<4, XT, true, MT>(jb, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename XT>
int launch(const Job& jb, const Plan& pl, cudaStream_t s) {
  return pl.mt == 4 ? launch_mt<XT, 4>(jb, pl, s) : launch_mt<XT, 8>(jb, pl, s);
}

}  // namespace

// x: (M, K) f32 or bf16, row-major; inv: (K,) f32; packed: (K*nbits/8, N) u8;
// cb: (16,) f32; y: (M, N) f32. Returns the launch's cudaError_t (0 = ok).
extern "C" int lut_gemv_launch(const void* x, int x_is_bf16, const float* inv,
                               const uint8_t* packed, const float* cb, float* y, int M, int K,
                               int N, int packed_rows, int nbits, int quantize, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || packed_rows * 8 != K * nbits) return (int)cudaErrorInvalidValue;
  const void* pk[1] = {packed};
  Job jb;
  Plan pl;
  if (int e = make_job(jb, pl, x, x_is_bf16 ? 2 : 4, inv, cb, nullptr, y, pk, &N, &nbits,
                       &quantize, 1, M, K))
    return e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(jb, pl, s) : launch<float>(jb, pl, s);
}

// The plan every GEMV launcher runs (lut_gemv.cuh make_plan) for an (M, K)
// launch over P projections, activations of x_bytes bytes, on a card of
// `sms` SMs: out[0..6] = rows a block, strips, row blocks, units, stages a
// unit, grid, uniform. Returns the shared-memory bytes of a block, or -1
// where the launchers refuse.
extern "C" int lut_gemv_plan(int M, int K, int P, const int* widths, const int* nbits,
                             const int* quantize, int x_bytes, int sms, int* out) {
  Plan pl;
  if (make_plan(pl, M, K, P, widths, nbits, quantize, x_bytes, sms)) return -1;
  const int v[7] = {pl.mt, pl.strips, pl.mblocks, pl.units, pl.stages, pl.grid, pl.uniform};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return pl.smem;
}
