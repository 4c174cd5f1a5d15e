// Dequantizing attention over a gathered int8 KV view (B8).
//
// Replaces the Pallas TPU kernel `paged_dequant_attention` of the JAX package
// (src/repro/kernels/paged_attention.py:151, pallas_call at :208): for every
// (slot, kv-head) the slot's g*T query rows attend over the slot's
// already-gathered logical view kq / vq (S, L, KV, D) int8, dequantized on
// chip as codes * scale[token, head] * smooth[head, :]; row r is (group r /
// T, token r % T) at position length + r % T; same mask rule as
// paged_pool_attention; a row with nothing visible gives 0.
//
// What bounds it on an H100: bytes — per active slot the int8 codes of the
// visible keys (length + n_new, narrowed by the window) for K and V with
// their scales, and q / out. The Pallas kernel padded L to the tuned lane
// multiple `l_pad` and materialized the whole (g*T, L) score tile in VMEM.
// Here the block body is paged_attention.cu's (paged_attention.cuh): each
// key's codes are read once per block through a two-stage cp.async ring of
// `l_pad` keys (a multiple of the 32-key chunk), dequantized as each key is
// read; a lane owns a key for the scores and D / 32 columns for P.V. The
// rows follow the canonical per-row key order, so this kernel on a view
// gathered from a pool gives the same bits as paged_pool_attention on that
// pool, and every l_pad gives the same bits: the tuner's choice cannot
// change a result. The window arrives as an int or as a pointer to an int32
// on the card (read there, never by the host).
#include "paged_attention.cuh"

namespace {

using pattn::MAX_DV;
using pattn::THREADS;

template <int RG, int ND>
__global__ void __launch_bounds__(THREADS, pattn::min_blocks(ND))
paged_dequant_kernel(const void* __restrict__ q, int q_bf16, const int8_t* __restrict__ kq,
                     const float* __restrict__ k_scale, const int8_t* __restrict__ vq,
                     const float* __restrict__ v_scale, const float* __restrict__ k_smooth,
                     const float* __restrict__ v_smooth, const int* __restrict__ lengths,
                     const int* __restrict__ n_new, const int* __restrict__ window_ptr,
                     int window_arg, void* __restrict__ out, int T, int H, int KV, int D, int L,
                     float softcap, float scale, pattn::Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int window = window_ptr ? *window_ptr : window_arg;
  const int length = lengths[s];
  const int total = length + n_new[s];
  pattn::ViewSrc<int8_t> src{kq, vq, k_scale, v_scale, (int64_t)s * L, KV, h};
  pattn::attend_block<int8_t, true, RG, ND>(src, q, out, q_bf16 != 0, k_smooth, v_smooth, s, h,
                                            blockIdx.z, T, H, KV, D, length, total, L, window,
                                            softcap, scale, pl, smem);
}

struct Args {
  const void* q;
  int q_bf16;
  const int8_t* kq;
  const float* k_scale;
  const int8_t* vq;
  const float *v_scale, *k_smooth, *v_smooth;
  const int *lengths, *n_new, *window_ptr;
  int window;
  void* out;
  int S, T, H, KV, D, L;
  float softcap;
};

template <int RG, int ND>
int launch_one(const Args& a, const pattn::Plan& pl, cudaStream_t stream) {
  auto kernel = paged_dequant_kernel<RG, ND>;
  if (pl.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = (a.H / a.KV) * a.T;
  dim3 grid(a.S, a.KV, (rows + pl.rows - 1) / pl.rows);
  kernel<<<grid, THREADS, pl.smem, stream>>>(
      a.q, a.q_bf16, a.kq, a.k_scale, a.vq, a.v_scale, a.k_smooth, a.v_smooth, a.lengths,
      a.n_new, a.window_ptr, a.window, a.out, a.T, a.H, a.KV, a.D, a.L, a.softcap,
      1.0f / sqrtf((float)a.D), pl);
  return (int)cudaGetLastError();
}

// D = 128 at compile time, any other D at run time (as paged_attention.cu)
template <int RG>
int launch_rg(const Args& a, const pattn::Plan& pl, cudaStream_t stream) {
  return a.D == 128 ? launch_one<RG, 4>(a, pl, stream) : launch_one<RG, 0>(a, pl, stream);
}

}  // namespace

// q/out: (S, T, H, D) f32 or bf16; kq, vq: (S, L, KV, D) int8; k_scale,
// v_scale: (S, L, KV) f32; k_smooth, v_smooth: (KV, D) f32; lengths, n_new:
// (S,) i32; window_ptr: one i32 on the card, or null to use `window`; rows:
// query rows per block and l_pad: keys per stage (kernels/paged_attention.py
// pool_plan). Returns the launch's cudaError_t (0 = ok).
extern "C" int paged_dequant_launch(const void* q, int q_is_bf16, const void* kq,
                                    const void* k_scale, const void* vq, const void* v_scale,
                                    const void* k_smooth, const void* v_smooth,
                                    const int* lengths, const int* n_new, const int* window_ptr,
                                    int window, void* out, int S, int T, int H, int KV, int D,
                                    int L, int rows, int l_pad, float softcap, void* stream) {
  if (S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D % 32 != 0 || D <= 0 || D > 32 * MAX_DV ||
      L <= 0 || !pattn::plan_ok(rows, l_pad))
    return (int)cudaErrorInvalidValue;
  const pattn::Plan pl = pattn::make_plan(rows, l_pad, D, 1, true);
  if (pl.smem > pattn::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const Args a{q,
               q_is_bf16,
               reinterpret_cast<const int8_t*>(kq),
               reinterpret_cast<const float*>(k_scale),
               reinterpret_cast<const int8_t*>(vq),
               reinterpret_cast<const float*>(v_scale),
               reinterpret_cast<const float*>(k_smooth),
               reinterpret_cast<const float*>(v_smooth),
               lengths,
               n_new,
               window_ptr,
               window,
               out,
               S, T, H, KV, D, L,
               softcap};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (pl.rg == 1) return launch_rg<1>(a, pl, st);
  if (pl.rg == 2) return launch_rg<2>(a, pl, st);
  return launch_rg<pattn::MAX_RG>(a, pl, st);
}
