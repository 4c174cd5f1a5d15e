// Dequantizing attention over a gathered int8 KV view.
//
// Replaces the Pallas TPU kernel `paged_dequant_attention` of the JAX package
// (src/repro/kernels/paged_attention.py): for every (slot, kv-head) the
// slot's g*T query rows attend over the slot's already-gathered logical view
// kq / vq (S, L, KV, D) int8, dequantized on chip as codes * scale[token,
// head] * smooth[head, :]; row r is (group r / T, token r % T) at position
// length + r % T; same mask rule as paged_pool_attention; a row with nothing
// visible gives 0.
//
// What bounds it on an H100: the bytes of the visible keys, per active slot
// (length + n_new, narrowed by the window) * KV * D int8 codes for K and V
// plus their scales, and q / out. The Pallas kernel padded L to the tuned
// lane multiple `l_pad` and materialized the whole (g*T, L) score tile in
// VMEM; here `l_pad` is the number of keys a thread block stages in shared
// memory at a time, as int8 codes with their scales (2 * l_pad * (D + 4)
// bytes: 66 KB at l_pad 256, D 128), and dequantization happens as each key
// is read. The block body is paged_attention.cu's (paged_attention.cuh): one
// warp per query row, keys one at a time in key order. So this kernel on a
// view gathered from a pool gives the same bits as paged_pool_attention on
// that pool, and every l_pad gives the same bits: the tuner's choice cannot
// change a result. The window arrives as an int or as a pointer to an int32
// on the card (read there, never by the host).
#include "paged_attention.cuh"

namespace {

using pattn::MAX_DV;
using pattn::THREADS;
using pattn::WARPS;

template <typename QT>
__global__ void __launch_bounds__(THREADS)
paged_dequant_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kq,
                     const float* __restrict__ k_scale, const int8_t* __restrict__ vq,
                     const float* __restrict__ v_scale, const float* __restrict__ k_smooth,
                     const float* __restrict__ v_smooth, const int* __restrict__ lengths,
                     const int* __restrict__ n_new, const int* __restrict__ window_ptr,
                     int window_arg, QT* __restrict__ out, int T, int H, int KV, int D, int L,
                     int l_pad, float softcap, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* kc = reinterpret_cast<int8_t*>(smem);                   // (l_pad, D) K codes
  int8_t* vc = kc + l_pad * D;                                     // (l_pad, D) V codes
  float* ksc = reinterpret_cast<float*>(vc + l_pad * D);           // (l_pad,) K scales
  float* vsc = ksc + l_pad;                                        // (l_pad,) V scales

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = H / KV;
  const int row = blockIdx.z * WARPS + tid / 32;
  const bool active = row < g * T;
  const int gi = active ? row / T : 0;
  const int t = active ? row % T : 0;
  const int nd = D / 32;

  const int window = window_ptr ? *window_ptr : window_arg;
  const int length = lengths[s];
  const int total = length + n_new[s];
  const int end = min(total, L);
  // no row of this slot (positions >= length) sees a column below `start`
  const int start = window > 0 ? max(0, length - window + 1) : 0;
  const int q_pos = length + t;

  const int64_t q_off = (((int64_t)s * T + t) * H + (h * g + gi)) * D;
  pattn::Row r;
  pattn::load_row(r, q + q_off, active, nd, lane);
  float ksm[MAX_DV], vsm[MAX_DV];
#pragma unroll
  for (int i = 0; i < MAX_DV; ++i) {
    ksm[i] = i < nd ? k_smooth[h * D + lane + 32 * i] : 0.0f;
    vsm[i] = i < nd ? v_smooth[h * D + lane + 32 * i] : 0.0f;
  }

  const int vecs = D / 16;  // 16-byte vectors per (token, head) row of codes
  for (int c0 = start; c0 < end; c0 += l_pad) {
    const int n = min(l_pad, end - c0);
    __syncthreads();
    for (int idx = tid; idx < n * vecs; idx += THREADS) {
      const int tok = idx / vecs;
      const int part = idx % vecs;
      const int64_t src = (((int64_t)s * L + c0 + tok) * KV + h) * D + part * 16;
      *reinterpret_cast<int4*>(kc + tok * D + part * 16) =
          *reinterpret_cast<const int4*>(kq + src);
      *reinterpret_cast<int4*>(vc + tok * D + part * 16) =
          *reinterpret_cast<const int4*>(vq + src);
    }
    for (int idx = tid; idx < n; idx += THREADS) {
      const int64_t src = ((int64_t)s * L + c0 + idx) * KV + h;
      ksc[idx] = k_scale[src];
      vsc[idx] = v_scale[src];
    }
    __syncthreads();
    if (!active) continue;

    for (int c = 0; c < n; ++c) {
      if (!pattn::visible(c0 + c, total, q_pos, window)) continue;  // uniform across the warp
      const int8_t* kr = kc + c * D + lane;
      const int8_t* vr = vc + c * D + lane;
      const float ks = ksc[c], vs = vsc[c];
      pattn::attend(
          r, nd, scale, softcap,
          [&](int i) { return pattn::dequant(pattn::to_float(kr[32 * i]), ks, ksm[i]); },
          [&](int i) { return pattn::dequant(pattn::to_float(vr[32 * i]), vs, vsm[i]); });
    }
  }

  if (active) pattn::store_row(r, out + q_off, nd, lane);
}

template <typename QT>
int launch(const void* q, const int8_t* kq, const float* k_scale, const int8_t* vq,
           const float* v_scale, const float* k_smooth, const float* v_smooth, const int* lengths,
           const int* n_new, const int* window_ptr, int window, void* out, int S, int T, int H,
           int KV, int D, int L, int l_pad, float softcap, cudaStream_t stream) {
  auto kernel = paged_dequant_kernel<QT>;
  const size_t smem = (size_t)2 * l_pad * D + (size_t)2 * l_pad * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = (H / KV) * T;
  dim3 grid(S, KV, (rows + WARPS - 1) / WARPS);
  kernel<<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const QT*>(q), kq, k_scale, vq, v_scale, k_smooth, v_smooth, lengths,
      n_new, window_ptr, window, reinterpret_cast<QT*>(out), T, H, KV, D, L, l_pad, softcap,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q/out: (S, T, H, D) f32 or bf16; kq, vq: (S, L, KV, D) int8; k_scale,
// v_scale: (S, L, KV) f32; k_smooth, v_smooth: (KV, D) f32; lengths, n_new:
// (S,) i32; window_ptr: one i32 on the card, or null to use `window`. Returns
// the launch's cudaError_t (0 = ok).
extern "C" int paged_dequant_launch(const void* q, int q_is_bf16, const void* kq,
                                    const void* k_scale, const void* vq, const void* v_scale,
                                    const void* k_smooth, const void* v_smooth,
                                    const int* lengths, const int* n_new, const int* window_ptr,
                                    int window, void* out, int S, int T, int H, int KV, int D,
                                    int L, int l_pad, float softcap, void* stream) {
  if (S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D % 32 != 0 || D > 32 * MAX_DV || L <= 0 ||
      l_pad <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto kq8 = reinterpret_cast<const int8_t*>(kq);
  auto vq8 = reinterpret_cast<const int8_t*>(vq);
  auto ks = reinterpret_cast<const float*>(k_scale);
  auto vs = reinterpret_cast<const float*>(v_scale);
  auto ksm = reinterpret_cast<const float*>(k_smooth);
  auto vsm = reinterpret_cast<const float*>(v_smooth);
  if (q_is_bf16)
    return launch<__nv_bfloat16>(q, kq8, ks, vq8, vs, ksm, vsm, lengths, n_new, window_ptr,
                                 window, out, S, T, H, KV, D, L, l_pad, softcap, st);
  return launch<float>(q, kq8, ks, vq8, vs, ksm, vsm, lengths, n_new, window_ptr, window, out,
                       S, T, H, KV, D, L, l_pad, softcap, st);
}
