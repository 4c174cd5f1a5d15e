// Pool-direct paged attention.
//
// Replaces the Pallas TPU kernel `paged_pool_attention` of the JAX package
// (src/repro/kernels/paged_attention.py): for every (slot, kv-head) the
// slot's g*T query rows attend over the slot's live KV blocks, read in place
// from the (num_blocks, block_size, KV, D) pools through the block table;
// int8 pools are dequantized on chip as codes * scale[token, head] *
// smooth[head, :]; online f32 softmax; fully masked rows give 0.
//
// What bounds it on an H100: the live KV bytes, sum over slots of
// (length + n_new) * KV * D * 2 pool elements, each needed once per query-row
// tile. The Pallas version took block table, lengths and n_new as scalar
// prefetch and carried the softmax state across a sequential block grid axis;
// here each thread block loads its own table row and lengths and loops over
// the live blocks itself. One warp owns one query row (lanes split D, a
// shuffle tree sums a score), a thread block of 8 warps shares each KV block
// through shared memory, already dequantized. A row's result depends on that
// row, its slot's length and the pools alone — not on T — so a decoding slot
// reads the same bits from a width-1 step and from a mixed prefill step. The
// per-row body (paged_attention.cuh) is shared with paged_dequant.cu (B8).
#include "paged_attention.cuh"

namespace {

using pattn::MAX_DV;
using pattn::THREADS;
using pattn::WARPS;

template <typename QT, typename PT, bool INT8>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const QT* __restrict__ q, const PT* __restrict__ k_pool,
                  const PT* __restrict__ v_pool, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const float* __restrict__ k_smooth,
                  const float* __restrict__ v_smooth, const int* __restrict__ block_tables,
                  const int* __restrict__ lengths, const int* __restrict__ n_new,
                  QT* __restrict__ out, int T, int H, int KV, int D, int nb, int bs, int NB,
                  int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;            // (bs, D) dequantized K block
  float* vs = smem + bs * D;   // (bs, D) dequantized V block

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = H / KV;
  const int row = blockIdx.z * WARPS + tid / 32;  // query row of this warp: (group, token)
  const bool active = row < g * T;
  const int gi = active ? row / T : 0;
  const int t = active ? row % T : 0;
  const int nd = D / 32;

  const int length = lengths[s];
  const int total = length + n_new[s];
  int live = (total + bs - 1) / bs;
  live = max(live, 1);
  live = min(live, NB);
  const int q_pos = length + t;

  const int64_t q_off = (((int64_t)s * T + t) * H + (h * g + gi)) * D;
  pattn::Row r;
  pattn::load_row(r, q + q_off, active, nd, lane);

  for (int j = 0; j < live; ++j) {
    int bid = block_tables[s * NB + j];
    bid = min(max(bid, 0), nb - 1);
    __syncthreads();
    for (int idx = tid; idx < bs * D; idx += THREADS) {
      const int tok = idx / D;
      const int d = idx % D;
      const int64_t slot = ((int64_t)bid * bs + tok) * KV + h;
      float kv_k = pattn::to_float(k_pool[slot * D + d]);
      float kv_v = pattn::to_float(v_pool[slot * D + d]);
      if (INT8) {
        kv_k = pattn::dequant(kv_k, k_scale[slot], k_smooth[h * D + d]);
        kv_v = pattn::dequant(kv_v, v_scale[slot], v_smooth[h * D + d]);
      }
      ks[idx] = kv_k;
      vs[idx] = kv_v;
    }
    __syncthreads();
    if (!active) continue;

    for (int c = 0; c < bs; ++c) {
      if (!pattn::visible(j * bs + c, total, q_pos, window)) continue;  // uniform across the warp
      const float* kc = ks + c * D + lane;
      const float* vc = vs + c * D + lane;
      pattn::attend(r, nd, scale, softcap, [&](int i) { return kc[32 * i]; },
                    [&](int i) { return vc[32 * i]; });
    }
  }

  if (active) pattn::store_row(r, out + q_off, nd, lane);
}

template <typename QT, typename PT, bool INT8>
int launch(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
           const float* v_scale, const float* k_smooth, const float* v_smooth,
           const int* block_tables, const int* lengths, const int* n_new, void* out, int S, int T,
           int H, int KV, int D, int nb, int bs, int NB, int window, float softcap,
           cudaStream_t stream) {
  auto kernel = paged_attn_kernel<QT, PT, INT8>;
  const size_t smem = (size_t)2 * bs * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = (H / KV) * T;
  dim3 grid(S, KV, (rows + WARPS - 1) / WARPS);
  kernel<<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const QT*>(q), reinterpret_cast<const PT*>(k_pool),
      reinterpret_cast<const PT*>(v_pool), k_scale, v_scale, k_smooth, v_smooth, block_tables,
      lengths, n_new, reinterpret_cast<QT*>(out), T, H, KV, D, nb, bs, NB, window, softcap,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_pool(int pool_kind, const void* q, const void* k_pool, const void* v_pool,
                const float* k_scale, const float* v_scale, const float* k_smooth,
                const float* v_smooth, const int* block_tables, const int* lengths,
                const int* n_new, void* out, int S, int T, int H, int KV, int D, int nb, int bs,
                int NB, int window, float softcap, cudaStream_t stream) {
  switch (pool_kind) {
    case 0:
      return launch<QT, float, false>(q, k_pool, v_pool, k_scale, v_scale, k_smooth, v_smooth,
                                      block_tables, lengths, n_new, out, S, T, H, KV, D, nb, bs,
                                      NB, window, softcap, stream);
    case 1:
      return launch<QT, __nv_bfloat16, false>(q, k_pool, v_pool, k_scale, v_scale, k_smooth,
                                              v_smooth, block_tables, lengths, n_new, out, S, T, H,
                                              KV, D, nb, bs, NB, window, softcap, stream);
    case 2:
      return launch<QT, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale, k_smooth, v_smooth,
                                      block_tables, lengths, n_new, out, S, T, H, KV, D, nb, bs, NB,
                                      window, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/out: (S, T, H, D) f32 or bf16; pools: (nb, bs, KV, D) f32 (pool_kind 0),
// bf16 (1) or int8 (2, with (nb, bs, KV) f32 scales and (KV, D) f32 smoothing
// vectors); block_tables: (S, NB) i32; lengths, n_new: (S,) i32. Returns the
// launch's cudaError_t (0 = ok).
extern "C" int paged_attn_launch(const void* q, int q_is_bf16, const void* k_pool,
                                 const void* v_pool, int pool_kind, const float* k_scale,
                                 const float* v_scale, const float* k_smooth,
                                 const float* v_smooth, const int* block_tables,
                                 const int* lengths, const int* n_new, void* out, int S, int T,
                                 int H, int KV, int D, int nb, int bs, int NB, int window,
                                 float softcap, void* stream) {
  if (S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D % 32 != 0 || D > 32 * MAX_DV || bs <= 0 ||
      NB <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (q_is_bf16)
    return launch_pool<__nv_bfloat16>(pool_kind, q, k_pool, v_pool, k_scale, v_scale, k_smooth,
                                      v_smooth, block_tables, lengths, n_new, out, S, T, H, KV, D,
                                      nb, bs, NB, window, softcap, st);
  return launch_pool<float>(pool_kind, q, k_pool, v_pool, k_scale, v_scale, k_smooth, v_smooth,
                            block_tables, lengths, n_new, out, S, T, H, KV, D, nb, bs, NB, window,
                            softcap, st);
}
