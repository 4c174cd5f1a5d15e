// Pool-direct paged attention (B5).
//
// Replaces the Pallas TPU kernel `paged_pool_attention` of the JAX package
// (src/repro/kernels/paged_attention.py:339, pallas_call at :419): for every
// (slot, kv-head) the slot's g*T query rows attend over the slot's live KV
// blocks, read in place from the (num_blocks, block_size, KV, D) pools
// through the block table; int8 pools are dequantized on chip as codes *
// scale[token, head] * smooth[head, :]; online f32 softmax; fully masked
// rows give 0.
//
// What bounds it on an H100: bytes. The live KV, sum over slots of the keys
// the new tokens can see times KV * D * 2 pool elements, read once; at
// llama2-7b's decode (T = 1) that is 2.7 us of 3.35 TB/s, and the f32
// arithmetic (4 D operations per visible (query, key) pair) is 20x less. At
// T = 32 the arithmetic, 3.6 us on the CUDA cores, comes close to the 4.4
// us of bytes. The Pallas version took block table, lengths and n_new as
// scalar prefetch and carried the softmax state across a sequential block
// grid axis. Here (paged_attention.cuh) a thread block owns up to 32 rows of
// one (slot, kv-head) and reads each of the slot's keys once, through a
// cp.async ring in the pool's own type; a lane owns a key for the scores
// and D / 32 columns for P.V, so a warp takes 32 keys at a time with no
// shuffle per key; at decode the 8 warps split a row's chunks. The rows'
// bits follow the canonical per-row key order (paged_attention.cuh), so a
// decoding slot reads the same bits from a width-1 step and from a mixed
// prefill step, and B8 (paged_dequant.cu) on a gathered view the same bits
// as this kernel on the pool.
#include "paged_attention.cuh"

namespace {

using pattn::MAX_DV;
using pattn::THREADS;

template <typename PT, bool INT8, int RG, int ND>
__global__ void __launch_bounds__(THREADS, pattn::min_blocks(ND))
paged_attn_kernel(const void* __restrict__ q, int q_bf16, const PT* __restrict__ k_pool,
                  const PT* __restrict__ v_pool, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const float* __restrict__ k_smooth,
                  const float* __restrict__ v_smooth, const int* __restrict__ block_tables,
                  const int* __restrict__ lengths, const int* __restrict__ n_new,
                  void* __restrict__ out, int T, int H, int KV, int D, int nb, int bs, int NB,
                  int window, float softcap, float scale, pattn::Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int length = lengths[s];
  const int total = length + n_new[s];
  // live blocks: max(ceil(total / bs), 1), at most NB; keys past them are never read
  pattn::PoolSrc<PT> src{k_pool, v_pool, k_scale, v_scale, block_tables + (size_t)s * NB,
                         nb, bs, KV, h};
  pattn::attend_block<PT, INT8, RG, ND>(src, q, out, q_bf16 != 0, k_smooth, v_smooth, s, h,
                                        blockIdx.z, T, H, KV, D, length, total, NB * bs, window,
                                        softcap, scale, pl, smem);
}

struct Args {
  const void* q;
  int q_bf16;
  const void *k_pool, *v_pool;
  const float *k_scale, *v_scale, *k_smooth, *v_smooth;
  const int *block_tables, *lengths, *n_new;
  void* out;
  int S, T, H, KV, D, nb, bs, NB, window;
  float softcap;
};

template <typename PT, bool INT8, int RG, int ND>
int launch_one(const Args& a, const pattn::Plan& pl, cudaStream_t stream) {
  auto kernel = paged_attn_kernel<PT, INT8, RG, ND>;
  if (pl.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = (a.H / a.KV) * a.T;
  dim3 grid(a.S, a.KV, (rows + pl.rows - 1) / pl.rows);
  kernel<<<grid, THREADS, pl.smem, stream>>>(
      a.q, a.q_bf16, reinterpret_cast<const PT*>(a.k_pool), reinterpret_cast<const PT*>(a.v_pool),
      a.k_scale, a.v_scale, a.k_smooth, a.v_smooth, a.block_tables, a.lengths, a.n_new, a.out,
      a.T, a.H, a.KV, a.D, a.nb, a.bs, a.NB, a.window, a.softcap, 1.0f / sqrtf((float)a.D), pl);
  return (int)cudaGetLastError();
}

// D = 128 (llama2-7b, qwen2-1.5b) at compile time; any other D at run time
template <typename PT, bool INT8, int RG>
int launch_rg(const Args& a, const pattn::Plan& pl, cudaStream_t stream) {
  return a.D == 128 ? launch_one<PT, INT8, RG, 4>(a, pl, stream)
                    : launch_one<PT, INT8, RG, 0>(a, pl, stream);
}

template <typename PT, bool INT8>
int launch(const Args& a, int rows, int stage_keys, cudaStream_t stream) {
  const pattn::Plan pl = pattn::make_plan(rows, stage_keys, a.D, sizeof(PT), INT8);
  if (pl.smem > pattn::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (pl.rg == 1) return launch_rg<PT, INT8, 1>(a, pl, stream);
  if (pl.rg == 2) return launch_rg<PT, INT8, 2>(a, pl, stream);
  return launch_rg<PT, INT8, pattn::MAX_RG>(a, pl, stream);
}

}  // namespace

// The plan make_plan gives the launchers for (rows, stage_keys, D,
// pool_kind): geom receives rg, groups, split and row_bytes. Returns the
// block's shared-memory bytes, or -1 where plan_ok refuses. It lets a caller
// hold kernels/paged_attention.py pool_plan to the launchers' arithmetic.
extern "C" long long paged_attn_plan(int rows, int stage_keys, int D, int pool_kind, int* geom) {
  if (!pattn::plan_ok(rows, stage_keys) || pool_kind < 0 || pool_kind > 2) return -1;
  const int elt = pool_kind == 0 ? 4 : pool_kind == 1 ? 2 : 1;
  const pattn::Plan pl = pattn::make_plan(rows, stage_keys, D, elt, pool_kind == 2);
  geom[0] = pl.rg;
  geom[1] = pl.groups;
  geom[2] = pl.split;
  geom[3] = pl.row_bytes;
  return (long long)pl.smem;
}

// q/out: (S, T, H, D) f32 or bf16; pools: (nb, bs, KV, D) f32 (pool_kind 0),
// bf16 (1) or int8 (2, with (nb, bs, KV) f32 scales and (KV, D) f32 smoothing
// vectors); block_tables: (S, NB) i32; lengths, n_new: (S,) i32; rows,
// stage_keys: the block's plan (kernels/paged_attention.py pool_plan).
// Returns the launch's cudaError_t (0 = ok).
extern "C" int paged_attn_launch(const void* q, int q_is_bf16, const void* k_pool,
                                 const void* v_pool, int pool_kind, const float* k_scale,
                                 const float* v_scale, const float* k_smooth,
                                 const float* v_smooth, const int* block_tables,
                                 const int* lengths, const int* n_new, void* out, int S, int T,
                                 int H, int KV, int D, int nb, int bs, int NB, int window,
                                 float softcap, int rows, int stage_keys, void* stream) {
  if (S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D % 32 != 0 || D <= 0 || D > 32 * MAX_DV ||
      bs <= 0 || NB <= 0 || nb <= 0 || !pattn::plan_ok(rows, stage_keys))
    return (int)cudaErrorInvalidValue;
  const Args a{q,       q_is_bf16, k_pool, v_pool, k_scale, v_scale, k_smooth, v_smooth,
               block_tables, lengths, n_new, out, S, T, H, KV, D, nb, bs, NB, window, softcap};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (pool_kind) {
    case 0: return launch<float, false>(a, rows, stage_keys, st);
    case 1: return launch<__nv_bfloat16, false>(a, rows, stage_keys, st);
    case 2: return launch<int8_t, true>(a, rows, stage_keys, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
