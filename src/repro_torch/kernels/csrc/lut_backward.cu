// Backward of the LUT projection, reading the packed codes.
//
// For Y = Xs @ W with Xs = x / smooth and W[k, n] = codebook[code[k, n]]:
//
//   lut_matmul_t_kernel       dXs = dY @ W^T (M x K), a LUT GEMM that
//                             contracts over N and decodes the 2/3/4-bit
//                             codes (core/lut.py layout) from their bytes;
//   lut_codebook_grad_kernel  G = Xs^T @ dY one 128 x 128 (k, n) tile a
//                             block, over all M inside the block's loop, then
//                             folded by code into 16 bucket sums and, per
//                             channel, into sum_n G[k, n] * W[k, n]; G is
//                             never written to device memory;
//   fold_codebook_kernel,     the blocks' partial sums, in a fixed order:
//   fold_smooth_kernel        dcodebook[c], and dsmooth[k] = -(1 / smooth[k])
//                             * sum_n G[k, n] * W[k, n].
//
// Replaces no TPU kernel: the JAX package leaves this backward to XLA
// (jax.value_and_grad through the gather of core/api.py clustered_matmul).
// It was added so that the codebook fine-tune (examples/distill_llm.py)
// runs on the card without a dequantised weight: scatter_add_ / index_add_
// sum with atomics on CUDA, so the codebook gradient would change from run
// to run, and G at 4096 x 11008 is 180 MB of f32 written and read again for
// every projection.
//
// What bounds it on an H100: 2*M*K*N operations each, in f32 on the CUDA
// cores (67 TFLOP/s): 5.513 ms at M 4096, K 4096, N 11008. The first design
// is simple: 128 x 128 output tiles, 256 threads with 8 x 8 outputs each,
// the contraction staged through shared memory 32 at a time. Every output
// is one fmaf chain in increasing contraction index, and every sum across
// threads or blocks is taken in a fixed order: no atomics, the same bits on
// every run. K is the packing-group-padded d_in; ragged M, N and K are
// masked here.
#include "lut_common.cuh"

namespace {

using namespace lut;

constexpr int TILE = 128;       // output tile side
constexpr int CH = 32;          // contraction indices staged at a time
constexpr int PITCH = TILE + 4; // floats per staged row (keeps float4 alignment)
constexpr int THREADS = 256;    // 16 x 16 threads, 8 x 8 outputs each

// One chunk of both operands along the contraction: a[c][i] feeds the tile's
// rows, b[c][j] its columns.
struct Stage {
  float a[CH][PITCH];
  float b[CH][PITCH];
};

// The i-th of a thread's 8 coordinates along one side of the tile:
// t*4 .. t*4+3, then 64 + t*4 .. 64 + t*4+3.
__device__ __forceinline__ int side(int t, int i) { return (i < 4 ? 0 : 64) + t * 4 + (i & 3); }

// acc[i][j] = fmaf(a[c][side(ty, i)], b[c][side(tx, j)], acc[i][j]) for c in order.
__device__ __forceinline__ void chunk_fma(const Stage& st, int ty, int tx, float (&acc)[8][8]) {
#pragma unroll 4
  for (int c = 0; c < CH; ++c) {
    const float4 a0 = *reinterpret_cast<const float4*>(&st.a[c][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&st.a[c][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&st.b[c][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&st.b[c][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// dXs[m, k] = sum_n dY[m, n] * codebook[code[k, n]], n in increasing order.
// Block (x, y): channels x*128.., rows y*128...
template <int NBITS>
__global__ void __launch_bounds__(THREADS)
lut_matmul_t_kernel(const float* __restrict__ dy, const uint8_t* __restrict__ packed,
                    const float* __restrict__ cb, float* __restrict__ dxs, int M, int K, int N,
                    int packed_rows) {
  __shared__ __align__(16) Stage st;
  __shared__ float cbs[KC];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  if (tid < KC) cbs[tid] = cb[tid];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < N; n0 += CH) {
    __syncthreads();  // the last chunk is consumed (and, at first, cbs is written)
    // a[c][i] = dY[m0 + i, n0 + c]: a warp reads 32 consecutive columns of a row
#pragma unroll
    for (int r = 0; r < TILE * CH / THREADS; ++r) {
      const int idx = tid + r * THREADS, i = idx / CH, c = idx % CH;
      const int m = m0 + i, n = n0 + c;
      st.a[c][i] = (m < M && n < N) ? dy[(int64_t)m * N + n] : 0.f;
    }
    // b[c][kk] = codebook[code[k0 + kk, n0 + c]]: one k-block word per (k-block, column)
#pragma unroll
    for (int r = 0; r < (TILE / KB) * CH / THREADS; ++r) {
      const int idx = tid + r * THREADS, kb = idx / CH, c = idx % CH;
      const int n = n0 + c, kblock = k0 / KB + kb;
      const uint32_t word = n < N ? load_word<NBITS>(packed, N, packed_rows, kblock, n) : 0u;
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
        st.b[c][kb * KB + kk] =
            (n < N && kblock * KB + kk < K) ? cbs[code_of<NBITS>(word, kk)] : 0.f;
    }
    __syncthreads();
    chunk_fma(st, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + side(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + side(tx, j);
      if (k < K) dxs[(int64_t)m * K + k] = acc[i][j];
    }
  }
}

// The fold's buffers reuse the staging area once the contraction is done.
struct Fold {
  float bucket[THREADS][KC + 1];  // each thread's 16 bucket sums
  float rows[TILE][17];           // each channel's 16 partial row sums, one per tx
};

union GradSmem {
  Stage st;
  Fold f;
};

// Block (x, y): the (k, n) tile of G at channels y*128.., columns x*128..,
// summed over all M (m in increasing order). Writes its 16 bucket sums to
// part_cb[(y * gridDim.x + x) * 16 ..] and its channels' sums of G * W to
// part_rows[x * K + k].
template <int NBITS>
__global__ void __launch_bounds__(THREADS)
lut_codebook_grad_kernel(const float* __restrict__ xs, const float* __restrict__ dy,
                         const uint8_t* __restrict__ packed, const float* __restrict__ cb,
                         float* __restrict__ part_cb, float* __restrict__ part_rows, int M, int K,
                         int N, int packed_rows) {
  __shared__ __align__(16) GradSmem sm;
  __shared__ float cbs[KC];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE;
  if (tid < KC) cbs[tid] = cb[tid];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int m0 = 0; m0 < M; m0 += CH) {
    __syncthreads();
    // a[c][i] = Xs[m0 + c, k0 + i], b[c][i] = dY[m0 + c, n0 + i]: rows read
    // 32 consecutive floats a warp
#pragma unroll
    for (int r = 0; r < TILE * CH / THREADS; ++r) {
      const int idx = tid + r * THREADS, c = idx / TILE, i = idx % TILE;
      const int m = m0 + c;
      sm.st.a[c][i] = (m < M && k0 + i < K) ? xs[(int64_t)m * K + k0 + i] : 0.f;
      sm.st.b[c][i] = (m < M && n0 + i < N) ? dy[(int64_t)m * N + n0 + i] : 0.f;
    }
    __syncthreads();
    chunk_fma(sm.st, ty, tx, acc);
  }
  // This thread's 8 x 8 of G, by code: its channels side(ty, 0..3) lie in one
  // k-block, side(ty, 4..7) in another, so one word a column and half.
  constexpr int NC = 1 << NBITS;
  float bucket[KC], row[8];
#pragma unroll
  for (int c = 0; c < KC; ++c) bucket[c] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) row[i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kh = k0 + side(ty, 4 * h);  // the half's first channel (a multiple of 4)
    const int kblock = kh / KB;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + side(tx, j);
      if (n >= N) continue;
      const uint32_t word = load_word<NBITS>(packed, N, packed_rows, kblock, n);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * h + q, k = kh + q;
        if (k >= K) continue;
        const int code = code_of<NBITS>(word, k % KB);
        const float g = acc[i][j];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (code == c) bucket[c] += g;
        row[i] = fmaf(g, cbs[code], row[i]);
      }
    }
  }
  __syncthreads();  // the stage is dead: the fold reuses it
#pragma unroll
  for (int c = 0; c < KC; ++c) sm.f.bucket[tid][c] = bucket[c];
#pragma unroll
  for (int i = 0; i < 8; ++i) sm.f.rows[side(ty, i)][tx] = row[i];
  __syncthreads();
  if (tid < KC) {
    float s = 0.f;
    for (int t = 0; t < THREADS; ++t) s += sm.f.bucket[t][tid];
    part_cb[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * KC + tid] = s;
  }
  if (tid < TILE && k0 + tid < K) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += sm.f.rows[tid][t];
    part_rows[(int64_t)blockIdx.x * K + k0 + tid] = s;
  }
}

// dcodebook[c]: warp c; lane l sums blocks l, l + 32, ... in order, then the
// lanes fold by a fixed xor tree.
__global__ void __launch_bounds__(KC * 32)
fold_codebook_kernel(const float* __restrict__ part_cb, int blocks, float* __restrict__ dcb) {
  const int c = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s = 0.f;
  for (int b = lane; b < blocks; b += 32) s += part_cb[(int64_t)b * KC + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dcb[c] = s;
}

// dsmooth[k] = -(sum over column tiles t, in order, of part_rows[t, k]) / smooth[k].
__global__ void __launch_bounds__(256)
fold_smooth_kernel(const float* __restrict__ part_rows, int col_tiles,
                   const float* __restrict__ smooth, float* __restrict__ dsmooth, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float s = 0.f;
  for (int t = 0; t < col_tiles; ++t) s += part_rows[(int64_t)t * K + k];
  dsmooth[k] = -s / smooth[k];
}

inline int tiles(int n) { return (n + TILE - 1) / TILE; }

bool bad_shape(int M, int K, int N, int packed_rows, int nbits) {
  return M <= 0 || K <= 0 || N <= 0 || nbits < 2 || nbits > 4 ||
         (int64_t)packed_rows * 8 != (int64_t)K * nbits || tiles(M) > 65535 || tiles(K) > 65535;
}

template <int NBITS>
void launch_t(const float* dy, const uint8_t* packed, const float* cb, float* dxs, int M, int K,
              int N, int packed_rows, cudaStream_t stream) {
  dim3 grid(tiles(K), tiles(M));
  lut_matmul_t_kernel<NBITS><<<grid, THREADS, 0, stream>>>(dy, packed, cb, dxs, M, K, N,
                                                           packed_rows);
}

template <int NBITS>
void launch_grad(const float* xs, const float* dy, const uint8_t* packed, const float* cb,
                 float* part_cb, float* part_rows, int M, int K, int N, int packed_rows,
                 cudaStream_t stream) {
  dim3 grid(tiles(N), tiles(K));
  lut_codebook_grad_kernel<NBITS><<<grid, THREADS, 0, stream>>>(xs, dy, packed, cb, part_cb,
                                                                part_rows, M, K, N, packed_rows);
}

}  // namespace

// dy: (M, N) f32; packed: (K*nbits/8, N) u8; cb: (16,) f32; dxs: (M, K) f32,
// all row-major and contiguous. Returns the launch's cudaError_t.
extern "C" int lut_matmul_t_launch(const float* dy, const uint8_t* packed, const float* cb,
                                   float* dxs, int M, int K, int N, int packed_rows, int nbits,
                                   void* stream) {
  if (bad_shape(M, K, N, packed_rows, nbits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 2: launch_t<2>(dy, packed, cb, dxs, M, K, N, packed_rows, s); break;
    case 3: launch_t<3>(dy, packed, cb, dxs, M, K, N, packed_rows, s); break;
    default: launch_t<4>(dy, packed, cb, dxs, M, K, N, packed_rows, s); break;
  }
  return (int)cudaGetLastError();
}

// Floats of lut_codebook_grad_launch's scratch for a K x N tile grid: 16 a
// block, then one a (column tile, channel).
extern "C" long long lut_codebook_grad_scratch_floats(int K, int N) {
  return (long long)tiles(N) * tiles(K) * KC + (long long)tiles(N) * K;
}

// xs: (M, K) f32 = x / smooth; dy: (M, N) f32; packed, cb as above; smooth:
// (K,) f32; dcb: (16,) f32; dsmooth: (K,) f32; scratch:
// lut_codebook_grad_scratch_floats(K, N) f32. Returns the launch's
// cudaError_t.
extern "C" int lut_codebook_grad_launch(const float* xs, const float* dy, const uint8_t* packed,
                                        const float* cb, const float* smooth, float* dcb,
                                        float* dsmooth, float* scratch, int M, int K, int N,
                                        int packed_rows, int nbits, void* stream) {
  if (bad_shape(M, K, N, packed_rows, nbits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* part_cb = scratch;
  const int blocks = tiles(N) * tiles(K);
  float* part_rows = scratch + (int64_t)blocks * KC;
  switch (nbits) {
    case 2: launch_grad<2>(xs, dy, packed, cb, part_cb, part_rows, M, K, N, packed_rows, s); break;
    case 3: launch_grad<3>(xs, dy, packed, cb, part_cb, part_rows, M, K, N, packed_rows, s); break;
    default: launch_grad<4>(xs, dy, packed, cb, part_cb, part_rows, M, K, N, packed_rows, s);
  }
  if (int e = (int)cudaGetLastError()) return e;
  fold_codebook_kernel<<<1, KC * 32, 0, s>>>(part_cb, blocks, dcb);
  fold_smooth_kernel<<<(K + 255) / 256, 256, 0, s>>>(part_rows, tiles(N), smooth, dsmooth, K);
  return (int)cudaGetLastError();
}
