// The fused LUT GEMM's two device parts, shared by the solo kernel
// (lut_gemm.cu, B2), the multi-projection kernel (lut_multi_gemm.cu, B4) and
// the §4 layer's kernels from 128 rows on (lut_plain.cu, B6 / B7):
//
//   lut_xt_kernel  the transformed activations T(x), once per launch and
//                  projection, in f32, laid out stage by stage in the order
//                  the tiles walk K (the "stage-tiled T(x)" below);
//   tile           one BM x BN output tile of Y = T(x) @ codebook[codes].
//
// Every kernel runs this same code for a tile, so a projection's columns
// carry the same bits whichever kernel served them, and a row the same bits
// the GEMV body gives it (both apply `transform<MODE>` of lut_common.cuh to
// the same element and then walk K in the canonical order).
//
// The order fixes each output's arithmetic: way by way, one fmaf chain per
// way over its k-blocks in increasing k from +0, the way results summed in
// way order from +0. Tensor cores cannot reproduce a sequential fmaf chain,
// so the arithmetic stays on the CUDA cores in f32 and the design is free
// only in what feeds it:
//
//   * K is walked way-major: way 0's k-blocks (0, 64, 128, ...), then way
//     1's, and so on, as one sequence of 8-channel k-blocks cut into stages
//     of TB = 4 (32 channels). A stage may straddle two ways; the
//     arithmetic flushes `total += acc; acc = 0` where a way begins, so the
//     order is the canonical one whatever the stage boundaries.
//   * The Eq. 11 transform runs once per element and launch: every column
//     tile of a launch needs the same rows of T(x), which a per-tile
//     transform repeated N / BN times. The pre-pass writes them in f32, a
//     stage's 32 channels of BM rows as one contiguous 16 KB piece, so a
//     tile's stage is 16-byte `cp.async` copies of neighbouring addresses.
//   * Loads overlap compute: x's stage, the packed code rows of its
//     k-blocks over BN columns, through a ring of NS = 4 stages in shared
//     memory, issued three stages ahead. The codebook decode runs once per
//     stage tile, one stage ahead of the arithmetic, into a double-buffered
//     f32 tile; one barrier per stage.
//   * 128 threads, each an 8 x 8 register tile (acc and total: 128
//     registers), split 4 + 4 rows and 4 + 4 columns half a tile apart so
//     that the four 16-byte shared reads per channel are free of bank
//     conflicts: 64 fmaf per 4 loads.
//   * A 128 x 64 tile of 4 warps gives 128 blocks at M = 256, N = 4096
//     (B2), 384 for llama2-7b's QKV and 688 for its gate+up (B4), two
//     blocks per SM (85 KB of shared memory). No split-K across ways: the
//     way-ordered sum forbids it.
//
// Where the codes cannot be copied 16 bytes at a time (N not a multiple of
// 16, a misaligned pointer) the stages are filled by ordinary loads; the
// arithmetic is the same. Rows past M and channels past K are zeros in the
// stage-tiled T(x): a zero adds fmaf(0, w, acc) == acc exactly (w is a
// finite table entry), so the bits are those of skipping them; columns past
// N are computed and not stored.
#pragma once

#include "cp_async.cuh"
#include "lut_common.cuh"

namespace lut {
namespace gemm {

constexpr int BM = 128;         // rows per tile
constexpr int BN = 64;          // columns per tile
constexpr int TM = 8;           // rows per thread: 4 at 4*ty, 4 at BM/2 + 4*ty
constexpr int TN = 8;           // columns per thread: 4 at 4*tx, 4 at BN/2 + 4*tx
constexpr int THREADS = 128;    // 16 x 8 threads
constexpr int TB = 4;           // k-blocks per stage
constexpr int TK = TB * KB;     // 32 channels per stage
constexpr int NS = 4;           // stages in the ring
constexpr int MAX_BITS = 4;

struct __align__(16) Smem {
  float xs[NS][TK][BM];                // stage-tiled T(x), k-major
  uint8_t craw[NS][TB][MAX_BITS][BN];  // packed code rows of the stage's k-blocks
  float ws[2][TK][BN];                 // codebook[code], k-major
  float cb[KC];
};

// The stage-tiled T(x) of one operand set: for stage s, channel slot c (the
// c % KB-th channel of the stage's (c / KB)-th k-block) and row m, the
// element at ((s * TK + c) * padded_rows(M) + m).
__host__ __device__ inline int kblocks(int K) { return (K + KB - 1) / KB; }
__host__ __device__ inline int stages(int K) { return (kblocks(K) + TB - 1) / TB; }
__host__ __device__ inline int padded_rows(int M) { return (M + BM - 1) / BM * BM; }
__host__ __device__ inline int64_t xt_floats(int M, int K) {
  return (int64_t)stages(K) * TK * padded_rows(M);
}

// The way-major walk over nblk k-blocks: way w holds
// base + (w < rem) k-blocks, w, w + WAYS, ..., and starts at position
// w * base + min(w, rem).
struct Walk {
  int w, j, cnt, base, rem;
  __device__ __forceinline__ explicit Walk(int nblk)
      : w(0), j(0), cnt(nblk / WAYS + (nblk % WAYS > 0)), base(nblk / WAYS), rem(nblk % WAYS) {}
  __device__ __forceinline__ int kblock() const { return w + WAYS * j; }
  __device__ __forceinline__ bool opens() const { return j == 0; }  // first of its way
  __device__ __forceinline__ void next() {
    if (++j == cnt) {
      ++w;
      j = 0;
      cnt = base + (w < rem);
    }
  }
};

// The pre-pass: T_p(x) of projection p = blockIdx.z (transform mode QUANT
// where bit p of qmask is set, else SMOOTH; NONE when !TRANSFORM, inv_stack
// unread) into xt + p * xt_floats(M, K). Grid (padded_rows(M) / THREADS,
// WAYS, P): a thread walks its row through one way.
template <typename XT, bool TRANSFORM>
__global__ void __launch_bounds__(THREADS)
lut_xt_kernel(const XT* __restrict__ x, const float* __restrict__ inv_stack, int qmask,
              float* __restrict__ xt, int M, int K) {
  const int nblk = kblocks(K), base = nblk / WAYS, rem = nblk % WAYS;
  const int mp = padded_rows(M);
  const int w = blockIdx.y, p = blockIdx.z;
  const int row = blockIdx.x * THREADS + threadIdx.x;
  const float* inv = TRANSFORM ? inv_stack + (int64_t)p * K : nullptr;
  const bool quant = (qmask >> p) & 1;
  float* out = xt + (int64_t)p * xt_floats(M, K) + row;
  const int q0 = w * base + min(w, rem);
  const int cnt = base + (w < rem);
  for (int j = 0; j < cnt; ++j) {
    const int q = q0 + j, b = w + WAYS * j;
    float* dst = out + ((int64_t)(q / TB) * TK + (q % TB) * KB) * mp;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int k = b * KB + kk;
      float v = 0.0f;
      if (row < M && k < K) {
        const float xv = to_float(x[(int64_t)row * K + k]);
        if constexpr (TRANSFORM)
          v = quant ? transform<QUANT>(xv, inv[k]) : transform<SMOOTH>(xv, inv[k]);
        else
          v = transform<NONE>(xv, 0.0f);
      }
      dst[(int64_t)kk * mp] = v;
    }
  }
}

using hopper::cp_async16;
using hopper::cp_commit;
using hopper::cp_wait;

// Stage `stage` into ring slot `slot`: its piece of the stage-tiled T(x) and
// the code rows of its k-blocks; `walk` stands at the stage's first
// position and is moved past it.
template <int NBITS>
__device__ __forceinline__ void load_stage(Smem& sm, Walk& walk, int slot, int stage,
                                           const float* __restrict__ xt,
                                           const uint8_t* __restrict__ packed, int N,
                                           int packed_rows, int nblk, int mp, int m0, int n0,
                                           bool cvec) {
  const int tid = threadIdx.x;
  const float* xs = xt + (int64_t)stage * TK * mp + m0;
#pragma unroll
  for (int u = 0; u < TK * BM / 4 / THREADS; ++u) {
    const int c = tid + THREADS * u;
    const int kr = c / (BM / 4), part = c % (BM / 4);
    cp_async16(&sm.xs[slot][kr][4 * part], xs + (int64_t)kr * mp + 4 * part, true);
  }
  for (int i = 0; i < TB; ++i) {
    if (stage * TB + i >= nblk) break;
    const int b = walk.kblock();
    walk.next();
    if (cvec) {
      constexpr int PARTS = BN / 16;
      if (tid < NBITS * PARTS) {
        const int r = tid / PARTS, col = n0 + (tid % PARTS) * 16;
        const bool ok = col < N;
        cp_async16(&sm.craw[slot][i][r][(tid % PARTS) * 16],
                   ok ? packed + (int64_t)(b * NBITS + r) * N + col : packed, ok);
      }
    } else if (tid < BN) {
      const uint32_t word =
          n0 + tid < N ? load_word<NBITS>(packed, N, packed_rows, b, n0 + tid) : 0u;
#pragma unroll
      for (int r = 0; r < NBITS; ++r) sm.craw[slot][i][r][tid] = (word >> (8 * r)) & 0xFFu;
    }
  }
}

// The code rows of ring slot `slot` through the table into ws[wbuf], once
// per element. Every k-block of the stage is decoded, also past the end of
// the walk (stale bytes, never used), so that all the reads go out first.
template <int NBITS>
__device__ __forceinline__ void decode_stage(Smem& sm, int slot, int wbuf) {
  constexpr int PAIRS = TB * BN / THREADS;
  uint32_t word[PAIRS];
#pragma unroll
  for (int u = 0; u < PAIRS; ++u) {
    const int p = threadIdx.x + THREADS * u;
    word[u] = 0;
#pragma unroll
    for (int r = 0; r < NBITS; ++r)
      word[u] |= (uint32_t)sm.craw[slot][p / BN][r][p % BN] << (8 * r);
  }
#pragma unroll
  for (int u = 0; u < PAIRS; ++u) {
    const int p = threadIdx.x + THREADS * u;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
      sm.ws[wbuf][(p / BN) * KB + kk][p % BN] = sm.cb[code_of<NBITS>(word[u], kk)];
  }
}

// Tile (nblock, mblock) of Y for one (stage-tiled T(x), packed, cb) operand
// set of width N; its element (m, n) is written to
// y[m * y_stride + y_col0 + n], times *out_scale when that is given (one
// rounded multiply).
template <int NBITS>
__device__ __forceinline__ void tile(const float* __restrict__ xt,
                                     const uint8_t* __restrict__ packed,
                                     const float* __restrict__ cb, float* __restrict__ y, int M,
                                     int K, int N, int packed_rows, int nblock, int mblock,
                                     int64_t y_stride, int y_col0, Smem& sm,
                                     const float* __restrict__ out_scale = nullptr) {
  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;
  const int m0 = mblock * BM;
  const int n0 = nblock * BN;
  const int nblk = kblocks(K);
  const int nst = stages(K);
  const int mp = padded_rows(M);
  const bool cvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;

  if (tid < KC) sm.cb[tid] = cb[tid];

  float acc[TM][TN], total[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = total[r][c] = 0.0f;

  Walk lwalk(nblk), cwalk(nblk);  // the loads' position, the arithmetic's
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nst)
      load_stage<NBITS>(sm, lwalk, s, s, xt, packed, N, packed_rows, nblk, mp, m0, n0, cvec);
    cp_commit();
  }
  cp_wait<NS - 2>();  // stage 0 has landed
  __syncthreads();
  decode_stage<NBITS>(sm, 0, 0);

  for (int st = 0; st < nst; ++st) {
    cp_wait<NS - 3>();  // stage st + 1 has landed (this thread's copies)
    __syncthreads();    // ... everyone's; stage st - 1 is done with its slot
    if (st + NS - 1 < nst)
      load_stage<NBITS>(sm, lwalk, (st + NS - 1) % NS, st + NS - 1, xt, packed, N, packed_rows,
                        nblk, mp, m0, n0, cvec);
    cp_commit();
    if (st + 1 < nst) decode_stage<NBITS>(sm, (st + 1) % NS, (st + 1) & 1);

    const float(*xs)[BM] = sm.xs[st % NS];
    const float(*ws)[BN] = sm.ws[st & 1];
#pragma unroll 1
    for (int i = 0; i < TB; ++i) {
      if (st * TB + i >= nblk) break;
      const bool opens = cwalk.opens();
      cwalk.next();
      if (opens) {  // a new way: fold the last one into the total, in way order
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            total[r][c] += acc[r][c];
            acc[r][c] = 0.0f;
          }
      }
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const int t = i * KB + kk;
        const float4 xa = *reinterpret_cast<const float4*>(&xs[t][4 * ty]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[t][BM / 2 + 4 * ty]);
        const float4 wa = *reinterpret_cast<const float4*>(&ws[t][4 * tx]);
        const float4 wb = *reinterpret_cast<const float4*>(&ws[t][BN / 2 + 4 * tx]);
        const float xr[TM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float wc[TN] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(xr[r], wc[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) total[r][c] += acc[r][c];

  const float sc = out_scale ? *out_scale : 1.0f;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + (r < 4 ? 4 * ty + r : BM / 2 + 4 * ty + r - 4);
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = n0 + (c < 4 ? 4 * tx + c : BN / 2 + 4 * tx + c - 4);
      if (n < N)
        y[(int64_t)m * y_stride + y_col0 + n] =
            out_scale ? __fmul_rn(total[r][c], sc) : total[r][c];
    }
  }
}

// Host side. The pre-pass of P operand sets sharing x into the scratch xt
// (P * xt_floats(M, K) floats); returns a cudaError_t.
template <typename XT, bool TRANSFORM>
inline int launch_xt(const XT* x, const float* inv_stack, int qmask, float* xt, int M, int K,
                     int P, cudaStream_t stream) {
  if (xt == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid(padded_rows(M) / THREADS, WAYS, P);
  lut_xt_kernel<XT, TRANSFORM><<<grid, THREADS, 0, stream>>>(x, inv_stack, qmask, xt, M, K);
  return (int)cudaGetLastError();
}

// Let a tile kernel use sizeof(Smem) bytes of dynamic shared memory.
template <typename Kernel>
inline int allow_smem(Kernel kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)sizeof(Smem));
}

}  // namespace gemm
}  // namespace lut
