// Backward of the LUT projection, reading the packed codes, on the tensor
// cores.
//
// For Y = Xs @ W with Xs = x / smooth and W[k, n] = codebook[code[k, n]]:
//
//   split_bf16_kernel         the pre-pass: an f32 operand v (dY, or x with
//                             the division by smooth folded in) into two bf16
//                             planes, hi = bf16(v) and lo = bf16(v - hi);
//   lut_matmul_t_kernel       dXs = dY @ W^T (M x K), contracting over N, the
//                             2/3/4-bit codes (core/lut.py layout) decoded
//                             from their bytes into hi / lo tiles of W;
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
// What bounds it on an H100: 2*M*K*N operations a product. On the CUDA cores
// in f32 (67 TFLOP/s) that is 2.051 ms at M = K = N = 4096 and 5.513 ms at
// 4096 x 4096 x 11008; the first design, 128 x 128 tiles of fmaf chains, took
// 1.8 times that. No bit contract binds these kernels to the LUT GEMMs'
// canonical K order, so they may take the tensor cores, whose f32 route
// (TF32, 10-bit mantissas) is too coarse for the 1e-4 the gradients are held
// to. So each f32 operand is split into two bf16 parts and the product is
// taken as three bf16 products, lo*hi + hi*lo + hi*hi, with f32
// accumulators: at 989 TFLOP/s that bounds a kernel at 0.417 ms at 4096^3
// and 1.120 ms at 4096 x 4096 x 11008, and the pre-pass (8 bytes an element
// read and written) adds about 0.04 / 0.11 ms for dY at those shapes.
//
// The design:
//   * the pre-pass writes dY's planes once a projection (both kernels read
//     them) and Xs's with x / smooth folded in (an IEEE division, the bits of
//     the plain version's x / smooth); the weight side costs nothing to
//     split: W[k, n] is one of 16 codebook values, so a block splits the 16
//     once (a 32-bit table, hi | lo << 16) and decodes codes straight into
//     hi and lo bf16 tiles;
//   * `wgmma.mma_async` m64n128k16 (bf16 in, f32 accumulators): 128 x 128
//     output tiles, two warpgroups of 64 x 128, operands read by the tensor
//     cores straight from shared memory in the 128-byte swizzle, the
//     contraction in stages of 64 (one 128-byte row) streamed by 16-byte
//     `cp.async` copies through a ring of NSTG stages, one barrier a stage.
//     The two accumulator sets (below) take 128 registers a thread, which
//     is what caps a warpgroup at 64 x 128 and a block at two of them;
//   * lut_matmul_t: both operands are K-major (dY's rows and W's rows run
//     along n). The codes of stage c + 1 travel in the ring with dY's stage
//     c, and are decoded into the other half of a double-buffered W tile
//     while stage c's products run on the tensor cores, so the decode
//     neither waits on device memory nor holds the tensor cores up. (The
//     first tensor-core design, `mma.sync` fed by `ldmatrix`, 8 warps of
//     64 x 32, took 1.44 ms at 4096^3 against wgmma's ~1.1: PERF.md);
//   * lut_codebook_grad: both operands contract over M, their slow axis,
//     so the tensor cores read them MN-major (transposed), each stage two
//     64-wide halves of 128-byte rows. The epilogue stages the tile's packed
//     bytes in shared memory, and each thread folds its accumulator
//     fragments by code into 16 bucket sums and its channels' sums of G * W;
//     the block folds the threads' bucket sums in thread order, the fold
//     kernels the blocks' in block order. Each block streams 2 x 128 x M
//     split operands (4 bytes an element), 4.3 GB at M = K = N = 4096;
//   * no atomics and no split of the contraction across blocks: the same
//     bits on every run.
//
// The accuracy argument. hi carries v to 2^-8 relative (bf16 has 8
// significant bits), lo the rest to 2^-8 of that, so hi + lo = v (1 + d)
// with |d| <= 2^-16; a product of two operands then errs by at most about
// 3 * 2^-16 of |a b| (the two parts' roundings and the dropped lo*lo, itself
// <= 2^-16 |a b|), with a random sign from term to term. A sum of n such
// terms is off by about 2^-16 of its own root-sum-square, a few 1e-6 of the
// largest |gradient|, against the 1e-4 (dXs, dx, dsmooth) and 1e-3
// (dcodebook) that chip_smoke.py holds the kernels to; so no fourth product
// is needed. The tensor cores may truncate each accumulation to f32 instead
// of rounding it, a bias toward zero of up to an ulp a step: hi*hi and the
// two corrections (2^-8 smaller) go to separate accumulators, so the
// corrections add no steps to the large sum, whose worst bias over the
// longest contraction here (11008 / 16 = 688 steps) stays below 4.1e-5 of it.
// On an H100 at M = 4096 the worst dXs error is 0.07 of its limit over a
// 4096-long contraction and 0.16 over 11008 (chip_smoke.py): it grows with the
// steps, as a bias does, and one accumulator set would triple them.
//
// K is the packing-group-padded d_in (a multiple of 8); ragged M, N and K are
// masked here. Where N is not a multiple of 8 (16 for the codes) the rows are
// staged element by element, synchronously (no model width needs it).
#include <algorithm>

#include "cp_async.cuh"
#include "lut_common.cuh"

namespace {

using namespace lut;
using bf16 = __nv_bfloat16;
using hopper::cp_async16;
using hopper::cp_commit;
using hopper::cp_wait;
using hopper::smem_u32;

constexpr int TILE = 128;     // output tile side (both kernels)
constexpr int CH = 64;        // contraction indices a stage: one 128-byte bf16 row
constexpr int NSTG = 3;       // stages of the operand ring
constexpr int THREADS = 256;  // two warpgroups of 64 x 128 outputs
constexpr int KBT = TILE / KB;  // k-blocks of a tile

__device__ __forceinline__ bf16 hi_of(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 lo_of(float v, bf16 hi) {
  return __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Byte offset of bf16 column `col` (< 64) of row r in a staged tile of
// 128-byte rows under the 128-byte swizzle wgmma reads: the 16-byte chunk c
// of row r lies at chunk c ^ (r % 8). Tiles start on 1024-byte boundaries.
__device__ __forceinline__ int swz(int r, int col) {
  return r * 128 + (((col >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// Descriptors of 128-byte-swizzled operands in shared memory (rows 128 bytes
// apart, 8-row groups 1024 bytes apart): K-major (a row runs along the
// contraction), and MN-major (a row holds 64 MN values at one contraction
// index; 64-value MN atoms `atom_bytes` apart).
__device__ __forceinline__ uint64_t kdesc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t mndesc(const void* p, uint32_t atom_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((atom_bytes >> 4) & 0x3FFF) << 16) |
         (64ull << 32) | (1ull << 62);
}

// d += A (64 x 16) * B (16 x 128), bf16 in, f32 accumulators: one
// warpgroup's m64n128k16, operands from shared memory, K-major (TRANS 0)
// or both MN-major (TRANS 1).
template <int TRANS>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS));
}

// One 64-deep stage's products for a warpgroup: corr += lo*hi + hi*lo, then
// main += hi*hi, four 16-deep steps, `step` descriptor units apart (32 bytes
// along a K-major row, 16 rows of an MN-major tile).
template <int TRANS>
__device__ __forceinline__ void stage_products(float (&main_)[64], float (&corr)[64], uint64_t ah,
                                               uint64_t al, uint64_t bh, uint64_t bl, int step) {
#pragma unroll
  for (int ks = 0; ks < CH / 16; ++ks) {
    wgmma128<TRANS>(corr, al + ks * step, bh + ks * step);
    wgmma128<TRANS>(corr, ah + ks * step, bl + ks * step);
    wgmma128<TRANS>(main_, ah + ks * step, bh + ks * step);
  }
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// this thread's shared-memory writes (cp.async and stores) made visible to
// the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The shared memory of a kernel: its struct on the first 1024-byte boundary
// (the launch asks for 1024 bytes more than the struct).
template <typename T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<T*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// ---------------------------------------------------------------------------
// the pre-pass
// ---------------------------------------------------------------------------

// hi / lo of v = x (or x / smooth[column]) for every element of a (rows,
// cols) f32 matrix; vec4: cols % 4 == 0 and every pointer 16-byte aligned.
__global__ void __launch_bounds__(256)
split_bf16_kernel(const float* __restrict__ x, const float* __restrict__ smooth,
                  bf16* __restrict__ hi, bf16* __restrict__ lo, int64_t total, int cols,
                  int vec4) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec4) {
    for (int64_t q = first; q < total / 4; q += stride) {
      float4 v = reinterpret_cast<const float4*>(x)[q];
      if (smooth != nullptr) {
        const float4 s = *reinterpret_cast<const float4*>(smooth + (q * 4) % cols);
        v = make_float4(__fdiv_rn(v.x, s.x), __fdiv_rn(v.y, s.y), __fdiv_rn(v.z, s.z),
                        __fdiv_rn(v.w, s.w));
      }
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
      const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - __low2float(h01),
                                                      v.y - __high2float(h01));
      const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - __low2float(h23),
                                                      v.w - __high2float(h23));
      uint2 ph, pl;
      ph.x = *reinterpret_cast<const uint32_t*>(&h01);
      ph.y = *reinterpret_cast<const uint32_t*>(&h23);
      pl.x = *reinterpret_cast<const uint32_t*>(&l01);
      pl.y = *reinterpret_cast<const uint32_t*>(&l23);
      reinterpret_cast<uint2*>(hi)[q] = ph;
      reinterpret_cast<uint2*>(lo)[q] = pl;
    }
  } else {
    for (int64_t e = first; e < total; e += stride) {
      float v = x[e];
      if (smooth != nullptr) v = __fdiv_rn(v, smooth[e % cols]);
      const bf16 h = hi_of(v);
      hi[e] = h;
      lo[e] = lo_of(v, h);
    }
  }
}

// ---------------------------------------------------------------------------
// dXs = dY @ W^T
// ---------------------------------------------------------------------------

constexpr int TPAIRS = KBT * (CH / 2) / THREADS;  // column pairs a thread decodes a stage
static_assert(KBT * (CH / 2) % THREADS == 0, "whole column pairs a thread");

struct TSmem {
  unsigned char a[NSTG][2][TILE * 128];  // dY hi / lo: rows m, CH columns n (swizzled)
  unsigned char w[2][2][TILE * 128];     // two buffers of W hi / lo: rows k, CH columns n
  uint8_t codes[NSTG][KBT * 4][CH];      // the tile's packed rows (<= 4 a k-block)
  uint32_t cb[KC];                       // the codebook's parts, hi | lo << 16
};

// Rows [r0, r0 + TILE) x columns [c0, c0 + 64) of an (R, C) bf16 plane into a
// swizzled tile; zeros outside. vec: 16-byte cp.async copies.
__device__ __forceinline__ void stage_swz(unsigned char* dst, const bf16* __restrict__ src, int r0,
                                          int c0, int R, int C, bool vec) {
  if (vec) {
#pragma unroll
    for (int s = 0; s < TILE * 8 / THREADS; ++s) {
      const int i = threadIdx.x + s * THREADS, r = i / 8, c = (i % 8) * 8;
      const bool ok = r0 + r < R && c0 + c < C;
      cp_async16(dst + swz(r, c), ok ? src + (int64_t)(r0 + r) * C + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * 64; i += THREADS) {
      const int r = i / 64, c = i % 64;
      *reinterpret_cast<bf16*>(dst + swz(r, c)) =
          (r0 + r < R && c0 + c < C) ? src[(int64_t)(r0 + r) * C + c0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// The tile's packed rows row0.. (NBITS a k-block) at columns n0.. into a
// ring slot; zeros past the packed rows or N. vec: 16-byte cp.async copies
// (N % 16 == 0, packed 16-byte aligned), else byte by byte, synchronously.
template <int NBITS>
__device__ __forceinline__ void stage_codes(uint8_t (*dst)[CH], const uint8_t* __restrict__ packed,
                                            int row0, int n0, int N, int packed_rows, bool vec) {
  constexpr int ROWS = KBT * NBITS;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * (CH / 16); i += THREADS) {
      const int r = i / (CH / 16), c = (i % (CH / 16)) * 16;
      const bool ok = row0 + r < packed_rows && n0 + c < N;
      cp_async16(&dst[r][c], ok ? packed + (int64_t)(row0 + r) * N + n0 + c : packed, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      dst[r][c] = (row0 + r < packed_rows && n0 + c < N) ? packed[(int64_t)(row0 + r) * N + n0 + c]
                                                         : 0;
    }
  }
}

// A thread's packed words of a staged slot: pair e = tid + r * THREADS is
// k-block e / (CH / 2) of the tile at columns 2 (e % (CH / 2)) + 0, 1 (a
// warp: one k-block, 64 neighbouring columns).
template <int NBITS>
__device__ __forceinline__ void t_words(uint32_t (&w)[TPAIRS][2], const uint8_t (*codes)[CH]) {
#pragma unroll
  for (int r = 0; r < TPAIRS; ++r) {
    const int e = threadIdx.x + r * THREADS, kb = e / (CH / 2), col = 2 * (e % (CH / 2));
    w[r][0] = w[r][1] = 0u;
#pragma unroll
    for (int b = 0; b < NBITS; ++b) {
      const uint32_t two = *reinterpret_cast<const uint16_t*>(&codes[kb * NBITS + b][col]);
      w[r][0] |= (two & 0xffu) << (8 * b);
      w[r][1] |= (two >> 8) << (8 * b);
    }
  }
}

// Those words decoded into a W stage: W[k][n - n0] = codebook[code] as hi
// and lo, two columns a 32-bit store; zeros past K or N.
template <int NBITS>
__device__ __forceinline__ void t_decode(TSmem& sm, int buf, const uint32_t (&w)[TPAIRS][2],
                                         int k0, int n0, int K, int N) {
#pragma unroll
  for (int r = 0; r < TPAIRS; ++r) {
    const int e = threadIdx.x + r * THREADS, kb = e / (CH / 2), col = 2 * (e % (CH / 2));
    const bool k_ok = k0 + kb * KB < K;  // K % 8 == 0: a k-block is whole or out
    const bool ok0 = k_ok && n0 + col < N, ok1 = k_ok && n0 + col + 1 < N;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const uint32_t t0 = ok0 ? sm.cb[code_of<NBITS>(w[r][0], kk)] : 0u;
      const uint32_t t1 = ok1 ? sm.cb[code_of<NBITS>(w[r][1], kk)] : 0u;
      const int at = swz(kb * KB + kk, col);
      *reinterpret_cast<uint32_t*>(&sm.w[buf][0][at]) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(&sm.w[buf][1][at]) = __byte_perm(t0, t1, 0x7632);
    }
  }
}

// dXs[m, k] = sum_n dY[m, n] W[k, n]. Block (x, y): channels x*TILE.., rows
// y*TILE..; warpgroup g owns rows 64 g.. of the tile, all its channels. Ring
// group c holds dY's stage c and the codes of stage c + 1; W(c + 1) is
// decoded while stage c's products run on the tensor cores.
template <int NBITS>
__global__ void __launch_bounds__(THREADS, 1)
lut_matmul_t_kernel(const bf16* __restrict__ dy_hi, const bf16* __restrict__ dy_lo,
                    const uint8_t* __restrict__ packed, const float* __restrict__ cb,
                    float* __restrict__ dxs, int M, int K, int N, int packed_rows, int vec,
                    int vec_codes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TSmem& sm = aligned_smem<TSmem>(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128;
  const int k0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE, row0 = k0 / KB * NBITS;
  const int nch = (N + CH - 1) / CH;
  if (tid < KC) {
    const float v = cb[tid];
    const bf16 h = hi_of(v), l = lo_of(v, h);
    sm.cb[tid] = (uint32_t)__bfloat16_as_ushort(h) | (uint32_t)__bfloat16_as_ushort(l) << 16;
  }
  auto stage = [&](int c) {  // group c: dY's stage c (if any) and the codes of c + 1
    if (c < nch) {
      stage_swz(sm.a[c % NSTG][0], dy_hi, m0, c * CH, M, N, vec);
      stage_swz(sm.a[c % NSTG][1], dy_lo, m0, c * CH, M, N, vec);
    }
    if (c + 1 < nch)
      stage_codes<NBITS>(sm.codes[(c + 1) % NSTG], packed, row0, (c + 1) * CH, N, packed_rows,
                         vec_codes);
  };
  stage_codes<NBITS>(sm.codes[0], packed, row0, 0, N, packed_rows, vec_codes);
#pragma unroll
  for (int s = 0; s < NSTG - 1; ++s) {
    stage(s);
    cp_commit();
  }
  uint32_t words[TPAIRS][2];
  cp_wait<NSTG - 2>();
  __syncthreads();  // group 0 and the codebook's parts
  t_words<NBITS>(words, sm.codes[0]);
  t_decode<NBITS>(sm, 0, words, k0, 0, K, N);

  float main_[64], corr[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) main_[i] = corr[i] = 0.f;
  for (int c = 0; c < nch; ++c) {
    cp_wait<NSTG - 2>();  // group c has landed (this thread's copies)
    fence_async_smem();    // ... and, with W(c), is visible to the tensor cores
    __syncthreads();       // ... for everyone's; stage c - 1 is consumed
    stage(c + NSTG - 1);
    cp_commit();
    if (c + 1 < nch) t_words<NBITS>(words, sm.codes[(c + 1) % NSTG]);
    const int s = c % NSTG, b = c & 1;
    const uint64_t ah = kdesc(sm.a[s][0] + wg * 64 * 128), al = kdesc(sm.a[s][1] + wg * 64 * 128);
    const uint64_t bh = kdesc(sm.w[b][0]), bl = kdesc(sm.w[b][1]);
    wg_fence();
    stage_products<0>(main_, corr, ah, al, bh, bl, 2);
    wg_commit();
    if (c + 1 < nch) t_decode<NBITS>(sm, b ^ 1, words, k0, (c + 1) * CH, K, N);
    wg_wait0();
  }

  // fragment j of the accumulators: rows 16 w + g (+ 8) of the warpgroup's 64,
  // channels 8 j + 2 t (+ 1)
  const int w = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = k0 + j * 8 + 2 * t;  // even, and K % 8 == 0: k + 1 < K too
    if (k >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * 64 + w * 16 + g + 8 * h;
      if (m < M)
        *reinterpret_cast<float2*>(&dxs[(int64_t)m * K + k]) =
            make_float2(main_[4 * j + 2 * h] + corr[4 * j + 2 * h],
                        main_[4 * j + 2 * h + 1] + corr[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// G = Xs^T @ dY, folded by code
// ---------------------------------------------------------------------------

// lut_codebook_grad's stages: CH rows m of Xs's 128 channels and of dY's 128
// columns, each as two 64-wide halves of 128-byte swizzled rows.
struct GStage {
  unsigned char xs[NSTG][2][2][CH * 128];  // Xs hi / lo, channel halves
  unsigned char dy[NSTG][2][2][CH * 128];  // dY hi / lo, column halves
};

// The epilogue's buffers reuse the ring once the contraction is done.
struct GFold {
  float bucket[THREADS][KC + 1];    // each thread's 16 bucket sums
  uint8_t packed[KBT * 4][TILE];    // the tile's packed bytes, NBITS rows a k-block
};

union GSmem {
  GStage st;
  GFold f;
};

// Rows [r0, r0 + CH) x columns [c0, c0 + 128) of an (R, C) bf16 plane into
// two swizzled halves; zeros outside. vec: 16-byte cp.async copies.
__device__ __forceinline__ void stage_mn(unsigned char (*dst)[CH * 128], const bf16* __restrict__ src,
                                         int r0, int c0, int R, int C, bool vec) {
  if (vec) {
#pragma unroll
    for (int s = 0; s < CH * 16 / THREADS; ++s) {
      const int i = threadIdx.x + s * THREADS, r = i / 16, c = (i % 16) * 8;
      const bool ok = r0 + r < R && c0 + c < C;
      cp_async16(dst[c / 64] + swz(r, c % 64), ok ? src + (int64_t)(r0 + r) * C + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < CH * 128; i += THREADS) {
      const int r = i / 128, c = i % 128;
      *reinterpret_cast<bf16*>(dst[c / 64] + swz(r, c % 64)) =
          (r0 + r < R && c0 + c < C) ? src[(int64_t)(r0 + r) * C + c0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Block (x, y): the (k, n) tile of G at channels y*128.., columns x*128..,
// summed over all M (in stages of CH rows, in order); warpgroup g owns
// channels 64 g.., all 128 columns. Writes the block's 16 bucket sums to
// part_cb[(y * gridDim.x + x) * 16 ..] and its channels' sums of G * W to
// part_rows[x * K + k].
template <int NBITS>
__global__ void __launch_bounds__(THREADS, 1)
lut_codebook_grad_kernel(const bf16* __restrict__ xs_hi, const bf16* __restrict__ xs_lo,
                         const bf16* __restrict__ dy_hi, const bf16* __restrict__ dy_lo,
                         const uint8_t* __restrict__ packed, const float* __restrict__ cb,
                         float* __restrict__ part_cb, float* __restrict__ part_rows, int M, int K,
                         int N, int packed_rows, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GSmem& sm = aligned_smem<GSmem>(smem_raw);
  __shared__ float cbs[KC];
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE;
  const int nch = (M + CH - 1) / CH;
  if (tid < KC) cbs[tid] = cb[tid];

  auto stage = [&](int s, int m0) {
    stage_mn(sm.st.xs[s][0], xs_hi, m0, k0, M, K, vec);
    stage_mn(sm.st.xs[s][1], xs_lo, m0, k0, M, K, vec);
    stage_mn(sm.st.dy[s][0], dy_hi, m0, n0, M, N, vec);
    stage_mn(sm.st.dy[s][1], dy_lo, m0, n0, M, N, vec);
  };
#pragma unroll
  for (int s = 0; s < NSTG - 1; ++s) {
    if (s < nch) stage(s, s * CH);
    cp_commit();
  }

  float main_[64], corr[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) main_[i] = corr[i] = 0.f;
  for (int c = 0; c < nch; ++c) {
    cp_wait<NSTG - 2>();
    fence_async_smem();
    __syncthreads();
    if (c + NSTG - 1 < nch) stage((c + NSTG - 1) % NSTG, (c + NSTG - 1) * CH);
    cp_commit();
    const int s = c % NSTG;
    const uint64_t ah = mndesc(sm.st.xs[s][0][wg], CH * 128), al = mndesc(sm.st.xs[s][1][wg], CH * 128);
    const uint64_t bh = mndesc(sm.st.dy[s][0][0], CH * 128), bl = mndesc(sm.st.dy[s][1][0], CH * 128);
    wg_fence();
    stage_products<1>(main_, corr, ah, al, bh, bl, 128);
    wg_commit();
    wg_wait0();
  }
  cp_wait<0>();
  __syncthreads();  // the ring is dead: the epilogue reuses it

  // the tile's packed bytes: NBITS rows of each of its KBT k-blocks
  for (int e = tid; e < KBT * NBITS * TILE; e += THREADS) {
    const int r = e / TILE, col = e % TILE;
    const int row = (k0 / KB) * NBITS + r, n = n0 + col;
    sm.f.packed[r][col] = (row < packed_rows && n < N) ? packed[(int64_t)row * N + n] : 0;
  }
  __syncthreads();

  // this thread's G by code: channel 64 wg + 16 w + 8 h + g is code g of
  // k-block 8 wg + 2 w + h; columns 8 j + 2 t + e
  constexpr int NC = 1 << NBITS;
  const int w = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float bucket[KC], rows[2];
#pragma unroll
  for (int cc = 0; cc < KC; ++cc) bucket[cc] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = 0.f;
    const int kb = wg * 8 + w * 2 + h;
    if (k0 + kb * KB + g >= K) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        if (n0 + col >= N) continue;
        uint32_t word = 0;
#pragma unroll
        for (int r = 0; r < NBITS; ++r) word |= (uint32_t)sm.f.packed[kb * NBITS + r][col] << (8 * r);
        const int code = code_of<NBITS>(word, g);
        const float v = main_[4 * j + 2 * h + e] + corr[4 * j + 2 * h + e];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          if (code == cc) bucket[cc] += v;
        rows[h] = fmaf(v, cbs[code], rows[h]);
      }
    }
  }
  // a channel's 4 lanes (t) fold by a fixed xor tree: all four hold its sum
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] += __shfl_xor_sync(0xffffffffu, rows[h], 1);
    rows[h] += __shfl_xor_sync(0xffffffffu, rows[h], 2);
    const int k = k0 + wg * 64 + w * 16 + 8 * h + g;
    if (t == 0 && k < K) part_rows[(int64_t)blockIdx.x * K + k] = rows[h];
  }
#pragma unroll
  for (int cc = 0; cc < KC; ++cc) sm.f.bucket[tid][cc] = bucket[cc];
  __syncthreads();
  if (tid < KC) {
    float s = 0.f;
    for (int th = 0; th < THREADS; ++th) s += sm.f.bucket[th][tid];
    part_cb[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * KC + tid] = s;
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

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool bad_shape(int M, int K, int N, int packed_rows, int nbits) {
  return M <= 0 || K <= 0 || N <= 0 || nbits < 2 || nbits > 4 ||
         (int64_t)packed_rows * 8 != (int64_t)K * nbits || (M + TILE - 1) / TILE > 65535 ||
         tiles(K) > 65535;
}

template <int NBITS>
int launch_t(const bf16* hi, const bf16* lo, const uint8_t* packed, const float* cb, float* dxs,
             int M, int K, int N, int packed_rows, cudaStream_t stream) {
  auto kernel = lut_matmul_t_kernel<NBITS>;
  if (int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)sizeof(TSmem) + 1024))
    return e;
  const int vec = N % 8 == 0 && aligned16(hi) && aligned16(lo);
  const int vec_codes = N % 16 == 0 && aligned16(packed);
  kernel<<<dim3((K + TILE - 1) / TILE, (M + TILE - 1) / TILE), THREADS, sizeof(TSmem) + 1024, stream>>>(
      hi, lo, packed, cb, dxs, M, K, N, packed_rows, vec, vec_codes);
  return (int)cudaGetLastError();
}

template <int NBITS>
int launch_grad(const bf16* xh, const bf16* xl, const bf16* dh, const bf16* dl,
                const uint8_t* packed, const float* cb, float* part_cb, float* part_rows, int M,
                int K, int N, int packed_rows, cudaStream_t stream) {
  auto kernel = lut_codebook_grad_kernel<NBITS>;
  if (int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)sizeof(GSmem) + 1024))
    return e;
  const int vec = N % 8 == 0 && aligned16(xh) && aligned16(xl) && aligned16(dh) && aligned16(dl);
  kernel<<<dim3(tiles(N), tiles(K)), THREADS, sizeof(GSmem) + 1024, stream>>>(
      xh, xl, dh, dl, packed, cb, part_cb, part_rows, M, K, N, packed_rows, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, cols) f32; smooth: (cols,) f32 or null; hi, lo: (rows, cols)
// bf16; all row-major and contiguous. Returns the launch's cudaError_t.
extern "C" int split_bf16_launch(const float* x, const float* smooth, void* hi, void* lo,
                                 long long rows, int cols, void* stream) {
  if (rows < 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)rows * cols;
  if (total == 0) return 0;
  const int vec4 = cols % 4 == 0 && aligned16(x) && aligned16(hi) && aligned16(lo) &&
                   (smooth == nullptr || aligned16(smooth));
  const int64_t work = vec4 ? total / 4 : total;
  const int blocks = (int)std::min<int64_t>((work + 255) / 256, 132 * 16);
  split_bf16_kernel<<<blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, smooth, static_cast<bf16*>(hi), static_cast<bf16*>(lo), total, cols, vec4);
  return (int)cudaGetLastError();
}

// dy_hi, dy_lo: (M, N) bf16, split_bf16 of dY; packed: (K*nbits/8, N) u8;
// cb: (16,) f32; dxs: (M, K) f32; all row-major and contiguous. Returns the
// launch's cudaError_t.
extern "C" int lut_matmul_t_launch(const void* dy_hi, const void* dy_lo, const uint8_t* packed,
                                   const float* cb, float* dxs, int M, int K, int N,
                                   int packed_rows, int nbits, void* stream) {
  if (bad_shape(M, K, N, packed_rows, nbits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* h = static_cast<const bf16*>(dy_hi);
  const bf16* l = static_cast<const bf16*>(dy_lo);
  switch (nbits) {
    case 2: return launch_t<2>(h, l, packed, cb, dxs, M, K, N, packed_rows, s);
    case 3: return launch_t<3>(h, l, packed, cb, dxs, M, K, N, packed_rows, s);
    default: return launch_t<4>(h, l, packed, cb, dxs, M, K, N, packed_rows, s);
  }
}

// Floats of lut_codebook_grad_launch's scratch for a K x N tile grid: 16 a
// block, then one a (column tile, channel).
extern "C" long long lut_codebook_grad_scratch_floats(int K, int N) {
  return (long long)tiles(N) * tiles(K) * KC + (long long)tiles(N) * K;
}

// xs_hi, xs_lo: (M, K) bf16, split_bf16 of Xs = x / smooth; dy_hi, dy_lo:
// (M, N) bf16; packed, cb as above; smooth: (K,) f32; dcb: (16,) f32;
// dsmooth: (K,) f32; scratch: lut_codebook_grad_scratch_floats(K, N) f32.
// Returns the launch's cudaError_t.
extern "C" int lut_codebook_grad_launch(const void* xs_hi, const void* xs_lo, const void* dy_hi,
                                        const void* dy_lo, const uint8_t* packed, const float* cb,
                                        const float* smooth, float* dcb, float* dsmooth,
                                        float* scratch, int M, int K, int N, int packed_rows,
                                        int nbits, void* stream) {
  if (bad_shape(M, K, N, packed_rows, nbits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xh = static_cast<const bf16*>(xs_hi);
  const bf16* xl = static_cast<const bf16*>(xs_lo);
  const bf16* dh = static_cast<const bf16*>(dy_hi);
  const bf16* dl = static_cast<const bf16*>(dy_lo);
  float* part_cb = scratch;
  const int blocks = tiles(N) * tiles(K);
  float* part_rows = scratch + (int64_t)blocks * KC;
  int e;
  switch (nbits) {
    case 2: e = launch_grad<2>(xh, xl, dh, dl, packed, cb, part_cb, part_rows, M, K, N, packed_rows, s); break;
    case 3: e = launch_grad<3>(xh, xl, dh, dl, packed, cb, part_cb, part_rows, M, K, N, packed_rows, s); break;
    default: e = launch_grad<4>(xh, xl, dh, dl, packed, cb, part_cb, part_rows, M, K, N, packed_rows, s);
  }
  if (e) return e;
  fold_codebook_kernel<<<1, KC * 32, 0, s>>>(part_cb, blocks, dcb);
  fold_smooth_kernel<<<(K + 255) / 256, 256, 0, s>>>(part_rows, tiles(N), smooth, dsmooth, K);
  return (int)cudaGetLastError();
}
