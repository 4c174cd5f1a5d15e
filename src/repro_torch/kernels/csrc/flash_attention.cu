// Online-softmax (flash) attention over (BH, S, D).
//
// Replaces the Pallas TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py): query row i of a (batch * head)
// sits at position q_offset + i and attends over the keys it may see —
// causal (j <= position), sliding window (position - j < window), live
// length (j < k_len) — with an optional logit softcap, in f32, out in q's
// dtype. Masked scores are the reference's finite -1e30, so a first step that
// is all masked for a row gives exp(0) = 1 junk that the next step's
// alpha = exp(-1e30 - m) = 0 wipes out, as in the reference (with -inf it
// would give NaN); a row that sees no key at all averages every value, as
// the reference does.
//
// What bounds it on an H100: operations, 4 * D per visible (query, key)
// pair; at D = 128 in bf16 the tensor cores bound a causal 4096 x 4096 x
// 32-head prefill at 0.14 ms (989 TFLOP/s), against 0.008 ms of bytes.
//
// Two kernels, chosen by dtype (a dispatch, not a fallback: a bf16 tensor
// never reaches the CUDA-core kernel, an f32 one never the tensor cores):
//
// bf16 — `flash_mma_kernel`, both products on the tensor cores. We use
//   `mma.sync.m16n8k16` (bf16 operands, f32 accumulators) rather than
//   `wgmma`: a warp owns 16 query rows, so the online softmax stays in the
//   accumulator fragments of one warp (row max, alpha and l with two quad
//   shuffles), and the same code serves every D <= 256 and every tile the
//   tuner proposes. A block of 8 warps walks its bq rows in passes of 128,
//   so each K / V chunk in shared memory serves 128 rows. K and V stream
//   through a ring of three stages in shared memory, filled with 16-byte
//   `cp.async` copies two chunks ahead of the arithmetic, one barrier per
//   chunk; rows are padded by 16 bytes so `ldmatrix` (Q, K) and
//   `ldmatrix.trans` (V) are free of bank conflicts. Every fragment of a
//   k-step is loaded before its products. S = Q K^T lands in f32
//   fragments; the 1/sqrt(D) scale is applied to S in f32 (the reference
//   scales in f32 too: scaling the bf16 q would round it once more), then
//   the softcap, log2 e (so each probability is one ex2) and the masks;
//   P = 2^(S - m) is split in registers into two bf16 parts, hi = bf16(P)
//   and lo = bf16(P - hi), the A operands of two products O += lo V + hi V,
//   with no trip through shared memory. The O rescale is skipped when no row
//   maximum of the warp moved. D is padded to 16 in shared memory with
//   zeros; keys past Sk are zeros with a score of -inf, so they add nothing,
//   not even to a row that sees no key.
//   What the H100 measurements chose (PERF.md): Q's fragments are read from
//   shared memory at each chunk rather than held in registers for the pass,
//   and the register budget is cut to 128 a thread (2 blocks, 16 warps an
//   SM at D <= 128): the kernel is bound by latency, and occupancy paid more
//   than registers did.
//   The softmax steps in the kernel's own key chunks (32 keys), not in bk
//   keys: on this path bk only has to divide Sk, as the reference asserts.
//   A pass walks the chunks from the first key any of its rows may see to
//   the last, and all of them when one of its rows sees no key; masks are
//   applied only to chunks that some row of the warp does not see whole.
//   The grid runs longest first: the late, most-loaded row blocks of every
//   head before the earlier ones (chip_smoke.py on an H100: 1.38 -> 1.13 ms
//   at llama2-7b's causal prefill against head-by-head order).
//   Why P is split: rounding P to bf16 costs at most 2^-9 relative per term,
//   so the output, a weighted mean of V, moves by up to 2^-9 max |v_i - out|.
//   That is below one bf16 ulp of the output only where |out| is comparable
//   to the values it averages; on a row that averages a few values far from
//   their mean it is several ulps of a small output (measured on the H100:
//   2^-6 at |out| ~ 0.5, 3.4 times the check's 2^-7 (|ref| + rms(ref))). With
//   hi + lo the weights carry about 2^-17 relative error, far below an ulp,
//   so an element differs from the plain version by the final rounding to
//   bf16 on both sides: at most one ulp, <= 2^-7 |ref|. The cost is a second
//   P V product: 1.5 times the tensor-core work of rounding P once.
//
// f32 — `flash_attn_kernel`, on the CUDA cores in f32 (TF32 would not hold
//   the reference's 2e-5). One thread block of 8 warps owns bq query rows of
//   one bh and walks them in passes of R rows (R = min(bq, 64, 8192 / bk):
//   the pass's scores of one bk step fit a 32 KB shared tile). Each softmax
//   step takes bk keys, as the reference's does: K streams through shared
//   memory in chunks of 64 keys (transposed, so lanes read neighbouring
//   keys) and fills the R x bk score tile, each warp its R / 8 rows with
//   lanes over keys; the step's row max, alpha and probabilities follow,
//   then V streams through in the same chunks and each warp adds P V to its
//   rows' accumulators, lanes over D. Every (bq, bk) the tuner proposes runs
//   at D <= 256: shared memory is R * D + R * bk + 65 * D floats (99 KB at
//   R = 64, D = 128). Steps masked for every row of a pass are skipped.
//
// Skipping key chunks or steps masked for every row changes no bit for a row
// that sees any key (see above).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;  // query rows per pass
constexpr int PAD = 8;            // bf16 of padding per shared-memory row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int KT = 32;            // keys per chunk, the softmax step
constexpr int NSTG = 3;           // stages of the K / V ring
constexpr int MIN_BLOCKS = 2;     // blocks per SM the register budget is cut for (D <= 128)

using hopper::cp_async16;
using hopper::cp_commit;
using hopper::cp_wait;
using hopper::smem_u32;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx: relative error below 2^-22; results below 2^-126 are 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows [r0, r0 + n) of a (rows_valid, D) bf16 matrix into a shared tile of n
// rows of stride st, channels padded with zeros to dp; rows at or past
// rows_valid are zeros. vec: 16-byte cp.async copies (D % 8 == 0, aligned);
// otherwise element by element, synchronously.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int n, int rows_valid, int D, int dp, int st,
                                          bool vec) {
  if (vec) {
    const int per_row = dp / 8;
    for (int c = threadIdx.x; c < n * per_row; c += THREADS) {
      const int r = c / per_row, d = (c % per_row) * 8;
      const bool ok = r0 + r < rows_valid && d < D;
      cp_async16(dst + r * st + d, ok ? src + (int64_t)(r0 + r) * D + d : src, ok);
    }
  } else {
    for (int c = threadIdx.x; c < n * dp; c += THREADS) {
      const int r = c / dp, d = c % dp;
      dst[r * st + d] = (r0 + r < rows_valid && d < D) ? src[(int64_t)(r0 + r) * D + d]
                                                      : __float2bfloat16(0.0f);
    }
  }
}

// DMAX: D rounded up to 64, 128 or 256 (the register arrays' extent)
template <int DMAX>
__global__ void __launch_bounds__(THREADS, DMAX <= 128 ? MIN_BLOCKS : 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Sk, int D,
                 int bq, int causal, int window, float softcap, int q_offset, int k_len,
                 float scale, int vec) {
  constexpr int NKS = DMAX / 16;  // k-steps of S over D
  constexpr int NDT = DMAX / 8;   // n-tiles of O over D
  constexpr int NST = KT / 8;     // n-tiles of S over a chunk's keys
  constexpr int VG = 4;           // V fragment loads in flight per group

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = (D + 15) & ~15;
  const int st = dp + PAD;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (ROWS, st)
  bf16* ks = qs + ROWS * st;                      // NSTG stages of (KT, st)
  bf16* vs = ks + NSTG * KT * st;                 // NSTG stages of (KT, st)

  const int nks = dp / 16, ndt = dp / 8;
  // late rows (most keys) first, across all heads: block i takes row block
  // nqb - 1 - i / nbh of head i % nbh, so the grid runs longest first
  const int nqb = Sq / bq;
  const int nbh = gridDim.x / nqb;
  const int bh = blockIdx.x % nbh;
  const int row0 = (nqb - 1 - blockIdx.x / nbh) * bq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int klim = k_len > 0 ? min(k_len, Sk) : Sk;
  const bf16* qb = q + (int64_t)bh * Sq * D;
  const bf16* kb = k + (int64_t)bh * Sk * D;
  const bf16* vb = v + (int64_t)bh * Sk * D;
  bf16* ob = out + (int64_t)bh * Sq * D;

  for (int p0 = 0; p0 < bq; p0 += ROWS) {
    const int rows = min(ROWS, bq - p0);
    const int qp0 = q_offset + row0 + p0;
    // the keys any row of the pass may see; all of them if some row sees none
    int lo = Sk, hi = 0;
    bool empty = false;
    for (int i = 0; i < rows; ++i) {
      const int qp = qp0 + i;
      const int kmin = window > 0 ? max(0, qp - window + 1) : 0;
      const int kmax = min(causal ? qp : Sk - 1, klim - 1);
      if (kmin > kmax) {
        empty = true;
      } else {
        lo = min(lo, kmin);
        hi = max(hi, kmax + 1);
      }
    }
    if (empty) {
      lo = 0;
      hi = Sk;
    }
    const int c_begin = (lo / KT) * KT;
    const int nchunks = (hi - c_begin + KT - 1) / KT;

    __syncthreads();  // the previous pass is done with qs, ks and vs
    load_rows(qs, qb, row0 + p0, ROWS, row0 + p0 + rows, D, dp, st, vec);
    cp_commit();
#pragma unroll
    for (int c = 0; c < NSTG - 1; ++c) {
      if (c < nchunks) {
        load_rows(ks + c * KT * st, kb, c_begin + c * KT, KT, Sk, D, dp, st, vec);
        load_rows(vs + c * KT * st, vb, c_begin + c * KT, KT, Sk, D, dp, st, vec);
      }
      cp_commit();
    }

    const bf16* qw = qs + warp * 16 * st;

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    float o[NDT][4];
#pragma unroll
    for (int n = 0; n < NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    // positions of this warp's first and last live rows
    const int wrows = max(1, min(16, rows - warp * 16));
    const int qmin = qp0 + warp * 16, qmax = qmin + wrows - 1;

    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c_begin + c * KT;
      cp_wait<NSTG - 2>();  // chunk c has landed (this thread's copies)
      __syncthreads();      // ... everyone's; chunk c - 1 is done with its stage
      if (c + NSTG - 1 < nchunks) {
        const int s1 = (c + NSTG - 1) % NSTG;
        load_rows(ks + s1 * KT * st, kb, c0 + (NSTG - 1) * KT, KT, Sk, D, dp, st, vec);
        load_rows(vs + s1 * KT * st, vb, c0 + (NSTG - 1) * KT, KT, Sk, D, dp, st, vec);
      }
      cp_commit();
      const bf16* kt_s = ks + (c % NSTG) * KT * st;
      const bf16* vt_s = vs + (c % NSTG) * KT * st;

      // S = Q K^T: thread holds rows g, g + 8 at keys 8j + 2t, 8j + 2t + 1
      float s[NST][4];
#pragma unroll
      for (int j = 0; j < NST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < NKS; ++kt) {
        if (kt < nks) {
          uint32_t a[4];
          ldsm_x4(a, qw + (lane % 16) * st + kt * 16 + (lane / 16) * 8);
          // every K fragment of this k-step first, then the products
          uint32_t b[NST / 2][4];
#pragma unroll
          for (int j = 0; j < NST; j += 2)
            ldsm_x4(b[j / 2], kt_s + (j * 8 + (lane / 16) * 8 + lane % 8) * st + kt * 16 +
                                  ((lane / 8) % 2) * 8);
#pragma unroll
          for (int j = 0; j < NST; j += 2) {
            mma16816(s[j], a, b[j / 2][0], b[j / 2][1]);
            mma16816(s[j + 1], a, b[j / 2][2], b[j / 2][3]);
          }
        }
      }

      // scale in f32, softcap, masks (only where some row of the warp does
      // not see the whole chunk); keys past Sk are -inf: they add nothing
      const bool whole = c0 + KT <= klim && (!causal || c0 + KT - 1 <= qmin) &&
                         (window <= 0 || qmax - c0 < window);
#pragma unroll
      for (int j = 0; j < NST; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
          x *= LOG2E;  // log2 units: each probability is one ex2
          if (!whole) {
            const int kp = c0 + j * 8 + 2 * t + (e & 1);
            const int qp = qmin + g + (e >> 1) * 8;
            bool keep = kp < klim;
            if (causal) keep = keep && qp >= kp;
            if (window > 0) keep = keep && qp - kp < window;
            x = kp >= Sk ? -INFINITY : (keep ? x : NEG_INF);
          }
          s[j][e] = x;
        }
      }

      // online softmax on the fragments: row h = 0 (g), 1 (g + 8)
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NST; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
      }
      // P as hi + lo bf16 parts (the A operands of P V); l sums P in f32
      uint32_t phi[NST][2], plo[NST][2];
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NST; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = ex2(s[j][2 * h] - m[h]);
          const float p1 = ex2(s[j][2 * h + 1] - m[h]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          phi[j][h] = *reinterpret_cast<const uint32_t*>(&hi);
          plo[j][h] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
          sum[h] += p0 + p1;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
      // once the row maxima settle, alpha is 1 for every row of the warp
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int n = 0; n < NDT; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }

      // O += P V: 16 keys per step, V fragments through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint32_t ah[4] = {phi[2 * kk][0], phi[2 * kk][1], phi[2 * kk + 1][0],
                                phi[2 * kk + 1][1]};
        const uint32_t al[4] = {plo[2 * kk][0], plo[2 * kk][1], plo[2 * kk + 1][0],
                                plo[2 * kk + 1][1]};
        // V fragments in groups of VG d-tile pairs, loaded before their products
#pragma unroll
        for (int n0 = 0; n0 < NDT; n0 += 2 * VG) {
          uint32_t b[VG][4];
#pragma unroll
          for (int g2 = 0; g2 < VG; ++g2)
            if (n0 + 2 * g2 < ndt)
              ldsm_x4_t(b[g2], vt_s + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * st +
                                   (n0 + 2 * g2) * 8 + (lane / 16) * 8);
#pragma unroll
          for (int g2 = 0; g2 < VG; ++g2) {
            const int n = n0 + 2 * g2;
            if (n < ndt) {
              mma16816(o[n], al, b[g2][0], b[g2][1]);
              mma16816(o[n + 1], al, b[g2][2], b[g2][3]);
            }
          }
#pragma unroll
          for (int g2 = 0; g2 < VG; ++g2) {
            const int n = n0 + 2 * g2;
            if (n < ndt) {
              mma16816(o[n], ah, b[g2][0], b[g2][1]);
              mma16816(o[n + 1], ah, b[g2][2], b[g2][3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      const float denom = fmaxf(lh, 1e-30f);
      const int r = warp * 16 + g + 8 * h;
      if (r >= rows) continue;
      bf16* orow = ob + (int64_t)(row0 + p0 + r) * D;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        const int d = n * 8 + 2 * t;
        if (n < ndt && d < D) {
          const float y0 = o[n][2 * h] / denom, y1 = o[n][2 * h + 1] / denom;
          if (d + 1 < D && (D % 2) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(y0, y1);
          } else {
            orow[d] = __float2bfloat16(y0);
            if (d + 1 < D) orow[d + 1] = __float2bfloat16(y1);
          }
        }
      }
    }
  }
}

// Shared memory of one block: the pass's Q tile and NSTG stages of K and V.
inline size_t smem_bytes(int D) {
  const int dp = (D + 15) & ~15;
  return sizeof(bf16) * (size_t)(ROWS + 2 * NSTG * KT) * (dp + PAD);
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Sq, int Sk, int D,
           int bq, int causal, int window, float softcap, int q_offset, int k_len,
           cudaStream_t stream) {
  auto kernel = flash_mma_kernel<DMAX>;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int64_t blocks = (int64_t)BH * (Sq / bq);
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
      reinterpret_cast<const bf16*>(v), reinterpret_cast<bf16*>(out), Sq, Sk, D, bq, causal,
      window, softcap, q_offset, k_len, 1.0f / sqrtf((float)D), vec);
  return (int)cudaGetLastError();
}

int launch_d(const void* q, const void* k, const void* v, void* out, int BH, int Sq, int Sk,
             int D, int bq, int causal, int window, float softcap, int q_offset, int k_len,
             cudaStream_t stream) {
  if (D <= 64)
    return launch<64>(q, k, v, out, BH, Sq, Sk, D, bq, causal, window, softcap, q_offset, k_len,
                      stream);
  if (D <= 128)
    return launch<128>(q, k, v, out, BH, Sq, Sk, D, bq, causal, window, softcap, q_offset,
                       k_len, stream);
  return launch<256>(q, k, v, out, BH, Sq, Sk, D, bq, causal, window, softcap, q_offset, k_len,
                     stream);
}

}  // namespace mma

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 64;          // keys per shared-memory chunk
constexpr int KCS = KC + 1;     // row stride of the transposed K chunk
constexpr int MAX_RW = 8;       // rows per warp (R <= 64)
constexpr int SCORE_TILE = 8192;  // R * bk floats
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ND: D / 32 rounded up, at most 4 (D <= 128) or 8 (D <= 256)
template <typename T, int ND>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int Sq, int Sk, int D, int bq, int bk, int R, int causal,
                  int window, float softcap, int q_offset, int k_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int DP = (D + 3) & ~3;
  float* qs = smem;             // (R, DP) q * scale, zero-padded
  float* ss = qs + R * DP;      // (R, bk) the step's scores, then probabilities
  float* cs = ss + R * bk;      // K chunk transposed (DP, KCS), or V chunk (KC, DP)

  const int nqb = Sq / bq;
  const int bh = blockIdx.x / nqb;
  const int row0 = (nqb - 1 - blockIdx.x % nqb) * bq;  // late rows (most keys) first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int RW = (R + WARPS - 1) / WARPS;
  const int klim = k_len > 0 ? min(k_len, Sk) : Sk;
  const T* qb = q + (int64_t)bh * Sq * D;
  const T* kb = k + (int64_t)bh * Sk * D;
  const T* vb = v + (int64_t)bh * Sk * D;
  T* ob = out + (int64_t)bh * Sq * D;

  for (int p0 = 0; p0 < bq; p0 += R) {
    const int rows = min(R, bq - p0);
    const int qp0 = q_offset + row0 + p0;  // position of the pass's first row
    // the keys any row of the pass may see; all of them if some row sees none
    int lo = Sk, hi = 0;
    bool empty = false;
    for (int i = 0; i < rows; ++i) {
      const int qp = qp0 + i;
      const int kmin = window > 0 ? max(0, qp - window + 1) : 0;
      const int kmax = min(causal ? qp : Sk - 1, klim - 1);
      if (kmin > kmax) {
        empty = true;
      } else {
        lo = min(lo, kmin);
        hi = max(hi, kmax + 1);
      }
    }
    if (empty) {
      lo = 0;
      hi = Sk;
    }

    __syncthreads();  // the previous pass is done with qs
    for (int idx = tid; idx < R * DP; idx += THREADS) {
      const int i = idx / DP, d = idx % DP;
      qs[idx] = (i < rows && d < D)
                    ? to_float(qb[(int64_t)(row0 + p0 + i) * D + d]) * scale
                    : 0.0f;
    }

    float m[MAX_RW], l[MAX_RW], acc[MAX_RW][ND];
#pragma unroll
    for (int i = 0; i < MAX_RW; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.0f;
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[i][e] = 0.0f;
    }

    for (int j = lo / bk; j < (hi + bk - 1) / bk; ++j) {
      const int k0 = j * bk;
      // scores of the step: lane -> keys lane and lane + 32 of each chunk
      for (int c0 = 0; c0 < bk; c0 += KC) {
        const int kc = min(KC, bk - c0);
        __syncthreads();
        for (int idx = tid; idx < kc * DP; idx += THREADS) {
          const int key = idx / DP, d = idx % DP;
          cs[d * KCS + key] = d < D ? to_float(kb[(int64_t)(k0 + c0 + key) * D + d]) : 0.0f;
        }
        __syncthreads();
        float sacc[MAX_RW][2];
#pragma unroll
        for (int i = 0; i < MAX_RW; ++i) sacc[i][0] = sacc[i][1] = 0.0f;
        for (int d = 0; d < DP; d += 4) {
          float ka[4], kb2[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = cs[(d + e) * KCS + lane];
            kb2[e] = cs[(d + e) * KCS + lane + 32];
          }
#pragma unroll
          for (int i = 0; i < MAX_RW; ++i) {
            const int r = warp * RW + i;
            if (i < RW && r < rows) {
              const float4 qv = *reinterpret_cast<const float4*>(qs + r * DP + d);
              sacc[i][0] = fmaf(qv.x, ka[0], sacc[i][0]);
              sacc[i][0] = fmaf(qv.y, ka[1], sacc[i][0]);
              sacc[i][0] = fmaf(qv.z, ka[2], sacc[i][0]);
              sacc[i][0] = fmaf(qv.w, ka[3], sacc[i][0]);
              sacc[i][1] = fmaf(qv.x, kb2[0], sacc[i][1]);
              sacc[i][1] = fmaf(qv.y, kb2[1], sacc[i][1]);
              sacc[i][1] = fmaf(qv.z, kb2[2], sacc[i][1]);
              sacc[i][1] = fmaf(qv.w, kb2[3], sacc[i][1]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MAX_RW; ++i) {
          const int r = warp * RW + i;
          if (!(i < RW && r < rows)) continue;
          const int qp = qp0 + r;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = lane + 32 * half;
            if (c >= kc) continue;
            const int kp = k0 + c0 + c;
            float sc = sacc[i][half];
            if (softcap > 0.0f) sc = softcap * tanhf(sc / softcap);
            bool keep = kp < klim;
            if (causal) keep = keep && qp >= kp;
            if (window > 0) keep = keep && qp - kp < window;
            ss[r * bk + c0 + c] = keep ? sc : NEG_INF;
          }
        }
      }
      __syncwarp();
      // the step's softmax update, per row
#pragma unroll
      for (int i = 0; i < MAX_RW; ++i) {
        const int r = warp * RW + i;
        if (!(i < RW && r < rows)) continue;
        float* sr = ss + r * bk;
        float mx = NEG_INF;
        for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, sr[c]);
        const float m_new = fmaxf(m[i], warp_max(mx));
        const float alpha = expf(m[i] - m_new);
        float sum = 0.0f;
        for (int c = lane; c < bk; c += 32) {
          const float p = expf(sr[c] - m_new);
          sr[c] = p;
          sum += p;
        }
        l[i] = l[i] * alpha + warp_sum(sum);
#pragma unroll
        for (int e = 0; e < ND; ++e) acc[i][e] *= alpha;
        m[i] = m_new;
      }
      __syncwarp();
      // acc += P V: lane -> channels lane + 32 * e
      for (int c0 = 0; c0 < bk; c0 += KC) {
        const int kc = min(KC, bk - c0);
        __syncthreads();
        for (int idx = tid; idx < kc * DP; idx += THREADS) {
          const int key = idx / DP, d = idx % DP;
          cs[key * DP + d] = d < D ? to_float(vb[(int64_t)(k0 + c0 + key) * D + d]) : 0.0f;
        }
        __syncthreads();
        for (int c = 0; c < kc; ++c) {
          float vv[ND];
#pragma unroll
          for (int e = 0; e < ND; ++e) {
            const int d = lane + 32 * e;
            vv[e] = d < D ? cs[c * DP + d] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < MAX_RW; ++i) {
            const int r = warp * RW + i;
            if (!(i < RW && r < rows)) continue;
            const float p = ss[r * bk + c0 + c];
#pragma unroll
            for (int e = 0; e < ND; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < MAX_RW; ++i) {
      const int r = warp * RW + i;
      if (!(i < RW && r < rows)) continue;
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        const int d = lane + 32 * e;
        if (d < D) store(ob + (int64_t)(row0 + p0 + r) * D + d, acc[i][e] / denom);
      }
    }
  }
}

template <typename T, int ND>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Sq, int Sk, int D,
           int bq, int bk, int causal, int window, float softcap, int q_offset, int k_len,
           cudaStream_t stream) {
  auto kernel = flash_attn_kernel<T, ND>;
  const int R = std::min(std::min(bq, WARPS * MAX_RW), SCORE_TILE / bk);
  const int DP = (D + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)R * DP + (size_t)R * bk + (size_t)DP * KCS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (int64_t)BH * (Sq / bq);
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), reinterpret_cast<T*>(out), Sq, Sk, D, bq, bk, R, causal,
      window, softcap, q_offset, k_len, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH, int Sq, int Sk,
             int D, int bq, int bk, int causal, int window, float softcap, int q_offset,
             int k_len, cudaStream_t stream) {
  if (D <= 128)
    return launch<T, 4>(q, k, v, out, BH, Sq, Sk, D, bq, bk, causal, window, softcap, q_offset,
                        k_len, stream);
  return launch<T, 8>(q, k, v, out, BH, Sq, Sk, D, bq, bk, causal, window, softcap, q_offset,
                      k_len, stream);
}

}  // namespace f32
}  // namespace

// q/out: (BH, Sq, D), k/v: (BH, Sk, D), all f32 or all bf16, contiguous.
// bq | Sq, bk | Sk, D <= 256; f32 also bk <= 8192. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 int is_bf16, int BH, int Sq, int Sk, int D, int bq, int bk,
                                 int causal, int window, float softcap, int q_offset, int k_len,
                                 void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 || bq <= 0 || bk <= 0 ||
      Sq % bq != 0 || Sk % bk != 0 || (!is_bf16 && bk > f32::SCORE_TILE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return mma::launch_d(q, k, v, out, BH, Sq, Sk, D, bq, causal, window, softcap, q_offset,
                         k_len, st);
  return f32::launch_d<float>(q, k, v, out, BH, Sq, Sk, D, bq, bk, causal, window, softcap,
                              q_offset, k_len, st);
}
