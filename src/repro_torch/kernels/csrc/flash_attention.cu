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
// pair; at D = 128 in bf16 the tensor cores would take 0.14 ms for a causal
// 4096 x 4096 x 32-head prefill. This first version runs on the CUDA cores
// in f32 (about 67 TFLOP/s at best), so it is far from that bound; it is the
// simple, right version that later work makes fast.
//
// The Pallas kernel had one program per (bh, bq query rows) and looped over
// bk-key tiles of K and V resident in VMEM. Here one thread block of 8 warps
// owns bq query rows of one bh and walks them in passes of R rows (R = min(bq,
// 64, 8192 / bk): the pass's scores of one bk step fit a 32 KB shared tile).
// Each softmax step takes bk keys, as the reference's does: K streams through
// shared memory in chunks of 64 keys (transposed, so lanes read neighbouring
// keys) and fills the R x bk score tile, each warp its R / 8 rows with lanes
// over keys; the step's row max, alpha and probabilities follow, then V
// streams through in the same chunks and each warp adds P V to its rows'
// accumulators, lanes over D. Every (bq, bk) the tuner proposes runs at
// D <= 256: shared memory is R * D + R * bk + 65 * D floats (99 KB at
// R = 64, D = 128). Steps masked for every row of a pass are skipped; for a
// row that sees any key that skip changes no bit (see above).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

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

}  // namespace

// q/out: (BH, Sq, D), k/v: (BH, Sk, D), all f32 or all bf16, contiguous.
// bq | Sq, bk | Sk, bk <= 8192, D <= 256. Returns the launch's cudaError_t
// (0 = ok).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 int is_bf16, int BH, int Sq, int Sk, int D, int bq, int bk,
                                 int causal, int window, float softcap, int q_offset, int k_len,
                                 void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 || bq <= 0 || bk <= 0 ||
      Sq % bq != 0 || Sk % bk != 0 || bk > SCORE_TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, D, bq, bk, causal, window, softcap,
                                   q_offset, k_len, st);
  return launch_d<float>(q, k, v, out, BH, Sq, Sk, D, bq, bk, causal, window, softcap, q_offset,
                         k_len, st);
}
