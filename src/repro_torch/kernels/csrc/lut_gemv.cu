// Fused smooth(+quant)+LUT GEMV for decode (M < 128 rows).
//
// Replaces the Pallas TPU kernel `lut_matmul_fused_gemv` of the JAX package
// (src/repro/kernels/lut_matmul.py): Y = T(x) @ codebook[codes] with the
// Eq. 11 transform T applied on the fly and the weights streamed as packed
// 2/3/4-bit centroid codes.
//
// What bounds it on an H100: the packed-code bytes, K*N*nbits/8, which are
// read once from device memory; x, inv and the codebook are tiny beside them.
// The Pallas body carried an f32 accumulator across a sequential K grid; here
// K is split 64 ways INSIDE a thread block (lut_common.cuh, the canonical
// order), so that a 32-column strip of the output keeps 512 threads streaming
// codes, and the ways are folded in a fixed order through shared memory: no
// atomics, a row's result depends on that row alone and is the same bits the
// GEMM kernel gives. Threads run along N (4 columns each, one 4-byte load per
// packed row), the codebook lookup is a 16-entry shared-memory table read,
// and ragged M, N and the K tail are masked here.
#include "lut_common.cuh"

namespace {

using namespace lut;

constexpr int MT = 8;              // rows per thread block
constexpr int CT = 4;              // columns per thread
constexpr int TN = 8;              // threads along N
constexpr int BN = TN * CT;        // 32 columns per thread block
constexpr int THREADS = TN * WAYS; // 512
constexpr int KROUND = WAYS * KB;  // 512 input channels per round
constexpr int RED_WAYS = 16;       // ways folded per reduction pass

template <int NBITS, typename XT, bool QUANT>
__global__ void __launch_bounds__(THREADS)
lut_gemv_kernel(const XT* __restrict__ x, const float* __restrict__ inv,
                const uint8_t* __restrict__ packed, const float* __restrict__ cb,
                float* __restrict__ y, int M, int K, int N, int packed_rows, int vec_ok) {
  __shared__ float cb_s[KC];
  __shared__ __align__(16) float buf[MT * KROUND];  // x tile, then reduction scratch

  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int tk = tid / TN;  // this thread's way
  const int m0 = blockIdx.y * MT;
  const int nblock0 = blockIdx.x * BN;
  const int n0 = nblock0 + tn * CT;
  const int nblk = (K + KB - 1) / KB;
  const int rounds = (nblk + WAYS - 1) / WAYS;

  if (tid < KC) cb_s[tid] = cb[tid];

  float acc[MT][CT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[m][c] = 0.0f;

  const bool vec = vec_ok && (n0 + CT <= N);

  // Operands of the NEXT round are fetched into registers before this round's
  // arithmetic, so that the latency of device memory hides behind it; nothing
  // is done to a fetched value before the round that uses it.
  XT xraw[MT];            // x[m0 + m, r*KROUND + tid]
  float iv = 0.0f;        // inv[r*KROUND + tid]
  uint32_t raw[NBITS];    // packed rows of this way's k-block, 4 columns each (vec)
  uint32_t wordn[CT];     // the same, column by column (ragged N or unaligned)
  auto fetch = [&](int r) {
    const int k = r * KROUND + tid;
    if (k < K) {
      iv = inv[k];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < M) xraw[m] = x[(int64_t)(m0 + m) * K + k];
    }
    const int b = r * WAYS + tk;
    if (b >= nblk) return;
    if (vec) {
#pragma unroll
      for (int rr = 0; rr < NBITS; ++rr) {
        const int row = b * NBITS + rr;
        raw[rr] = (row < packed_rows)
                      ? *reinterpret_cast<const uint32_t*>(packed + (int64_t)row * N + n0)
                      : 0u;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c)
        wordn[c] = (n0 + c < N) ? load_word<NBITS>(packed, N, packed_rows, b, n0 + c) : 0u;
    }
  };

  fetch(0);
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();
    {  // stage T(x) for channels [r*KROUND, (r+1)*KROUND): thread tid owns channel tid
      const int k = r * KROUND + tid;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float v = 0.0f;
        if (k < K && m0 + m < M) v = transform<QUANT>(to_float(xraw[m]), iv);
        buf[m * KROUND + tid] = v;
      }
    }
    const int b = r * WAYS + tk;
    uint32_t word[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      word[c] = 0;
      if (b < nblk) {
        if (vec) {
#pragma unroll
          for (int rr = 0; rr < NBITS; ++rr) word[c] |= ((raw[rr] >> (8 * c)) & 0xFFu) << (8 * rr);
        } else {
          word[c] = wordn[c];
        }
      }
    }
    __syncthreads();
    if (r + 1 < rounds) fetch(r + 1);
    if (b >= nblk) continue;
    const int kvalid = min(KB, K - b * KB);

    float w[CT][KB];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) w[c][kk] = cb_s[code_of<NBITS>(word[c], kk)];

#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 xa = *reinterpret_cast<const float4*>(&buf[m * KROUND + tk * KB]);
      const float4 xb = *reinterpret_cast<const float4*>(&buf[m * KROUND + tk * KB + 4]);
      const float xv[KB] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      if (kvalid == KB) {
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) acc[m][c] = fmaf(xv[kk], w[c][kk], acc[m][c]);
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int kk = 0; kk < KB; ++kk)
            if (kk < kvalid) acc[m][c] = fmaf(xv[kk], w[c][kk], acc[m][c]);
      }
    }
  }

  // ordered fold of the WAYS way results: way 0 first, from +0
  float total = 0.0f;
  const int om = tid / BN;   // owner threads: tid < MT*BN
  const int oc = tid % BN;
  for (int p = 0; p < WAYS / RED_WAYS; ++p) {
    __syncthreads();
    if (tk / RED_WAYS == p) {
      const int j = tk % RED_WAYS;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CT; ++c) buf[(j * MT + m) * BN + tn * CT + c] = acc[m][c];
    }
    __syncthreads();
    if (tid < MT * BN) {
#pragma unroll
      for (int j = 0; j < RED_WAYS; ++j) total += buf[(j * MT + om) * BN + oc];
    }
  }
  if (tid < MT * BN && m0 + om < M && nblock0 + oc < N)
    y[(int64_t)(m0 + om) * N + nblock0 + oc] = total;
}

template <int NBITS, typename XT>
void launch_q(const XT* x, const float* inv, const uint8_t* packed, const float* cb, float* y, int M,
              int K, int N, int packed_rows, int quantize, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  const int vec_ok = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(packed) % 4 == 0);
  if (quantize)
    lut_gemv_kernel<NBITS, XT, true><<<grid, THREADS, 0, stream>>>(x, inv, packed, cb, y, M, K, N,
                                                                   packed_rows, vec_ok);
  else
    lut_gemv_kernel<NBITS, XT, false><<<grid, THREADS, 0, stream>>>(x, inv, packed, cb, y, M, K, N,
                                                                    packed_rows, vec_ok);
}

template <typename XT>
int launch_bits(const XT* x, const float* inv, const uint8_t* packed, const float* cb, float* y,
                int M, int K, int N, int packed_rows, int nbits, int quantize, cudaStream_t stream) {
  switch (nbits) {
    case 2: launch_q<2, XT>(x, inv, packed, cb, y, M, K, N, packed_rows, quantize, stream); break;
    case 3: launch_q<3, XT>(x, inv, packed, cb, y, M, K, N, packed_rows, quantize, stream); break;
    case 4: launch_q<4, XT>(x, inv, packed, cb, y, M, K, N, packed_rows, quantize, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) f32 or bf16, row-major; inv: (K,) f32; packed: (K*nbits/8, N) u8;
// cb: (16,) f32; y: (M, N) f32. Returns the launch's cudaError_t (0 = ok).
extern "C" int lut_gemv_launch(const void* x, int x_is_bf16, const float* inv,
                               const uint8_t* packed, const float* cb, float* y, int M, int K,
                               int N, int packed_rows, int nbits, int quantize, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_bits(reinterpret_cast<const __nv_bfloat16*>(x), inv, packed, cb, y, M, K, N,
                       packed_rows, nbits, quantize, s);
  return launch_bits(reinterpret_cast<const float*>(x), inv, packed, cb, y, M, K, N, packed_rows,
                     nbits, quantize, s);
}
