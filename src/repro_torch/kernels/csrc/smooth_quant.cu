// Standalone Eq. 11 input transformation: q = int8(clip(rint(x * inv[c]),
// -2^(b-1), 2^(b-1)-1)), x (M, C) f32 or bf16, inv (C,) f32, q (M, C) int8.
//
// Replaces the Pallas TPU kernel `smooth_quant` of the JAX package
// (src/repro/kernels/smooth_quant.py), which tiled (rows, channels) blocks
// with the channel scale broadcast along the channel axis of each block.
//
// What bounds it on an H100: bytes — each activation is read once (4 or 2
// bytes) and its code written once (1 byte); the C scales are read once per
// row but stay in L1/L2. There is no arithmetic to speak of. Design: a
// grid-stride loop in which each thread takes 16 bytes of x at once (4 f32
// or 8 bf16 values, one vector load) and stores their 4 or 8 codes in one
// store, when C is a multiple of that group and the pointers are aligned;
// otherwise one element per step. Rounding is rintf (half to even, as
// jnp.round) after an IEEE float32 multiply, so the codes are the
// reference's integers; the -2^(b-1) end of the clip is kept (this kernel,
// unlike the fused LUT kernels, does not clip symmetrically).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quant(float x, float inv, float qmin, float qmax) {
  const float v = fminf(fmaxf(rintf(__fmul_rn(x, inv)), qmin), qmax);
  return static_cast<int8_t>(static_cast<int>(v));
}

template <typename XT>
__global__ void __launch_bounds__(THREADS)
smooth_quant_kernel(const XT* __restrict__ x, const float* __restrict__ inv,
                    int8_t* __restrict__ q, int64_t total, int C, float qmin, float qmax) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride)
    q[i] = quant(to_float(x[i]), inv[i % C], qmin, qmax);
}

// VEC = 16 / sizeof(XT) elements per step; requires C % VEC == 0 and aligned
// pointers, so a group never crosses a row and its scales are contiguous.
template <typename XT>
__global__ void __launch_bounds__(THREADS)
smooth_quant_vec_kernel(const XT* __restrict__ x, const float* __restrict__ inv,
                        int8_t* __restrict__ q, int64_t groups, int C, float qmin, float qmax) {
  constexpr int VEC = 16 / sizeof(XT);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x; g < groups; g += stride) {
    const int64_t e = g * VEC;
    const int c0 = (int)(e % C);
    const uint4 raw = *reinterpret_cast<const uint4*>(x + e);
    const XT* xv = reinterpret_cast<const XT*>(&raw);
    uint32_t word[VEC / 4];
#pragma unroll
    for (int v = 0; v < VEC; v += 4) {
      const float4 s = *reinterpret_cast<const float4*>(inv + c0 + v);
      const uint32_t b0 = (uint8_t)quant(to_float(xv[v + 0]), s.x, qmin, qmax);
      const uint32_t b1 = (uint8_t)quant(to_float(xv[v + 1]), s.y, qmin, qmax);
      const uint32_t b2 = (uint8_t)quant(to_float(xv[v + 2]), s.z, qmin, qmax);
      const uint32_t b3 = (uint8_t)quant(to_float(xv[v + 3]), s.w, qmin, qmax);
      word[v / 4] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
    }
    if constexpr (VEC == 4)
      *reinterpret_cast<uint32_t*>(q + e) = word[0];
    else
      *reinterpret_cast<uint2*>(q + e) = make_uint2(word[0], word[1]);
  }
}

template <typename XT>
int launch(const XT* x, const float* inv, int8_t* q, int64_t M, int C, int bits,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(XT);
  const float qmin = -(float)(1 << (bits - 1));
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const int64_t total = M * C;
  const bool vec = (C % VEC == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(inv) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(q) % VEC == 0);
  const int64_t items = vec ? total / VEC : total;
  const int64_t want = (items + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 4096 ? want : 4096);
  if (vec)
    smooth_quant_vec_kernel<XT><<<blocks, THREADS, 0, stream>>>(x, inv, q, items, C, qmin, qmax);
  else
    smooth_quant_kernel<XT><<<blocks, THREADS, 0, stream>>>(x, inv, q, items, C, qmin, qmax);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, C) f32 or bf16 row-major; inv: (C,) f32; q: (M, C) int8; 1 <= bits <= 8.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int smooth_quant_launch(const void* x, int x_is_bf16, const float* inv, int8_t* q,
                                   long long M, int C, int bits, void* stream) {
  if (M <= 0 || C <= 0 || bits < 1 || bits > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(x), inv, q, (int64_t)M, C, bits, s);
  return launch(reinterpret_cast<const float*>(x), inv, q, (int64_t)M, C, bits, s);
}
