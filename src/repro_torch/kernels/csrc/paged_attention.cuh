// The per-query-row body shared by the paged attention kernels: B5
// (paged_attention.cu, keys read from the block pools through the block
// tables) and B8 (paged_dequant.cu, keys read from a gathered int8 view).
//
// One warp owns one query row; its lanes split D (lane + 32 * i). Keys are
// taken one at a time in key order, and the softmax state is updated after
// each: running max m, running sum l, accumulator acc. Every floating-point
// step is an explicit intrinsic (fmaf, __fmul_rn, __fsub_rn, __fdiv_rn), so
// the compiler has no contraction left to choose: a row fed the same keys in
// the same order gets the same bits from either kernel and whatever the
// staging around the body looks like.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pattn {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DV = 8;  // D <= 256, D % 32 == 0

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// codes * per-(token, head) scale * per-(head, channel) smoothing, rounded
// after each multiply
__device__ __forceinline__ float dequant(float code, float scale, float smooth) {
  return __fmul_rn(__fmul_rn(code, scale), smooth);
}

// Query row at position q_pos of a slot with `total` = length + n_new keys
// sees column col iff col < total, col <= q_pos and, with a window,
// q_pos - col < window.
__device__ __forceinline__ bool visible(int col, int total, int q_pos, int window) {
  return col < total && q_pos >= col && (window <= 0 || q_pos - col < window);
}

struct Row {
  float q[MAX_DV], acc[MAX_DV];
  float m, l;
};

template <typename QT>
__device__ __forceinline__ void load_row(Row& r, const QT* q_row, bool active, int nd, int lane) {
#pragma unroll
  for (int i = 0; i < MAX_DV; ++i) {
    r.acc[i] = 0.0f;
    r.q[i] = (active && i < nd) ? to_float(q_row[lane + 32 * i]) : 0.0f;
  }
  r.m = -1e30f;
  r.l = 0.0f;
}

// One key: kval(i) / vval(i) give the key's and the value's element
// lane + 32 * i as f32.
template <typename KF, typename VF>
__device__ __forceinline__ void attend(Row& r, int nd, float scale, float softcap, KF kval,
                                       VF vval) {
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_DV; ++i)
    if (i < nd) part = fmaf(r.q[i], kval(i), part);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  float sc = __fmul_rn(part, scale);
  if (softcap > 0.0f) sc = __fmul_rn(softcap, tanhf(__fdiv_rn(sc, softcap)));
  const float m_new = fmaxf(r.m, sc);
  const float alpha = expf(__fsub_rn(r.m, m_new));
  const float p = expf(__fsub_rn(sc, m_new));
  r.l = fmaf(r.l, alpha, p);
#pragma unroll
  for (int i = 0; i < MAX_DV; ++i)
    if (i < nd) r.acc[i] = fmaf(p, vval(i), __fmul_rn(r.acc[i], alpha));
  r.m = m_new;
}

// acc / max(l, 1e-30): a row that saw no key has acc = 0 and gives 0.
template <typename QT>
__device__ __forceinline__ void store_row(const Row& r, QT* out_row, int nd, int lane) {
  const float denom = fmaxf(r.l, 1e-30f);
#pragma unroll
  for (int i = 0; i < MAX_DV; ++i)
    if (i < nd) store(out_row + lane + 32 * i, __fdiv_rn(r.acc[i], denom));
}

}  // namespace pattn
