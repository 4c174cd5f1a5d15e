// The block body shared by the paged attention kernels: B5
// (paged_attention.cu, keys read from the block pools through the block
// tables) and B8 (paged_dequant.cu, keys read from a gathered int8 view),
// the counterparts of the Pallas kernels `paged_pool_attention` and
// `paged_dequant_attention` (src/repro/kernels/paged_attention.py). Both are
// bound by the bytes of the keys their rows see, so the body reads each key
// once per block and keeps a warp on 32 keys at a time (below).
//
// The canonical per-row key order. A query row's result is defined by its
// own q, the values of the keys it sees and D alone, never by T, S, the
// grid, the rows of a thread block, the warps, the pool's block size, the
// stage length or B8's l_pad:
//
//   1. Keys are cut into chunks of CHUNK = 32 consecutive key indices,
//      chunk c covering keys [32 c, 32 c + 32) — the segment of the order.
//   2. A chunk's partial (m_c, l_c, pv) is a fresh softmax over the row's
//      visible keys in it. Key 32 c + j belongs to lane j: its score is
//      q . k over d in eight fmaf chains (chain u takes d = 8 i + u in
//      increasing i), summed ((s0+s1)+(s2+s3))+((s4+s5)+(s6+s7)), times
//      1/sqrt(D), then the softcap. m_c is the max of the visible scores
//      (a max tree over the lanes), p_j = exp(score_j - m_c) for a visible
//      key and 0 for another, l_c the sum of p over an xor-shuffle tree of
//      the lanes (16, 8, 4, 2, 1), and pv[d] an fmaf chain over the chunk's
//      32 keys in key order, from 0.
//   3. The chunk partials are folded left in chunk order into the row's
//      state (m, l, acc), starting from (-1e30, 0, 0), with one formula:
//        M = max(m, m_c), a = exp(m - M), b = exp(m_c - M),
//        l = fmaf(l_c, b, l * a), acc = fmaf(pv, b, acc * a), m = M.
//   4. The row's output is acc / max(l, 1e-30): a row that sees no key
//      gives 0.
//
// A chunk with no visible key for a row may be skipped, and a kernel skips
// it whenever no row of a warp's group sees it: its partial is (-1e30, 0,
// 0), so b = exp(-1e30 - m) = 0 and a = 1 once the row has seen a key
// (l = fmaf(0, 0, l * 1) = l, acc likewise), and a = b = 1 with l = acc = 0
// before; either way no bit moves. Every step is an explicit intrinsic
// (fmaf, __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so the compiler has no
// contraction left to choose: the same row gets the same bits from B5 and
// B8, from a width-1 and a width-32 launch, whatever the tiling.
//
// The work. One thread block of 8 warps owns up to 32 query rows of one
// (slot, kv-head). It stages the keys its rows can see, a stage of
// `stage_keys` (a multiple of 32) at a time, K and V in their stored type
// (int8 codes with their scales), through a ring of two buffers filled by
// 16-byte cp.async copies, so the next stage's copies overlap this one's
// arithmetic (deeper rings measured no faster on an H100); each key is read from device memory once per block. The rows
// form groups of rg rows: 1 up to R = 8, 2 up to 16, then 4. With more than 4
// groups, or 4 rows a group, each warp owns one group and walks its chunks
// in order, folding in registers; a warp computes a chunk for its rg rows
// together, each key element read from shared memory once for all of them.
// With R <= 4 rows (decode) the W = 8 / R warps of a row split each stage's
// chunks, write their partials to shared memory, and one warp folds them in
// chunk order after the next barrier. A tile's rows of a GQA group share
// the staged keys. The kernels are instantiated per pool type, rg and D:
// D = 128 (the D of every configuration the port serves) with D / 32 = 4 at
// compile time, any other D with D / 32 read at run time; q and out are f32
// or bf16 at run time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace pattn {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 32;      // keys per chunk: the segment of the canonical order
constexpr int MAX_DV = 8;      // D <= 256, D % 32 == 0: columns per lane
constexpr int MAX_ROWS = 32;   // query rows of one thread block
constexpr int MAX_RG = 4;      // rows of one warp's group
constexpr int ROW_PAD = 16;    // bytes after each staged key row: lanes on distinct banks
constexpr int STAGES = 2;      // buffers of the ring
constexpr size_t SMEM_LIMIT = 232448;  // shared memory one thread block may use on an H100

// two blocks an SM (at most 128 registers a thread) for the D = 128
// instances; the run-time-D ones keep their registers
constexpr int min_blocks(int nd) { return nd == 4 ? 2 : 1; }

__host__ __device__ inline bool plan_ok(int rows, int stage_keys) {
  return rows >= 1 && rows <= MAX_ROWS && stage_keys >= CHUNK && stage_keys % CHUNK == 0;
}

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

// 8 consecutive elements of a staged row as f32 (exact conversions)
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&o)[8]) {
  const int2 u = *reinterpret_cast<const int2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = (float)(int8_t)(u.x >> (8 * i));
    o[4 + i] = (float)(int8_t)(u.y >> (8 * i));
  }
}

// The block's geometry and its shared-memory carve, the same arithmetic as
// kernels/paged_attention.py pool_plan.
struct Plan {
  int rows;        // R: query rows of a block
  int rg;          // rows of a warp's group: 1 (R <= 8), 2 (R <= 16) or MAX_RG
  int groups;      // G = ceil(R / rg)
  int split;       // W: warps per group (W > 1 only when R <= 4, and then rg = 1)
  int stage_keys;  // keys per stage, a multiple of CHUNK
  int row_bytes;   // one staged key row: D * sizeof(KT) + ROW_PAD
  size_t smem;     // bytes
};

__host__ __device__ inline Plan make_plan(int rows, int stage_keys, int D,
                                          int elt_bytes, bool int8) {
  Plan p;
  p.rows = rows;
  p.rg = rows <= 8 ? 1 : rows <= 16 ? 2 : MAX_RG;
  p.groups = (rows + p.rg - 1) / p.rg;
  p.split = (p.rg == 1 && p.groups <= 4) ? WARPS / p.groups : 1;
  p.stage_keys = stage_keys;
  p.row_bytes = D * elt_bytes + ROW_PAD;
  const int cps = stage_keys / CHUNK;
  size_t floats = (size_t)p.groups * p.rg * D       // q tile, f32, whole groups
                  + (size_t)WARPS * MAX_RG * CHUNK  // p of each warp's chunk
                  + (int8 ? D : 0)                  // K smoothing of the head
                  + (p.split > 1 ? (size_t)2 * p.groups * cps * (D + 4) : 0);  // partials
  p.smem = floats * 4 + (size_t)STAGES * (2 * (size_t)stage_keys * p.row_bytes +
                                          (int8 ? 2 * (size_t)stage_keys * 4 : 0));
  return p;
}

// a row sees keys [lo, hi); an idle row has lo = hi = 0
__device__ __forceinline__ bool chunk_seen(int c0, int lo, int hi) {
  return max(lo, c0) < min(hi, c0 + CHUNK);
}

// Columns per lane: ND = D / 32 at compile time, or 0 for any D % 32 == 0
// up to 256 (the count is then read at run time, each column guarded).
template <int ND>
struct Cols {
  static constexpr int N = ND ? ND : MAX_DV;
  __device__ __forceinline__ static bool has(int i, int nd) { return ND ? i < ND : i < nd; }
};

// the fold of a chunk partial into a row's state (the order's step 3)
template <int ND, typename PV>
__device__ __forceinline__ void fold(float& m, float& l, float (&acc)[Cols<ND>::N], float mc,
                                     float lc, PV pv, int nd) {
  const float M = fmaxf(m, mc);
  const float a = expf(__fsub_rn(m, M));
  const float b = expf(__fsub_rn(mc, M));
  l = fmaf(lc, b, __fmul_rn(l, a));
#pragma unroll
  for (int i = 0; i < Cols<ND>::N; ++i)
    if (Cols<ND>::has(i, nd)) acc[i] = fmaf(pv(i), b, __fmul_rn(acc[i], a));
  m = M;
}

// The order's step 2 for the RG rows of a warp's group over the chunk whose
// first key is c0, staged at kst / vst (rows of row_bytes; int8: scales ksc
// / vsc). q_s holds the group's rows (f32, stride D; an idle row is zeros
// with lo = hi = 0, so its p is 0 and nothing reads its result); lo / hi
// each row's visible keys; pbuf the warp's (RG, 32) scratch.
template <typename KT, bool INT8, int RG, int ND>
__device__ __forceinline__ void chunk_partial(const float* q_s, const int (&lo)[RG],
                                              const int (&hi)[RG], int c0,
                                              const unsigned char* kst,
                                              const unsigned char* vst, int row_bytes,
                                              const float* ksc, const float* vsc,
                                              const float* ksm_s,
                                              const float (&vsm)[Cols<ND>::N], int D,
                                              float scale, float softcap, float* pbuf, int lane,
                                              float (&mc)[RG], float (&lc)[RG],
                                              float (&pv)[RG][Cols<ND>::N]) {
  constexpr int NC = Cols<ND>::N;
  const int nd = ND ? ND : D / 32;
  const int DD = ND ? 32 * ND : D;
  {
    float part[RG][8];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int u = 0; u < 8; ++u) part[r][u] = 0.0f;
    const KT* krow = reinterpret_cast<const KT*>(kst + lane * row_bytes);
    const float ks = INT8 ? ksc[lane] : 0.0f;
#pragma unroll 4
    for (int d0 = 0; d0 < DD; d0 += 8) {
      float kf[8];
      load8(krow + d0, kf);
      if (INT8) {
        float sm[8];
        load8(ksm_s + d0, sm);
#pragma unroll
        for (int u = 0; u < 8; ++u) kf[u] = dequant(kf[u], ks, sm[u]);
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float qf[8];
        load8(q_s + r * DD + d0, qf);
#pragma unroll
        for (int u = 0; u < 8; ++u) part[r][u] = fmaf(qf[u], kf[u], part[r][u]);
      }
    }
    const int c = c0 + lane;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float sc = __fadd_rn(__fadd_rn(__fadd_rn(part[r][0], part[r][1]),
                                     __fadd_rn(part[r][2], part[r][3])),
                           __fadd_rn(__fadd_rn(part[r][4], part[r][5]),
                                     __fadd_rn(part[r][6], part[r][7])));
      sc = __fmul_rn(sc, scale);
      if (softcap > 0.0f) sc = __fmul_rn(softcap, tanhf(__fdiv_rn(sc, softcap)));
      const bool vis = c >= lo[r] && c < hi[r];
      float x = vis ? sc : -1e30f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
      mc[r] = x;
      const float p = vis ? expf(__fsub_rn(sc, x)) : 0.0f;
      pbuf[r * CHUNK + lane] = p;
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, o));
      lc[r] = ps;
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) pv[r][i] = 0.0f;
#pragma unroll 2
  for (int j0 = 0; j0 < CHUNK; j0 += 4) {
    float4 p4[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) p4[r] = *reinterpret_cast<const float4*>(pbuf + r * CHUNK + j0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
      const KT* vrow = reinterpret_cast<const KT*>(vst + j * row_bytes) + lane;
      const float vs = INT8 ? vsc[j] : 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (Cols<ND>::has(i, nd)) {
          float v = to_float(vrow[32 * i]);
          if (INT8) v = dequant(v, vs, vsm[i]);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const float p = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y : jj == 2 ? p4[r].z : p4[r].w;
            pv[r][i] = fmaf(p, v, pv[r][i]);
          }
        }
      }
    }
  }
  __syncwarp();  // pbuf is rewritten by the warp's next chunk
}

// Where a block's keys come from: key c's K / V row of head h (D elements)
// and, for int8, its scales. B5 reads them through the block table, B8 from
// the gathered view.
template <typename KT>
struct PoolSrc {
  const KT* k;
  const KT* v;
  const float* ks;
  const float* vs;
  const int* table;  // the slot's row of the block table
  int nb, bs, KV, h;
  __device__ __forceinline__ int64_t row(int c) const {
    int bid = __ldg(table + c / bs);
    bid = min(max(bid, 0), nb - 1);
    return ((int64_t)bid * bs + c % bs) * KV + h;
  }
};

template <typename KT>
struct ViewSrc {
  const KT* k;
  const KT* v;
  const float* ks;
  const float* vs;
  int64_t base;  // s * L
  int KV, h;
  __device__ __forceinline__ int64_t row(int c) const { return (base + c) * KV + h; }
};

// Stage keys [c_start, c_start + stage_keys) (those >= c_end are zero-filled)
// into buffer `buf`: every thread issues its share of 16-byte copies. The
// rows' addresses (a block-table read each for B5) are read for a batch of
// copies before any of them is issued, so the table reads overlap.
template <typename KT, bool INT8, class Src>
__device__ __forceinline__ void issue_stage(const Src& src, int c_start, int c_end,
                                            unsigned char* buf, const Plan& pl, int D, int tid) {
  constexpr int BATCH = 8;
  const int per_row = D * (int)sizeof(KT) / 16;
  const int n = pl.stage_keys * per_row;
  unsigned char* kdst = buf;
  unsigned char* vdst = buf + (size_t)pl.stage_keys * pl.row_bytes;
  for (int base = tid; base < n; base += BATCH * THREADS) {
    int64_t off[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int idx = base + b * THREADS;
      const int c = c_start + idx / per_row;
      off[b] = (idx < n && c < c_end) ? src.row(c) * D : -1;
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int idx = base + b * THREADS;
      if (idx >= n) break;
      const int key = idx / per_row;
      const int part = idx - key * per_row;
      const bool valid = off[b] >= 0;
      const int64_t o = valid ? off[b] : 0;
      const size_t dst = (size_t)key * pl.row_bytes + part * 16;
      hopper::cp_async16(kdst + dst, reinterpret_cast<const unsigned char*>(src.k + o) + part * 16,
                         valid);
      hopper::cp_async16(vdst + dst, reinterpret_cast<const unsigned char*>(src.v + o) + part * 16,
                         valid);
    }
  }
  if (INT8) {
    float* ksc = reinterpret_cast<float*>(vdst + (size_t)pl.stage_keys * pl.row_bytes);
    float* vsc = ksc + pl.stage_keys;
    for (int key = tid; key < pl.stage_keys; key += THREADS) {
      const int c = c_start + key;
      const bool valid = c < c_end;
      const int64_t r = valid ? src.row(c) : 0;
      hopper::cp_async4(ksc + key, src.ks + r, valid);
      hopper::cp_async4(vsc + key, src.vs + r, valid);
    }
  }
}

// The block body. The block's rows are tile * R + i (i < R) of the (slot,
// kv-head)'s g * T rows, row r being (group member r / T, token r % T) at
// position length + r % T; keys [0, key_cap) exist (the live blocks, or
// the view's L); a row sees key c iff c < total, c <= position and, with a
// window, position - c < window. q / out are f32, or bf16 with q_bf16.
template <typename KT, bool INT8, int RG, int ND, class Src>
__device__ __forceinline__ void attend_block(const Src& src, const void* __restrict__ q,
                                             void* __restrict__ out, bool q_bf16,
                                             const float* __restrict__ k_smooth,
                                             const float* __restrict__ v_smooth, int s, int h,
                                             int tile, int T, int H, int KV, int D, int length,
                                             int total, int key_cap, int window, float softcap,
                                             float scale, const Plan& pl,
                                             unsigned char* smem) {
  constexpr int NC = Cols<ND>::N;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = H / KV;
  const int nd = ND ? ND : D / 32;
  const int R = pl.rows;
  const int q_rows = pl.groups * RG;
  const int cps = pl.stage_keys / CHUNK;

  float* q_s = reinterpret_cast<float*>(smem);
  float* pbuf = q_s + (size_t)q_rows * D;
  float* ksm_s = pbuf + WARPS * MAX_RG * CHUNK;
  float* parts = ksm_s + (INT8 ? D : 0);
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      parts + (pl.split > 1 ? (size_t)2 * pl.groups * cps * (D + 4) : 0));
  const size_t stage_bytes =
      2 * (size_t)pl.stage_keys * pl.row_bytes + (INT8 ? 2 * (size_t)pl.stage_keys * 4 : 0);

  // the tile's rows: their positions bound the keys the block stages
  const int row0 = tile * R;
  const int n_rows = min(R, g * T - row0);
  const int hi_all = min(total, key_cap);
  int t_min = T, t_max = -1;
  for (int i = 0; i < n_rows; ++i) {
    const int t = (row0 + i) % T;
    t_min = min(t_min, t);
    t_max = max(t_max, t);
  }
  const int blk_lo = window > 0 ? max(0, length + t_min - window + 1) : 0;
  const int blk_hi = min(hi_all, length + t_max + 1);

  // the ring's first stage in flight, then (meanwhile) the q rows (f32; rows
  // past the tile's zeros) and the K smoothing into shared memory, the loads
  // of a batch in flight together
  const int c_first = blk_hi > blk_lo ? (blk_lo / CHUNK) * CHUNK : 0;
  const int n_stages = blk_hi > blk_lo ? (blk_hi - c_first + pl.stage_keys - 1) / pl.stage_keys : 0;
  if (n_stages > 0) issue_stage<KT, INT8>(src, c_first, blk_hi, ring, pl, D, tid);
  hopper::cp_commit();

  for (int base = tid; base < q_rows * D; base += 8 * THREADS) {
    float v[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int idx = base + b * THREADS;
      const int i = idx / D, d = idx - i * D;
      const int r = row0 + i;
      const int64_t at = (((int64_t)s * T + r % T) * H + h * g + r / T) * D + d;
      v[b] = 0.0f;
      if (idx < q_rows * D && i < n_rows)
        v[b] = q_bf16 ? to_float(reinterpret_cast<const __nv_bfloat16*>(q)[at])
                      : reinterpret_cast<const float*>(q)[at];
    }
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (base + b * THREADS < q_rows * D) q_s[base + b * THREADS] = v[b];
  }
  if (INT8)
    for (int d = tid; d < D; d += THREADS) ksm_s[d] = k_smooth[h * D + d];

  // this warp's group and rows
  const int grp = warp / pl.split;
  const int sub = warp % pl.split;
  const bool working = grp < pl.groups;
  const bool owner = working && sub == 0;  // holds the group's state and stores it
  int lo[RG], hi[RG];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    lo[r] = hi[r] = 0;
    if (working && grp * RG + r < n_rows) {
      const int pos = length + (row0 + grp * RG + r) % T;
      lo[r] = window > 0 ? max(0, pos - window + 1) : 0;
      hi[r] = min(hi_all, pos + 1);
    }
  }
  float vsm[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i)
    vsm[i] = (INT8 && Cols<ND>::has(i, nd)) ? v_smooth[h * D + lane + 32 * i] : 0.0f;
  float m[RG], l[RG], acc[RG][NC];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    m[r] = -1e30f;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.0f;
  }

  float* my_pbuf = pbuf + warp * MAX_RG * CHUNK;
  const size_t part_stride = D + 4;

  // split mode (RG = 1): the owner folds stage st's partials, in chunk order
  auto fold_stage = [&](int st) {
    const float* pp = parts + (size_t)(st & 1) * pl.groups * cps * part_stride +
                      (size_t)grp * cps * part_stride;
    for (int ch = 0; ch < cps; ++ch) {
      const int c0 = c_first + st * pl.stage_keys + ch * CHUNK;
      if (!chunk_seen(c0, lo[0], hi[0])) continue;
      const float* p = pp + ch * part_stride;
      fold<ND>(m[0], l[0], acc[0], p[0], p[1], [&](int i) { return p[4 + lane + 32 * i]; }, nd);
    }
  };

  for (int st = 0; st < n_stages; ++st) {
    hopper::cp_wait<0>();  // stage st has landed (the only group in flight)
    __syncthreads();       // ... for every thread, and stage st - 1 is consumed
    if (st + 1 < n_stages)
      issue_stage<KT, INT8>(src, c_first + (st + 1) * pl.stage_keys, blk_hi,
                            ring + ((st + 1) % STAGES) * stage_bytes, pl, D, tid);
    hopper::cp_commit();
    if (!working) continue;
    if (pl.split > 1 && owner && st > 0) fold_stage(st - 1);

    const unsigned char* buf = ring + (st % STAGES) * stage_bytes;
    const unsigned char* kst = buf;
    const unsigned char* vst = buf + (size_t)pl.stage_keys * pl.row_bytes;
    const float* ksc = reinterpret_cast<const float*>(vst + (size_t)pl.stage_keys * pl.row_bytes);
    const float* vsc = ksc + pl.stage_keys;
    for (int ch = sub; ch < cps; ch += pl.split) {
      const int c0 = c_first + st * pl.stage_keys + ch * CHUNK;
      bool seen = false;
#pragma unroll
      for (int r = 0; r < RG; ++r) seen |= chunk_seen(c0, lo[r], hi[r]);
      if (!seen) continue;  // uniform across the warp; bit-neutral (header)
      float mc[RG], lc[RG], pv[RG][NC];
      chunk_partial<KT, INT8, RG, ND>(q_s + (size_t)grp * RG * D, lo, hi, c0,
                                      kst + (size_t)ch * CHUNK * pl.row_bytes,
                                      vst + (size_t)ch * CHUNK * pl.row_bytes, pl.row_bytes,
                                      ksc + ch * CHUNK, vsc + ch * CHUNK, ksm_s, vsm, D, scale,
                                      softcap, my_pbuf, lane, mc, lc, pv);
      if (pl.split == 1) {
#pragma unroll
        for (int r = 0; r < RG; ++r)
          fold<ND>(m[r], l[r], acc[r], mc[r], lc[r], [&](int i) { return pv[r][i]; }, nd);
      } else {
        float* p = parts + (size_t)(st & 1) * pl.groups * cps * part_stride +
                   ((size_t)grp * cps + ch) * part_stride;
        if (lane == 0) {
          p[0] = mc[0];
          p[1] = lc[0];
        }
#pragma unroll
        for (int i = 0; i < NC; ++i)
          if (Cols<ND>::has(i, nd)) p[4 + lane + 32 * i] = pv[0][i];
      }
    }
  }
  if (pl.split > 1 && n_stages > 0) {
    __syncthreads();
    if (owner) fold_stage(n_stages - 1);
  }
  hopper::cp_wait<0>();  // no copy outlives the block (only empty groups remain)

  if (!owner) return;
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    if (grp * RG + r >= n_rows) continue;
    const int row = row0 + grp * RG + r;
    const int64_t at = (((int64_t)s * T + row % T) * H + h * g + row / T) * D + lane;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (!Cols<ND>::has(i, nd)) continue;
      const float o = __fdiv_rn(acc[r][i], denom);
      if (q_bf16)
        store(reinterpret_cast<__nv_bfloat16*>(out) + at + 32 * i, o);
      else
        store(reinterpret_cast<float*>(out) + at + 32 * i, o);
    }
  }
}

}  // namespace pattn
