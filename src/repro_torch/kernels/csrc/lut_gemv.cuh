// The thread-block body of the fused LUT GEMV (M < 128 rows), shared by the
// solo kernel (lut_gemv.cu, B1), the multi-projection kernel
// (lut_multi_gemv.cu, B3) and the §4 layer's kernels below 128 rows
// (lut_plain.cu, B6 / B7), with the host plan every launcher runs.
//
// Work: Y = T(x) @ codebook[codes] over units of 32 columns of one
// projection (a strip) and MT rows (MT = 4 when M <= 4, else 8). A launch's
// units are strip-major, each projection's strips after the previous
// projection's, so no strip straddles two projections. A persistent grid of
// min(units, SMs) blocks walks them, block b taking units b, b + grid, ...
// (a B3 group of mixed widths or transforms: one block per unit).
//
// What bounds it on an H100. Each packed code is read once (K*N*nbits/8
// bytes over 3.35 TB/s) and feeds M fmaf on the CUDA cores (2*M*K*N
// operations over 67 TFLOP/s: the canonical order admits no tensor core).
// At 4 bits the two cross near M = 5: at the engine's decode width M = 8
// the f32 core rate bounds the kernel, and what counts is the share of
// issue slots that are fmaf and how well the shared-memory loads that feed
// them overlap; at M <= 4 the bytes do, and what counts is the bytes in
// flight. The design, for both: the block's warps are specialised.
//
//   * 4 producer warps only move bytes. Per stage (one k-block of each of
//     the 64 ways, 512 channels) they copy the strip's packed code rows (8 KB
//     at 4 bits), the stage's raw x rows and inv into one entry of a 4-entry
//     ring by `cp.async`, and arrive on the entry's `full` mbarrier when the
//     copies land; they refill an entry once the consumers have arrived on
//     its `empty` mbarrier. Up to 4 stages (32 KB of codes) are in flight.
//     Codes that cannot be copied 16 bytes at a time (N % 16, a misaligned
//     pointer) and activations that cannot (K % 16, misaligned) take
//     ordinary loads into the same entry; rows past the end, columns past N,
//     rows past M and channels past K are zeros.
//   * 8 consumer warps decode and multiply: thread (way w, 8-column group
//     tn) owns MT x 8 accumulators of its way. Per stage a warp first turns
//     its 8 ways' raw x into T(x) in a tile of its own (no block barrier),
//     then per packed byte does one shift, one mask and one 8-byte shared
//     load from a byte-indexed decode table, built per block from the
//     16-entry codebook: at 4 bits entry b is (cb[b & 15], cb[b >> 4]), the
//     two codes of a byte (channels 2rr and 2rr + 1 of packed row rr); at 2
//     bits a float4 of four codes; at 3 bits, where codes straddle bytes,
//     the codebook itself. Every entry is held in 16 (4-bit), 8 (2-bit) or
//     32 (3-bit) copies, one per lane of a shared-memory phase, so random
//     codes never collide in a bank. The values read are the codebook's
//     floats, unchanged. Per k-block a thread does 64 * MT fmaf for 32 table
//     loads and 2 * MT 16-byte loads of T(x).
//   * The fold: at a unit's end each consumer writes its way results, the
//     consumers meet at a barrier of their own, and one thread per output
//     sums the 64 in way order; a block that moves to another projection
//     rebuilds its decode table there.
//
// The canonical order of lut_common.cuh, exactly: consumer (w, tn) owns way
// w's fmaf chain for its outputs, taking k-blocks w, w + 64, ... in
// increasing order and within a k-block the channels in increasing k, from
// +0; the way results are summed in way order from +0 by one thread. No
// tensor cores, no split chain, no tree fold, no split of the ways across
// blocks. Rows past M and channels past K are zeros in T(x): fmaf(0, w, acc)
// == acc exactly (acc is never -0, w is a finite table entry), so their
// bits are those of skipping them. A row's bits therefore depend on that
// row alone: not on M, MT, the strip, the grid or the kernel serving it.
#pragma once

#include "cp_async.cuh"
#include "lut_common.cuh"

namespace lut {
namespace gemv {

constexpr int TN = 4;                 // consumer threads along N: the 4 lanes of a way
constexpr int CT = 8;                 // columns per consumer
constexpr int BN = TN * CT;           // 32 columns a strip
constexpr int CONSUMERS = TN * WAYS;  // 256: thread (way c / TN, column group c % TN)
constexpr int PRODUCERS = 128;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int KROUND = WAYS * KB;     // 512 channels a stage: one k-block per way
constexpr int MAX_M = 127;            // the GEMV serves M < 128
constexpr int MAX_SMEM = 232448;      // bytes of shared memory one block may use

// ring entries: 4, or 3 with f32 activations (their raw rows take twice the room)
__host__ __device__ constexpr int stages(int x_bytes) { return x_bytes == 4 ? 3 : 4; }
// floats of one way's T(x) in a tile: KB channels x MT rows + padding that
// puts the 8 ways of a consumer warp on different banks
__host__ __device__ constexpr int xw(int mt) { return KB * mt + 4; }

// Shared-memory layout of a block (byte offsets), host and device: the
// decode table; the ring, each entry a stage's packed code rows ([row of the
// k-block][way][BN bytes]), raw x ([row][512 channels]) and inv; each
// consumer warp's two T(x) tiles ([way][channel][row]); the fold buffer;
// the ring's full / empty mbarriers.
struct Layout {
  int ring_n, raw, inv, entry, ring, tiles, fold, bars, total;
  __host__ __device__ constexpr Layout(int nbits, int mt, int x_bytes)
      : ring_n(stages(x_bytes)),
        raw(WAYS * nbits * BN),
        inv(raw + mt * KROUND * x_bytes),
        entry(inv + KROUND * 4),
        ring((nbits == 3 ? 8 : 256) * 128),
        tiles(ring + ring_n * entry),
        fold(tiles + 2 * 4 * WAYS * xw(mt)),
        bars(fold + 4 * WAYS * mt * BN),
        total(bars + 2 * ring_n * 8) {}
};

// One launch: P projections sharing x (P = 1 for the solo kernels).
struct Job {
  const void* x;                    // (M, K) XT, row-major
  const float* inv;                 // (P, K) Eq. 11 multipliers; null in mode NONE
  const float* cb;                  // (P, KC) codebooks
  const float* out_scale;           // null, or one f32 every output is multiplied by
  float* y;                         // (M, ys): projection p's columns from col0[p]
  const uint8_t* packed[MAX_PROJ];  // (K * nbits[p] / 8, n[p]) u8
  int n[MAX_PROJ], nbits[MAX_PROJ], quantize[MAX_PROJ], col0[MAX_PROJ];
  int cvec[MAX_PROJ];               // codes copied 16 bytes at a time
  int strip0[MAX_PROJ + 1];         // first strip of each projection; [P] = all strips
  int P, M, K, ys, mblocks, units, stages;
  int kvec;                         // x and inv copied 16 bytes at a time
};

// The geometry a launcher picks; gemv_plan in kernels/lut_matmul.py mirrors it.
struct Plan {
  int mt, strips, mblocks, units, stages, grid, uniform, smem;
};

__host__ __device__ inline int strips_of(int n) { return (n + BN - 1) / BN; }

// The plan of an (M, K) launch over P projections with activations of
// x_bytes bytes (4, 2 or 1) on a card of `sms` SMs. Returns 0, or -1 for an
// argument the kernels do not take.
inline int make_plan(Plan& pl, int M, int K, int P, const int* widths, const int* nbits,
                     const int* quantize, int x_bytes, int sms) {
  if (M < 1 || M > MAX_M || K < 1 || P < 1 || P > MAX_PROJ || sms < 1) return -1;
  if (x_bytes != 4 && x_bytes != 2 && x_bytes != 1) return -1;
  int strips = 0, uniform = 1, smem = 0;
  for (int p = 0; p < P; ++p) {
    if (widths[p] < 1 || nbits[p] < 2 || nbits[p] > 4 || (K * nbits[p]) % 8) return -1;
    strips += strips_of(widths[p]);
    uniform &= nbits[p] == nbits[0] && !quantize[p] == !quantize[0];
  }
  // a group of mixed widths or transforms runs one compiled body per block,
  // and only at MT = 8
  pl.mt = (uniform && M <= 4) ? 4 : 8;
  for (int p = 0; p < P; ++p) {
    const int b = Layout(nbits[p], pl.mt, x_bytes).total;
    smem = b > smem ? b : smem;
  }
  if (smem > MAX_SMEM) return -1;
  pl.strips = strips;
  pl.mblocks = (M + pl.mt - 1) / pl.mt;
  pl.units = strips * pl.mblocks;
  pl.stages = ((K + KB - 1) / KB + WAYS - 1) / WAYS;
  pl.grid = uniform ? (pl.units < sms ? pl.units : sms) : pl.units;
  pl.uniform = uniform;
  pl.smem = smem;
  return 0;
}

// The job and plan of a launch; the device's SM count is read once.
inline int make_job(Job& jb, Plan& pl, const void* x, int x_bytes, const float* inv,
                    const float* cb, const float* out_scale, float* y,
                    const void* const* packed, const int* widths, const int* nbits,
                    const int* quantize, int P, int M, int K) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaErrorInvalidDevice;
  }
  if (make_plan(pl, M, K, P, widths, nbits, quantize, x_bytes, sms))
    return (int)cudaErrorInvalidValue;
  jb = Job{};
  jb.x = x;
  jb.inv = inv;
  jb.cb = cb;
  jb.out_scale = out_scale;
  jb.y = y;
  int strip = 0, col = 0;
  for (int p = 0; p < P; ++p) {
    jb.packed[p] = static_cast<const uint8_t*>(packed[p]);
    jb.n[p] = widths[p];
    jb.nbits[p] = nbits[p];
    jb.quantize[p] = quantize[p] ? 1 : 0;
    jb.col0[p] = col;
    jb.strip0[p] = strip;
    jb.cvec[p] = widths[p] % 16 == 0 && reinterpret_cast<uintptr_t>(packed[p]) % 16 == 0;
    strip += strips_of(widths[p]);
    col += widths[p];
  }
  jb.strip0[P] = strip;
  jb.P = P;
  jb.M = M;
  jb.K = K;
  jb.ys = col;
  jb.mblocks = pl.mblocks;
  jb.units = pl.units;
  jb.stages = pl.stages;
  jb.kvec = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(inv) % 16 == 0;
  return 0;
}

template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------------------
// device side

// The projection a strip t belongs to (the last p with strip0[p] <= t) and
// its entries of the job. Every entry is read at a compile-time index (an
// unrolled select), so the job stays in the parameter bank.
struct ProjRef {
  const uint8_t* packed;
  int n, nbits, quantize, col0, strip0, cvec, p;
};

__device__ __forceinline__ ProjRef proj_of_strip(const Job& jb, int t) {
  ProjRef r{jb.packed[0], jb.n[0], jb.nbits[0], jb.quantize[0],
            jb.col0[0],   jb.strip0[0], jb.cvec[0], 0};
#pragma unroll
  for (int q = 1; q < MAX_PROJ; ++q)
    if (q < jb.P && t >= jb.strip0[q])
      r = ProjRef{jb.packed[q], jb.n[q],      jb.nbits[q], jb.quantize[q],
                  jb.col0[q],   jb.strip0[q], jb.cvec[q],  q};
  return r;
}

// The decode table of one codebook, built by the consumers; lane l reads copy
// l % REP of an entry, so entry e of lane l is at tab + e * 128 +
// (l % REP) * (128 / REP). Every load of a thread's entries is issued
// before the first store.
template <int NBITS>
__device__ __forceinline__ void build_table(unsigned char* tab, const float* __restrict__ cb,
                                            int c) {
  if constexpr (NBITS == 4) {
    constexpr int PER = 256 * 16 / CONSUMERS;
    float2 v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = (c + j * CONSUMERS) >> 4;
      v[j] = make_float2(__ldg(cb + (e & 15)), __ldg(cb + (e >> 4)));
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) reinterpret_cast<float2*>(tab)[c + j * CONSUMERS] = v[j];
  } else if constexpr (NBITS == 2) {
    constexpr int PER = 256 * 8 / CONSUMERS;
    float4 v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = (c + j * CONSUMERS) >> 3;
      v[j] = make_float4(__ldg(cb + (e & 3)), __ldg(cb + ((e >> 2) & 3)),
                         __ldg(cb + ((e >> 4) & 3)), __ldg(cb + (e >> 6)));
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) reinterpret_cast<float4*>(tab)[c + j * CONSUMERS] = v[j];
  } else {
    for (int i = c; i < 8 * 32; i += CONSUMERS) reinterpret_cast<float*>(tab)[i] = __ldg(cb + (i >> 5));
  }
}

// A producer thread's copies of every stage of its block's units, walked
// unit by unit. Per stage, into a ring entry: NBITS 16-byte chunks of the
// strip's packed code rows (rows p/2 + 64 i of the stage, columns 16 (p % 2)
// .. +15), and chunks p, p + 128, ... of the stage's raw x rows and of its
// inv. Zeros past the end of the codes, past N, past M and past K.
template <int NBITS, typename XT, int MODE, int MT>
struct Producer {
  static constexpr int XCHUNKS = MT * KROUND * (int)sizeof(XT) / 16;  // raw x, 16 bytes each
  static constexpr int ROW_CHUNKS = KROUND * (int)sizeof(XT) / 16;    // of one row
  int dst[NBITS];    // code chunk i's offset in an entry
  int qrow[NBITS];   // code chunk i's row within a stage
  int p, h;
  const uint8_t* base;  // the projection's codes (a valid address)
  const uint8_t* cp;    // row 0 of the stage, at this thread's 16 columns
  int n, rows, row, cvec, col_ok, col;
  const XT* x;          // row m0, channel 0 of the unit
  const float* ip;      // the projection's inv, channel 0
  int k0, m0;

  __device__ __forceinline__ void init(int p_) {
    p = p_;
    h = p % 2;
#pragma unroll
    for (int i = 0; i < NBITS; ++i) {
      const int q = p / 2 + WAYS * i;
      qrow[i] = q;
      dst[i] = ((q % NBITS) * WAYS + q / NBITS) * BN + h * 16;
    }
  }

  __device__ __forceinline__ void start(const Job& jb, int u) {
    const int t = u / jb.mblocks;
    const ProjRef r = proj_of_strip(jb, t);
    base = r.packed;
    n = r.n;
    rows = jb.K * NBITS / 8;
    row = 0;
    col = (t - r.strip0) * BN + h * 16;
    col_ok = col < n;
    cvec = r.cvec;
    cp = base + col;
    m0 = (u % jb.mblocks) * MT;
    k0 = 0;
    x = static_cast<const XT*>(jb.x) + (int64_t)m0 * jb.K;
    if constexpr (MODE != NONE) ip = jb.inv + (int64_t)r.p * jb.K;
  }

  __device__ __forceinline__ void copy(const Job& jb, uint8_t* entry) {
#pragma unroll
    for (int i = 0; i < NBITS; ++i) {  // codes
      const uint8_t* src = cp + (int64_t)qrow[i] * n;
      if (cvec) {
        const bool ok = col_ok && row + qrow[i] < rows;
        hopper::cp_async16(entry + dst[i], ok ? src : base, ok);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (row + qrow[i] < rows) {
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (col + b < n) v[b / 4] |= (uint32_t)src[b] << (8 * (b % 4));
        }
        *reinterpret_cast<uint4*>(entry + dst[i]) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    cp += (int64_t)WAYS * NBITS * n;
    row += WAYS * NBITS;

    uint8_t* raw = entry + WAYS * NBITS * BN;
    float* inv = reinterpret_cast<float*>(raw + MT * KROUND * (int)sizeof(XT));
    const int K = jb.K;
    if (jb.kvec) {
#pragma unroll
      for (int j = p; j < XCHUNKS; j += PRODUCERS) {  // raw x: row j / ROW_CHUNKS
        const int m = j / ROW_CHUNKS, k = k0 + (j % ROW_CHUNKS) * (16 / (int)sizeof(XT));
        const bool ok = m0 + m < jb.M && k < K;
        hopper::cp_async16(raw + 16 * j,
                           ok ? static_cast<const void*>(x + (int64_t)m * K + k) : base, ok);
      }
      if constexpr (MODE != NONE) {  // inv: 128 chunks of 4 channels
        const bool ok = k0 + 4 * p < K;
        hopper::cp_async16(inv + 4 * p, ok ? static_cast<const void*>(ip + k0 + 4 * p) : base,
                           ok);
      }
    } else {
      constexpr int E = 16 / (int)sizeof(XT);
#pragma unroll
      for (int j = p; j < XCHUNKS; j += PRODUCERS) {
        const int m = j / ROW_CHUNKS, k = k0 + (j % ROW_CHUNKS) * E;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (!(m0 + m < jb.M && k + i < K)) continue;
          const XT xv = x[(int64_t)m * K + k + i];
          if constexpr (sizeof(XT) == 4) v[i] = __float_as_uint(to_float(xv));
          else if constexpr (sizeof(XT) == 2)
            v[i >> 1] |= (uint32_t)__bfloat16_as_ushort(xv) << (16 * (i & 1));
          else v[i >> 2] |= (uint32_t)(uint8_t)xv << (8 * (i & 3));
        }
        *reinterpret_cast<uint4*>(raw + 16 * j) = make_uint4(v[0], v[1], v[2], v[3]);
      }
      if constexpr (MODE != NONE) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          inv[4 * p + i] = k0 + 4 * p + i < K ? ip[k0 + 4 * p + i] : 0.0f;
      }
    }
    k0 += KROUND;
  }
};

// Element i of raw activations held as 32-bit words.
template <typename XT>
__device__ __forceinline__ float raw_elem(const uint32_t* r, int i) {
  if constexpr (sizeof(XT) == 4) return __uint_as_float(r[i]);
  else if constexpr (sizeof(XT) == 2)
    return __uint_as_float((i & 1) ? (r[i >> 1] & 0xFFFF0000u) : (r[i >> 1] << 16));
  else return static_cast<float>(static_cast<int8_t>(r[i >> 2] >> (8 * (i & 3))));
}

// A consumer's share of its warp's T(x) for a stage: way w's k-block (w the
// way's index in the warp), rows (MT / TN) * tn .. +MT/TN - 1, all 8
// channels, from the entry's raw rows and inv into the warp's tile (channel
// c, row m of way w at tile[w * XW + c * MT + m]). wg: the way in the block.
template <typename XT, int MODE, int MT>
__device__ __forceinline__ void transform_share(const uint8_t* raw, const float* inv, float* tile,
                                                int wg, int w, int tn) {
  constexpr int RPL = MT / TN;  // rows a lane transforms
  constexpr int WORDS = KB * (int)sizeof(XT) / 4;
  float iv[KB];
  if constexpr (MODE != NONE) {
    const float4 a = *reinterpret_cast<const float4*>(inv + wg * KB);
    const float4 b = *reinterpret_cast<const float4*>(inv + wg * KB + 4);
    iv[0] = a.x, iv[1] = a.y, iv[2] = a.z, iv[3] = a.w, iv[4] = b.x, iv[5] = b.y, iv[6] = b.z,
    iv[7] = b.w;
  }
  float v[RPL][KB];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int m = tn * RPL + r;
    const uint8_t* src = raw + (m * KROUND + wg * KB) * (int)sizeof(XT);
    uint32_t wd[WORDS];
    if constexpr (WORDS >= 4) {
#pragma unroll
      for (int i = 0; i < WORDS / 4; ++i) {
        const uint4 q = reinterpret_cast<const uint4*>(src)[i];
        wd[4 * i] = q.x, wd[4 * i + 1] = q.y, wd[4 * i + 2] = q.z, wd[4 * i + 3] = q.w;
      }
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(src);
      wd[0] = q.x, wd[1] = q.y;
    }
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      v[r][i] = raw_elem<XT>(wd, i);
      if constexpr (MODE != NONE) v[r][i] = transform<MODE>(v[r][i], iv[i]);
    }
  }
  float* t = tile + w * xw(MT) + tn * RPL;
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    if constexpr (RPL == 4)
      *reinterpret_cast<float4*>(t + i * MT) = make_float4(v[0][i], v[1][i], v[2][i], v[3][i]);
    else if constexpr (RPL == 2)
      *reinterpret_cast<float2*>(t + i * MT) = make_float2(v[0][i], v[1][i]);
    else
      t[i * MT] = v[0][i];
  }
}

// N 4-byte words from shared memory, in one load where N allows.
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N], const uint8_t* src) {
  if constexpr (N == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  }
}

// One stage of a consumer's way for its CT columns and MT rows. cw: its code
// bytes of packed row 0 of the way's k-block (row rr at + rr * WAYS * BN);
// xs: the way's T(x), channel kk of row m at xs[kk * MT + m]; tabl: the
// decode table at this lane's copy.
template <int NBITS, int MT>
__device__ __forceinline__ void compute(const uint8_t* cw, const float* xs,
                                        const unsigned char* tabl, float (&acc)[MT][CT]) {
  constexpr int WORDS = CT / 4;  // 4-byte code words of a packed row
  if constexpr (NBITS == 4 || NBITS == 2) {
    constexpr int CPB = 8 / NBITS;  // channels of a packed byte
#pragma unroll
    for (int rr = 0; rr < NBITS; ++rr) {
      uint32_t word[WORDS];
      load_words<WORDS>(word, cw + rr * WAYS * BN);
      float xv[CPB][MT];
#pragma unroll
      for (int ch = 0; ch < CPB; ++ch)
#pragma unroll
        for (int m = 0; m < MT; m += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xs + (rr * CPB + ch) * MT + m);
          xv[ch][m] = v.x, xv[ch][m + 1] = v.y, xv[ch][m + 2] = v.z, xv[ch][m + 3] = v.w;
        }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        // byte c of the row, zero-extended (one PRMT), times 128 plus the table
        const uint32_t byte = __byte_perm(word[c / 4], 0u, 0x4440u | (c % 4));
        const unsigned char* e = tabl + (byte << 7);
        float wv[CPB];
        if constexpr (NBITS == 4) {
          const float2 t = *reinterpret_cast<const float2*>(e);
          wv[0] = t.x, wv[1] = t.y;
        } else {
          const float4 t = *reinterpret_cast<const float4*>(e);
          wv[0] = t.x, wv[1] = t.y, wv[2] = t.z, wv[3] = t.w;
        }
#pragma unroll
        for (int ch = 0; ch < CPB; ++ch)
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[ch][m], wv[ch], acc[m][c]);
      }
    }
  } else {  // 3 bits: a column's 8 codes span its 3 bytes
    uint32_t word[CT];
#pragma unroll
    for (int hh = 0; hh < WORDS; ++hh) {
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(cw + 4 * hh);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(cw + WAYS * BN + 4 * hh);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(cw + 2 * WAYS * BN + 4 * hh);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        word[4 * hh + c] = ((r0 >> (8 * c)) & 0xFFu) | (((r1 >> (8 * c)) & 0xFFu) << 8) |
                           (((r2 >> (8 * c)) & 0xFFu) << 16);
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      float xv[MT];
#pragma unroll
      for (int m = 0; m < MT; m += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xs + kk * MT + m);
        xv[m] = v.x, xv[m + 1] = v.y, xv[m + 2] = v.z, xv[m + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float wv =
            *reinterpret_cast<const float*>(tabl + (((word[c] >> (3 * kk)) & 7u) << 7));
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[m], wv, acc[m][c]);
      }
    }
  }
}

// Block b's units b, b + du, ... (< jb.units) of one launch whose every
// projection has width NBITS and transform MODE, MT rows a unit. Warps
// 0..7 consume, warps 8..11 produce.
template <int NBITS, typename XT, int MODE, int MT>
__device__ __forceinline__ void run(const Job& jb, unsigned char* smem, int u0, int du) {
  constexpr Layout L(NBITS, MT, (int)sizeof(XT));
  constexpr int S = L.ring_n;
  constexpr int XW = xw(MT);
  constexpr int REP = NBITS == 4 ? 16 : NBITS == 2 ? 8 : 32;
  unsigned char* tab = smem;
  unsigned char* ring = smem + L.ring;
  float* fold = reinterpret_cast<float*>(smem + L.fold);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + S;

  const int nunits = u0 < jb.units ? (jb.units - u0 + du - 1) / du : 0;
  const int total = nunits * jb.stages;
  if (total == 0) return;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(full + i, PRODUCERS);       // each producer, once its copies land
      hopper::mbar_init(empty + i, CONSUMERS / 32);  // each consumer warp
    }
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // ---- producers
    Producer<NBITS, XT, MODE, MT> pr;
    pr.init(tid - CONSUMERS);
    int j = 0, s = 0;
    pr.start(jb, u0);
    for (int g = 0; g < total; ++g) {
      const int e = g % S;
      if (g >= S) hopper::mbar_wait(empty + e, (g / S - 1) & 1);
      pr.copy(jb, ring + e * L.entry);
      if (pr.cvec && jb.kvec) {
        hopper::mbar_arrive_copies(full + e);
      } else {  // ordinary stores too: published by a plain arrival once the copies are in
        hopper::cp_commit();
        hopper::cp_wait<0>();
        hopper::mbar_arrive(full + e);
      }
      if (++s == jb.stages) {
        s = 0;
        if (++j < nunits) pr.start(jb, u0 + j * du);
      }
    }
    hopper::cp_commit();
    hopper::cp_wait<0>();
    return;
  }

  // ---- consumers
  const int c = tid;
  const int tn = c % TN, w = c / TN;
  const unsigned char* tabl = tab + ((c & 31) % REP) * (128 / REP);
  // this warp's two T(x) tiles, of its WW ways
  constexpr int WW = 32 / TN;
  float* tiles = reinterpret_cast<float*>(smem + L.tiles) + (c / 32) * (2 * WW * XW);
  int pcur = proj_of_strip(jb, u0 / jb.mblocks).p;
  build_table<NBITS>(tab, jb.cb + pcur * KC, c);
  hopper::bar_sync(1, CONSUMERS);  // the table

  float acc[MT][CT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < CT; ++i) acc[m][i] = 0.0f;

  // T(x) of stage g into the warp's tile g & 1 (entry g % S has landed)
  auto transform = [&](int g) {
    const uint8_t* entry = ring + (g % S) * L.entry;
    transform_share<XT, MODE, MT>(entry + L.raw, reinterpret_cast<const float*>(entry + L.inv),
                                  tiles + (g & 1) * (WW * XW), w, w % WW, tn);
  };
  hopper::mbar_wait(full, 0);
  transform(0);
  __syncwarp();
  int cj = 0, cs = 0;
  for (int g = 0; g < total; ++g) {
    const int e = g % S;
    // stage g's arithmetic and stage g + 1's T(x) in one stretch, so that
    // the one's loads hide behind the other's fmaf
    const bool next = g + 1 < total;
    if (next) hopper::mbar_wait(full + (g + 1) % S, ((g + 1) / S) & 1);
    compute<NBITS, MT>(ring + e * L.entry + w * BN + tn * CT,
                       tiles + (g & 1) * (WW * XW) + (w % WW) * XW, tabl, acc);
    if (next) transform(g + 1);
    __syncwarp();  // the warp's T(x) of stage g + 1; every lane done with entry g
    if ((c & 31) == 0) hopper::mbar_arrive(empty + e);
    if (++cs < jb.stages) continue;

    // the unit's end: the ordered fold of its 64 way results
    cs = 0;
    const int u = u0 + cj * du;
    float* fw = fold + w * (MT * BN) + tn * CT;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < CT; i += 4)
        *reinterpret_cast<float4*>(fw + m * BN + i) =
            make_float4(acc[m][i], acc[m][i + 1], acc[m][i + 2], acc[m][i + 3]);
#pragma unroll
      for (int i = 0; i < CT; ++i) acc[m][i] = 0.0f;
    }
    hopper::bar_sync(1, CONSUMERS);  // every way result written; every table read done
    for (int o = c; o < MT * BN; o += CONSUMERS) {
      float sum = 0.0f;
#pragma unroll 16
      for (int v = 0; v < WAYS; ++v) sum += fold[v * (MT * BN) + o];
      const int t = u / jb.mblocks;
      const ProjRef pr = proj_of_strip(jb, t);
      const int row = (u % jb.mblocks) * MT + o / BN;
      const int col = (t - pr.strip0) * BN + o % BN;
      if (row < jb.M && col < pr.n)
        jb.y[(int64_t)row * jb.ys + pr.col0 + col] =
            jb.out_scale ? __fmul_rn(sum, *jb.out_scale) : sum;
    }
    if (++cj < nunits) {  // the next unit's codebook
      const int p = proj_of_strip(jb, (u0 + cj * du) / jb.mblocks).p;
      if (p != pcur) {
        pcur = p;
        build_table<NBITS>(tab, jb.cb + p * KC, c);
      }
    }
    hopper::bar_sync(1, CONSUMERS);  // the fold buffer read, the table rebuilt
  }
}

}  // namespace gemv
}  // namespace lut
