// Fused correctIq (-q 1) NBFM kernels for Hopper (sm_90a): K4, the path's
// kernel, and K5, its sequential-order variant (below q1_kernel).
//
// fused_nbfm_q1 (K4) replaces the Pallas TPU kernel fused_nbfm_q1_twopass_u32_3d
// (demodulator_tpu/ops/pallas/fused_nbfm.py:644: pass 1 pallas_call :684
// with _q1_sum_kernel :563, the XLA block prefix
// ops/conditioning.py:190, pass 2 pallas_call :711 with _q1_apply_kernel
// :605 and _q1_body :429).  It computes the reference's correctIq DC tracker
// (src/matrix.c:120-140), chained through every block of the launch, then
// the discriminator and the stationary audio FIR:
//
//   pair-step k of a block of n bytes takes front pair k and mirror pair
//   n-2k-2:  out = raw - off (both pairs);  off' = a*off + esr*(front + back)
//   with a = 1 - 2*esr, per I/Q lane, on RAW byte values.
//
// In words (4 bytes, two pairs): front word j holds steps 2j, 2j+1; the
// mirror word n/4-1-j holds steps 2j+1 then 2j.  So "step pair" j reads
// those two words, and the whole block is n/8 step pairs.
//
// Design.  The recurrence is affine, so the blocks' step pairs are cut into
// tiles of `tile` step pairs (ops/cuda/fused_nbfm.py Q1_TILE; the last tile
// of a block takes the remainder, 1..tile), each with its own affine
// summary, and the whole launch is one kernel with a decoupled look-back:
//   1. a CTA takes a ticket from an atomic counter, so tiles start in order
//      over all tiles of all blocks, and stages its tile's front and mirror
//      words (plus the D step pairs after it that its FIR reads) in shared
//      memory, once;
//   2. each thread steps the recurrence through its run of step pairs from
//      0 (odd run lengths: the runs' shared-memory reads are free of bank
//      conflicts), and a CTA scan of the threads' affine maps (warp
//      shuffles, then one step across the warps) gives every run's
//      exclusive map and the tile's aggregate, which is published at once
//      (one 64-bit store: value and state in one word);
//   3. warp 0 finds the tile's entering offset in two levels.  A block's
//      last tile folds the maps of the block's earlier tiles and its own
//      into the block's map from zero and publishes it.  Every tile finds
//      the offset entering its block by a decoupled look-back over the
//      blocks before it, 32 at a time, to the nearest published inclusive
//      prefix (before block 0: off_in), composing the blocks' maps after
//      it with a^words, as the plain version composes blocks
//      (block_look_back); the block's last tile publishes the block's
//      inclusive prefix (off_final after the last block).  Then it folds
//      the maps of its block's earlier tiles onto that offset (fold_tiles),
//      and a block's first tile writes off_entering.  A CTA only waits on
//      lower tickets, whose CTAs are resident: no deadlock;
//   4. from the tile's entering offset, the offset at every step: each front
//      and mirror word is conditioned and demodulated into shared memory,
//      and the audio FIR writes the outputs.  A front word's FIR reads the
//      D words after it (higher step pairs); a mirror word's reads the D
//      words after it in the block, which are LOWER step pairs.  So a tile
//      computes its step pairs plus the D after it, and owns the front
//      outputs of its own step pairs and the mirror outputs of the step pairs
//      D higher (tile 0 also the first D): every read is inside what the
//      tile computed.
// The mirror is a reversed index, not the TPU's anti-identity matmuls.  The
// input is read once.
//
// Precision.  The offset sits near the raw DC (~127) and a float32 power
// a^m carries a relative error; a product of many rounded powers carries
// one per factor, and each lands on the offset as 127 times that.  So the
// scans carry each map's step-pair COUNT (an exact integer) beside its b,
// and every power q^m (q = a^2) is one float64 power rounded to float32, as
// the JAX package's host constants are (a^(n/4) is ~e^-68 at 96 kHz: a
// float32 normal; what underflows is 0 in both).  The host computes them
// once per esr (the table T[m], m <= tile + kMaxTaps - 1: every count a scan
// meets, and every tile's), and the kernel reads them from shared memory.
// Blocks compose with the host's float32 a^words.  The only pow on the
// card is the look-back's, one per window of 32 blocks it passes without a
// prefix.  Only the few steps of one thread's run multiply by the float32 a
// itself.
//
// What bounds it: the input is read once and the audio written once, 8
// bytes per output word, against about 56 float32 operations per word (the
// discriminator, the FIR and the recurrence); each thread's run of ~9 step
// pairs is sequential, the scan log-depth, and the CTAs pass through
// staging, scan, look-back, discriminator and FIR together.  Measured like
// K1 (the same discriminator and FIR, no tracker), it is latency-bound, not
// bytes-bound: on an NVIDIA H100 80GB HBM3 at 700 W, 15.0 us for 16 blocks
// of 256 KiB (K1: 7.5) and 127 us for 256 (K1: 111); the block look-back
// adds 1.3 and 4.2 us of that.  Tiles of 2048 step pairs were the fastest
// of 1024, 2048 and 4096 at 256 blocks and within 0.1 us of the fastest at
// 16 (ops/cuda/sections.py); PERF.md has the numbers.

#include "nbfm_device.cuh"

namespace {

using namespace nbfm;

constexpr int kMaxTile = 4096;  // step pairs per tile, the most a launch takes
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  long long words;  // words per block
  long long half;   // step pairs per block = words / 2
  int tile;         // step pairs per tile
  int tpb;          // tiles per block = ceil(half / tile)
};

__device__ __forceinline__ void tile_range(const Geometry& g, int tile,
                                           long long& j0, long long& j1) {
  j0 = static_cast<long long>(tile) * g.tile;
  j1 = min(j0 + g.tile, g.half);
}

// step pairs of the block's last tile
__device__ __forceinline__ int last_len(const Geometry& g) {
  return static_cast<int>(g.half - static_cast<long long>(g.tpb - 1) * g.tile);
}

// Stage front words j0.. and mirror words words-1-j0.. of `len` step pairs.
__device__ __forceinline__ void load_pairs(const uint32_t* __restrict__ in,
                                           long long row, const Geometry& g,
                                           long long j0, int len, uint32_t* fw,
                                           uint32_t* bw) {
  for (int i = threadIdx.x; i < len; i += kThreads) {
    fw[i] = in[row + j0 + i];
    bw[i] = in[row + g.words - 1 - (j0 + i)];
  }
}

__device__ __forceinline__ float byte_at(uint32_t w, int k) {
  return static_cast<float>((w >> (8 * k)) & 255u);
}

// s0 (step 2j) and s1 (step 2j+1) of one step pair, per lane
__device__ __forceinline__ void step_inputs(uint32_t fw, uint32_t bw, float esr,
                                            float2& s0, float2& s1) {
  s0.x = __fmul_rn(__fadd_rn(byte_at(fw, 0), byte_at(bw, 2)), esr);
  s0.y = __fmul_rn(__fadd_rn(byte_at(fw, 1), byte_at(bw, 3)), esr);
  s1.x = __fmul_rn(__fadd_rn(byte_at(fw, 2), byte_at(bw, 0)), esr);
  s1.y = __fmul_rn(__fadd_rn(byte_at(fw, 3), byte_at(bw, 1)), esr);
}

__device__ __forceinline__ float2 affine(float a, float2 off, float2 s) {
  return make_float2(__fadd_rn(__fmul_rn(a, off.x), s.x),
                     __fadd_rn(__fmul_rn(a, off.y), s.y));
}

// Thread t's run [i0, i1) of `len` staged step pairs: an odd length, so the
// threads of a warp read the staged words at an odd stride.
__device__ __forceinline__ void run_of(int len, int& i0, int& i1) {
  const int c = (len + kThreads - 1) / kThreads | 1;
  i0 = min(len, static_cast<int>(threadIdx.x) * c);
  i1 = min(len, i0 + c);
}

// This thread's run as the b of its affine map (its A is q^(i1-i0)); b_stop
// gets the b of [i0, stop) where the run holds step pair stop - 1.
__device__ __forceinline__ float2 run_b(const uint32_t* fw, const uint32_t* bw,
                                        int i0, int i1, int stop, float esr, float a,
                                        float2& b_stop) {
  float2 b = make_float2(0.0f, 0.0f);
  for (int i = i0; i < i1; ++i) {
    float2 s0, s1;
    step_inputs(fw[i], bw[i], esr, s0, s1);
    b = affine(a, affine(a, b, s0), s1);
    if (i + 1 == stop) b_stop = b;
  }
  return b;
}

// (m, b) of the map composed from (ml, bl), then (m, b): q^m*bl + b
__device__ __forceinline__ void compose(const float* T, int ml, float2 bl, int& m,
                                        float2& b) {
  b = affine(T[m], bl, b);
  m += ml;
}

// Inclusive scan over the warp's lanes of (m, b), lower lanes applied first.
__device__ __forceinline__ void warp_scan(const float* T, int& m, float2& b, int width) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int d = 1 << l;
    if (d >= width) break;
    const int ml = __shfl_up_sync(kFull, m, d);
    const float2 bl = make_float2(__shfl_up_sync(kFull, b.x, d),
                                  __shfl_up_sync(kFull, b.y, d));
    if (lane >= d) compose(T, ml, bl, m, b);
  }
}

// Exclusive scan over the CTA's threads of the affine maps x -> q^m*x + b
// (m = the thread's run length), lower threads applied first; T[m] =
// float32(q^m).  Returns the thread's exclusive b (its exclusive count is
// its run's start).  wm, wb: kWarps entries of shared memory.
__device__ float2 cta_scan(int m, float2 b, const float* T, int* wm, float2* wb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_scan(T, m, b, 32);
  if (lane == 31) {
    wm[warp] = m;
    wb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    int mw = lane < kWarps ? wm[lane] : 0;
    float2 bw = lane < kWarps ? wb[lane] : make_float2(0.0f, 0.0f);
    warp_scan(T, mw, bw, kWarps);
    if (lane < kWarps) {
      wm[lane] = mw;
      wb[lane] = bw;
    }
  }
  __syncthreads();
  // exclusive within the warp: lane - 1's inclusive map
  const int mx = __shfl_up_sync(kFull, m, 1);
  float2 bx = make_float2(__shfl_up_sync(kFull, b.x, 1), __shfl_up_sync(kFull, b.y, 1));
  if (lane == 0) bx = make_float2(0.0f, 0.0f);
  return warp == 0 ? bx : affine(T[lane ? mx : 0], wb[warp - 1], bx);
}

// Stages the tile of `len` step pairs from j0 and the powers T[0 .. max(len,
// tile)], then scans the tile.  Returns the thread's run [i0, i1) and its
// exclusive b; *agg gets the map of the tile's first `own` step pairs (its
// count is own).
__device__ float2 stage_and_scan(const uint32_t* __restrict__ in, long long row,
                                 const Geometry& g, long long j0, int own, int len,
                                 const float* __restrict__ pow_table, float esr, float a,
                                 uint32_t* fw, uint32_t* bw, float* T, int* wm, float2* wb,
                                 float2* agg, int& i0, int& i1) {
  const int tn = max(len, g.tile);
  for (int i = threadIdx.x; i <= tn; i += kThreads) T[i] = pow_table[i];
  load_pairs(in, row, g, j0, len, fw, bw);
  __syncthreads();
  run_of(len, i0, i1);
  float2 b_own = make_float2(0.0f, 0.0f);
  const float2 b = run_b(fw, bw, i0, i1, own, esr, a, b_own);
  const float2 b_ex = cta_scan(i1 - i0, b, T, wm, wb);
  if (i0 < own && own <= i1) *agg = affine(T[own - i0], b_ex, b_own);
  return b_ex;
}

// Conditioning, discriminator and audio FIR of one tile whose step pairs
// j0 .. e1 = min(j1 + D, half) are staged in fw/bw; `off` is the offset
// entering this thread's run [i0, i1).
template <bool kPrecise>
__device__ void apply_tile(float* __restrict__ out, long long row,
                           const Geometry& g, int tile, long long j0,
                           long long j1, const Taps& taps, float esr, float a,
                           float2 off, int i0, int i1, const uint32_t* fw,
                           const uint32_t* bw, float* xf, float* xb) {
  const int D = taps.n - 1;
  const int t = threadIdx.x;
  for (int i = i0; i < i1; ++i) {
    const uint32_t f = fw[i], m = bw[i];
    float2 s0, s1;
    step_inputs(f, m, esr, s0, s1);
    const float2 off1 = affine(a, off, s0);  // entering step 2j+1
    xf[i] = demod_pairs<kPrecise>(
        __fsub_rn(byte_at(f, 0), off.x), __fsub_rn(byte_at(f, 1), off.y),
        __fsub_rn(byte_at(f, 2), off1.x), __fsub_rn(byte_at(f, 3), off1.y));
    xb[i] = demod_pairs<kPrecise>(
        __fsub_rn(byte_at(m, 0), off1.x), __fsub_rn(byte_at(m, 1), off1.y),
        __fsub_rn(byte_at(m, 2), off.x), __fsub_rn(byte_at(m, 3), off.y));
    off = affine(a, off1, s1);
  }
  __syncthreads();

  // front words j0 + i, i < own: word j0 + i + d is the front word of step
  // pair j0 + i + d below the middle (staged at xf[i + d] for i + d < nf),
  // else the mirror word of step pair words-1-(j0 + i + d)
  const int own = static_cast<int>(j1 - j0);
  const int nf = static_cast<int>(min(j1 + D, g.half) - j0);
  float* of = out + row + j0;
  for (int i = t; i < own; i += kThreads) {
    float y = __fmul_rn(taps.t[0], xf[i]);
    if (i + D < nf) {
      for (int d = 1; d <= D; ++d) y = __fadd_rn(y, __fmul_rn(taps.t[d], xf[i + d]));
    } else {
      for (int d = 1; d <= D; ++d) {
        const float v = i + d < nf ? xf[i + d]
                                   : xb[static_cast<int>(g.words - 1 - (j0 + i + d) - j0)];
        y = __fadd_rn(y, __fmul_rn(taps.t[d], v));
      }
    }
    of[i] = y;
  }
  // mirror words of step pairs j0 + k, k in [k0, k1): word words-1-(j0+k)+d
  // is the mirror word of step pair j0 + k - d (xb[k - d]), zero before the
  // block's start
  const int k0 = tile == 0 ? 0 : D;
  const int k1 = static_cast<int>((tile == g.tpb - 1 ? g.half : min(j1 + D, g.half)) - j0);
  float* ob = out + row + g.words - 1 - j0;
  for (int k = k0 + t; k < k1; k += kThreads) {
    float y = __fmul_rn(taps.t[0], xb[k]);
    for (int d = 1; d <= D; ++d) {
      y = __fadd_rn(y, __fmul_rn(taps.t[d], k - d >= 0 ? xb[k - d] : 0.0f));
    }
    ob[-k] = y;
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void wait_flag(const unsigned* p) {
  while (ld_acquire(p) == 0u) {
  }
}

// Shared memory of a tile of at most `tile` step pairs: the front and mirror
// words and their discriminator outputs of tile + kMaxTaps - 1 step pairs,
// and the power table T[0 .. tile + kMaxTaps - 1].
size_t smem_bytes(int tile) {
  const size_t ext = static_cast<size_t>(tile) + kMaxTaps - 1;
  return 4 * 4 * ext + 4 * (ext + 1);
}

struct Smem {
  uint32_t *fw, *bw;
  float *xf, *xb, *T;
};

__device__ __forceinline__ Smem carve(uint32_t* base, int tile) {
  const int ext = tile + kMaxTaps - 1;
  Smem s;
  s.fw = base;
  s.bw = s.fw + ext;
  s.xf = reinterpret_cast<float*>(s.bw + ext);
  s.xb = s.xf + ext;
  s.T = s.xb + ext;
  return s;
}

// K4's published state: a float2 as one 64-bit word, all ones until
// published (a NaN pattern; no map or offset is NaN).  The word carries its
// own value, so relaxed loads and stores at gpu scope suffice, and polls do
// not hold back the arithmetic around them.
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned long long ld_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long pack(float2 f) {
  return (static_cast<unsigned long long>(__float_as_uint(f.y)) << 32) | __float_as_uint(f.x);
}

__device__ __forceinline__ void st_relaxed64(unsigned long long* p, float2 f) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(pack(f)) : "memory");
}

__device__ __forceinline__ float2 unpack(unsigned long long v) {
  return make_float2(__uint_as_float(static_cast<unsigned>(v)),
                     __uint_as_float(static_cast<unsigned>(v >> 32)));
}

// q^m for a count beyond the table: one float64 pow, rounded once
__device__ __forceinline__ float qpow(double q, long long m) {
  return static_cast<float>(pow(q, static_cast<double>(m)));
}

// Warp: e with the maps of `count` full tiles from tile `first` applied in
// order (each x -> A*x + agg, A = T[tile]), their aggregates polled until
// published, 32 at a time.
__device__ float2 fold_tiles(const unsigned long long* tile_agg, long long first, int count,
                             float2 e, float A) {
  const int lane = threadIdx.x & 31;
  for (int w = 0; w < count; w += 32) {
    unsigned long long v = kNone;
    if (w + lane < count) {
      while ((v = ld_relaxed64(&tile_agg[first + w + lane])) == kNone) {
      }
    }
    const int n = min(32, count - w);
    for (int l = 0; l < n; ++l) e = affine(A, e, unpack(__shfl_sync(kFull, v, l)));
  }
  return e;
}

// A block's published state for the look-back: its inclusive prefix (the
// offset entering the next block) if published, else its map from zero,
// else kNone; st 2, 1 or 0.  Block -1 is off_in, a prefix.
struct Slot {
  unsigned long long v;
  int st;
};

__device__ __forceinline__ Slot poll(long long k, const unsigned long long* blk_agg,
                                     const unsigned long long* blk_pre, const float* off_in) {
  if (k < 0) return {pack(make_float2(off_in[0], off_in[1])), 2};
  const unsigned long long p = ld_relaxed64(&blk_pre[k]);
  const unsigned long long a = ld_relaxed64(&blk_agg[k]);
  return p != kNone ? Slot{p, 2} : Slot{a, a != kNone ? 1 : 0};
}

// Warp: the offset entering block blk, by a decoupled look-back over the
// blocks before it.  Each round holds the 32 blocks below hi (lane l: block
// hi - l) and waits until every block from hi down to the nearest inclusive
// prefix has at least its map.  The window is composed serially through the
// lanes from that prefix (or the window's first map) forward, each block
// x -> a_blk*x + tot as the plain version composes them.  Without a prefix,
// the next window's polls are issued first, then the window's map is
// prepended to the later windows' (one pow, for their count).
__device__ float2 block_look_back(long long blk, const unsigned long long* blk_agg,
                                  const unsigned long long* blk_pre, const float* off_in,
                                  float a_blk, double q, long long half) {
  const int lane = threadIdx.x & 31;
  long long acc_n = 0;  // the later windows' blocks
  float2 acc_b = make_float2(0.0f, 0.0f);
  long long hi = blk - 1;
  Slot sl = poll(hi - lane, blk_agg, blk_pre, off_in);
  while (true) {
    unsigned pm, need;
    while (true) {
      pm = __ballot_sync(kFull, sl.st == 2);
      need = pm ? pm ^ (pm - 1) : kFull;  // the lanes up to the nearest prefix
      if ((__ballot_sync(kFull, sl.st != 0) & need) == need) break;
      if (sl.st == 0) sl = poll(hi - lane, blk_agg, blk_pre, off_in);
    }
    const unsigned long long v = sl.v;
    if (!pm) sl = poll(hi - 32 - lane, blk_agg, blk_pre, off_in);  // the next window
    const int first = pm ? __ffs(pm) - 1 : 31;
    float2 e = unpack(__shfl_sync(kFull, v, first));
    for (int l = first - 1; l >= 0; --l) e = affine(a_blk, e, unpack(__shfl_sync(kFull, v, l)));
    // e: the offset entering block hi + 1 (a prefix was found), else the b
    // of the window's map of 32 blocks
    const float later = acc_n ? qpow(q, acc_n * half) : 1.0f;
    if (pm) return affine(later, e, acc_b);
    acc_b = affine(later, e, acc_b);
    acc_n += 32;
    hi -= 32;
  }
}

// K4.  sync: 2 + 2 * (tiles + 2 * blocks) words, every bit set: the ticket
// counter (word 0; all ones, so the first ticket is 0), then 64-bit words
// (from word 2): each tile's map from zero, each block's map from zero and
// each block's inclusive prefix.
template <bool kPrecise>
__global__ void __launch_bounds__(kThreads)
q1_kernel(const uint32_t* __restrict__ in, float* __restrict__ out,
          const float* __restrict__ off_in, float2* __restrict__ off_entering,
          float* __restrict__ off_final, unsigned* sync,
          const float* __restrict__ pow_table, long long tiles, long long blocks,
          Geometry g, Taps taps, float esr, float a, double q, float a_blk) {
  extern __shared__ uint32_t smem[];
  __shared__ int wm[kWarps];
  __shared__ float2 wb[kWarps];
  __shared__ long long s_ticket;
  __shared__ float2 s_agg, s_off;
  const Smem s = carve(smem, g.tile);
  auto tile_agg = reinterpret_cast<unsigned long long*>(sync + 2);
  auto blk_agg = tile_agg + tiles;
  auto blk_pre = blk_agg + blocks;
  if (threadIdx.x == 0) s_ticket = atomicAdd(sync, 1u) + 1u;
  __syncthreads();
  const long long gt = s_ticket;
  const long long blk = gt / g.tpb;
  const int tile = static_cast<int>(gt % g.tpb);
  const long long row = blk * g.words;
  long long j0, j1;
  tile_range(g, tile, j0, j1);
  const int own = static_cast<int>(j1 - j0);
  const int len = static_cast<int>(min(j1 + taps.n - 1, g.half) - j0);
  int i0, i1;
  const float2 b_ex = stage_and_scan(in, row, g, j0, own, len, pow_table, esr, a, s.fw,
                                     s.bw, s.T, wm, wb, &s_agg, i0, i1);
  __syncthreads();
  if (threadIdx.x < 32) {
    const long long first = blk * g.tpb;
    const float A = s.T[g.tile];
    const bool last = tile == g.tpb - 1;
    float2 tot;
    if (last) {
      // the block's map from zero: its earlier tiles, then this one
      tot = affine(s.T[own], fold_tiles(tile_agg, first, tile, make_float2(0.0f, 0.0f), A),
                   s_agg);
      if (threadIdx.x == 0) st_relaxed64(&blk_agg[blk], tot);
    } else if (threadIdx.x == 0) {
      st_relaxed64(&tile_agg[gt], s_agg);
    }
    const float2 e_blk = block_look_back(blk, blk_agg, blk_pre, off_in, a_blk, q, g.half);
    if (threadIdx.x == 0 && last) {
      const float2 next = affine(a_blk, e_blk, tot);
      st_relaxed64(&blk_pre[blk], next);
      if (blk == blocks - 1) {
        off_final[0] = next.x;
        off_final[1] = next.y;
      }
    }
    const float2 e = fold_tiles(tile_agg, first, tile, e_blk, A);
    if (threadIdx.x == 0) {
      if (tile == 0) off_entering[blk] = e_blk;
      s_off = e;
    }
  }
  __syncthreads();
  apply_tile<kPrecise>(out, row, g, tile, j0, j1, taps, esr, a,
                       affine(s.T[i0], s_off, b_ex), i0, i1, s.fw, s.bw, s.xf, s.xb);
}

// ---------------------------------------------------------------------------
// K5: fused_nbfm_q1_seq replaces fused_nbfm_q1_u32_3d
// (demodulator_tpu/ops/pallas/fused_nbfm.py:739, pallas_call :782, body
// _q1_kernel :524 and _q1_body :429): the same function as K4, with the
// blocks chained in block order, one composition per block
//
//   off_{i+1} = a^{words} * off_i + tot_i   (float32, a^{words} one float64
//   pow rounded, as _q1_kernel's a_n)
//
// where tot_i is block i's summary from a zero offset.  The TPU kernel
// carries the offset through scratch on a sequential grid.  Here the grid
// runs in one launch with a chained look-back: each CTA takes a ticket from
// an atomic counter and treats ticket t as tile t % tpb of block t / tpb, so
// a CTA only ever waits on a CTA with a lower ticket, which is already
// resident; the chain cannot deadlock.  Per CTA:
//   1. stage the tile (plus the D step pairs the FIR reads after it) and
//      scan it (K4's steps 1 and 2); publish the tile's summary with a
//      release store on the tile's flag;
//   2. thread 0 of the block's last tile composes all of the block's tile
//      summaries into tot_i; thread 0 waits (acquire loads) for the
//      entering offset of its block, published by the previous block's last
//      tile (block 0: off_in); the last tile publishes off_{i+1} (release);
//      then it composes the block's earlier tiles onto the entering offset
//      in order, which gives its own tile's;
//   3. apply from that offset (K4's step 4).
// What bounds it: the chain's flag hops, one per block (~1 us each on an
// NVIDIA H100 80GB HBM3 at 700 W), beside K4's work; the bytes are 8 per
// output word.

// sync: [1 + tiles + blocks] zeroed words: the ticket counter, one ready
// flag per tile summary, one per block's entering offset.
template <bool kPrecise>
__global__ void __launch_bounds__(kThreads)
q1_seq_kernel(const uint32_t* __restrict__ in, float* __restrict__ out,
              const float* __restrict__ off_in, float2* off_entering,
              float* off_final, unsigned* sync, float2* tile_b,
              const float* __restrict__ pow_table, long long tiles, long long blocks,
              Geometry g, Taps taps, float esr, float a, float a_blk) {
  extern __shared__ uint32_t smem[];
  __shared__ int wm[kWarps];
  __shared__ float2 wb[kWarps];
  __shared__ long long s_ticket;
  __shared__ float2 s_agg, s_off;
  const Smem s = carve(smem, g.tile);
  unsigned* tile_ready = sync + 1;
  unsigned* blk_ready = tile_ready + tiles;
  if (threadIdx.x == 0) s_ticket = atomicAdd(sync, 1u);
  __syncthreads();
  const long long t = s_ticket;
  const long long blk = t / g.tpb;
  const int tile = static_cast<int>(t % g.tpb);
  const long long row = blk * g.words;
  long long j0, j1;
  tile_range(g, tile, j0, j1);
  const int own = static_cast<int>(j1 - j0);
  const int len = static_cast<int>(min(j1 + taps.n - 1, g.half) - j0);

  // 1. this tile's summary from a zero offset
  int i0, i1;
  const float2 b_ex = stage_and_scan(in, row, g, j0, own, len, pow_table, esr, a, s.fw,
                                     s.bw, s.T, wm, wb, &s_agg, i0, i1);
  __syncthreads();
  if (threadIdx.x == 0) {
    tile_b[t] = s_agg;
    st_release(&tile_ready[t], 1u);
  }
  // 2. wait for the summaries this CTA composes: the block's earlier tiles,
  // or all of them on the block's last tile
  const long long first = blk * g.tpb;
  const int need = tile == g.tpb - 1 ? g.tpb : tile;
  for (int k = threadIdx.x; k < need; k += kThreads) wait_flag(&tile_ready[first + k]);
  __syncthreads();
  if (threadIdx.x == 0) {
    const float A_tile = s.T[g.tile];
    const bool last = tile == g.tpb - 1;
    // the block's summary first, so the chain's critical path per block is
    // one wait, one composition and one release
    float2 tot = make_float2(0.0f, 0.0f);
    if (last) {
      const float A_last = s.T[last_len(g)];
      for (int k = 0; k < g.tpb; ++k) {
        tot = affine(k == g.tpb - 1 ? A_last : A_tile, tot, __ldcg(&tile_b[first + k]));
      }
    }
    float2 off_b;
    if (blk == 0) {
      off_b = make_float2(off_in[0], off_in[1]);
      if (tile == 0) off_entering[0] = off_b;
    } else {
      wait_flag(&blk_ready[blk]);
      off_b = __ldcg(&off_entering[blk]);
    }
    if (last) {
      const float2 next = affine(a_blk, off_b, tot);
      if (blk + 1 < blocks) {
        off_entering[blk + 1] = next;
        st_release(&blk_ready[blk + 1], 1u);
      } else {
        off_final[0] = next.x;
        off_final[1] = next.y;
      }
    }
    float2 o = off_b;
    for (int k = 0; k < tile; ++k) o = affine(A_tile, o, __ldcg(&tile_b[first + k]));
    s_off = o;
  }
  __syncthreads();
  // 3. apply
  apply_tile<kPrecise>(out, row, g, tile, j0, j1, taps, esr, a,
                       affine(s.T[i0], s_off, b_ex), i0, i1, s.fw, s.bw, s.xf, s.xb);
}

// The geometry of `blocks` blocks of `words` words in tiles of `tile` step
// pairs, or tpb = 0 if the launch cannot take them.
Geometry geometry(long long blocks, long long words, int tile, long long tiles, int ntaps) {
  Geometry g{words, words / 2, tile, 0};
  if (blocks < 1 || words < 2 || words % 2 || tile < 1 || tile > kMaxTile || ntaps < 1 ||
      ntaps > kMaxTaps || g.half < ntaps) {
    return g;
  }
  const long long tpb = (g.half + tile - 1) / tile;
  if (tpb > 0x7fffffffLL || tiles != blocks * tpb || tiles > 0x7fffffffLL) return g;
  g.tpb = static_cast<int>(tpb);
  return g;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// C entry point (loaded with ctypes by ops/cuda/build.py).  off_in: device
// float[2]; off_entering: device float[blocks][2]; off_final: device
// float[2]; sync: device uint32[2 + 2 * (tiles + 2 * blocks)], every bit SET
// (the ticket counter, then the published maps and prefixes); pow_table:
// device float[tile + kMaxTaps], float32(q^m) with q = decay^2, the power
// taken in float64; tiles = blocks * ceil(words / 2 / tile); a_blk: float32
// of decay^words.  One launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int fused_nbfm_q1_launch(const void* in, void* out, const void* off_in,
                                    void* off_entering, void* off_final, void* sync,
                                    const void* pow_table, long long tiles, long long blocks,
                                    long long words, int tile, const float* taps_host,
                                    int ntaps, float esr, double decay, float a_blk,
                                    int precise, void* stream) {
  const Geometry g = geometry(blocks, words, tile, tiles, ntaps);
  if (g.tpb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const Taps taps = make_taps(taps_host, ntaps);
  const float a = static_cast<float>(decay);
  const double q = decay * decay;  // per step pair, as the host's table
  auto s = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const uint32_t*>(in);
  auto dst = static_cast<float*>(out);
  auto oin = static_cast<const float*>(off_in);
  auto oent = static_cast<float2*>(off_entering);
  auto ofin = static_cast<float*>(off_final);
  auto flags = static_cast<unsigned*>(sync);
  auto pt = static_cast<const float*>(pow_table);
  const size_t smem = smem_bytes(tile);
  const unsigned grid = static_cast<unsigned>(tiles);
  int rc;
  if (precise) {
    rc = set_smem(q1_kernel<true>, smem);
    if (rc) return rc;
    q1_kernel<true><<<grid, kThreads, smem, s>>>(src, dst, oin, oent, ofin, flags, pt, tiles,
                                                  blocks, g, taps, esr, a, q, a_blk);
  } else {
    rc = set_smem(q1_kernel<false>, smem);
    if (rc) return rc;
    q1_kernel<false><<<grid, kThreads, smem, s>>>(src, dst, oin, oent, ofin, flags, pt, tiles,
                                                   blocks, g, taps, esr, a, q, a_blk);
  }
  return static_cast<int>(cudaGetLastError());
}

// C entry point of K5.  off_in: device float[2]; off_entering: device
// float[blocks][2]; off_final: device float[2]; sync: device uint32[1 + tiles
// + blocks], ZEROED; tile_b: device float[tiles][2]; pow_table as K4's;
// tiles = blocks * ceil(words / 2 / tile); a_blk: float32 of decay^words.
// One launch on `stream`, no synchronisation; returns cudaGetLastError().
extern "C" int fused_nbfm_q1_seq_launch(const void* in, void* out, const void* off_in,
                                        void* off_entering, void* off_final,
                                        void* sync, void* tile_b, const void* pow_table,
                                        long long tiles, long long blocks, long long words,
                                        int tile, const float* taps_host, int ntaps,
                                        float esr, double decay, float a_blk, int precise,
                                        void* stream) {
  const Geometry g = geometry(blocks, words, tile, tiles, ntaps);
  if (g.tpb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const Taps taps = make_taps(taps_host, ntaps);
  const float a = static_cast<float>(decay);
  auto s = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const uint32_t*>(in);
  auto dst = static_cast<float*>(out);
  auto oin = static_cast<const float*>(off_in);
  auto oent = static_cast<float2*>(off_entering);
  auto ofin = static_cast<float*>(off_final);
  auto flags = static_cast<unsigned*>(sync);
  auto tb = static_cast<float2*>(tile_b);
  auto pt = static_cast<const float*>(pow_table);
  const size_t smem = smem_bytes(tile);
  const unsigned grid = static_cast<unsigned>(tiles);
  int rc;
  if (precise) {
    rc = set_smem(q1_seq_kernel<true>, smem);
    if (rc) return rc;
    q1_seq_kernel<true><<<grid, kThreads, smem, s>>>(src, dst, oin, oent, ofin, flags, tb,
                                                      pt, tiles, blocks, g, taps, esr, a,
                                                      a_blk);
  } else {
    rc = set_smem(q1_seq_kernel<false>, smem);
    if (rc) return rc;
    q1_seq_kernel<false><<<grid, kThreads, smem, s>>>(src, dst, oin, oent, ofin, flags, tb,
                                                       pt, tiles, blocks, g, taps, esr, a,
                                                       a_blk);
  }
  return static_cast<int>(cudaGetLastError());
}
