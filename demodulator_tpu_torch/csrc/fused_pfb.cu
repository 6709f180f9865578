// Polyphase channel-bank front (K6) for Hopper (sm_90a).
//
// fused_pfb replaces the Pallas TPU kernel fused_pfb_demod
// (demodulator_tpu/ops/pallas/fused_pfb.py:196, pallas_call :232, body
// _pfb_kernel :90).  It computes what the channelizer's call_split followed
// by the fast discriminator computes (ops/channelizer.py, ops/demod.py):
//
//   x[i]     = shiftOrigin of complex sample i (u16 word i: low byte I)
//   z[m, c]  = sum_p h[p, c] * x[(m - p)C - c]       (branch filter, p order)
//   y[m, k]  = sum_c z[m, c] * e^{+j 2 pi k c / C}   (C-point DFT)
//   d[m2, k] = atan2 of conj(y[2 m2, k]) * y[2 m2 + 1, k], NaN -> 0
//
// with x[i] for i < 0 taken from the carried history (the last P*C
// conditioned samples before the launch), and new_hist = the last P*C
// conditioned samples of hist ++ x.
//
// Design.  One CTA per tile of F frames (F*C about kTileSamples complex
// samples, kSmallTileSamples at C = 2 and 4; the last tile takes what is
// left, so any block of T % 2C == 0 samples runs, at every C up to
// kMaxChannels).  The plan's sizes (C, its factors, the strides, F, the
// frame pairs of a warp batch) are compile-time constants for every power
// of two C from 2 to 256 with the 12-tap prototype (Fixed), so divisions
// and addresses fold into shifts and immediates; any other C or P reads
// them from the host's Plan.  Per tile:
//   1. staging: the conditioned samples of the tile's frames and the P*C
//      before them go to shared memory as float2 (I, Q), from the history
//      where they precede the launch, else from the input, a 32-bit word
//      (two samples) a load, all of a thread's kStageWords loads in flight
//      at once, and one 16-byte store, conditioned exactly as the plain
//      version but with byte permutes instead of int-to-float conversions
//      (condition_word); the last tile writes the new history from there;
//   2. branch filter, into z (float32, frames padded to C + C2 where
//      C % 32 == 0): a thread takes channel c of kRun consecutive frames and
//      slides a ring of kRun samples down the staged column, so each tap
//      loads one sample and one tap value for kRun outputs (run_len;
//      unrolled for the prototype's kTaps = 12).  Each z is the plain
//      version's: the same float32 multiply and add per tap, in p order, bit
//      for bit;
//   3. the DFT as a two-factor Cooley-Tukey FFT in float64, C = C1*C2 (the
//      wrapper's plan, ops/cuda/fused_pfb.py fft_plan): with w = e^{+j 2
//      pi/C}, c = C2*c1 + c2 and k = k1 + C1*k2,
//
//        u[k1, c2]       = sum_c1 w_C1^(k1 c1) z[C2 c1 + c2]   (stage 1)
//        u[k1, c2]      *= w_C^(k1 c2)                        (twiddle)
//        y[k1 + C1 k2]   = sum_c2 w_C2^(k2 c2) u[k1, c2]       (stage 2)
//
//      A stage of 2, 4, 8 or 16 points is a radix-2 butterfly network
//      unrolled at compile time in registers, one task per column; any
//      other size a direct sum, one task per output.  Each warp takes G frame
//      pairs at a time through both stages, exchanging through its own
//      buffer u (double2, rows padded to C2 + 1 so both stages' accesses are
//      free of bank conflicts at the main path's sizes; u reuses the staged
//      samples' space) with __syncwarp only; at C = 2 and 4 a thread takes a
//      frame pair through both stages in registers (small_pairs).  Every
//      factor is read from one float64 table of exact cos and sin, staged in
//      shared memory: w_C^i for i < C, then w_C^(k1 c2) in u's layout; a
//      factor that is exactly +j (a quarter turn) is a swap of parts.  Each
//      y is rounded to float32 once;
//   4. the discriminator pairs the even and the odd frame of each pair.
//      Where C1 is a power of two up to 16 and C2 a radix size (every power
//      of two C from 8 to 256), the two frames' stage-2 tasks sit in lanes l
//      and l ^ C1: each lane hands half of its outputs to the other with
//      __shfl_xor_sync and computes the discriminator of its own half
//      (stage2_demod), so y never goes back to shared memory.  Other plans
//      write y over z and read it back.  d is written k fastest.
// A frame's arithmetic does not depend on the tile or the launch it falls in.
//
// Precision.  With strong carriers in other channels a weak channel's bin is
// a large cancellation, and float32 sums in two different orders put the
// angles of such bins up to 0.0074 rad apart at C = 64 (a float32 direct DFT
// against a float32 matrix product, on an NVIDIA H100 80GB HBM3 at 700 W).
// So the FFT runs in float64, as the plain version's matrix product does.
// None of the TPU kernel's lane packing, lane rolls, folded lane constants,
// 3-pass bf16 DFT or 8-row tile divisor is carried over.
//
// What bounds it: the bound counts 2 bytes in and 2 out per sample and, as
// float32 work, 4*P operations per sample for the branch filter and
// 5*log2(C) for the FFT (chip_smoke.py pfb_ops).  The kernel cannot reach
// it: z must be summed with separate float32 multiplies and adds (48 a
// sample at P = 12), the FFT costs about 18 float64 operations and 4
// float32<->float64 conversions a sample, at a half and an eighth of the
// float32 rate, and the discriminator about 20 float32 operations a
// sample; all of it issues from the SMs' instruction slots, and each wave
// of CTAs stages its tiles before it computes.  On an NVIDIA H100 80GB HBM3
// at 700 W (ops/cuda/sections.py, cumulative) one bank64 block (C = 64,
// 8 x 8) takes about 4.3 us for the output alone, 6.7 with staging, 14.0
// with the branch filter, 15.4 with the discriminator and 21.5 for the
// whole kernel; a bank4 chunk (C = 4, 2 x 2) 3.2, 4.1, 8.1, 8.1 and
// 10.2 us.  PERF.md has the numbers.

#include "nbfm_device.cuh"

namespace {

using namespace nbfm;

constexpr int kMaxChannels = 256;   // ops/cuda/fused_pfb.py MAX_CHANNELS
constexpr int kMaxPhases = 32;      // ops/cuda/fused_pfb.py MAX_PHASES
constexpr int kTileSamples = 2048;  // complex samples per CTA tile (target)
constexpr int kSmallTileSamples = 2560;
constexpr int kWarps = kThreads / 32;
constexpr int kStageWords = 6;      // staging loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;
// taps per branch of the channelizer's prototype (ops/channelizer.py
// design_pfb_prototype): the branch filter's unrolled case
constexpr int kTaps = 12;

__host__ __device__ constexpr bool is_radix(int n) {
  return n == 2 || n == 4 || n == 8 || n == 16;
}

// The largest radix factor of the plan (1: both direct): the kernel's
// instantiation, which holds only the butterfly networks up to it.
__host__ __device__ constexpr int max_radix(int C1, int C2) {
  const int r1 = is_radix(C1) ? C1 : 1, r2 = is_radix(C2) ? C2 : 1;
  return r1 > r2 ? r1 : r2;
}

// C = 2 (1 x 2) and C = 4 (2 x 2): a thread takes a frame pair through both
// stages in registers, with no stage buffers (small_pairs).
__host__ __device__ constexpr bool is_small(int C) { return C == 2 || C == 4; }

// Frames per thread in the branch filter of a compiled-in plan: 8 where
// C >= 16, 7 at C = 4, else 5 (a runtime plan's filter, of any P, takes
// runs of 5).  Longer runs load fewer samples per output; where a warp's
// lanes hold several frame groups (C < 16) the run is odd, so that their
// loads fall in distinct banks.
__host__ __device__ constexpr int run_len(int C) { return C >= 16 ? 8 : (C == 4 ? 7 : 5); }

// Frames per tile: a multiple of 2 * run (whole frame pairs and filter
// runs), at least that, about kTileSamples complex samples
// (kSmallTileSamples for C = 2 and 4, where the filter's runs and the frame
// pairs then come out at whole multiples of kThreads).
__host__ __device__ constexpr int tile_frames(int C, int run) {
  const int f = (is_small(C) ? kSmallTileSamples : kTileSamples) / C / (2 * run) * (2 * run);
  return f < 2 * run ? 2 * run : f;
}

// Frame pairs per warp batch: the batch fills the warp in the stage with
// fewer tasks per frame (a column per radix task, an output per direct one).
__host__ __device__ constexpr int batch_pairs(int C1, int C2, int F) {
  const int t1 = is_radix(C1) ? C2 : C1 * C2;
  const int t2 = is_radix(C2) ? C1 : C1 * C2;
  const int g = 32 / (2 * (t1 < t2 ? t1 : t2));
  return g < 1 ? 1 : (g > F / 2 ? F / 2 : g);
}

// Row stride of the stage buffers u in double2, and frame stride of z in
// floats (frames padded so that the stage-1 reads of a warp's frames, C2
// columns each, fall in distinct banks).
__host__ __device__ constexpr int row_stride(int C2) { return C2 > 1 ? C2 + 1 : 1; }
__host__ __device__ constexpr int frame_stride(int C, int C2) { return C % 32 ? C : C + C2; }

// log2(C1) where stage 2 carries the discriminator (C1 a power of two up to
// 16, C2 a radix size, C not small), else -1.
__host__ __device__ constexpr int demod_shift(int C1, int C2) {
  if (is_small(C1 * C2) || !is_radix(C2) || (C1 & (C1 - 1)) || C1 > 16) return -1;
  int l = 0;
  while ((1 << l) < C1) ++l;
  return l;
}

// The plan's sizes, read at run time: any C, any P (filter runs of 5).
struct Plan {
  static constexpr int RUN = 5;
  int C, C1, C2, P;
  int F;   // frames per tile
  int G;   // frame pairs per warp batch (shared-memory stages)
  int RS;  // row_stride(C2)
  int ZS;  // frame_stride(C, C2)
  int L1;  // demod_shift(C1, C2)
};

Plan make_plan(int C, int C1, int C2, int P, int run) {
  const int F = tile_frames(C, run);
  return Plan{C, C1, C2, P, F, batch_pairs(C1, C2, F), row_stride(C2), frame_stride(C, C2),
              demod_shift(C1, C2)};
}

// The same sizes as compile-time constants: C = kC1 * kC2 (a power of two)
// with the kTaps-tap prototype.  Built from a Plan it ignores.
template <int kC1, int kC2>
struct Fixed {
  static constexpr int C1 = kC1, C2 = kC2, C = kC1 * kC2, P = kTaps, RUN = run_len(C);
  static constexpr int F = tile_frames(C, RUN), G = batch_pairs(kC1, kC2, F);
  static constexpr int RS = row_stride(kC2), ZS = frame_stride(C, kC2), L1 = demod_shift(kC1, kC2);
  __device__ explicit Fixed(const Plan&) {}
};

template <class S>
__host__ __device__ __forceinline__ int table_len(const S& p) {
  return p.C + p.C1 * p.RS;
}

// twiddle table | z (re, im) | staged samples (float2, one spare for the
// alignment of the staging stores), reused by the warps' stage buffers u
size_t smem_bytes(const Plan& p) {
  const size_t tw = sizeof(double2) * table_len(p);
  const size_t z = sizeof(float) * 2 * p.F * p.ZS;
  const size_t x = sizeof(float2) * (static_cast<size_t>(p.P) * p.C + p.F * p.C + 1);
  const size_t u = is_small(p.C) ? 0 : sizeof(double2) * kWarps * 2 * p.G * p.C1 * p.RS;
  return tw + z + (x > u ? x : u);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return make_double2(__fma_rn(a.x, w.x, -__dmul_rn(a.y, w.y)),
                      __fma_rn(a.x, w.y, __dmul_rn(a.y, w.x)));
}

// acc + a * w
__device__ __forceinline__ double2 cmac(double2 acc, double2 a, double2 w) {
  acc.x = __fma_rn(a.x, w.x, acc.x);
  acc.x = __fma_rn(-a.y, w.y, acc.x);
  acc.y = __fma_rn(a.x, w.y, acc.y);
  acc.y = __fma_rn(a.y, w.x, acc.y);
  return acc;
}

template <int N>
struct Log2 {
  static constexpr int value = 1 + Log2<N / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// i with its log2(N) bits reversed (loops of constant trip count, so the
// unrolled callers index registers with constants)
template <int N>
__device__ __forceinline__ int bitrev(int i) {
  int r = 0;
#pragma unroll
  for (int b = 0; b < Log2<N>::value; ++b) r = (r << 1) | ((i >> b) & 1);
  return r;
}

// The butterflies of span LEN, then those of the larger spans.  The factor
// w_LEN^(LEN/4) is exactly +j: a swap of parts.
template <int N, int LEN>
__device__ __forceinline__ void fft_pass(double2 (&v)[N], const double2* tw, int stride) {
#pragma unroll
  for (int j = 0; j < LEN / 2; ++j) {
    // w_LEN^j = w_N^(j N/LEN)
    const double2 w = j ? tw[j * (N / LEN) * stride] : make_double2(1.0, 0.0);
#pragma unroll
    for (int i = 0; i < N; i += LEN) {
      const double2 a = v[i + j];
      const double2 c = v[i + j + LEN / 2];
      const double2 b = j == 0 ? c : (4 * j == LEN ? make_double2(-c.y, c.x) : cmul(c, w));
      v[i + j] = make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
      v[i + j + LEN / 2] = make_double2(__dsub_rn(a.x, b.x), __dsub_rn(a.y, b.y));
    }
  }
  if constexpr (LEN < N) fft_pass<N, 2 * LEN>(v, tw, stride);
}

// In-register radix-2 FFT of N points, v in bit-reversed order on entry and
// natural order on return: v[k] = sum_c in[c] w_N^(k c), w_N^m = tw[m*stride].
template <int N>
__device__ __forceinline__ void fft(double2 (&v)[N], const double2* tw, int stride) {
  if constexpr (N > 1) fft_pass<N, 2>(v, tw, stride);
}

// Stage 1 of nf frames from z (frame f at zr + f*ZS) into u (frame f at
// u + f*C1*RS, row k1 at k1*RS), twiddles applied.  N = C1 for a radix
// stage; 0 for the direct sum.
template <int N, class S>
__device__ __forceinline__ void stage1(const float* zr, const float* zi, double2* u,
                                       const double2* tw, int nf, const S& p, int lane) {
  const int C = p.C, C1 = p.C1, C2 = p.C2, RS = p.RS, ZS = p.ZS;
  const double2* tw2 = tw + C;  // w_C^(k1 c2) at k1*RS + c2
  if constexpr (N > 0) {
    for (int t = lane; t < nf * C2; t += 32) {
      const int f = t / C2;
      const int c2 = t - f * C2;
      const float* fr = zr + f * ZS + c2;
      const float* fi = zi + f * ZS + c2;
      double2 v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c1 = bitrev<N>(i);
        v[i] = make_double2(fr[c1 * C2], fi[c1 * C2]);
      }
      fft<N>(v, tw, C2);  // w_C1^m = w_C^(m C2)
      double2* out = u + f * C1 * RS + c2;
#pragma unroll
      for (int k1 = 0; k1 < N; ++k1) {
        out[k1 * RS] = k1 ? cmul(v[k1], tw2[k1 * RS + c2]) : v[0];
      }
    }
  } else {
    for (int t = lane; t < nf * C; t += 32) {
      const int f = t / C;
      const int r = t - f * C;
      const int k1 = r / C2;
      const int c2 = r - k1 * C2;
      const float* fr = zr + f * ZS + c2;
      const float* fi = zi + f * ZS + c2;
      double2 acc = make_double2(0.0, 0.0);
      int m = 0;  // k1 c1 mod C1
      for (int c1 = 0; c1 < C1; ++c1) {
        acc = cmac(acc, make_double2(fr[c1 * C2], fi[c1 * C2]), tw[m * C2]);
        m += k1;
        if (m >= C1) m -= C1;
      }
      u[(f * C1 + k1) * RS + c2] = k1 ? cmul(acc, tw2[k1 * RS + c2]) : acc;
    }
  }
}

// Stage 2 of nf frames from u into y, rounded once to float32 and written
// over the frames' z (natural k order).  N = C2 for a radix stage; 0 for the
// direct sum.
template <int N, class S>
__device__ __forceinline__ void stage2(const double2* u, float* zr, float* zi, const double2* tw,
                                       int nf, const S& p, int lane) {
  const int C = p.C, C1 = p.C1, C2 = p.C2, RS = p.RS, ZS = p.ZS;
  if constexpr (N > 0) {
    for (int t = lane; t < nf * C1; t += 32) {
      const int f = t / C1;
      const int k1 = t - f * C1;
      const double2* in = u + (f * C1 + k1) * RS;
      double2 v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = in[bitrev<N>(i)];
      fft<N>(v, tw, C1);  // w_C2^m = w_C^(m C1)
      float* yr = zr + f * ZS + k1;
      float* yi = zi + f * ZS + k1;
#pragma unroll
      for (int k2 = 0; k2 < N; ++k2) {
        yr[k2 * C1] = __double2float_rn(v[k2].x);
        yi[k2 * C1] = __double2float_rn(v[k2].y);
      }
    }
  } else {
    for (int t = lane; t < nf * C; t += 32) {
      const int f = t / C;
      const int k = t - f * C;
      const int k2 = k / C1;
      const int k1 = k - k2 * C1;
      const double2* in = u + (f * C1 + k1) * RS;
      double2 acc = make_double2(0.0, 0.0);
      int m = 0;  // k2 c2 mod C2
      for (int c2 = 0; c2 < C2; ++c2) {
        acc = cmac(acc, in[c2], tw[m * C1]);
        m += k2;
        if (m >= C2) m -= C2;
      }
      zr[f * ZS + k] = __double2float_rn(acc.x);
      zi[f * ZS + k] = __double2float_rn(acc.y);
    }
  }
}

// demod_pairs of a frame pair's bin from the lane holding (mr, mi) and the
// other frame's (pr, pi): frame 2j is the lane's own on an even lane, the
// other's on an odd one.  The same float32 operations as demod_pairs in both
// cases (the products commute; zj's operands swap).
template <bool kPrecise>
__device__ __forceinline__ float demod_lane(float mr, float mi, float pr, float pi, bool odd) {
  const float zr = __fadd_rn(__fmul_rn(mr, pr), __fmul_rn(mi, pi));
  const float a = __fmul_rn(mi, pr), b = __fmul_rn(mr, pi);
  const float zj = odd ? __fsub_rn(b, a) : __fsub_rn(a, b);
  const float s = atan2_poly<kPrecise>(zj, zr);
  return isnan(s) ? 0.0f : s;
}

// Stage 2 of np frame pairs from u, with the discriminator, into rows
// 0 .. np-1 of out.  N = C2 (a radix size); C1 = 2^L1 <= 16, so task t =
// f*C1 + k1 sits in lane t % 32 and frame f's pair partner in lane ^ C1.
// The even lane computes bins k2 < N/2 of the pair, the odd lane the rest,
// each handing the other the half it needs.
template <bool kPrecise, int N, class S>
__device__ __forceinline__ void stage2_demod(const double2* u, const double2* tw, float* out,
                                             int np, const S& p, int lane) {
  const int C = p.C, C1 = p.C1, RS = p.RS, L1 = p.L1;
  const int nt = np << (L1 + 1);
  const int k1 = lane & (C1 - 1);
  const bool odd = (lane >> L1) & 1;
  for (int t0 = 0; t0 < nt; t0 += 32) {  // warp-uniform: every lane shuffles
    const int t = t0 + lane;
    const bool on = t < nt;
    const double2* in = u + (on ? t : 0) * RS;
    double2 v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = in[bitrev<N>(i)];
    fft<N>(v, tw, C1);  // w_C2^m = w_C^(m C1)
    float yr[N], yi[N];
#pragma unroll
    for (int k2 = 0; k2 < N; ++k2) {
      yr[k2] = __double2float_rn(v[k2].x);
      yi[k2] = __double2float_rn(v[k2].y);
    }
    float* row = out + ((t >> L1) >> 1) * C + k1 + (odd ? (N / 2) * C1 : 0);
#pragma unroll
    for (int h = 0; h < N / 2; ++h) {
      const float mr = odd ? yr[h + N / 2] : yr[h], mi = odd ? yi[h + N / 2] : yi[h];
      const float sr = odd ? yr[h] : yr[h + N / 2], si = odd ? yi[h] : yi[h + N / 2];
      const float pr = __shfl_xor_sync(kFull, sr, C1);
      const float pi = __shfl_xor_sync(kFull, si, C1);
      const float s = demod_lane<kPrecise>(mr, mi, pr, pi, odd);
      if (on) row[h * C1] = s;
    }
  }
}

// Stage 1 of n1 points: the radix network of n1 if n1 is a power of two
// from N up to R, else the direct sum.
template <int N, int R, class S>
__device__ __forceinline__ void stage1_of(int n1, const float* zr, const float* zi, double2* u,
                                          const double2* tw, int nf, const S& p, int lane) {
  if constexpr (N <= R) {
    if (n1 == N) {
      stage1<N, S>(zr, zi, u, tw, nf, p, lane);
      return;
    }
    stage1_of<2 * N, R, S>(n1, zr, zi, u, tw, nf, p, lane);
  } else {
    stage1<0, S>(zr, zi, u, tw, nf, p, lane);
  }
}

template <int N, int R, class S>
__device__ __forceinline__ void stage2_of(int n2, const double2* u, float* zr, float* zi,
                                          const double2* tw, int nf, const S& p, int lane) {
  if constexpr (N <= R) {
    if (n2 == N) {
      stage2<N, S>(u, zr, zi, tw, nf, p, lane);
      return;
    }
    stage2_of<2 * N, R, S>(n2, u, zr, zi, tw, nf, p, lane);
  } else {
    stage2<0, S>(u, zr, zi, tw, nf, p, lane);
  }
}

// stage2_demod of n2 points, n2 a radix size from N up to R
template <bool kPrecise, int N, int R, class S>
__device__ __forceinline__ void stage2_demod_of(int n2, const double2* u, const double2* tw,
                                                float* out, int np, const S& p, int lane) {
  if constexpr (N <= R) {
    if (n2 == N) {
      stage2_demod<kPrecise, N, S>(u, tw, out, np, p, lane);
      return;
    }
    stage2_demod_of<kPrecise, 2 * N, R, S>(n2, u, tw, out, np, p, lane);
  }
}

// Both stages of one frame of C1*C2 points in registers, v in natural order
// on entry and y on return, with the arithmetic of stage1 and stage2.
template <int C1, int C2>
__device__ __forceinline__ void frame_fft(double2 (&v)[C1 * C2], const double2* tw) {
  constexpr int C = C1 * C2, RS = C2 > 1 ? C2 + 1 : 1;
  double2 u[C1][C2];
#pragma unroll
  for (int c2 = 0; c2 < C2; ++c2) {
    double2 a[C1];
#pragma unroll
    for (int i = 0; i < C1; ++i) a[i] = v[C2 * bitrev<C1>(i) + c2];
    fft<C1>(a, tw, C2);
#pragma unroll
    for (int k1 = 0; k1 < C1; ++k1) {
      // w_C^(k1 c2), exactly +j at a quarter turn
      u[k1][c2] = k1 * c2 == 0 ? a[k1]
                  : (4 * k1 * c2 == C ? make_double2(-a[k1].y, a[k1].x)
                                      : cmul(a[k1], tw[C + k1 * RS + c2]));
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < C1; ++k1) {
    double2 b[C2];
#pragma unroll
    for (int i = 0; i < C2; ++i) b[i] = u[k1][bitrev<C2>(i)];
    fft<C2>(b, tw, C1);
#pragma unroll
    for (int k2 = 0; k2 < C2; ++k2) v[k1 + C1 * k2] = b[k2];
  }
}

// A small C: thread j takes frame pair j of the tile (frames 2j, 2j + 1 of
// z) through the FFT and the discriminator, into row j of d.
template <bool kPrecise, int C1, int C2, class S>
__device__ __forceinline__ void small_pairs(const float* zr, const float* zi, const S& p,
                                            const double2* tw, float* d, int pairs) {
  const int ZS = p.ZS;
  constexpr int C = C1 * C2;
  for (int j = threadIdx.x; j < pairs; j += kThreads) {
    float y[2][C][2];
#pragma unroll
    for (int fr = 0; fr < 2; ++fr) {
      double2 v[C];
      const int f = 2 * j + fr;
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = make_double2(zr[f * ZS + c], zi[f * ZS + c]);
      frame_fft<C1, C2>(v, tw);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        y[fr][k][0] = __double2float_rn(v[k].x);
        y[fr][k][1] = __double2float_rn(v[k].y);
      }
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      d[j * C + k] = demod_pairs<kPrecise>(y[0][k][0], y[0][k][1], y[1][k][0], y[1][k][1]);
    }
  }
}

// Branch-filter tap p = p0 + Q, p0 = 1 (mod 5), of channel c for 5
// consecutive frames (the filter of any P): the new sample goes to ring slot
// (-p) mod 5, and output r reads slot (r - p) mod 5.
template <int Q>
__device__ __forceinline__ void filter_tap(int p, const float2* xc, const float* __restrict__ h,
                                           int C, int c, float2 (&w)[5], float (&ar)[5],
                                           float (&ai)[5]) {
  w[(9 - Q) % 5] = xc[-p * C];
  const float hv = h[p * C + c];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const float2 xv = w[(r + 9 - Q) % 5];
    ar[r] = __fadd_rn(ar[r], __fmul_rn(hv, xv.x));
    ai[r] = __fadd_rn(ai[r], __fmul_rn(hv, xv.y));
  }
}

// The branch filter of channel c for kRun consecutive frames, into ar, ai.
// kP > 0: P = kP taps, unrolled, so every ring slot and tap value is a
// register; kP = 0: any P, the taps in rings of 5 (kRun = 5).
template <int kP, int kRun>
__device__ __forceinline__ void filter_run(const float2* xc, const float* __restrict__ h, int P,
                                           int C, int c, float (&ar)[kRun], float (&ai)[kRun]) {
  float2 w[kRun];
  const float h0 = h[c];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    w[r] = xc[r * C];
    ar[r] = __fmul_rn(h0, w[r].x);
    ai[r] = __fmul_rn(h0, w[r].y);
  }
  if constexpr (kP > 0) {
#pragma unroll
    for (int p = 1; p < kP; ++p) {
      w[(kP * kRun - p) % kRun] = xc[-p * C];  // slot (-p) mod kRun
      const float hv = h[p * C + c];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const float2 xv = w[(kP * kRun + r - p) % kRun];  // slot (r - p) mod kRun
        ar[r] = __fadd_rn(ar[r], __fmul_rn(hv, xv.x));
        ai[r] = __fadd_rn(ai[r], __fmul_rn(hv, xv.y));
      }
    }
  } else {
    static_assert(kRun == 5, "the filter of any P takes runs of 5");
    int p0 = 1;
    for (; p0 + 5 <= P; p0 += 5) {
      filter_tap<0>(p0, xc, h, C, c, w, ar, ai);
      filter_tap<1>(p0 + 1, xc, h, C, c, w, ar, ai);
      filter_tap<2>(p0 + 2, xc, h, C, c, w, ar, ai);
      filter_tap<3>(p0 + 3, xc, h, C, c, w, ar, ai);
      filter_tap<4>(p0 + 4, xc, h, C, c, w, ar, ai);
    }
    if (p0 < P) filter_tap<0>(p0, xc, h, C, c, w, ar, ai);
    if (p0 + 1 < P) filter_tap<1>(p0 + 1, xc, h, C, c, w, ar, ai);
    if (p0 + 2 < P) filter_tap<2>(p0 + 2, xc, h, C, c, w, ar, ai);
    if (p0 + 3 < P) filter_tap<3>(p0 + 3, xc, h, C, c, w, ar, ai);
  }
}

// CTAs an SM holds, as registers allow: the radix-16 network needs up to
// 128 registers a thread, radix 8 up to 80, the others 64, a small C 48.
constexpr int min_ctas(int kR, int kSmall) {
  return kSmall ? 5 : (kR == 16 ? 2 : (kR == 8 ? 3 : 4));
}

// kR: the plan's largest radix factor (max_radix); kSmall: C for a small C
// (is_small), else 0; kP: kTaps for P = kTaps, else 0; S: Plan, or Fixed
// for a compiled-in plan.  CTA b takes frames [b*F, min((b+1)*F, n/C)).
template <bool kPrecise, int kR, int kSmall, int kP, class S>
__global__ void __launch_bounds__(kThreads, min_ctas(kR, kSmall))
pfb_kernel(const uint16_t* __restrict__ in, const float* __restrict__ hist,
           const float* __restrict__ h, const double2* __restrict__ table,
           float* __restrict__ d, float* __restrict__ new_hist, long long n, Plan pl) {
  const S s(pl);
  constexpr int kRun = S::RUN;
  extern __shared__ double2 smem[];
  const int C = s.C, P = kP ? kP : s.P, ZS = s.ZS;
  const int PC = P * C;
  const long long M = n / C;  // frames in the launch
  const long long m0 = static_cast<long long>(blockIdx.x) * s.F;
  const int Fe = static_cast<int>(min(static_cast<long long>(s.F), M - m0));
  double2* tw = smem;                              // [table_len]
  float* zr = reinterpret_cast<float*>(tw + table_len(s));  // [F * ZS]
  float* zi = zr + s.F * ZS;
  float2* xs = reinterpret_cast<float2*>(zi + s.F * ZS);  // [PC + F * C + 1]
  // per-warp stage buffers, over the staged samples once z is done
  double2* u = reinterpret_cast<double2*>(xs) + (threadIdx.x / 32) * 2 * s.G * s.C1 * s.RS;

  for (int i = threadIdx.x; i < table_len(s); i += kThreads) tw[i] = table[i];
  // stage x[base + i], i < len, as (I, Q): before sample 0 from the
  // history, then from `in` a 32-bit word (two samples) a load and a 16-byte
  // store (x starts one float2 in where that aligns the stores),
  // kStageWords loads in flight
  const long long base = m0 * C - PC;
  const int len = PC + Fe * C;
  const int nh = base < 0 ? static_cast<int>(min(static_cast<long long>(len), -base)) : 0;
  const uint16_t* src = in + base;  // src[i] for nh <= i < len
  // a sample before the first whole word, and one after the last
  const int w0 = nh + (nh < len && (reinterpret_cast<uintptr_t>(src + nh) & 2) ? 1 : 0);
  const int nw = (len - w0) / 2;
  float2* x = xs + (w0 & 1);
  for (int i = threadIdx.x; i < nh; i += kThreads) {  // hist[lane][PC + base + i]
    x[i] = make_float2(hist[PC + base + i], hist[2 * PC + base + i]);
  }
  if (threadIdx.x < 2) {
    const int i = threadIdx.x ? w0 + 2 * nw : nh;
    if (i < (threadIdx.x ? len : w0)) {
      const float4 c = condition_word<false>(src[i]);  // bytes 2, 3 unused
      x[i] = make_float2(c.x, c.y);
    }
  }
  // this thread's words: w0/2 + threadIdx.x + k*kThreads (one round of
  // kStageWords at the main path's sizes)
  const uint32_t* words = reinterpret_cast<const uint32_t*>(src + w0) + threadIdx.x;
  float4* x4 = reinterpret_cast<float4*>(x + w0) + threadIdx.x;
  for (int v0 = 0; v0 < nw; v0 += kStageWords * kThreads) {
    uint32_t w[kStageWords];
#pragma unroll
    for (int r = 0; r < kStageWords; ++r) {
      w[r] = v0 + r * kThreads + static_cast<int>(threadIdx.x) < nw
                 ? __ldg(words + v0 + r * kThreads)
                 : 0u;
    }
#pragma unroll
    for (int r = 0; r < kStageWords; ++r) {
      if (v0 + r * kThreads + static_cast<int>(threadIdx.x) < nw) {
        x4[v0 + r * kThreads] = condition_word<false>(w[r]);
      }
    }
  }
  __syncthreads();

  // the carried history: the last P*C samples of hist ++ x, the last tile's
  // last P*C staged samples
  if (blockIdx.x == gridDim.x - 1) {
    for (int i = threadIdx.x; i < PC; i += kThreads) {
      const float2 v = x[len - PC + i];
      new_hist[i] = v.x;
      new_hist[PC + i] = v.y;
    }
  }

  // branch filter: x[(m0 + f - p)C - c] is staged at PC + (f - p)C - c.  A
  // thread takes channel c of kRun consecutive frames f0.. and slides a
  // window over the staged column: at tap p frame f0 + r reads what frame
  // f0 + r - 1 read at tap p - 1, so each tap loads one new sample and one
  // tap value for kRun outputs.  The window is a ring (slot (r - p) mod
  // kRun), the taps unrolled so that every slot index is a constant.  Each
  // output is still summed tap by tap from p = 0, as the plain version sums
  // it.  A run past Fe reads staged space and stores nothing.
  const int groups = (Fe + kRun - 1) / kRun;
  for (int e = threadIdx.x; e < groups * C; e += kThreads) {
    const int fg = e / C;
    const int c = e - fg * C;
    const int f0 = fg * kRun;
    float ar[kRun], ai[kRun];
    // frame f0 + r at tap p: xc[(r - p) * C]
    filter_run<kP, kRun>(x + PC + f0 * C - c, h, P, C, c, ar, ai);
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (f0 + r < Fe) {
        zr[(f0 + r) * ZS + c] = ar[r];
        zi[(f0 + r) * ZS + c] = ai[r];
      }
    }
  }
  __syncthreads();

  // FFT of the even and the odd frame of each pair, then the discriminator;
  // output row m0/2 + j for pair j
  const int pairs = Fe / 2;
  if constexpr (kSmall == 2) {
    small_pairs<kPrecise, 1, 2>(zr, zi, s, tw, d + (m0 / 2) * C, pairs);
  } else if constexpr (kSmall == 4) {
    small_pairs<kPrecise, 2, 2>(zr, zi, s, tw, d + (m0 / 2) * C, pairs);
  } else {
    const int lane = threadIdx.x & 31;
    for (int j0 = (threadIdx.x / 32) * s.G; j0 < pairs; j0 += kWarps * s.G) {
      const int np = min(s.G, pairs - j0);
      float* fr = zr + 2 * j0 * ZS;
      float* fi = zi + 2 * j0 * ZS;
      float* out = d + (m0 / 2 + j0) * C;
      stage1_of<2, kR>(s.C1, fr, fi, u, tw, 2 * np, s, lane);
      __syncwarp();
      if (s.L1 >= 0) {
        stage2_demod_of<kPrecise, 2, kR>(s.C2, u, tw, out, np, s, lane);
      } else {
        stage2_of<2, kR>(s.C2, u, fr, fi, tw, 2 * np, s, lane);
        __syncwarp();
        for (int t = lane; t < np * C; t += 32) {
          const int j = t / C;
          const int k = t - j * C;
          const int e = 2 * j * ZS + k;
          out[t] = demod_pairs<kPrecise>(fr[e], fi[e], fr[e + ZS], fi[e + ZS]);
        }
      }
      __syncwarp();
    }
  }
}

template <bool kPrecise, int kR, int kSmall, int kP, class S>
int launch(const uint16_t* in, const float* hist, const float* h, const double2* table,
           float* d, float* new_hist, long long n, const Plan& pl, cudaStream_t s) {
  auto kernel = pfb_kernel<kPrecise, kR, kSmall, kP, S>;
  const size_t smem = smem_bytes(pl);
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long tiles = (n / pl.C + pl.F - 1) / pl.F;
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(in, hist, h, table, d, new_hist,
                                                              n, pl);
  return static_cast<int>(cudaGetLastError());
}

// A compiled-in plan: every power of two C from 2 to 256 with the kTaps-tap
// prototype, factors as the wrapper plans them.
template <bool kPrecise, int kC1, int kC2>
int launch_fixed(const uint16_t* in, const float* hist, const float* h, const double2* table,
                 float* d, float* new_hist, long long n, cudaStream_t s) {
  constexpr int C = kC1 * kC2;
  const Plan pl = make_plan(C, kC1, kC2, kTaps, Fixed<kC1, kC2>::RUN);
  return launch<kPrecise, max_radix(kC1, kC2), is_small(C) ? C : 0, kTaps, Fixed<kC1, kC2>>(
      in, hist, h, table, d, new_hist, n, pl, s);
}

template <bool kPrecise, int kP>
int launch_taps(const uint16_t* in, const float* hist, const float* h, const double2* table,
                float* d, float* new_hist, long long n, const Plan& pl, cudaStream_t s) {
  if constexpr (kP == 0) {  // with kTaps taps, C = 2 and 4 are compiled in
    if (is_small(pl.C)) {
      return pl.C == 2
                 ? launch<kPrecise, 2, 2, kP, Plan>(in, hist, h, table, d, new_hist, n, pl, s)
                 : launch<kPrecise, 2, 4, kP, Plan>(in, hist, h, table, d, new_hist, n, pl, s);
    }
  }
  switch (max_radix(pl.C1, pl.C2)) {
    case 2: return launch<kPrecise, 2, 0, kP, Plan>(in, hist, h, table, d, new_hist, n, pl, s);
    case 4: return launch<kPrecise, 4, 0, kP, Plan>(in, hist, h, table, d, new_hist, n, pl, s);
    case 8: return launch<kPrecise, 8, 0, kP, Plan>(in, hist, h, table, d, new_hist, n, pl, s);
    case 16: return launch<kPrecise, 16, 0, kP, Plan>(in, hist, h, table, d, new_hist, n, pl, s);
    default: return launch<kPrecise, 1, 0, kP, Plan>(in, hist, h, table, d, new_hist, n, pl, s);
  }
}

template <bool kPrecise>
int launch_plan(const uint16_t* in, const float* hist, const float* h, const double2* table,
                float* d, float* new_hist, long long n, int C, int C1, int C2, int P,
                cudaStream_t s) {
  if (P == kTaps) {
    const int key = C1 * 1000 + C2;
#define PFB_FIXED(a, b) \
  case a * 1000 + b: return launch_fixed<kPrecise, a, b>(in, hist, h, table, d, new_hist, n, s);
    switch (key) {
      PFB_FIXED(1, 2) PFB_FIXED(2, 2) PFB_FIXED(2, 4) PFB_FIXED(4, 4) PFB_FIXED(4, 8)
      PFB_FIXED(8, 8) PFB_FIXED(8, 16) PFB_FIXED(16, 16)
      default: break;
    }
#undef PFB_FIXED
  }
  const Plan pl = make_plan(C, C1, C2, P, Plan::RUN);
  return P == kTaps ? launch_taps<kPrecise, kTaps>(in, hist, h, table, d, new_hist, n, pl, s)
                    : launch_taps<kPrecise, 0>(in, hist, h, table, d, new_hist, n, pl, s);
}

}  // namespace

// C entry point (loaded with ctypes by ops/cuda/build.py).  in: device
// uint16[n] (the raw bytes, one little-endian word per complex sample);
// hist, new_hist: device float[2][P*C]; h: device float[P][C]; table: device
// double[C + C1*RS][2], RS = C2 + 1 (C2 > 1) or 1: cos and sin of 2 pi i / C
// for i < C, then of 2 pi k1 c2 / C at C + k1*RS + c2 (ops/cuda/fused_pfb.py
// fft_table); d: device float[n / (2C)][C].  C = C1 * C2 (1 x 2 at C = 2,
// 2 x 2 at C = 4), n % (2C) == 0, 1 <= C <= kMaxChannels, 1 <= P <=
// kMaxPhases.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int fused_pfb_launch(const void* in, const void* hist, const void* h,
                                const void* table, void* d, void* new_hist, long long n,
                                int C, int C1, int C2, int P, int precise, void* stream) {
  if (C < 1 || C > kMaxChannels || P < 1 || P > kMaxPhases || C1 < 1 || C2 < 1 ||
      C1 * C2 != C || (is_small(C) && C1 != C / 2) || n < 2LL * C || n % (2LL * C) ||
      n / (2LL * C) >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto src = static_cast<const uint16_t*>(in);
  auto hi = static_cast<const float*>(hist);
  auto hp = static_cast<const float*>(h);
  auto tb = static_cast<const double2*>(table);
  auto out = static_cast<float*>(d);
  auto nh = static_cast<float*>(new_hist);
  auto s = static_cast<cudaStream_t>(stream);
  return precise ? launch_plan<true>(src, hi, hp, tb, out, nh, n, C, C1, C2, P, s)
                 : launch_plan<false>(src, hi, hp, tb, out, nh, n, C, C1, C2, P, s);
}
