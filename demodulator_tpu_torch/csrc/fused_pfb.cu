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
// Design.  Up to kMaxStaged channels, one CTA per tile of F frames (F*C
// about kTileSamples complex samples, kSmallTileSamples at C = 2 and 4; the
// last tile takes what is left, so any block of T % 2C == 0 samples runs, at
// every C up to kMaxStaged; above, up to kMaxCtaChannels, the three-factor
// route further down, pfb_wide_kernel and pfb_big_kernel, and above that
// the four-step route at the end, pfb_pass1_kernel and pfb_pass2_kernel,
// for any C that fused_pfb_cluster.cu has no cluster plan for).  The plan's
// sizes (C, its factors, the strides, F, the frame pairs of a warp batch)
// are compile-time constants for every power of two C from 2 to 256 with
// the 12-tap prototype (Fixed), so divisions and addresses fold into
// shifts and immediates; any other C or P reads them from the host's Plan.
// Per tile:
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

#include <algorithm>
#include <initializer_list>

#include "nbfm_device.cuh"
#include "pfb_device.cuh"

namespace {

using namespace nbfm;

// the largest C whose frame pair a CTA holds; above, the four-step route
constexpr int kMaxCtaChannels = 4096;  // ops/cuda/fused_pfb.py MAX_CTA_CHANNELS
constexpr int kMaxPhases = 32;      // ops/cuda/fused_pfb.py MAX_PHASES
constexpr int kTileSamples = 2048;  // complex samples per CTA tile (target)
constexpr int kSmallTileSamples = 2560;
constexpr int kWarps = kThreads / 32;
constexpr int kStageWords = 6;      // staging loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;
// taps per branch of the channelizer's prototype (ops/channelizer.py
// design_pfb_prototype): the branch filter's unrolled case
constexpr int kTaps = 12;

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

// ---------------------------------------------------------------------------
// The three-factor route: C > kMaxStaged.  A tile of the route above stages
// (P + F) * C samples as float2, which passes a CTA's shared memory at C of
// about 900, so here a CTA takes one frame pair and stages none of the
// input (pfb_big_kernel: any plan not compiled in; pfb_wide_kernel further
// down runs the 6.25 kHz grids, the same function laid out for the H100).
// With C = C1*C2*C3 (the wrapper's plan: C2 <= 16, C1 and C3 any size), D =
// C2*C3, c = D*c1 + C3*c2 + c3 and k = k1 + C1*k2 + C1*C2*k3:
//
//   u1[k1, d]      = w_C^(k1 d)   * sum_c1 w_C1^(k1 c1) z[D c1 + d]       (stage 1)
//   u2[k1, k2, c3] = w_C^(C1 k2 c3) * sum_c2 w_C2^(k2 c2) u1[k1, C3 c2 + c3]  (stage 2)
//   y[k]           = sum_c3 w_C3^(k3 c3) u2[k1, k2, c3]                   (stage 3)
//
// Every factor is an entry of one float64 table of exact cos and sin, w_C^i
// for i < C (every exponent above is below C), read through the read-only
// cache.  Per CTA (frame pair j, frames 2j and 2j + 1):
//   1. branch filter, into Z (float2 [2][C]): thread c takes channel c of
//      both frames, reading x[(2j + 1 - p)C - c] for p = 0 .. P straight
//      from the input (a 16-bit word a sample, coalesced across c) or the
//      carried history, conditioned as the plain version conditions it;
//      the odd frame's tap p is the even frame's tap p - 1, so P + 1 loads
//      make both.  Each z is summed tap by tap from p = 0, the same float32
//      multiply and add as the plain version, bit for bit;
//   2. stage 1, Z -> U (double2 [2][C1][S1], rows padded to an odd stride
//      so that stage 3's reads across k1 fall in distinct banks); stage 2 in
//      place in U; stage 3 from U with the discriminator, into row j of d.
//      Stages 1 and 2 of at most 16 points take a column per thread in
//      registers: a radix size (2, 4, 8, 16) as the butterfly network,
//      another size as the direct sum (column_dft); a larger stage 1 (a
//      prime factor above 16, or a plan with no split into three factors of
//      at most 16) takes an output per thread, summing its column from
//      shared memory.  Stage 3 pairs both frames for the discriminator, so y
//      never goes back to shared memory: a radix size a column per thread,
//      any other size an output per thread.  Each y is rounded to float32
//      once.  Registers are capped at 128, for 2 CTAs an SM where shared
//      memory allows (C up to about 2400); the largest columns spill;
//   3. the new history, the last P*C samples of hist ++ x, conditioned
//      again from the input, spread over the grid.
// Shared memory is 32 (C + C1) + 16 C bytes at most (big_smem_bytes), 197 120
// at C = 4096: the pair's float64 spectra, and its float32 branch outputs.

constexpr int kMaxStaged = 256;  // ops/cuda/fused_pfb.py MAX_STAGED
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA can have
constexpr int kMaxColumn = 16;    // the largest stage run a column per thread

// An N-point FFT of F columns in a CTA's shared memory on a three-stage
// plan N = C1*C2*C3 (a two-factor plan (a, b) as (a, 1, b)), D = C2*C3:
// column f's stage buffer at U + f*FS, row k1 at k1*S1 (S1 = D, or D + 1
// where D is even, so that tasks a row apart fall in distinct banks; FS =
// C1*S1, made odd too where tasks a column apart run side by side).  w_N^m
// is entry m*TS of the table (TS = C / N).  pfb_big_kernel: the frame
// pair's two columns of N = C, TS = 1; the four-step route's passes: the
// N2- and N1-point FFTs of their tiles.
struct Sub {
  int N, C1, C2, C3, D, S1, FS, TS;
};

Sub make_sub(int N, int C1, int C2, int TS, bool odd_fs) {
  const int D = N / C1, S1 = D % 2 ? D : D + 1;
  const int FS = odd_fs && C1 * S1 % 2 == 0 ? C1 * S1 + 1 : C1 * S1;
  return Sub{N, C1, C2, D / C2, D, S1, FS, TS};
}

struct Big {
  Sub s;        // the C-point plan
  int P;
  int precise;  // the discriminator: precise, or fast
};

Big make_big(int C, int C1, int C2, int P, int precise) {
  return Big{make_sub(C, C1, C2, 1, false), P, precise};
}

// demod_pairs, precise or fast as the launch asks (one kernel for both:
// the branch is uniform over the grid)
__device__ __forceinline__ float big_demod(const Big& b, float a, float bb, float c, float d) {
  return b.precise ? demod_pairs<true>(a, bb, c, d) : demod_pairs<false>(a, bb, c, d);
}

size_t big_smem_bytes(const Big& b) {
  return sizeof(double2) * 2 * b.s.FS + sizeof(float2) * 2 * b.s.N;
}

// The branch filter of channel c for both frames of a pair, the odd frame
// starting at sample top: the odd frame at tap p reads x[top - c - pC], the
// even frame at tap p what the odd one read at tap p + 1, so P + 1 loads
// make both.  Each z is summed tap by tap from p = 0, the same float32
// multiply and add as the plain version, bit for bit.
__device__ __forceinline__ void pair_filter(const uint16_t* __restrict__ in,
                                            const float* __restrict__ hist,
                                            const float* __restrict__ h, int C, int P,
                                            long long top, int c, float2& ze, float2& zo) {
  const int PC = P * C;
  const long long x0 = top - c;
  float hp = h[c];
  float2 s = big_sample(in, hist, PC, x0);
  float orr = __fmul_rn(hp, s.x), oi = __fmul_rn(hp, s.y);
  float er = 0.0f, ei = 0.0f;
#pragma unroll 4
  for (int p = 1; p <= P; ++p) {
    s = big_sample(in, hist, PC, x0 - static_cast<long long>(p) * C);
    // the even frame's tap p - 1 (hp = h[p - 1][c])
    er = p == 1 ? __fmul_rn(hp, s.x) : __fadd_rn(er, __fmul_rn(hp, s.x));
    ei = p == 1 ? __fmul_rn(hp, s.y) : __fadd_rn(ei, __fmul_rn(hp, s.y));
    if (p < P) {  // the odd frame's tap p
      hp = h[p * C + c];
      orr = __fadd_rn(orr, __fmul_rn(hp, s.x));
      oi = __fadd_rn(oi, __fmul_rn(hp, s.y));
    }
  }
  ze = make_float2(er, ei);
  zo = make_float2(orr, oi);
}

// The n-point DFT (n <= kMaxColumn) of v, in natural order in registers:
// out(k, y[k]) for each k < n, y[k] = sum_c v[c] w_n^(k c), w_n^m =
// tw[m * stride].  N = n for a radix size (the butterfly network, k a
// constant in each out), N = 0 for any other n (the direct sum, one k at a
// time).  Every v is read before the first out.
template <int N, class Out>
__device__ __forceinline__ void column_dft(const double2 (&v)[kMaxColumn], int n,
                                           const double2* __restrict__ tw, int stride, Out out) {
  if constexpr (N > 0) {
    double2 a[N];
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = v[bitrev<N>(i)];
    fft<N>(a, tw, stride);
#pragma unroll
    for (int k = 0; k < N; ++k) out(k, a[k]);
  } else {
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      double2 acc = make_double2(0.0, 0.0);
      int m = 0;  // k c mod n
#pragma unroll
      for (int c = 0; c < kMaxColumn; ++c) {
        if (c < n) {
          acc = cmac(acc, v[c], __ldg(tw + m * stride));
          m += k;
          if (m >= n) m -= n;
        }
      }
      out(k, acc);
    }
  }
}

// Stage 1 of F columns, in(f, c) -> U, each output times w_N^(k1 d); d
// fastest across threads.  R: C1 for a radix size, 0 for another C1 <=
// kMaxColumn (a column (f, d) a task, in registers), -1 for a larger C1 (an
// output (f, k1, d) a task, reading its column whole).
template <int R, class In>
__device__ __forceinline__ void sub_stage1(const In& in, double2* U,
                                           const double2* __restrict__ tw, const Sub& s, int F) {
  const int C1 = s.C1, D = s.D, S1 = s.S1, FS = s.FS, TS = s.TS;
  if constexpr (R >= 0) {
    for (int t = threadIdx.x; t < F * D; t += kThreads) {
      const int f = t / D, dd = t - f * D;
      double2 v[kMaxColumn];
#pragma unroll
      for (int i = 0; i < kMaxColumn; ++i) {
        if (i < C1) v[i] = in(f, i * D + dd);
      }
      double2* u = U + f * FS + dd;
      column_dft<R>(v, C1, tw, D * TS, [&](int k1, double2 y) {
        u[k1 * S1] = k1 * dd ? cmul(y, __ldg(tw + k1 * dd * TS)) : y;
      });
    }
  } else {
    for (int t = threadIdx.x; t < F * s.N; t += kThreads) {
      const int f = t / s.N, r = t - f * s.N;
      const int k1 = r / D, dd = r - k1 * D;
      double2 acc = make_double2(0.0, 0.0);
      int m = 0;  // k1 c1 mod C1
      for (int c1 = 0; c1 < C1; ++c1) {
        acc = cmac(acc, in(f, c1 * D + dd), __ldg(tw + m * D * TS));
        m += k1;
        if (m >= C1) m -= C1;
      }
      U[f * FS + k1 * S1 + dd] = k1 * dd ? cmul(acc, __ldg(tw + k1 * dd * TS)) : acc;
    }
  }
}

// Stage 2 of F columns in place in U, a column (f, k1, c3) a task, times
// w_N^(C1 k2 c3).  R: C2 for a radix size, else 0 (C2 <= kMaxColumn).
template <int R>
__device__ __forceinline__ void sub_stage2(double2* U, const double2* __restrict__ tw,
                                           const Sub& s, int F) {
  const int C1 = s.C1, C2 = s.C2, C3 = s.C3, S1 = s.S1, FS = s.FS, TS = s.TS;
  const int cols = C1 * C3;
  for (int t = threadIdx.x; t < F * cols; t += kThreads) {
    const int f = t / cols, r = t - f * cols;
    const int k1 = r / C3, c3 = r - k1 * C3;
    double2* u = U + f * FS + k1 * S1 + c3;
    double2 v[kMaxColumn];
#pragma unroll
    for (int i = 0; i < kMaxColumn; ++i) {
      if (i < C2) v[i] = u[i * C3];
    }
    column_dft<R>(v, C2, tw, C1 * C3 * TS, [&](int k2, double2 y) {
      u[k2 * C3] = k2 * c3 ? cmul(y, __ldg(tw + C1 * k2 * c3 * TS)) : y;
    });
  }
}

// Stages 1 and 2 of F columns from in(f, c), with the barriers after them.
template <class In>
__device__ __forceinline__ void sub_stages12(const In& in, double2* U,
                                             const double2* __restrict__ tw, const Sub& s, int F) {
  switch (s.C1) {
    case 2: sub_stage1<2>(in, U, tw, s, F); break;
    case 4: sub_stage1<4>(in, U, tw, s, F); break;
    case 8: sub_stage1<8>(in, U, tw, s, F); break;
    case 16: sub_stage1<16>(in, U, tw, s, F); break;
    default:
      if (s.C1 <= kMaxColumn) {
        sub_stage1<0>(in, U, tw, s, F);
      } else {
        sub_stage1<-1>(in, U, tw, s, F);
      }
  }
  __syncthreads();
  if (s.C2 > 1) {
    switch (s.C2) {
      case 2: sub_stage2<2>(U, tw, s, F); break;
      case 4: sub_stage2<4>(U, tw, s, F); break;
      case 8: sub_stage2<8>(U, tw, s, F); break;
      case 16: sub_stage2<16>(U, tw, s, F); break;
      default: sub_stage2<0>(U, tw, s, F);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float2 round_f32(double2 y) {
  return make_float2(__double2float_rn(y.x), __double2float_rn(y.y));
}

// Stage 3 from U.  R: C3 for a radix size (a column (f, k1, k2) a task),
// else 0 (an output (f, k) a task).  kColFast: consecutive threads take
// consecutive columns f (FS is odd), else consecutive k1 (S1 is odd).
// kPair false: out(f, k, y), y in float64, every output k of each of the F
// columns.  kPair true: columns f and f + F/2 (a frame pair) in one task,
// out(f, k, ye, yo) with both rounded once to float32, the first column's
// held while the second's is made (the discriminator's inputs in one
// thread, y never back in shared memory).
template <int R, bool kColFast, bool kPair, class Out>
__device__ __forceinline__ void sub_stage3(const double2* U, const double2* __restrict__ tw,
                                           const Sub& s, int F, const Out& out) {
  const int C1 = s.C1, C3 = s.C3, S1 = s.S1, FS = s.FS, N = s.N;
  const int st = C1 * s.C2;  // w_C3^m = w_N^(m st)
  const int ts = st * s.TS;
  const int G = kPair ? F / 2 : F;  // the columns a task starts from
  const int PS = G * FS;            // kPair: the second column's offset
  if constexpr (R > 0) {
    for (int t = threadIdx.x; t < G * st; t += kThreads) {
      const int f = kColFast ? t % G : t / st;
      const int r = kColFast ? t / G : t - f * st;
      const int k2 = r / C1;
      const double2* u = U + f * FS + (r - k2 * C1) * S1 + k2 * C3;
      double2 a[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = u[bitrev<R>(i)];
      fft<R>(a, tw, ts);
      if constexpr (kPair) {
        float2 ye[R];
#pragma unroll
        for (int k3 = 0; k3 < R; ++k3) ye[k3] = round_f32(a[k3]);
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = u[PS + bitrev<R>(i)];
        fft<R>(a, tw, ts);
#pragma unroll
        for (int k3 = 0; k3 < R; ++k3) out(f, r + st * k3, ye[k3], round_f32(a[k3]));
      } else {
#pragma unroll
        for (int k3 = 0; k3 < R; ++k3) out(f, r + st * k3, a[k3]);
      }
    }
  } else {
    for (int t = threadIdx.x; t < G * N; t += kThreads) {
      const int f = kColFast ? t % G : t / N;
      const int k = kColFast ? t / G : t - f * N;
      const int k3 = k / st, r = k - k3 * st, k2 = r / C1;
      const double2* u = U + f * FS + (r - k2 * C1) * S1 + k2 * C3;
      double2 acc = make_double2(0.0, 0.0), acc2 = acc;
      int m = 0;  // k3 c3 mod C3
      for (int c3 = 0; c3 < C3; ++c3) {
        const double2 w = __ldg(tw + m * ts);
        acc = cmac(acc, u[c3], w);
        if constexpr (kPair) acc2 = cmac(acc2, u[PS + c3], w);
        m += k3;
        if (m >= C3) m -= C3;
      }
      if constexpr (kPair) {
        out(f, k, round_f32(acc), round_f32(acc2));
      } else {
        out(f, k, acc);
      }
    }
  }
}

template <bool kColFast, bool kPair, class Out>
__device__ __forceinline__ void sub_stage3_of(const double2* U, const double2* __restrict__ tw,
                                              const Sub& s, int F, const Out& out) {
  switch (s.C3) {
    case 2: sub_stage3<2, kColFast, kPair>(U, tw, s, F, out); break;
    case 4: sub_stage3<4, kColFast, kPair>(U, tw, s, F, out); break;
    case 8: sub_stage3<8, kColFast, kPair>(U, tw, s, F, out); break;
    case 16: sub_stage3<16, kColFast, kPair>(U, tw, s, F, out); break;
    default: sub_stage3<0, kColFast, kPair>(U, tw, s, F, out);
  }
}

// CTA j takes frame pair j: frames 2j and 2j + 1 of the launch.
__global__ void __launch_bounds__(kThreads, 2)
pfb_big_kernel(const uint16_t* __restrict__ in, const float* __restrict__ hist,
               const float* __restrict__ h, const double2* __restrict__ tw,
               float* __restrict__ d, float* __restrict__ new_hist, long long n, Big b) {
  extern __shared__ double2 smem[];
  const int C = b.s.N, P = b.P, PC = P * C;
  double2* U = smem;                                      // [2][C1 * S1]
  float2* Z = reinterpret_cast<float2*>(U + 2 * b.s.FS);  // [2][C]

  // the carried history, spread over the grid
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < PC;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const float2 v = big_sample(in, hist, PC, n - PC + i);
    new_hist[i] = v.x;
    new_hist[PC + i] = v.y;
  }

  // branch filter: the odd frame 2j + 1 at tap p reads x[(2j + 1 - p)C -
  // c], the even frame at tap p what the odd one read at tap p + 1
  const long long top = (2LL * blockIdx.x + 1) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    pair_filter(in, hist, h, C, P, top, c, Z[c], Z[C + c]);
  }
  __syncthreads();

  sub_stages12(
      [&](int f, int c) {
        const float2 z = Z[f * C + c];
        return make_double2(z.x, z.y);
      },
      U, tw, b.s, 2);
  float* row = d + static_cast<long long>(blockIdx.x) * C;
  sub_stage3_of<false, true>(U, tw, b.s, 2, [&](int, int k, float2 ye, float2 yo) {
    row[k] = big_demod(b, ye.x, ye.y, yo.x, yo.y);
  });
}

constexpr int kMaxDevices = 64;

// The current device's ordinal, or -1 where it is none the caches below
// can key.
int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  return dev;
}

// The shared-memory limit of each of `kernels` raised to the most a CTA can
// have, once per device: raised[dev], the caller's record for the list
int raise_smem(std::initializer_list<const void*> kernels, bool (&raised)[kMaxDevices]) {
  const int dev = current_device();
  if (dev >= 0 && raised[dev]) return cudaSuccess;
  for (const void* k : kernels) {
    const cudaError_t rc =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (dev >= 0) raised[dev] = true;
  return cudaSuccess;
}

bool big_raised[kMaxDevices];  // pfb_big_kernel's limit raised

int raise_big_smem() {
  return raise_smem({reinterpret_cast<const void*>(pfb_big_kernel)}, big_raised);
}

// A kernel's registers a thread, local memory a thread (stack and spills,
// bytes), dynamic shared memory (bytes) and CTAs an SM at `smem` bytes, into
// out[4].  Returns a cudaError_t.
int func_attrs(const void* kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int ctas = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, smem);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = ctas;
  return static_cast<int>(rc);
}

int launch_big(const uint16_t* in, const float* hist, const float* h, const double2* table,
               float* d, float* new_hist, long long n, int C, int C1, int C2, int P,
               int precise, cudaStream_t s) {
  const Big b = make_big(C, C1, C2, P, precise);
  const size_t smem = big_smem_bytes(b);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = raise_big_smem();
  if (rc != cudaSuccess) return rc;
  pfb_big_kernel<<<static_cast<unsigned>(n / (2LL * C)), kThreads, smem, s>>>(
      in, hist, h, table, d, new_hist, n, b);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The three-factor route's compiled-in plans (pfb_wide_kernel): the grids
// users run, 6.25 kHz channels of 2.4 to 25.6 Msps, C = 384 (3 x 8 x 16),
// 512 (8 x 8 x 8), 1024 (8 x 8 x 16), 2048 (8 x 16 x 16) and 4096 (16 x 16
// x 16) with the kTaps-tap prototype, as the wrapper plans them (Wide, the
// PFB_WIDE list below; every other C > kMaxStaged, or another P, runs
// pfb_big_kernel above).  The same function, the same stage order and the
// same table as pfb_big_kernel, laid out for the H100:
//   - a unit is G consecutive frame pairs (Wide::G), and a CTA walks a run
//     of consecutive units (grid: the units, at most the CTAs the card holds
//     at once, each run within one of the others' length), so each FFT stage
//     has about Wide::T columns or more, and the barriers, the plan's
//     constants and the wave tail are paid once a run;
//   - the input rows a unit reads, P + 2G rows of C samples ((m0 - P)C up to
//     (m0 + 2G)C for first frame m0), are staged as raw 16-bit words in a
//     ring of P + 2G rows in shared memory by bulk asynchronous copies
//     (cp.async.bulk, completing on one mbarrier), a unit's 2G new rows
//     issued as soon as the unit before it has filtered, so they arrive
//     during its FFT (input not 16-byte aligned: the CTA's threads copy
//     them); rows before sample 0 come from the history, as big_sample
//     takes them;
//   - the branch filter takes channel c of the unit's 2G frames at once,
//     sliding a window of 2G samples down the staged column (P + 2G - 1
//     loads and conditionings, P tap loads for 2G outputs), each z summed
//     tap by tap from p = 0 as the plain version sums it, into the stage
//     buffer U as float64 in stage 1's layout (no separate z buffer);
//   - stages 1 and 2 in place in U, a column per thread, stage 3 a column
//     of both frames of a pair per thread with the discriminator; every
//     size, stride and index a compile-time constant, each stage's own
//     factors w_N^m constants (kW16, kW3: the table's entries, bit for bit),
//     the twiddles between the stages read from the table;
//   - at 2048 and 4096 (Wide::kSeq) a pair's two float64 spectra would
//     leave no room for the staged rows, so U holds one frame: the filter
//     parks the odd frame's z in Zo (float32), the even frame's y waits in
//     its thread's registers (one stage-3 column a thread) until the odd
//     frame's, which stage 1 reads from Zo.
// Registers are held to the CTAs an SM that shared memory allows
// (Wide::CTAS); no plan spills.  No thread block cluster: at 4096 one
// frame's spectra, Zo and the staged rows fill the SM (213 264 bytes), and
// a cluster would only have split a pair the ring already feeds.
//
// What bounds it: the bound counts 2 bytes in and 2 out a sample and, as
// float32 work, 4P operations a sample for the branch filter and 5 log2(C)
// for the FFT (chip_smoke.py pfb_ops).  The kernel issues the filter's
// separate float32 multiplies and adds (48 a sample at P = 12) with about 5
// integer operations a staged sample for its conditioning, the float64 FFT
// (about 20 operations a sample at half the float32 rate, and the powers of
// the twiddles), the discriminator, and a barrier a stage; the filter is the
// largest part.  On an NVIDIA H100 80GB HBM3 at 700 W (ops/cuda/sections.py
// pfb, cumulative) one 0.25 s block at C = 512 takes 1.9 us for the output
// alone, 6.8 with the branch filter and its staging, 7.5 with stage 1, 8.8
// with stage 2 and 9.8 for the whole kernel (pfb_big_kernel: 28.2); at C =
// 4096 5.8, 81.1, 93.5, 104.2 and 114.1 us (437.2).  PERF.md has the
// numbers.

// A compiled-in plan: C = kC1 * kC2 * kC3 with the kTaps-tap prototype, kG
// frame pairs a unit, kSeq (kG = 1) one frame in U at a time, kT threads,
// registers held to kCtas CTAs an SM.
template <int kC1, int kC2, int kC3, int kG, bool kSeqFrames, int kT, int kCtas>
struct Wide {
  static constexpr int C1 = kC1, C2 = kC2, C3 = kC3, C = kC1 * kC2 * kC3, P = kTaps;
  static constexpr int G = kG, T = kT, CTAS = kCtas;
  static constexpr bool kSeq = kSeqFrames;
  static constexpr int NF = 2 * kG;          // frames a unit
  static constexpr int UF = kSeq ? 1 : NF;   // frames in U at once
  static constexpr int D = kC2 * kC3;        // stage 1's columns a frame
  static constexpr int S1 = D % 2 ? D : D + 1, FS = kC1 * S1;  // U's row and frame strides
  static constexpr int ST = kC1 * kC2;       // stage 3's columns a frame
  static constexpr int RING = P + NF;        // staged rows of C samples
  static constexpr int UNROLL = kSeq ? 4 : 2;  // the branch filter's channels in flight
  // shared memory: U (double2 [UF][C1][S1]) | Zo (float2 [C], kSeq) | the
  // ring (uint16 [RING][C]) | the mbarrier
  static constexpr int kUBytes = 16 * UF * FS, kZoBytes = kSeq ? 8 * C : 0;
  static constexpr int kRingBytes = 2 * RING * C;
  static constexpr int kSmem = kUBytes + kZoBytes + kRingBytes + 16;
  static_assert(C % 8 == 0, "rows of whole 16-byte chunks");
  static_assert(C % (kT * UNROLL) == 0, "whole unrolled channel runs");
  static_assert(!kSeq || (kG == 1 && ST == kT), "one stage-3 column a thread");
  static_assert(kSmem <= kMaxSmem, "a CTA's shared memory");
};

// One thread: bytes of transactions expected in the mbarrier's phase, and a
// bulk asynchronous copy of [src, src + bytes) into dst completing on it.
__device__ __forceinline__ void ring_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void ring_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void ring_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Rows [ra, rb) of the input (row r: samples rC .. rC + C - 1) into ring
// slots r mod RING: bulk copies issued by thread 0 (a copy a contiguous run
// of slots), or, for input not 16-byte aligned, copied by every thread.
template <class W>
__device__ __forceinline__ void wide_fill(const uint16_t* __restrict__ in, uint16_t* ring,
                                          uint64_t* bar, long long ra, long long rb, bool bulk) {
  constexpr int C = W::C, RING = W::RING;
  if (bulk) {
    if (threadIdx.x == 0) {
      // the slots' earlier reads (ordered by the barrier before) come before
      // the copies' writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      ring_expect(bar, static_cast<unsigned>((rb - ra) * 2 * C));
      while (ra < rb) {
        const int sl = static_cast<int>(ra % RING);
        const long long k = min(rb - ra, static_cast<long long>(RING - sl));
        ring_copy(ring + sl * C, in + ra * C, static_cast<unsigned>(k * 2 * C), bar);
        ra += k;
      }
    }
  } else {
    const int len = static_cast<int>(rb - ra) * C;
    for (int i = threadIdx.x; i < len; i += W::T) {
      ring[static_cast<int>((ra + i / C) % RING) * C + i % C] = in[ra * C + i];
    }
  }
}

// The branch filter of the unit's NF frames m0 .. m0 + NF - 1, into U in
// stage 1's layout (channel c = D c1 + d of frame f at f*FS + c1*S1 + d;
// kSeq: frame 1 into Zo[c]).  x(q) = sample (m0 + q)C - c, q = -(P-1) ..
// NF-1, lies in row m0 + q - 1 at position C - c for c > 0, in row m0 + q at
// position 0 for c = 0; rows before 0 are the history's (the units with m0
// < P; kHist false: a unit with none, the check compiled out).  The rows'
// ring offsets are the unit's, the same for every channel: a load is a
// select and an add.  Frame r at tap p reads x(r - p) from slot (r - p) mod
// NF of a window of NF samples: a new sample a tap.
template <class W, bool kHist>
__device__ __forceinline__ void wide_filter(const uint16_t* ring, const float* __restrict__ hist,
                                            const float* __restrict__ h, double2* U, float2* Zo,
                                            long long m0) {
  constexpr int C = W::C, P = W::P, NF = W::NF, RING = W::RING, Q = P + NF;
  constexpr int D = W::D, S1 = W::S1, FS = W::FS;
  // off[j]: the ring offset of row m0 - P + j
  int off[Q];
  const int base = static_cast<int>((m0 + RING - P) % RING);
#pragma unroll
  for (int j = 0; j < Q; ++j) off[j] = (base + j < RING ? base + j : base + j - RING) * C;
  const int m = kHist && m0 < P ? static_cast<int>(m0) : P;  // rows before 0: q < 1 - m
  // W::UNROLL channels' loads in flight a thread
#pragma unroll W::UNROLL
  for (int i = 0; i < C / W::T; ++i) {
    const int c = threadIdx.x + i * W::T;
    const int e = c > 0;
    const int pos = e ? C - c : 0;
    const int qlo = e - m;  // x(q) for q < qlo is the history's
    auto x = [&](int q) -> float2 {
      if (kHist && q < qlo) {
        const int s = (m + q) * C - c;
        return make_float2(hist[P * C + s], hist[2 * P * C + s]);
      }
      return wide_cond(ring[(e ? off[q + P - 1] : off[q + P]) + pos]);
    };
    float2 w[NF];
    float ar[NF], ai[NF];
    const float h0 = __ldg(h + c);
#pragma unroll
    for (int r = 0; r < NF; ++r) {
      w[r] = x(r);
      ar[r] = __fmul_rn(h0, w[r].x);
      ai[r] = __fmul_rn(h0, w[r].y);
    }
#pragma unroll
    for (int p = 1; p < P; ++p) {
      w[(P * NF - p) % NF] = x(-p);  // slot (-p) mod NF
      const float hv = __ldg(h + p * C + c);
#pragma unroll
      for (int r = 0; r < NF; ++r) {
        const float2 xv = w[(P * NF + r - p) % NF];  // slot (r - p) mod NF
        ar[r] = __fadd_rn(ar[r], __fmul_rn(hv, xv.x));
        ai[r] = __fadd_rn(ai[r], __fmul_rn(hv, xv.y));
      }
    }
    const int at = (c / D) * S1 + c % D;
#pragma unroll
    for (int r = 0; r < NF; ++r) {
      if (W::kSeq && r == 1) {
        Zo[c] = make_float2(ar[r], ai[r]);
      } else {
        U[r * FS + at] = make_double2(ar[r], ai[r]);
      }
    }
  }
}

// p[k] = w^k for k < N, by squarings and products in float64 (a power
// within a few ulps of the table's entry): the twiddles of a column from
// one entry of the table
template <int N>
__device__ __forceinline__ void wide_powers(double2 w, double2 (&p)[N]) {
  p[0] = make_double2(1.0, 0.0);
#pragma unroll
  for (int k = 1; k < N; ++k) {
    p[k] = k == 1 ? w : (k % 2 ? cmul(p[k - 1], w) : cmul(p[k / 2], p[k / 2]));
  }
}

// Stage 1 in place in U (zo: frame 0 of U from Zo), a column (f, d) a
// thread: y = the C1-point DFT of U[f][.][d], times w_C^(k1 d) = (w_C^d)^k1
template <class W>
__device__ __forceinline__ void wide_stage1(double2* U, const float2* Zo,
                                            const double2* __restrict__ tw, bool zo) {
  constexpr int C1 = W::C1, D = W::D, S1 = W::S1, FS = W::FS;
#pragma unroll 1
  for (int t = threadIdx.x; t < W::UF * D; t += W::T) {
    const int f = t / D, dd = t % D;
    double2* u = U + f * FS + dd;
    double2 v[C1];
    if (zo) {
#pragma unroll
      for (int i = 0; i < C1; ++i) {
        const float2 z = Zo[i * D + dd];
        v[i] = make_double2(z.x, z.y);
      }
    } else {
#pragma unroll
      for (int i = 0; i < C1; ++i) v[i] = u[i * S1];
    }
    double2 w[C1];
    wide_powers<C1>(__ldg(tw + dd), w);
    wide_fft<C1>(v);
#pragma unroll
    for (int k1 = 0; k1 < C1; ++k1) u[k1 * S1] = k1 ? cmul(v[k1], w[k1]) : v[k1];
  }
}

// Stage 2 in place in U, a column (f, k1, c3) a thread: the C2-point DFT of
// U[f][k1][C3 c2 + c3] over c2, times w_C^(C1 k2 c3) = (w_C^(C1 c3))^k2
template <class W>
__device__ __forceinline__ void wide_stage2(double2* U, const double2* __restrict__ tw) {
  constexpr int C1 = W::C1, C2 = W::C2, C3 = W::C3, S1 = W::S1, FS = W::FS, PER = C1 * C3;
#pragma unroll 1
  for (int t = threadIdx.x; t < W::UF * PER; t += W::T) {
    const int f = t / PER, r = t % PER, k1 = r / C3, c3 = r % C3;
    double2* u = U + f * FS + k1 * S1 + c3;
    double2 v[C2];
#pragma unroll
    for (int i = 0; i < C2; ++i) v[i] = u[i * C3];
    double2 w[C2];
    wide_powers<C2>(__ldg(tw + C1 * c3), w);
    wide_fft<C2>(v);
#pragma unroll
    for (int k2 = 0; k2 < C2; ++k2) u[k2 * C3] = k2 ? cmul(v[k2], w[k2]) : v[k2];
  }
}

__device__ __forceinline__ float wide_demod(int precise, float a, float b, float c, float d) {
  return precise ? demod_pairs<true>(a, b, c, d) : demod_pairs<false>(a, b, c, d);
}

// Stage 3 of the unit's pairs with the discriminator, a column (j, k1, k2)
// of both frames of pair j a thread, k1 fastest (the stores of a k3 are
// consecutive): the even frame's y rounded to float32 and held, then the
// odd frame's, paired; pair j < np into row j of `rows`.
template <class W>
__device__ __forceinline__ void wide_stage3(const double2* U, float* __restrict__ rows, int np,
                                            int precise) {
  constexpr int C = W::C, C1 = W::C1, C3 = W::C3, S1 = W::S1, FS = W::FS, ST = W::ST;
#pragma unroll 1
  for (int t = threadIdx.x; t < W::G * ST; t += W::T) {
    const int j = t / ST, r = t % ST, k2 = r / C1, k1 = r % C1;
    const double2* u = U + 2 * j * FS + k1 * S1 + k2 * C3;
    double2 v[C3];
    float yr[C3], yi[C3];
#pragma unroll
    for (int i = 0; i < C3; ++i) v[i] = u[i];
    wide_fft<C3>(v);
#pragma unroll
    for (int k3 = 0; k3 < C3; ++k3) {
      yr[k3] = __double2float_rn(v[k3].x);
      yi[k3] = __double2float_rn(v[k3].y);
    }
#pragma unroll
    for (int i = 0; i < C3; ++i) v[i] = u[FS + i];
    wide_fft<C3>(v);
    if (j < np) {
#pragma unroll
      for (int k3 = 0; k3 < C3; ++k3) {
        rows[j * C + r + ST * k3] = wide_demod(precise, yr[k3], yi[k3],
                                               __double2float_rn(v[k3].x),
                                               __double2float_rn(v[k3].y));
      }
    }
  }
}

// kSeq: stage 3 of frame `odd` of the pair in U, column (k1, k2) = thread:
// the even frame's y into (yr, yi), the odd frame's paired with them into
// row.
template <class W>
__device__ __forceinline__ void wide_stage3_seq(const double2* U, float* __restrict__ row,
                                                int odd, float (&yr)[W::C3], float (&yi)[W::C3],
                                                int precise) {
  constexpr int C1 = W::C1, C3 = W::C3, S1 = W::S1, ST = W::ST;
  const int r = threadIdx.x, k2 = r / C1, k1 = r % C1;
  const double2* u = U + k1 * S1 + k2 * C3;
  double2 v[C3];
#pragma unroll
  for (int i = 0; i < C3; ++i) v[i] = u[i];
  wide_fft<C3>(v);
  if (!odd) {
#pragma unroll
    for (int k3 = 0; k3 < C3; ++k3) {
      yr[k3] = __double2float_rn(v[k3].x);
      yi[k3] = __double2float_rn(v[k3].y);
    }
  } else {
#pragma unroll
    for (int k3 = 0; k3 < C3; ++k3) {
      row[r + ST * k3] = wide_demod(precise, yr[k3], yi[k3], __double2float_rn(v[k3].x),
                                    __double2float_rn(v[k3].y));
    }
  }
}

// CTA b takes units [b U / grid, (b + 1) U / grid) of the U = ceil(pairs /
// G) units (unit u: pairs uG .. uG + G - 1, the last unit of the launch
// maybe fewer).
template <class W>
__global__ void __launch_bounds__(W::T, W::CTAS)
pfb_wide_kernel(const uint16_t* __restrict__ in, const float* __restrict__ hist,
                const float* __restrict__ h, const double2* __restrict__ tw,
                float* __restrict__ d, float* __restrict__ new_hist, long long n, int precise) {
  extern __shared__ double2 wsm[];
  constexpr int C = W::C, P = W::P, PC = P * C, NF = W::NF;
  double2* U = wsm;
  float2* Zo = reinterpret_cast<float2*>(reinterpret_cast<char*>(wsm) + W::kUBytes);
  uint16_t* ring = reinterpret_cast<uint16_t*>(reinterpret_cast<char*>(Zo) + W::kZoBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(ring) + W::kRingBytes);
  const long long M = n / C;  // frames, rows of the input
  const long long pairs = M / 2;
  const long long units = (pairs + W::G - 1) / W::G;

  // the carried history, spread over the grid
  for (long long i = static_cast<long long>(blockIdx.x) * W::T + threadIdx.x; i < PC;
       i += static_cast<long long>(gridDim.x) * W::T) {
    const float2 v = big_sample(in, hist, PC, n - PC + i);
    new_hist[i] = v.x;
    new_hist[PC + i] = v.y;
  }

  const long long ua = units * blockIdx.x / gridDim.x;
  const long long ub = units * (blockIdx.x + 1) / gridDim.x;
  const bool bulk = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  if (bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the first unit's rows m0 - P .. m0 + NF - 1 (rows before 0 are the
  // history's), then each next unit's NF new rows
  wide_fill<W>(in, ring, bar, max(ua * NF - P, 0LL), min(ua * NF + NF, M), bulk);
  __syncthreads();
  float yr[W::C3], yi[W::C3];  // kSeq: the even frame's y of this thread's column
  unsigned phase = 0;
  for (long long u = ua; u < ub; ++u, phase ^= 1u) {
    const long long m0 = u * NF;
    if (bulk) ring_wait(bar, phase);
    // kSeq's plans keep one filter: on the H100 a second copy without the
    // history's check made the 2048 and 4096 plans slower, not faster
    if (W::kSeq || m0 < P) {
      wide_filter<W, true>(ring, hist, h, U, Zo, m0);
    } else {
      wide_filter<W, false>(ring, hist, h, U, Zo, m0);
    }
    __syncthreads();
    if (u + 1 < ub) wide_fill<W>(in, ring, bar, m0 + NF, min(m0 + 2 * NF, M), bulk);
    if constexpr (W::kSeq) {
      float* row = d + u * C;
#pragma unroll 1
      for (int f = 0; f < 2; ++f) {
        wide_stage1<W>(U, Zo, tw, f != 0);
        __syncthreads();
        wide_stage2<W>(U, tw);
        __syncthreads();
        wide_stage3_seq<W>(U, row, f, yr, yi, precise);
        __syncthreads();
      }
    } else {
      const int np = static_cast<int>(min(static_cast<long long>(W::G), pairs - u * W::G));
      wide_stage1<W>(U, Zo, tw, false);
      __syncthreads();
      wide_stage2<W>(U, tw);
      __syncthreads();
      wide_stage3<W>(U, d + u * W::G * C, np, precise);
      __syncthreads();
    }
  }
}

// The grid a launch of W takes on this device: the CTAs it holds at once
// (asked once per device, when the shared-memory limit is raised), at most
// one a unit.
template <class W>
int launch_wide(const uint16_t* in, const float* hist, const float* h, const double2* table,
                float* d, float* new_hist, long long n, int precise, cudaStream_t s) {
  auto kernel = pfb_wide_kernel<W>;
  static int slots[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!slots[dev]) {
    cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          W::kSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    int ctas = 0, sms = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, W::T, W::kSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (ctas < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots[dev] = ctas * sms;
  }
  const long long units = (n / (2LL * W::C) + W::G - 1) / W::G;
  const unsigned grid =
      static_cast<unsigned>(std::min(units, static_cast<long long>(slots[dev])));
  kernel<<<grid, W::T, W::kSmem, s>>>(in, hist, h, table, d, new_hist, n, precise);
  return static_cast<int>(cudaGetLastError());
}

// The kernel attributes of W: registers, local memory a thread (stack and
// spills), dynamic shared memory, CTAs an SM.
template <class W>
int wide_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, pfb_wide_kernel<W>);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(pfb_wide_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            W::kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int ctas = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, pfb_wide_kernel<W>, W::T, W::kSmem);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = W::kSmem;
  out[3] = ctas;
  return static_cast<int>(rc);
}

constexpr int kNotCompiledIn = -1;

// A compiled-in plan C1 x C2 x C3 (kTaps taps): its launch (attrs null) or
// its attributes into attrs; kNotCompiledIn for any other plan.  The plans
// are the wrapper's (fft_plan; WIDE_PLANS in ops/cuda/fused_pfb.py, which a
// CPU test holds to this list).
int wide_plan(const uint16_t* in, const float* hist, const float* h, const double2* table,
              float* d, float* new_hist, long long n, int C1, int C2, int C3, int precise,
              cudaStream_t s, int* attrs) {
#define PFB_WIDE(a, b, c, g, seq, t, ctas)                                                   \
  if (C1 == a && C2 == b && C3 == c) {                                                       \
    using W = Wide<a, b, c, g, seq, t, ctas>;                                                \
    return attrs ? wide_attrs<W>(attrs)                                                      \
                 : launch_wide<W>(in, hist, h, table, d, new_hist, n, precise, s);           \
  }
  PFB_WIDE(3, 8, 16, 4, false, 96, 3)
  PFB_WIDE(8, 8, 8, 2, false, 128, 4)
  PFB_WIDE(8, 8, 16, 1, false, 128, 3)
  PFB_WIDE(8, 16, 16, 1, true, 128, 2)
  PFB_WIDE(16, 16, 16, 1, true, 256, 1)
#undef PFB_WIDE
  return kNotCompiledIn;
}

// ---------------------------------------------------------------------------
// The four-step route: C > kMaxCtaChannels, where one frame pair's float64
// spectra no longer fit a CTA's shared memory, for every C (and P) with no
// cluster plan (fused_pfb_cluster.cu, one launch on thread block clusters,
// takes the 6.25 kHz grids 4800, 6144, 8192 and 16384 with kTaps taps).
// Bailey's four-step FFT in two kernels through a float64 scratch buffer
// in global memory: with C = N1*N2 (the wrapper's four_step_plan: both
// factors as near sqrt(C) as the divisors allow, a factor above
// kMaxCtaChannels as N1), c = n1 + N1*n2 and k = k2 + N2*k1,
//
//   Y[n1, k2]     = w_C^(n1 k2) * sum_n2 z[n1 + N1 n2] w_N2^(n2 k2)   (pfb_pass1_kernel)
//   y[k2 + N2 k1] = sum_n1 Y[n1, k2] w_N1^(n1 k1)                     (pfb_pass2_kernel)
//
// Y is laid out [pair][frame][k2][n1], so pass 2 reads whole rows.  The
// launches run over a group of consecutive frame pairs, pass 1 then pass 2
// a group, on one stream: every pair of the call, unless Y (32 bytes a
// channel a pair) would pass the wrapper's bound on its memory.
//   - pass 1: a CTA takes a frame pair and a tile of T consecutive n1: the
//     branch filter of channels n1 + N1*n2 of both frames (pair_filter:
//     consecutive n1 read consecutive input words; z bit-equal to the plain
//     version's), the N2-point FFT of each of the 2T columns in shared
//     memory (sub_stages12, sub_stage3_of: pfb_big_kernel's stages, here
//     for 2T columns, on fft_plan(N2)), the twiddle w_C^(n1 k2), Y written
//     a column per consecutive thread (runs of T n1).  The first group's
//     grid also writes new_hist;
//   - pass 2: a CTA takes a frame pair and a tile of T consecutive k2: the
//     N1-point FFT of the 2T rows (stage 1 reads them from Y, consecutive
//     threads consecutive n1), each y rounded once to float32 into shared
//     memory, the discriminator of the pair into d[m2, k2 + N2*k1] (runs of
//     T k2).  N1 > kMaxCtaChannels (a prime factor that large): a direct
//     sum a thread, k1 consecutive across threads, both frames' rows read
//     from global memory (every thread of a warp reads the same entry).
// Every factor is an entry of the table w_C^i, i < C (the N-point plans
// read entry m*C/N for w_N^m).  The order of the float64 sums differs from
// the plain version's matrix product; each y is rounded once to float32.
//
// What bounds it: the same bound as the other routes (chip_smoke.py
// pfb_ops; 24.2 us at C = 8192 on a 0.25 s block, operations).  The kernels
// are far from it: pass 1 reads the input as pfb_big_kernel does, P + 1
// conditioned 16-bit loads a channel of a pair from L2 in runs of T words,
// with 16 warps an SM (128 registers, ~390 bytes of spills, two CTAs of
// ~103 KB); Y makes a round trip through memory (32 bytes a channel a
// pair).  On an NVIDIA H100 80GB HBM3 at 700 W (ops/cuda/sections.py step)
// one 0.25 s block at C = 8192 took 487.5 us in pass 1 and 132.6 in pass 2
// as one group; groups whose Y stays in L2 were slower (689 us at 16 MiB),
// their launches too small to fill the card.  PERF.md has the
// numbers.

// A launch of one pass over a group of frame pairs.  T: columns a tile (n1
// in pass 1, k2 in pass 2; 0 in pass 2: the direct sum), `tiles` a pair;
// ZS: the float2 buffer's column stride (pass 1 the z of each column, pass
// 2 its y); s: pass 1's N2-point plan (TS = N1), pass 2's N1-point one (TS
// = N2).
struct Step {
  int C, N1, N2, P, T, tiles, ZS;
  Sub s;
  long long pair0;  // the group's first frame pair in the launch
  int precise;
};

// Shared memory of a pass's CTA: U (double2 [2T][FS]) | z or y (float2
// [2T][ZS]); ops/cuda/fused_pfb.py four_step_smem.
size_t step_smem(const Step& st) {
  return st.T ? (sizeof(double2) * st.s.FS + sizeof(float2) * st.ZS) * 2 * st.T : 0;
}

// CTA b: pair b / tiles of the group, its tile b % tiles of n1.
__global__ void __launch_bounds__(kThreads, 2)
pfb_pass1_kernel(const uint16_t* __restrict__ in, const float* __restrict__ hist,
                 const float* __restrict__ h, const double2* __restrict__ tw,
                 double2* __restrict__ Y, float* __restrict__ new_hist, long long n, Step st) {
  extern __shared__ double2 smem[];
  const int C = st.C, N1 = st.N1, N2 = st.N2, P = st.P, PC = P * C;
  const int T = st.T, F = 2 * T, ZS = st.ZS;
  double2* U = smem;
  float2* Z = reinterpret_cast<float2*>(U + F * st.s.FS);
  const int jp = blockIdx.x / st.tiles;
  const int a = (blockIdx.x - jp * st.tiles) * T;  // the tile's first n1
  const int live = min(T, N1 - a);

  if (st.pair0 == 0) {  // the carried history, spread over the first group's grid
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < PC;
         i += static_cast<long long>(gridDim.x) * kThreads) {
      const float2 v = big_sample(in, hist, PC, n - PC + i);
      new_hist[i] = v.x;
      new_hist[PC + i] = v.y;
    }
  }

  // branch filter of channel a + tt + N1*n2, tt fastest: column tt of the
  // even frame, T + tt of the odd one, point n2
  const long long top = (2 * (st.pair0 + jp) + 1) * C;
  for (int e = threadIdx.x; e < T * N2; e += kThreads) {
    const int n2 = e / T, tt = e - n2 * T;
    if (tt < live) {
      pair_filter(in, hist, h, C, P, top, a + tt + N1 * n2, Z[tt * ZS + n2],
                  Z[(T + tt) * ZS + n2]);
    }
  }
  __syncthreads();
  sub_stages12(
      [&](int f, int c) {
        const float2 z = Z[f * ZS + c];
        return make_double2(z.x, z.y);
      },
      U, tw, st.s, F);
  double2* Yp = Y + 2LL * jp * C;  // the pair's [frame][k2][n1]
  sub_stage3_of<true, false>(U, tw, st.s, F, [&](int f, int k2, double2 y) {
    const int e = f >= T, tt = f - e * T;
    if (tt < live) {
      const int n1 = a + tt;
      Yp[e * C + k2 * N1 + n1] = n1 * k2 ? cmul(y, __ldg(tw + n1 * k2)) : y;
    }
  });
}

// CTA b: pair b / tiles of the group, its tile b % tiles of k2; T = 0: pair
// b / (N2 chunks), k2 = (b / chunks) % N2, k1 in chunk b % chunks of
// kThreads.
__global__ void __launch_bounds__(kThreads, 2)
pfb_pass2_kernel(const double2* __restrict__ Y, const double2* __restrict__ tw,
                 float* __restrict__ d, Step st) {
  const int C = st.C, N1 = st.N1, N2 = st.N2, T = st.T;
  if (T == 0) {
    const int chunks = (N1 + kThreads - 1) / kThreads;
    const int jp = blockIdx.x / (N2 * chunks);
    const int r = blockIdx.x - jp * N2 * chunks, k2 = r / chunks;
    const int k1 = (r - k2 * chunks) * kThreads + threadIdx.x;
    if (k1 >= N1) return;
    const double2* ye = Y + 2LL * jp * C + static_cast<long long>(k2) * N1;
    const double2* yo = ye + C;
    double2 ae = make_double2(0.0, 0.0), ao = ae;
    int m = 0;  // n1 k1 mod N1
    for (int n1 = 0; n1 < N1; ++n1) {
      const double2 w = __ldg(tw + m * N2);
      ae = cmac(ae, ye[n1], w);
      ao = cmac(ao, yo[n1], w);
      m += k1;
      if (m >= N1) m -= N1;
    }
    d[(st.pair0 + jp) * C + k2 + N2 * k1] =
        wide_demod(st.precise, __double2float_rn(ae.x), __double2float_rn(ae.y),
                   __double2float_rn(ao.x), __double2float_rn(ao.y));
    return;
  }
  extern __shared__ double2 smem[];
  const int F = 2 * T, YS = st.ZS;
  double2* U = smem;
  float2* Yf = reinterpret_cast<float2*>(U + F * st.s.FS);
  const int jp = blockIdx.x / st.tiles;
  const int b = (blockIdx.x - jp * st.tiles) * T;  // the tile's first k2
  const int live = min(T, N2 - b);
  // column tt of the even frame, T + tt of the odd one: row b + tt
  const double2* Yp = Y + 2LL * jp * C + static_cast<long long>(b) * N1;
  sub_stages12(
      [&](int f, int c) {
        const int e = f >= T, tt = f - e * T;
        return tt < live ? Yp[e * C + tt * N1 + c] : make_double2(0.0, 0.0);
      },
      U, tw, st.s, F);
  sub_stage3_of<false, false>(U, tw, st.s, F, [&](int f, int k1, double2 y) {
    Yf[f * YS + k1] = round_f32(y);
  });
  __syncthreads();
  float* row = d + (st.pair0 + jp) * C + b;
  for (int t = threadIdx.x; t < T * N1; t += kThreads) {
    const int k1 = t / T, tt = t - k1 * T;
    if (tt < live) {
      const float2 ye = Yf[tt * YS + k1], yo = Yf[(T + tt) * YS + k1];
      row[tt + N2 * k1] = wide_demod(st.precise, ye.x, ye.y, yo.x, yo.y);
    }
  }
}

bool step_raised[kMaxDevices];  // both passes' limits raised

int raise_step_smem() {
  return raise_smem({reinterpret_cast<const void*>(pfb_pass1_kernel),
                     reinterpret_cast<const void*>(pfb_pass2_kernel)},
                    step_raised);
}

// The two passes' launches (Step) of C channels from the wrapper's plan
// {N1, T1, T2, pass 1's C1, C2 (of N2), pass 2's C1, C2 (of N1)}, or false
// where the plan is not one the kernels take.
bool make_steps(int C, const int* plan, int P, long long pair0, int precise, Step* st) {
  const int N1 = plan[0], T1 = plan[1], T2 = plan[2];
  if (C <= kMaxCtaChannels || P < 1 || P > kMaxPhases || N1 < 1 || C % N1) return false;
  const int N2 = C / N1;
  const bool direct = N1 > kMaxCtaChannels;
  if (N2 > kMaxCtaChannels || T1 < 1 || T1 > N1 || (direct ? T2 != 0 : T2 < 1 || T2 > N2)) {
    return false;
  }
  const int subs[2][3] = {{N2, plan[3], plan[4]}, {N1, plan[5], plan[6]}};
  for (int i = 0; i < 2; ++i) {
    const int N = subs[i][0], a = subs[i][1], b = subs[i][2];
    if (i == 1 && direct) continue;
    if (a < 1 || b < 1 || b > kMaxColumn || N % (a * b)) return false;
  }
  for (int i = 0; i < 2; ++i) {
    const int N = subs[i][0], T = i ? T2 : T1;
    st[i] = Step{C, N1, N2, P, T, T ? ((i ? N2 : N1) + T - 1) / T : 0, N % 2 ? N : N + 1,
                 direct && i ? Sub{} : make_sub(N, subs[i][1], subs[i][2], C / N, true), pair0,
                 precise};
    if (step_smem(st[i]) > static_cast<size_t>(kMaxSmem)) return false;
  }
  return true;
}

}  // namespace

// C entry point (loaded with ctypes by ops/cuda/build.py).  in: device
// uint16[n] (the raw bytes, one little-endian word per complex sample);
// hist, new_hist: device float[2][P*C]; h: device float[P][C]; d: device
// float[n / (2C)][C]; n % (2C) == 0, 1 <= C <= kMaxCtaChannels, 1 <= P <=
// kMaxPhases.  The plan (ops/cuda/fused_pfb.py fft_plan and fft_table):
// C <= kMaxStaged: C = C1 * C2 (1 x 2 at C = 2, 2 x 2 at C = 4); table:
// device double[C + C1*RS][2], RS = C2 + 1 (C2 > 1) or 1: cos and sin of 2
// pi i / C for i < C, then of 2 pi k1 c2 / C at C + k1*RS + c2.  Above:
// C = C1 * C2 * C3 with C3 = C / (C1 * C2) and C2 <= 16; table: device
// double[C][2], cos and sin of 2 pi i / C: pfb_wide_kernel for the plans
// compiled in with P = kTaps (wide_plan), else pfb_big_kernel.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int fused_pfb_launch(const void* in, const void* hist, const void* h,
                                const void* table, void* d, void* new_hist, long long n,
                                int C, int C1, int C2, int P, int precise, void* stream) {
  if (C < 1 || C > kMaxCtaChannels || P < 1 || P > kMaxPhases || C1 < 1 || C2 < 1 ||
      n < 2LL * C || n % (2LL * C) || n / (2LL * C) >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool staged = C <= kMaxStaged;
  if (staged ? C1 * C2 != C || (is_small(C) && C1 != C / 2)
             : C1 > C || C2 > kMaxColumn || C % (C1 * C2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto src = static_cast<const uint16_t*>(in);
  auto hi = static_cast<const float*>(hist);
  auto hp = static_cast<const float*>(h);
  auto tb = static_cast<const double2*>(table);
  auto out = static_cast<float*>(d);
  auto nh = static_cast<float*>(new_hist);
  auto s = static_cast<cudaStream_t>(stream);
  if (!staged) {
    const int rc = P == kTaps ? wide_plan(src, hi, hp, tb, out, nh, n, C1, C2, C / (C1 * C2),
                                          precise, s, nullptr)
                              : kNotCompiledIn;
    return rc != kNotCompiledIn ? rc
                                : launch_big(src, hi, hp, tb, out, nh, n, C, C1, C2, P,
                                             precise != 0, s);
  }
  return precise ? launch_plan<true>(src, hi, hp, tb, out, nh, n, C, C1, C2, P, s)
                 : launch_plan<false>(src, hi, hp, tb, out, nh, n, C, C1, C2, P, s);
}

// The attributes of the kernel a launch of C = C1 * C2 * C3 > kMaxStaged
// channels of P taps runs (pfb_wide_kernel or pfb_big_kernel) into out[4]:
// registers a thread, local memory a thread (stack and spills, bytes), dynamic
// shared memory (bytes), CTAs an SM.  Returns a cudaError_t.
extern "C" int fused_pfb_kernel_attrs(int C, int C1, int C2, int P, int* out) {
  if (C <= kMaxStaged || C > kMaxCtaChannels || C1 < 1 || C2 < 1 || C % (C1 * C2) || P < 1 ||
      P > kMaxPhases) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == kTaps) {
    const int rc = wide_plan(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, C1, C2,
                             C / (C1 * C2), 0, nullptr, out);
    if (rc != kNotCompiledIn) return rc;
  }
  const int raised = raise_big_smem();
  if (raised != cudaSuccess) return raised;
  return func_attrs(reinterpret_cast<const void*>(pfb_big_kernel),
                    big_smem_bytes(make_big(C, C1, C2, P, 0)), out);
}

// The four-step route (C > kMaxCtaChannels): pass 1, then pass 2, over frame
// pairs [pair0, pair0 + npairs) of the launch's n samples.  y: device
// double[npairs][2][N2][N1][2], the scratch Y; plan: host int[7], {N1, T1,
// T2, C1 and C2 of fft_plan(N2), C1 and C2 of fft_plan(N1)} (a two-factor
// plan (a, b) as a, 1; T2 = 0 where N1 > kMaxCtaChannels: the direct sum;
// ops/cuda/fused_pfb.py step_plan); table: device double[C][2], cos and sin
// of 2 pi i / C; the group with pair0 = 0 writes new_hist.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError() (a plan the
// kernels do not take: cudaErrorInvalidValue, before any launch).
extern "C" int fused_pfb_step_launch(const void* in, const void* hist, const void* h,
                                     const void* table, void* y, void* d, void* new_hist,
                                     long long n, int C, const int* plan, int P, long long pair0,
                                     int npairs, int precise, void* stream) {
  Step st[2];
  if (C <= kMaxCtaChannels || n < 2LL * C || n % (2LL * C) || pair0 < 0 || npairs < 1 ||
      pair0 + npairs > n / (2LL * C) || !make_steps(C, plan, P, pair0, precise, st)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (st[1].N1 + kThreads - 1) / kThreads;
  const long long g1 = static_cast<long long>(npairs) * st[0].tiles;
  const long long g2 =
      static_cast<long long>(npairs) * (st[1].T ? st[1].tiles : st[1].N2 * chunks);
  if (g1 >= 0x7fffffffLL || g2 >= 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int raised = raise_step_smem();
  if (raised != cudaSuccess) return raised;
  auto s = static_cast<cudaStream_t>(stream);
  auto Y = static_cast<double2*>(y);
  auto tb = static_cast<const double2*>(table);
  pfb_pass1_kernel<<<static_cast<unsigned>(g1), kThreads, step_smem(st[0]), s>>>(
      static_cast<const uint16_t*>(in), static_cast<const float*>(hist),
      static_cast<const float*>(h), tb, Y, static_cast<float*>(new_hist), n, st[0]);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  pfb_pass2_kernel<<<static_cast<unsigned>(g2), kThreads, step_smem(st[1]), s>>>(
      Y, tb, static_cast<float*>(d), st[1]);
  return static_cast<int>(cudaGetLastError());
}

// The attributes of the four-step route's two kernels for C channels of P
// taps on `plan` (as fused_pfb_step_launch takes it) into out[8]: pass 1's
// registers a thread, local memory a thread (stack and spills, bytes),
// dynamic shared memory (bytes) and CTAs an SM, then pass 2's.  Returns a
// cudaError_t.
extern "C" int fused_pfb_step_attrs(int C, const int* plan, int P, int* out) {
  Step st[2];
  if (!make_steps(C, plan, P, 0, 0, st)) return static_cast<int>(cudaErrorInvalidValue);
  const int raised = raise_step_smem();
  if (raised != cudaSuccess) return raised;
  const void* kernels[2] = {reinterpret_cast<const void*>(pfb_pass1_kernel),
                            reinterpret_cast<const void*>(pfb_pass2_kernel)};
  for (int i = 0; i < 2; ++i) {
    const int rc = func_attrs(kernels[i], step_smem(st[i]), out + 4 * i);
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}
