// K6 above 4096 channels on thread block clusters, for Hopper (sm_90a).
//
// pfb_cluster_kernel replaces, for the 6.25 kHz grids of 30, 38.4, 51.2 and
// 102.4 Msps (C = 4800, 6144, 8192, 16384 with the 12-tap prototype), the
// two-pass four-step route of fused_pfb.cu (pfb_pass1_kernel,
// pfb_pass2_kernel); like it, it is the port of the Pallas TPU kernel
// fused_pfb_demod (demodulator_tpu/ops/pallas/fused_pfb.py:196, pallas_call
// :232) and computes what fused_pfb.cu's header states: shiftOrigin, the
// P-tap branch filter over the carried history (each z summed tap by tap
// from p = 0 in float32, bit for bit as the plain version), the C-point DFT
// as a float64 FFT with each y rounded once to float32, the even/odd
// conjugate product, the precise or the fast discriminator, and the new
// history.  Every other C > 4096, or another P, keeps the two passes.
//
// The FFT is Bailey's four-step one with C = N1*N2 (the wrapper's
// four_step_plan), c = n1 + N1*n2 and k = k2 + N2*k1:
//
//   Y[n1, k2]     = w_C^(n1 k2) * sum_n2 z[n1 + N1 n2] w_N2^(n2 k2)   (step A)
//   y[k2 + N2 k1] = sum_n1 Y[n1, k2] w_N1^(n1 k1)                     (step B)
//
// Design.  A cluster of K CTAs (Cluster::K; launched with
// cudaLaunchAttributeClusterDimension) holds a frame pair's float64
// spectra in its CTAs' shared memory, 32 C / K bytes a CTA, and never in
// global memory: one launch a call, no scratch buffer.  The grid is the
// clusters the card holds at once (cudaOccupancyMaxActiveClusters, asked
// once per device), at most one a pair; cluster i walks a run of
// consecutive frame pairs.  Each CTA has two buffers X0 and X1: pair j's
// spectra in X = X[j % 2], step B working in the other, XB.  A pair, in
// CTA r of its cluster:
//   - the branch filter of channels n1 + N1*n2 for n1 in r's slice [a, a +
//     NA) (NA = N1 / K) and every n2, both frames, from a ring of the input
//     rows in shared memory (below), into X[frame][n2][n1 - a] as float64,
//     n1 fastest (X's lane stride LSA odd);
//   - step A: the N2-point FFT of the 2*NA columns in place, stage by stage
//     (Stages: a compiled-in plan of 2 or 3 stages of 2, 4, 8, 16, 3 or 5
//     points, a column's R points a thread, the twiddles between the stages
//     the powers of one table entry), the last stage times w_C^(n1 k2);
//   - barrier.cluster (arrive.release, wait.acquire): every CTA's Y is done;
//   - step B: CTA r takes k2 in [r*NB, r*NB + NB) (NB = ceil(N2 / K)): the
//     first stage of the N1-point FFTs of its 2*NB rows reads its R points
//     from the X of the CTAs that own them, through distributed shared
//     memory (mapa, ld.shared::cluster; consecutive threads read consecutive
//     n1 of one CTA), and writes its outputs into XB[frame][n1 position][k2
//     - r*NB]; the other stages run in place, the last pairing the two
//     frames (a column of both a thread): each y rounded once to float32,
//     the discriminator, d[pair][k2 + N2*k1].
//   One cluster barrier a pair: no CTA writes X[j % 2] again (pair j + 2's
//   filter) before every CTA has passed pair j + 1's barrier, after its
//   step B of pair j; a last barrier before the CTAs exit.  At 8192 (K = 4)
//   192 KB of a pair's 256 KB of spectra cross the SM-to-SM network
//   instead of 512 KB going through HBM and back.
// The input rows: frame m at tap p reads sample (m - p)C - c, the row of
// the input whose samples (R + 1)C - c a CTA keeps for its channels c is
// "row R" of its ring, so frame 2j + 1 reads rows 2j - p and frame 2j rows
// 2j - 1 - p: a pair reads rows 2j - P .. 2j (P + 1 rows, the ring's
// slots, RING = P + 1).  Of a row, CTA r needs, for each n2, NA consecutive
// samples (R + 1)C - N1 n2 - a - NA + 1 .. (R + 1)C - N1 n2 - a: a run, held
// with the 8 words before it as RW = NA + 8 raw 16-bit words (16-byte
// aligned at both ends: RW / 8 16-byte cp.async copies, spread over the
// threads; 48-byte cp.async.bulk copies, one a run, were issue-bound at
// about 50 ns each).  A pair's two new rows are issued as soon as its
// filter has read the two slots they replace, so they land during its FFT;
// each word is loaded into shared memory once a cluster's run and
// conditioned once a read.  Input not 16-byte aligned: the threads copy the
// runs.  Samples before 0 come from the history (and row -1 of channel 0,
// sample 0, from the input), in the pairs whose rows start before 0 (2j <
// P, a second instantiation of the filter).  The taps are read through
// __ldg a channel a pair, or, where that does not spill (4800: 3 channels
// of 12 taps a thread), held in registers across the walk
// (Cluster::kRegTaps; sections.py times both).
//
// What bounds it: the same bound as the other routes (chip_smoke.py
// pfb_ops; 24.2 us at C = 8192 on a 0.25 s block, operations).  The kernel
// issues the filter's separate float32 multiplies and adds (48 a sample at
// P = 12) with the ring's loads and conditionings, the float64 FFT on the
// CUDA cores (about 20 operations a sample at half the float32 rate, and the
// twiddles' powers), the exchange of Y between the cluster's CTAs, and the
// barriers; one CTA of 16 warps an SM.  PERF.md has its times.

#include <algorithm>
#include <cstdint>

#include "nbfm_device.cuh"
#include "pfb_device.cuh"

namespace {

using namespace nbfm;

constexpr int kClusterTaps = 12;  // ops/cuda/fused_pfb.py WIDE_TAPS
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA can have
constexpr int kMaxDevices = 64;
constexpr int kNotCompiledIn = -1;

// An N-point FFT's compiled-in plan: stages of R(0), R(1) (and R(2)) points
// (2, 4, 8, 16, 3 or 5).  Stage s runs on blocks of B(s) consecutive points
// (N / B(s) of them), its task (block, d) with d < D(s) = B(s) / R(s) taking
// points block*B(s) + D(s)*i + d (i < R(s)), their R(s)-point DFT, output k
// times w_B(s)^(k d) back at block*B(s) + D(s)*k + d.  After the last stage
// natural output k sits at pos(k).
template <int kR1, int kR2, int kR3 = 1>
struct Stages {
  static constexpr int N = kR1 * kR2 * kR3, S = kR3 > 1 ? 3 : 2;
  __host__ __device__ static constexpr int R(int s) { return s == 0 ? kR1 : (s == 1 ? kR2 : kR3); }
  __host__ __device__ static constexpr int B(int s) {
    int b = N;
    for (int u = 0; u < s; ++u) b /= R(u);
    return b;
  }
  __host__ __device__ static constexpr int D(int s) { return B(s) / R(s); }
  // natural k -> its position after the stages (its digits k_s, k = sum
  // k_s R(0)..R(s-1), at sum k_s D(s))
  __host__ __device__ static constexpr int pos(int k) {
    int p = 0;
    for (int s = 0; s < S; ++s) {
      p += (k % R(s)) * D(s);
      k /= R(s);
    }
    return p;
  }
  // the last stage's block `row` -> the natural index of its output 0 (its
  // output k is kbase + k*N/R(S-1))
  __host__ __device__ static constexpr int kbase(int row) {
    int kb = 0, m = 1;
    for (int s = 0; s < S - 1; ++s) {
      kb += (row / (D(s) / R(S - 1)) % R(s)) * m;
      m *= R(s);
    }
    return kb;
  }
};

// A compiled-in plan: C = kN1 * kN2 (four_step_plan), clusters of kK CTAs of
// kT threads, step A's N2-point plan SA and step B's N1-point plan SB;
// kRegTaps: each thread's taps held in registers across the walk.
template <int kN1, int kN2, int kK, int kT, class SA_, class SB_, bool kRegTaps = false>
struct Cluster {
  using SA = SA_;
  using SB = SB_;
  static constexpr int N1 = kN1, N2 = kN2, C = kN1 * kN2, K = kK, T = kT, P = kClusterTaps;
  static constexpr int NA = N1 / K;            // n1 a CTA in step A
  static constexpr int NB = (N2 + K - 1) / K;  // k2 a CTA in step B (the last rank maybe fewer)
  static constexpr int LSA = NA | 1, LSB = NB | 1;  // X's lane strides (odd: no bank conflicts)
  static constexpr int RW = NA + 8;            // a run's 16-bit words in the ring
  static constexpr int RING = P + 1;           // the ring's rows
  static constexpr int XA = 2 * N2 * LSA, XB = 2 * N1 * LSB;
  static constexpr int CPT = (NA * N2 + T - 1) / T;  // the filter's channels a thread
  static constexpr bool kTapsHeld = kRegTaps;
  // shared memory: X0 and X1 (each double2 [2][N2][LSA] in step A,
  // [2][N1][LSB] in step B) | the ring (uint16 [RING][N2][RW])
  static constexpr int kXWords = XA > XB ? XA : XB;
  static constexpr int kXBytes = 2 * 16 * kXWords;
  static constexpr int kRingBytes = 2 * RING * N2 * RW;
  static constexpr int kSmem = kXBytes + kRingBytes;
  using HeldTaps = float[kRegTaps ? CPT : 1][kRegTaps ? P : 1];
  static_assert(SA::N == N2 && SB::N == N1, "the stage plans' sizes are N2 and N1");
  static_assert(N1 % K == 0 && NA % 8 == 0 && C % 8 == 0, "16-byte aligned runs");
  static_assert(2 * NB * SB::D(0) <= T, "step B's first stage: a task a thread");
  static_assert(kRingBytes % 16 == 0 && kSmem <= kMaxSmem, "a CTA's shared memory");
};

__device__ __forceinline__ unsigned cluster_special(int which) {
  unsigned r;
  if (which == 0) {
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  } else if (which == 1) {
    asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  } else {
    asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  }
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The double2 at shared address `cta` (a shared::cta address of this CTA's
// layout) in CTA `rank` of the cluster
__device__ __forceinline__ double2 ld_cluster(unsigned cta, int rank) {
  unsigned a;
  double2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(cta), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f64 {%0, %1}, [%2];"
               : "=d"(v.x), "=d"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

// The R-point DFT of v in place, natural order in and out, w_R^m constants:
// a radix size is the butterfly network; 3 and 5 pair the points c and R - c
// (y_k and y_(R-k) from the sums and differences of the pairs).
template <int R>
__device__ __forceinline__ void cl_dft(double2 (&v)[R]) {
  if constexpr (is_radix(R)) {
    wide_fft<R>(v);
  } else {
    static_assert(R == 3 || R == 5, "a stage of 2, 3, 4, 5, 8 or 16 points");
    constexpr int H = (R - 1) / 2;
    double2 sa[H], sb[H];
    double2 y0 = v[0];
#pragma unroll
    for (int c = 1; c <= H; ++c) {
      sa[c - 1] = make_double2(__dadd_rn(v[c].x, v[R - c].x), __dadd_rn(v[c].y, v[R - c].y));
      sb[c - 1] = make_double2(__dsub_rn(v[c].x, v[R - c].x), __dsub_rn(v[c].y, v[R - c].y));
      y0 = make_double2(__dadd_rn(y0.x, sa[c - 1].x), __dadd_rn(y0.y, sa[c - 1].y));
    }
    double2 y[R];
    y[0] = y0;
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      double2 a = v[0], b = make_double2(0.0, 0.0);
#pragma unroll
      for (int c = 1; c <= H; ++c) {
        const double2 w = wconst<R>((k * c) % R);  // (cos, sin) of 2 pi k c / R
        a = make_double2(__fma_rn(sa[c - 1].x, w.x, a.x), __fma_rn(sa[c - 1].y, w.x, a.y));
        b = make_double2(__fma_rn(sb[c - 1].x, w.y, b.x), __fma_rn(sb[c - 1].y, w.y, b.y));
      }
      // y_k = a + j b, y_(R-k) = a - j b
      y[k] = make_double2(__dsub_rn(a.x, b.y), __dadd_rn(a.y, b.x));
      y[R - k] = make_double2(__dadd_rn(a.x, b.y), __dsub_rn(a.y, b.x));
    }
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = y[k];
  }
}

// Stage s (not the last) of S's N-point FFTs of the 2*L columns in X, in
// place: point i of column (frame f, lane l) at X[(f*N + i)*LS + l].  A task
// (f, block, d, l), l fastest; its outputs k times w_B^(k d), the powers of
// table entry d*C/B (w_C^m at tw[m]).
template <class W, class S, int s, int L, int LS>
__device__ __forceinline__ void cl_stage(double2* X, const double2* __restrict__ tw) {
  constexpr int N = S::N, R = S::R(s), B = S::B(s), D = B / R, PER = N / R;
#pragma unroll 1
  for (int t = threadIdx.x; t < 2 * L * PER; t += W::T) {
    const int l = t % L, q = t / L, f = q / PER, r = q % PER;
    const int dd = r % D;
    double2* x = X + (f * N + (r / D) * B + dd) * LS + l;
    double2 v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = x[i * D * LS];
    cl_dft<R>(v);
    const double2 w = __ldg(tw + dd * (W::C / B));
    double2 p = w;
    x[0] = v[0];
#pragma unroll
    for (int k = 1; k < R; ++k) {
      x[k * D * LS] = cmul(v[k], p);
      if (k + 1 < R) p = cmul(p, w);
    }
  }
}

// Step A's last stage: column (f, l) is n1 = a + l; output k of block row
// is k2 = kbase(row) + k*N2/R, written times w_C^(n1 k2), the powers of
// w_C^(n1 N2/R) from w_C^(n1 kbase).
template <class W>
__device__ __forceinline__ void cl_last_a(double2* X, const double2* __restrict__ tw, int a) {
  using S = typename W::SA;
  constexpr int N = S::N, R = S::R(S::S - 1), ROWS = N / R, L = W::NA, LS = W::LSA;
#pragma unroll 1
  for (int t = threadIdx.x; t < 2 * L * ROWS; t += W::T) {
    const int l = t % L, q = t / L, f = q / ROWS, row = q % ROWS;
    double2* x = X + (f * N + row * R) * LS + l;
    double2 v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = x[i * LS];
    cl_dft<R>(v);
    const int n1 = a + l;
    double2 p = __ldg(tw + n1 * S::kbase(row));
    const double2 w = __ldg(tw + n1 * ROWS);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      x[k * LS] = cmul(v[k], p);
      if (k + 1 < R) p = cmul(p, w);
    }
  }
}

__device__ __forceinline__ float2 round_pair(double2 y) {
  return make_float2(__double2float_rn(y.x), __double2float_rn(y.y));
}

// Step B's last stage: a column of both frames a thread (lane l is k2 =
// kb0 + l), each y rounded once to float32, the discriminator of the pair
// into row[k2 + N2*k1].
template <class W>
__device__ __forceinline__ void cl_last_b(const double2* X, float* __restrict__ row, int kb0,
                                          int live, int precise) {
  using S = typename W::SB;
  constexpr int N = S::N, R = S::R(S::S - 1), ROWS = N / R, L = W::NB, LS = W::LSB;
#pragma unroll 1
  for (int t = threadIdx.x; t < L * ROWS; t += W::T) {
    const int l = t % L, r = t / L;
    if (l >= live) continue;
    const double2* x = X + r * R * LS + l;
    double2 v[R];
    float2 ye[R];
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = x[i * LS];
    cl_dft<R>(v);
#pragma unroll
    for (int k = 0; k < R; ++k) ye[k] = round_pair(v[k]);
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = x[(N + i) * LS];
    cl_dft<R>(v);
    float* out = row + kb0 + l + W::N2 * S::kbase(r);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float2 yo = round_pair(v[k]);
      out[W::N2 * ROWS * k] = precise ? demod_pairs<true>(ye[k].x, ye[k].y, yo.x, yo.y)
                                      : demod_pairs<false>(ye[k].x, ye[k].y, yo.x, yo.y);
    }
  }
}

// Step B: CTA `rank`'s k2 in [kb0, kb0 + live).  Its first stage's task
// (frame f, lane l, d), d fastest, reads points n1 = D*i + d of row k2 from
// the XA of their owners (n1 / NA) through distributed shared memory and
// writes its outputs into X, this CTA's other buffer.
template <class W>
__device__ __forceinline__ void step_b(const double2* XA, double2* X,
                                       const double2* __restrict__ tw, float* __restrict__ row,
                                       int kb0, int live, int precise) {
  using SB = typename W::SB;
  constexpr int N1 = W::N1, N2 = W::N2, NA = W::NA, NB = W::NB, LSA = W::LSA, LSB = W::LSB;
  constexpr int R = SB::R(0), D = SB::D(0);
  const int t = threadIdx.x, dd = t % D, q = t / D, l = q % NB, f = q / NB;
  const bool on = t < 2 * NB * D && l < live;
  if (on) {
    double2 v[R];
    const unsigned base = smem_addr(XA + (f * N2 + W::SA::pos(kb0 + l)) * LSA);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int n1 = D * i + dd;
      v[i] = ld_cluster(base + 16u * (n1 % NA), n1 / NA);
    }
    cl_dft<R>(v);
    const double2 w = __ldg(tw + dd * N2);  // w_N1^d
    double2 p = w;
#pragma unroll
    for (int k = 1; k < R; ++k) {
      v[k] = cmul(v[k], p);
      if (k + 1 < R) p = cmul(p, w);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) X[(f * N1 + D * k + dd) * LSB + l] = v[k];
  }
  __syncthreads();
  if constexpr (SB::S == 3) {
    cl_stage<W, SB, 1, NB, LSB>(X, tw);
    __syncthreads();
  }
  cl_last_b<W>(X, row, kb0, live, precise);
}

// Rows [ra, rb) of the CTA's ring (row R: for each n2 the run of RW words
// from sample (R + 1)C - N1 n2 - a - NA) into slots R mod RING: 16-byte
// asynchronous copies (cp.async, one commit group; cp.async.wait_all and a
// barrier make them visible), spread over the threads, or, for input not
// 16-byte aligned, copied by the threads.
template <class W>
__device__ __forceinline__ void cl_fill(const uint16_t* __restrict__ in, uint16_t* ring,
                                        long long ra, long long rb, int a, bool aligned) {
  constexpr int C = W::C, N1 = W::N1, N2 = W::N2, NA = W::NA, RW = W::RW, RING = W::RING;
  const int runs = static_cast<int>(rb - ra) * N2;
  const int slot0 = static_cast<int>(ra % RING);
  const uint16_t* src = in + (ra + 1) * C - a - NA;  // row ra's run n2 = 0
  // the ring offset and the source offset of run e of the rows
  auto at = [&](int e, int& from) {
    const int rr = e / N2, n2 = e - rr * N2;
    const int slot = slot0 + rr < RING ? slot0 + rr : slot0 + rr - RING;
    from = rr * C - N1 * n2;
    return (slot * N2 + n2) * RW;
  };
  if (aligned) {
    constexpr int Q = RW / 8;  // 16-byte chunks a run
    for (int e = threadIdx.x; e < runs * Q; e += W::T) {
      const int run = e / Q, k = e - run * Q;
      int from;
      const int to = at(run, from);
      cp_async16(ring + to + 8 * k, src + from + 8 * k);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    for (int e = threadIdx.x; e < runs * RW; e += W::T) {
      const int run = e / RW, w = e - run * RW;
      int from;
      const int to = at(run, from);
      ring[to + w] = src[from + w];
    }
  }
}

// The branch filter of pair j's two frames for this CTA's channels c = a +
// l + N1 n2 (e = l + NA n2 = threadIdx.x + i*T), into X[frame][n2][l]: ring
// row 2j - q at q = 0 .. P, the odd frame's tap p at q = p, the even
// frame's at q = p + 1 (pair_filter's order and arithmetic).  kHist: rows
// before 0 (2j < P) from the history, channel 0's row -1 (sample 0) from
// the input.
template <class W, bool kHist>
__device__ __forceinline__ void cl_filter(const uint16_t* ring, const uint16_t* __restrict__ in,
                                          const float* __restrict__ hist,
                                          const float* __restrict__ h,
                                          const typename W::HeldTaps& hr, double2* X, long long j,
                                          int a) {
  constexpr int C = W::C, P = W::P, PC = P * C, N1 = W::N1, N2 = W::N2, NA = W::NA;
  constexpr int RW = W::RW, RING = W::RING, LSA = W::LSA;
  const long long top = 2 * j;
  const int s0 = static_cast<int>(top % RING);  // row 2j's slot
  int off[P + 1];  // row 2j - q's slot offset (rows before 0: unused)
#pragma unroll
  for (int q = 0; q <= P; ++q) off[q] = (s0 >= q ? s0 - q : s0 - q + RING) * (N2 * RW);
#pragma unroll
  for (int i = 0; i < W::CPT; ++i) {
    const int e = threadIdx.x + i * W::T;
    if (W::CPT * W::T != NA * N2 && e >= NA * N2) break;
    const int l = e % NA, n2 = e / NA, c = a + l + N1 * n2;
    const int at = n2 * RW + NA - l;
    auto x = [&](int q) -> float2 {
      if constexpr (kHist) {
        const long long s = (top - q + 1) * C - c;
        if (s < 0) return make_float2(hist[PC + s], hist[2 * PC + s]);
        if (top - q < 0) return wide_cond(__ldg(in + s));
      }
      return wide_cond(ring[off[q] + at]);
    };
    auto tap = [&](int p) -> float {
      if constexpr (W::kTapsHeld) {
        return hr[i][p];
      } else {
        return __ldg(h + p * C + c);
      }
    };
    float hp = tap(0);
    float2 s = x(0);
    float orr = __fmul_rn(hp, s.x), oi = __fmul_rn(hp, s.y);
    float er = 0.0f, ei = 0.0f;
#pragma unroll
    for (int p = 1; p <= P; ++p) {
      s = x(p);
      // the even frame's tap p - 1 (hp = h[p - 1][c])
      er = p == 1 ? __fmul_rn(hp, s.x) : __fadd_rn(er, __fmul_rn(hp, s.x));
      ei = p == 1 ? __fmul_rn(hp, s.y) : __fadd_rn(ei, __fmul_rn(hp, s.y));
      if (p < P) {  // the odd frame's tap p
        hp = tap(p);
        orr = __fadd_rn(orr, __fmul_rn(hp, s.x));
        oi = __fadd_rn(oi, __fmul_rn(hp, s.y));
      }
    }
    X[n2 * LSA + l] = make_double2(er, ei);
    X[(N2 + n2) * LSA + l] = make_double2(orr, oi);
  }
}

// Cluster i (of the grid's) takes pairs [i*pairs / clusters, (i + 1)*pairs /
// clusters); its CTA r the slices a = r*NA of n1 and kb0 = r*NB of k2.
template <class W>
__global__ void __launch_bounds__(W::T, 1)
pfb_cluster_kernel(const uint16_t* __restrict__ in, const float* __restrict__ hist,
                   const float* __restrict__ h, const double2* __restrict__ tw,
                   float* __restrict__ d, float* __restrict__ new_hist, long long n, int precise) {
  extern __shared__ __align__(16) unsigned char csm[];
  constexpr int C = W::C, P = W::P, PC = P * C;
  double2* X0 = reinterpret_cast<double2*>(csm);
  double2* X1 = X0 + W::kXWords;
  uint16_t* ring = reinterpret_cast<uint16_t*>(csm + W::kXBytes);
  const long long M = n / C, pairs = M / 2;

  // the carried history, spread over the grid
  for (long long i = static_cast<long long>(blockIdx.x) * W::T + threadIdx.x; i < PC;
       i += static_cast<long long>(gridDim.x) * W::T) {
    const float2 v = big_sample(in, hist, PC, n - PC + i);
    new_hist[i] = v.x;
    new_hist[PC + i] = v.y;
  }

  const int rank = static_cast<int>(cluster_special(0));
  const long long cid = cluster_special(1), ncl = cluster_special(2);
  const long long ja = pairs * cid / ncl, jb = pairs * (cid + 1) / ncl;
  const int a = rank * W::NA, kb0 = rank * W::NB;
  const int live = min(W::NB, W::N2 - kb0);
  typename W::HeldTaps hr;
  if constexpr (W::kTapsHeld) {
#pragma unroll
    for (int i = 0; i < W::CPT; ++i) {
      const int e = min(static_cast<int>(threadIdx.x) + i * W::T, W::NA * W::N2 - 1);
      const int c = a + e % W::NA + W::N1 * (e / W::NA);
#pragma unroll
      for (int p = 0; p < P; ++p) hr[i][p] = __ldg(h + p * C + c);
    }
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  // the first pair's rows 2ja - P .. 2ja (rows before 0 are the history's),
  // then each next pair's two new rows
  cl_fill<W>(in, ring, max(2 * ja - P, 0LL), 2 * ja + 1, a, aligned);
  for (long long j = ja; j < jb; ++j) {
    // pair j's spectra in X, step B's working buffer XB (X1 and X0 in turn)
    double2* X = j & 1 ? X1 : X0;
    double2* XB = j & 1 ? X0 : X1;
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // the pair's rows in the ring
    if (2 * j < P) {
      cl_filter<W, true>(ring, in, hist, h, hr, X, j, a);
    } else {
      cl_filter<W, false>(ring, in, hist, h, hr, X, j, a);
    }
    __syncthreads();
    if (j + 1 < jb) cl_fill<W>(in, ring, 2 * j + 1, 2 * j + 3, a, aligned);
    // step A: the N2-point FFTs of this CTA's n1, the last stage twiddled
    cl_stage<W, typename W::SA, 0, W::NA, W::LSA>(X, tw);
    __syncthreads();
    if constexpr (W::SA::S == 3) {
      cl_stage<W, typename W::SA, 1, W::NA, W::LSA>(X, tw);
      __syncthreads();
    }
    cl_last_a<W>(X, tw, a);
    cluster_arrive();  // Y of every CTA written
    cluster_wait();
    step_b<W>(X, XB, tw, d + j * C, kb0, live, precise);
    __syncthreads();
  }
  // no CTA leaves while another may still read its X
  cluster_arrive();
  cluster_wait();
}

int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  return dev;
}

// A launch of W on n samples (attrs null), or W's attributes into attrs[6]:
// registers a thread, local memory a thread (stack and spills, bytes),
// dynamic shared memory (bytes), CTAs an SM, CTAs a cluster, clusters the
// card holds at once.  The shared-memory limit is raised and the clusters
// asked once per device.
template <class W>
int cluster_run(const uint16_t* in, const float* hist, const float* h, const double2* table,
                float* d, float* new_hist, long long n, int precise, cudaStream_t s,
                int* attrs) {
  auto kernel = pfb_cluster_kernel<W>;
  static int clusters[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = W::K;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(W::K);
  cfg.blockDim = dim3(W::T);
  cfg.dynamicSmemBytes = W::kSmem;
  cfg.stream = s;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (!clusters[dev]) {
    cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    int ncl = 0;
    rc = cudaOccupancyMaxActiveClusters(&ncl, kernel, &cfg);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (ncl < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    clusters[dev] = ncl;
  }
  if (attrs) {
    cudaFuncAttributes fa;
    cudaError_t rc = cudaFuncGetAttributes(&fa, kernel);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    int ctas = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, W::T, W::kSmem);
    attrs[0] = fa.numRegs;
    attrs[1] = static_cast<int>(fa.localSizeBytes);
    attrs[2] = W::kSmem;
    attrs[3] = ctas;
    attrs[4] = W::K;
    attrs[5] = clusters[dev];
    return static_cast<int>(rc);
  }
  const long long pairs = n / (2LL * W::C);
  cfg.gridDim = dim3(static_cast<unsigned>(std::min(pairs, static_cast<long long>(clusters[dev])) * W::K));
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, in, hist, h, table, d, new_hist, n,
                                            precise);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The compiled-in plans (the wrapper's CLUSTER_PLANS, which a CPU test holds
// to this list): C, then Cluster's arguments.
int cluster_plan(int C, const uint16_t* in, const float* hist, const float* h,
                 const double2* table, float* d, float* new_hist, long long n, int precise,
                 cudaStream_t s, int* attrs) {
#define PFB_CLUSTER(c, ...)                                                                    \
  if (C == c) {                                                                                \
    return cluster_run<Cluster<__VA_ARGS__>>(in, hist, h, table, d, new_hist, n, precise, s, \
                                             attrs);                                           \
  }
  PFB_CLUSTER(4800, 64, 75, 4, 512, Stages<3, 5, 5>, Stages<8, 8>, true)
  PFB_CLUSTER(6144, 64, 96, 4, 512, Stages<8, 4, 3>, Stages<8, 8>)
  PFB_CLUSTER(8192, 64, 128, 4, 512, Stages<16, 8>, Stages<8, 8>)
  PFB_CLUSTER(16384, 128, 128, 8, 512, Stages<8, 4, 4>, Stages<8, 4, 4>)
#undef PFB_CLUSTER
  return kNotCompiledIn;
}

}  // namespace

// C entry point (loaded with ctypes by ops/cuda/build.py): K6 on a
// compiled-in cluster plan.  in: device uint16[n]; hist, new_hist: device
// float[2][P*C]; h: device float[P][C]; table: device double[C][2], cos and
// sin of 2 pi i / C; d: device float[n / (2C)][C]; n % (2C) == 0; P =
// kClusterTaps.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (a C with no plan, or another P: cudaErrorInvalidValue,
// before any launch).
extern "C" int fused_pfb_cluster_launch(const void* in, const void* hist, const void* h,
                                        const void* table, void* d, void* new_hist, long long n,
                                        int C, int P, int precise, void* stream) {
  if (P != kClusterTaps || C < 1 || n < 2LL * C || n % (2LL * C) ||
      n / (2LL * C) >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = cluster_plan(C, static_cast<const uint16_t*>(in), static_cast<const float*>(hist),
                              static_cast<const float*>(h), static_cast<const double2*>(table),
                              static_cast<float*>(d), static_cast<float*>(new_hist), n,
                              precise, static_cast<cudaStream_t>(stream), nullptr);
  return rc == kNotCompiledIn ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

// The attributes of the kernel of C's compiled-in cluster plan into out[6]
// (cluster_run's attrs).  Returns a cudaError_t.
extern "C" int fused_pfb_cluster_attrs(int C, int* out) {
  const int rc = cluster_plan(C, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0,
                              nullptr, out);
  return rc == kNotCompiledIn ? static_cast<int>(cudaErrorInvalidValue) : rc;
}
