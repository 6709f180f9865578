// The span kernel body shared by K1 (fused_nbfm.cu, no stage) and K3
// (fused_nbfm_cplx.cu, one or two complex stages): per IQ block row
//
//   condition -> [complex stage]x0..2 -> discriminator -> audio FIR
//
// with every float32 operation the plain version's, in its order
// (ops/cuda/fused_nbfm.py fused_nbfm_ref, fused_nbfm_cplx_ref).
//
// Layout.  A warp owns one span of a row: kVecs chunks of 128 consecutive
// words, lane l holding words 128c + 4l .. 128c + 4l + 3 of chunk c, read
// with one 16-byte load and written with one 16-byte store per chunk.  A
// lane conditions its 8 complex samples per chunk, runs each stage and its
// discriminator on them and its audio FIR on its 4 words, all in registers.
// The look-ahead a stage (n - 1 samples) or the FIR (D words) needs comes
// from the next lanes by warp shuffles; past lane 31 of a chunk it is chunk
// c + 1's lane 0.  Past the span's last lane the shuffles return garbage, so
// a span's last `halo` words (span_halo, rounded up to whole lanes) are
// loaded and computed but not written: spans overlap by that much, each
// starts 16-byte aligned (step = 128 * kVecs - halo, a multiple of 4), and
// no warp waits on another.  No shared memory, no barrier.
//
// Block ends.  Each stage's input is zero past the row's end, so every
// stage's output there is set to zero (a second stage reads zeros, not the
// constant), and so is the discriminator's (the FIR reads zeros there).
//
// Tap counts.  kT (audio taps) and kS0, kS1 (stage taps) are compile-time
// counts: every loop unrolls, every register index and tap is a constant,
// so the taps are read from the parameter bank and nothing is addressed
// through a pointer (ptxas: 0 bytes of stack frame).  A count of 0 reads
// the count at run time (Taps::n, Stages::n) and unrolls to its maximum
// with a uniform guard per tap: the same kernel with every count up to
// kMaxTaps / kMaxCplxTaps, and a halo up to 31 + 31 words.
//
// Rows whose words are not a multiple of 4 or whose bytes are not 16-byte
// aligned take scalar loads and stores (SpanArgs::vec = 0) of the same
// lanes; a span that holds the row's end masks its words past it.
#pragma once

#include "nbfm_device.cuh"

namespace nbfm {

constexpr int kMaxStages = 2;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// 16-byte chunks per lane (ops/cuda/fused_nbfm.py SPAN_VECS), chosen by
// measurement (ops/cuda/sections.py, PERF.md)
constexpr int kVecs = 1;
constexpr int kSpanWords = 128 * kVecs;

struct Stages {
  float t[kMaxStages][kMaxCplxTaps];
  float c[kMaxStages][2];
  int n[kMaxStages];
};

// One launch: rows of `words` words at in and out, each cut into `spans`
// warp spans of `step` written words.
struct SpanArgs {
  const uint32_t* in;
  float* out;
  long long words;
  int step;
  int spans;
  int vec;  // 16-byte loads and stores
  Taps taps;
  Stages st;
};

// Words a span reads past its written ones: the stages' reach in samples,
// halved up, plus D; rounded up to whole lanes
// (ops/cuda/fused_nbfm.py span_halo, span_plan).
inline int span_step(int ntaps, const int* stage_n, int nstages) {
  int reach = 0;
  for (int s = 0; s < nstages; ++s) reach += stage_n[s] - 1;
  const int halo = (reach + 1) / 2 + ntaps - 1;
  return kSpanWords - (halo + 3) / 4 * 4;
}

__device__ __forceinline__ float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(kFullMask, v.x, src), __shfl_sync(kFullMask, v.y, src));
}
__device__ __forceinline__ float shfl(float v, int src) { return __shfl_sync(kFullMask, v, src); }

// e[c][m] = element P + m of this lane's chunk c, for m < live (warp-uniform,
// at most M): element m % P of lane + 1 + m / P, of chunk c + 1 where that
// lane is past 31.  One shuffle per chunk and element.
template <int P, int M, class T>
__device__ __forceinline__ void gather(const T (&v)[kVecs][P], T (&e)[kVecs][M], int lane,
                                       int live) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (m < live) {
      const int src = lane + 1 + m / P;
      T s[kVecs];
#pragma unroll
      for (int c = 0; c < kVecs; ++c) s[c] = shfl(v[c][m % P], src & 31);
#pragma unroll
      for (int c = 0; c < kVecs; ++c) {
        constexpr int kLast = kVecs - 1;
        e[c][m] = (c < kLast && src >= 32) ? s[c < kLast ? c + 1 : c] : s[c];
      }
    }
  }
}

// Stage S: z'_s = c + sum_k t[k] z_{s+k} on this lane's samples.
template <int S, int kN>
__device__ __forceinline__ void complex_stage(float2 (&z)[kVecs][8], const Stages& st, int lane) {
  constexpr int kB = kN ? kN : kMaxCplxTaps;  // the taps, or their bound
  constexpr int kE = kB > 1 ? kB - 1 : 1;
  const int n = kN ? kN : st.n[S];
  float2 e[kVecs][kE];
  gather<8, kE>(z, e, lane, n - 1);
  float2 y[kVecs][8];
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float yr = st.c[S][0], yi = st.c[S][1];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        if (kN || k < n) {
          const float2 v = i + k < 8 ? z[c][i + k] : e[c][i + k - 8];
          yr = __fadd_rn(yr, __fmul_rn(st.t[S][k], v.x));
          yi = __fadd_rn(yi, __fmul_rn(st.t[S][k], v.y));
        }
      }
      y[c][i] = make_float2(yr, yi);
    }
  }
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) z[c][i] = y[c][i];
  }
}

// Zero past the row's end: word i of chunk c is in the row iff 128c + i <
// left (the row's words from this lane's first).
__device__ __forceinline__ void mask_samples(float2 (&z)[kVecs][8], int left) {
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (128 * c + i / 2 >= left) z[c][i] = make_float2(0.0f, 0.0f);
    }
  }
}

__device__ __forceinline__ void mask_words(float (&x)[kVecs][4], int left) {
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (128 * c + i >= left) x[c][i] = 0.0f;
    }
  }
}

template <bool kNormalize>
__device__ __forceinline__ void condition_words(const uint32_t (&w)[kVecs][4],
                                                float2 (&z)[kVecs][8]) {
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = condition_word<kNormalize>(w[c][i]);
      z[c][2 * i] = make_float2(f.x, f.y);
      z[c][2 * i + 1] = make_float2(f.z, f.w);
    }
  }
}

// The span of warp `span` of row blockIdx.y.  kT: audio taps; kNS: stages;
// kS0, kS1: their taps (0: read at run time).
template <int kT, int kNS, int kS0, int kS1, bool kPrecise, bool kNormalize>
__device__ __forceinline__ void nbfm_span(const SpanArgs& a) {
  const int lane = threadIdx.x & 31;
  const int span = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (span >= a.spans) return;  // whole warps
  const long long row = static_cast<long long>(blockIdx.y) * a.words;
  const long long w0 = static_cast<long long>(span) * a.step;
  const bool edge = a.words - w0 < kSpanWords;  // the row ends in this span
  // the row's words from this lane's first word
  const int left = edge ? static_cast<int>(a.words - w0) - 4 * lane : kSpanWords;
  const uint32_t* src = a.in + row + w0 + 4 * lane;

  // loads
  uint32_t w[kVecs][4];
  if (a.vec) {
#pragma unroll
    for (int c = 0; c < kVecs; ++c) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (128 * c < left) v = __ldg(reinterpret_cast<const uint4*>(src + 128 * c));
      w[c][0] = v.x;
      w[c][1] = v.y;
      w[c][2] = v.z;
      w[c][3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kVecs; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[c][i] = 128 * c + i < left ? __ldg(src + 128 * c + i) : 0u;
    }
  }

  // conditioning
  float2 z[kVecs][8];
  condition_words<kNormalize>(w, z);
  if (edge) mask_samples(z, left);

  // the complex stages
  if constexpr (kNS >= 1) {
    complex_stage<0, kS0>(z, a.st, lane);
    if (edge) mask_samples(z, left);
  }
  if constexpr (kNS >= 2) {
    complex_stage<1, kS1>(z, a.st, lane);
    if (edge) mask_samples(z, left);
  }

  // the discriminator
  float x[kVecs][4];
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[c][i] = demod_pairs<kPrecise>(z[c][2 * i].x, z[c][2 * i].y, z[c][2 * i + 1].x,
                                      z[c][2 * i + 1].y);
    }
  }
  if (edge) mask_words(x, left);

  // the audio FIR: sum_d t[d] x[q + d] from the first tap on
  constexpr int kB = kT ? kT : kMaxTaps;
  constexpr int kE = kB > 1 ? kB - 1 : 1;
  const int nt = kT ? kT : a.taps.n;
  float xe[kVecs][kE];
  gather<4, kE>(x, xe, lane, nt - 1);
  float y[kVecs][4];
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float acc = __fmul_rn(a.taps.t[0], x[c][i]);
#pragma unroll
      for (int d = 1; d < kB; ++d) {
        if (kT || d < nt) {
          acc = __fadd_rn(acc, __fmul_rn(a.taps.t[d], i + d < 4 ? x[c][i + d] : xe[c][i + d - 4]));
        }
      }
      y[c][i] = acc;
    }
  }

  // stores: the span's first `step` words that are in the row
  float* dst = a.out + row + w0 + 4 * lane;
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
    if (128 * c + 4 * lane >= a.step) continue;
    if (a.vec) {
      if (128 * c < left) {
        *reinterpret_cast<float4*>(dst + 128 * c) = make_float4(y[c][0], y[c][1], y[c][2], y[c][3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (128 * c + i < left) dst[128 * c + i] = y[c][i];
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// A launch's arguments but the stages' taps and constants; the 16-byte path
// where every row starts 16-byte aligned.
inline SpanArgs span_args(const void* in, void* out, long long words, const float* taps_host,
                          int ntaps, const int* stage_n, int nstages) {
  SpanArgs a{};
  a.in = static_cast<const uint32_t*>(in);
  a.out = static_cast<float*>(out);
  a.words = words;
  a.step = span_step(ntaps, stage_n, nstages);
  a.spans = static_cast<int>((words + a.step - 1) / a.step);
  a.vec = words % 4 == 0 && aligned16(in) && aligned16(out);
  a.taps = make_taps(taps_host, ntaps);
  for (int s = 0; s < nstages; ++s) a.st.n[s] = stage_n[s];
  return a;
}

// The launch grid of rows of spans: (ceil(spans / kWarps), blocks).
inline dim3 span_grid(long long blocks, int spans) {
  return dim3(static_cast<unsigned>((spans + kWarps - 1) / kWarps), static_cast<unsigned>(blocks));
}

}  // namespace nbfm
