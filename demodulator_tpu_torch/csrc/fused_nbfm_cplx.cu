// Fused NBFM kernel with one or two complex FIR stages (K3), for Hopper
// (sm_90a).
//
// fused_nbfm_cplx replaces the Pallas TPU kernel fused_nbfm_cplx_u32_3d
// (demodulator_tpu/ops/pallas/fused_nbfm.py:253, pallas_call :269, body
// _kernel :142 with _cplx_fir_lanes :102 and _roll_left :84) and its
// one-stage wrapper fused_nbfm_inlpf_u32_3d (:283).  Per IQ block it runs
//
//   condition -> [complex stage]x1|2 -> discriminator -> audio FIR
//
// where a stage is the stationary interior of the reference's
// applyComplexFilter, z'_s = c + sum_k t[k]*z_{s+k} over complex samples s,
// with the constant c = (c_i, c_q) per lane.  Each stage's INPUT is zero past
// the block's end (the TPU kernel's _roll_left zero fill), so a second stage
// reads zeros there, not c.  The sum starts from c and adds the taps in
// order k = 0..Dc, as the TPU kernel does; the plain version
// (ops/cuda/fused_nbfm.py, fused_nbfm_cplx_ref) sums in the same order.
// One stage serves -L and -q 2, two serve -q 2 -L (DC block, then the input
// lowpass).  The caller patches the head and tail rows in float64
// (models/nbfm.py, BlockPipeline._fused_inlpf / _fused_q2l) with P3 or P4,
// launched as programmatic dependents of this kernel, which triggers them
// at entry; K1 (the same body, fused_nbfm.cu) does not.
//
// What bounds it: the bytes are K1's (fused_nbfm.cu), 4 in and 4 out per
// output, and a stage adds only 8 * (Dc + 1) multiplies and adds per word
// (Dc is 1 or 2 for the reference's filters).  On the card a word is two
// complex samples, so a stage is plain indexing: the TPU's sub-lattice lane
// rolls are gone.  The body is nbfm_span.cuh: each lane keeps its 8
// conditioned samples per chunk in registers through the stages, the
// discriminator and the FIR, and takes each stage's n - 1 samples of
// look-ahead from the next lane by warp shuffles, so nothing is staged in
// shared memory and there is no barrier.  The CLI's counts are
// compiled in: audio taps 2 and 3, and one or two stages of 2 or 3 taps;
// any other count up to kMaxTaps / kMaxCplxTaps runs the same body with the
// counts read at run time.

#include "nbfm_span.cuh"

namespace {

using namespace nbfm;

template <int kT, int kNS, int kS0, int kS1, bool kPrecise, bool kNormalize>
__global__ void __launch_bounds__(kThreads) fused_nbfm_cplx_kernel(SpanArgs a) {
  // Let the float64 patch launched after it (P3 or P4, nbfm_patch.cu, a
  // programmatic dependent) start now: it reads only the raw bytes and
  // its constants until its griddepcontrol.wait, which waits for this
  // grid's completion before it stores into the output.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  nbfm_span<kT, kNS, kS0, kS1, kPrecise, kNormalize>(a);
}

template <int kT, int kNS, int kS0, int kS1>
void launch(const SpanArgs& a, dim3 grid, int precise, int normalize, cudaStream_t s) {
  if (precise) {
    if (normalize) fused_nbfm_cplx_kernel<kT, kNS, kS0, kS1, true, true><<<grid, kThreads, 0, s>>>(a);
    else fused_nbfm_cplx_kernel<kT, kNS, kS0, kS1, true, false><<<grid, kThreads, 0, s>>>(a);
  } else {
    if (normalize) fused_nbfm_cplx_kernel<kT, kNS, kS0, kS1, false, true><<<grid, kThreads, 0, s>>>(a);
    else fused_nbfm_cplx_kernel<kT, kNS, kS0, kS1, false, false><<<grid, kThreads, 0, s>>>(a);
  }
}

}  // namespace

// C entry point (loaded with ctypes by ops/cuda/build.py): stage_taps is
// [2][kMaxCplxTaps] row-major, stage_c [2][2]; launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
extern "C" int fused_nbfm_cplx_launch(const void* in, void* out,
                                      long long blocks, long long words,
                                      const float* taps_host, int ntaps,
                                      const float* stage_taps,
                                      const int* stage_n, const float* stage_c,
                                      int nstages, int precise, int normalize,
                                      void* stream) {
  if (blocks < 1 || blocks > 65535 || words < 1 || ntaps < 1 ||
      ntaps > kMaxTaps || nstages < 1 || nstages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < nstages; ++s) {
    if (stage_n[s] < 1 || stage_n[s] > kMaxCplxTaps) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  SpanArgs a = span_args(in, out, words, taps_host, ntaps, stage_n, nstages);
  for (int s = 0; s < nstages; ++s) {
    for (int k = 0; k < stage_n[s]; ++k) a.st.t[s][k] = stage_taps[s * kMaxCplxTaps + k];
    a.st.c[s][0] = stage_c[2 * s];
    a.st.c[s][1] = stage_c[2 * s + 1];
  }
  const dim3 grid = span_grid(blocks, a.spans);
  auto s = static_cast<cudaStream_t>(stream);
  // the CLI's counts (2 or 3 each) compiled in, keyed T S0 S1 (S1 = 0: one
  // stage); any other count read at run time
  auto small = [](int n) { return n == 2 || n == 3; };
  const int s1 = nstages == 2 ? stage_n[1] : 0;
  const int key = small(ntaps) && small(stage_n[0]) && (nstages == 1 || small(s1))
                      ? 100 * ntaps + 10 * stage_n[0] + s1
                      : 0;
  switch (key) {
#define CPLX_FIXED(T, S0, S1)                                         \
  case 100 * T + 10 * S0 + S1:                                        \
    launch<T, (S1 ? 2 : 1), S0, S1>(a, grid, precise, normalize, s);    \
    break;
    CPLX_FIXED(2, 2, 0) CPLX_FIXED(2, 3, 0) CPLX_FIXED(3, 2, 0) CPLX_FIXED(3, 3, 0)
    CPLX_FIXED(2, 2, 2) CPLX_FIXED(2, 2, 3) CPLX_FIXED(2, 3, 2) CPLX_FIXED(2, 3, 3)
    CPLX_FIXED(3, 2, 2) CPLX_FIXED(3, 2, 3) CPLX_FIXED(3, 3, 2) CPLX_FIXED(3, 3, 3)
#undef CPLX_FIXED
    default:
      if (nstages == 1) launch<0, 1, 0, 0>(a, grid, precise, normalize, s);
      else launch<0, 2, 0, 0>(a, grid, precise, normalize, s);
  }
  return static_cast<int>(cudaGetLastError());
}
