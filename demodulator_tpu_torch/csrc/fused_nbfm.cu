// Fused NBFM block kernel for Hopper (sm_90a), and its memory-traffic floor.
//
// fused_nbfm replaces the Pallas TPU kernel fused_nbfm_u32_3d
// (demodulator_tpu/ops/pallas/fused_nbfm.py:214, body _kernel :142 with
// _atan2_fast_recip :48 and _audio_fir :187).  Per IQ block of n raw bytes
// it computes n/4 audio samples in one pass:
//
//   4 bytes (I0, Q0, I1, Q1) -> shiftOrigin ((b+1)&255)-128 or normalize
//   b*f32(2/255)-1 -> conjugate product zr = ac+bd, zj = bc-ad -> polynomial
//   atan2 (precise: IEEE division + 9 terms; fast: rcp.approx + one Newton
//   step + 6 terms) -> NaN to 0 -> stationary anti-causal audio FIR
//   y[q] = sum_d taps[d]*x[q+d], zero past the end of the block.
//
// The caller overwrites the first H outputs of each block with the float64
// head rows (models/nbfm.py, BlockPipeline._fused_plain).
//
// What bounds it: 4 bytes are read and 4 bytes written per output against
// some 45 float32 operations, below the card's operations-per-byte balance,
// so the bound is device-memory bandwidth; but the instructions per word
// (the division, the polynomial) are close to it.  The kernel is K3's span
// body with no stage (nbfm_span.cuh): 16-byte loads and stores per lane,
// conditioning by byte permutes, the discriminator and the FIR in
// registers with the FIR's look-ahead by warp shuffles, no shared memory.
// Audio taps 2 and 3 (D = 1, 2: the CLI's filters) are compiled in; any
// other count up to kMaxTaps runs the same body with the count read at run
// time.  dma_floor has the same loads and stores with almost no arithmetic:
// it is the measured floor fused_nbfm is reported against.  It replaces
// dma_floor_u32_3d (demodulator_tpu/ops/pallas/fused_nbfm.py:304).

#include "nbfm_span.cuh"

namespace {

using namespace nbfm;

template <int kT, bool kPrecise, bool kNormalize>
__global__ void __launch_bounds__(kThreads) fused_nbfm_kernel(SpanArgs a) {
  nbfm_span<kT, 0, 0, 0, kPrecise, kNormalize>(a);
}

template <int kT>
void launch(const SpanArgs& a, dim3 grid, int precise, int normalize, cudaStream_t s) {
  if (precise) {
    if (normalize) fused_nbfm_kernel<kT, true, true><<<grid, kThreads, 0, s>>>(a);
    else fused_nbfm_kernel<kT, true, false><<<grid, kThreads, 0, s>>>(a);
  } else {
    if (normalize) fused_nbfm_kernel<kT, false, true><<<grid, kThreads, 0, s>>>(a);
    else fused_nbfm_kernel<kT, false, false><<<grid, kThreads, 0, s>>>(a);
  }
}

// grid ceil(total / (kThreads * 4 * kVecs)); lane l of a warp takes words
// 128c + 4l .. +3 of the warp's 128 * kVecs, as fused_nbfm's lanes do.
__global__ void __launch_bounds__(kThreads)
dma_floor_kernel(const uint32_t* __restrict__ in, float* __restrict__ out, long long total,
                 int vec) {
  const long long base = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
                             kSpanWords + 4 * (threadIdx.x & 31);
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
    const long long i = base + 128 * c;
    if (vec && i + 4 <= total) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(in + i));
      const uint32_t v[4] = {w.x, w.y, w.z, w.w};
      float f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[k] = static_cast<float>((v[k] & 255u) + ((v[k] >> 8) & 255u) + ((v[k] >> 16) & 255u) +
                                  (v[k] >> 24));
      }
      *reinterpret_cast<float4*>(out + i) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
      for (long long j = i; j < i + 4 && j < total; ++j) {
        const uint32_t v = __ldg(in + j);
        out[j] = static_cast<float>((v & 255u) + ((v >> 8) & 255u) + ((v >> 16) & 255u) + (v >> 24));
      }
    }
  }
}

}  // namespace

// C entry points (loaded with ctypes by ops/cuda/build.py).  Each launches on
// `stream`, does not synchronise, and returns cudaGetLastError().

extern "C" int fused_nbfm_launch(const void* in, void* out, long long blocks,
                                 long long words, const float* taps_host,
                                 int ntaps, int precise, int normalize,
                                 void* stream) {
  if (blocks < 1 || blocks > 65535 || words < 1 || ntaps < 1 ||
      ntaps > kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SpanArgs a = span_args(in, out, words, taps_host, ntaps, nullptr, 0);
  const dim3 grid = span_grid(blocks, a.spans);
  auto s = static_cast<cudaStream_t>(stream);
  if (ntaps == 2) launch<2>(a, grid, precise, normalize, s);
  else if (ntaps == 3) launch<3>(a, grid, precise, normalize, s);
  else launch<0>(a, grid, precise, normalize, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dma_floor_launch(const void* in, void* out, long long total,
                                void* stream) {
  if (total < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_cta = static_cast<long long>(kThreads) * 4 * kVecs;
  const unsigned grid = static_cast<unsigned>((total + per_cta - 1) / per_cta);
  dma_floor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<float*>(out), total,
      aligned16(in) && aligned16(out));
  return static_cast<int>(cudaGetLastError());
}
