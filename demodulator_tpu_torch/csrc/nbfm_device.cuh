// Device helpers shared by the fused NBFM kernels (fused_nbfm.cu,
// fused_nbfm_cplx.cu, fused_nbfm_q1.cu, fused_pfb.cu): conditioning and the
// polynomial atan2 discriminator.
//
// Arithmetic is written with explicit round-to-nearest intrinsics so that
// nvcc contracts nothing into FMAs: every operation rounds where the plain
// PyTorch versions (ops/cuda/fused_nbfm.py) round, in the same order.  Build
// without --use_fast_math and without -prec-div=false.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nbfm {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 32;      // ops/cuda/fused_nbfm.py MAX_TAPS
constexpr int kMaxCplxTaps = 32;  // ops/cuda/fused_nbfm.py MAX_CPLX_TAPS

struct Taps {
  float t[kMaxTaps];
  int n;
};

// float32 roundings of pi/2, pi and 2/255 (ops/demod.py, ops/conditioning.py)
constexpr float kHalfPi = 0x1.921fb6p+0f;
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kNormScale = 0x1.010102p-7f;

// Horner evaluation of the atan correction polynomial in u = z*z.  The
// coefficients are the float32 roundings of ops/demod.py _ATAN_COEFFS
// (precise) and _ATAN_COEFFS_FAST (fast); tests/test_torch_fused_nbfm.py
// holds these literals to the Python tuples.
template <bool kPrecise>
__device__ __forceinline__ float atan_poly(float u) {
  if constexpr (kPrecise) {
    const float kAtanPrecise[9] = {
        -0x1.555554p-2f, 0x1.99986p-3f,  -0x1.246faep-3f,
        0x1.c41de8p-4f,  -0x1.634146p-4f, 0x1.016938p-4f,
        -0x1.29220ep-5f, 0x1.c29648p-7f,  -0x1.40c102p-9f};
    float p = kAtanPrecise[8];
#pragma unroll
    for (int i = 7; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, u), kAtanPrecise[i]);
    return p;
  } else {
    const float kAtanFast[6] = {
        -0x1.554c32p-2f, 0x1.97595ap-3f,  -0x1.12a754p-3f,
        0x1.4a38f2p-4f,  -0x1.0d1316p-5f, 0x1.9193aep-8f};
    float p = kAtanFast[5];
#pragma unroll
    for (int i = 4; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, u), kAtanFast[i]);
    return p;
  }
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// atan2(y, x) by octant reduction.  The signbit fixups keep the order
// ay > ax, signbit(x), signbit(y): atan2(+-0, -0) = +-pi as C99 atan2f.
template <bool kPrecise>
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  float hi = fmaxf(ax, ay);
  const float lo = fminf(ax, ay);
  hi = (hi == 0.0f) ? 1.0f : hi;
  float z;
  if constexpr (kPrecise) {
    z = __fdiv_rn(lo, hi);
  } else {
    float r = rcp_approx(hi);
    r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(hi, r)));  // one Newton step
    z = __fmul_rn(lo, r);
  }
  const float z2 = __fmul_rn(z, z);
  float at = __fadd_rn(z, __fmul_rn(__fmul_rn(z, z2), atan_poly<kPrecise>(z2)));
  if (ay > ax) at = __fsub_rn(kHalfPi, at);
  if (__float_as_uint(x) >> 31) at = __fsub_rn(kPi, at);  // signbit(x)
  if (__float_as_uint(y) >> 31) at = -at;                 // signbit(y)
  return at;
}

// The conditioning of ops/conditioning.py without an int-to-float conversion.
// A byte b placed under the bits of 2^23 is the float 2^23 + b, so
// shiftOrigin's ((b + 1) & 255) - 128 is that float less 2^23 + 128 (with b
// already incremented mod 256), and normalize's float(b) is it less 2^23,
// both exact; normalize then rounds b * f32(2/255) and the - 1 as the plain
// version does.  The byte permute puts byte k of w (k = 0..3) in the low
// byte of 0x4B000000.
template <bool kNormalize>
__device__ __forceinline__ float condition_byte(uint32_t w, uint32_t k) {
  const float f = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + k));
  if constexpr (kNormalize) {
    return __fsub_rn(__fmul_rn(__fsub_rn(f, 8388608.0f), kNormScale), 1.0f);
  } else {
    return __fsub_rn(f, 8388736.0f);
  }
}

// The four bytes of w conditioned, byte 0 first.  shiftOrigin increments
// every byte mod 256 at once (no carry crosses a byte) before the permutes.
template <bool kNormalize>
__device__ __forceinline__ float4 condition_word(uint32_t w) {
  if constexpr (!kNormalize) w = ((w & 0x7f7f7f7fu) + 0x01010101u) ^ (w & 0x80808080u);
  return make_float4(condition_byte<kNormalize>(w, 0), condition_byte<kNormalize>(w, 1),
                     condition_byte<kNormalize>(w, 2), condition_byte<kNormalize>(w, 3));
}

// Two conditioned complex samples (a + bi, c + di) -> one discriminator
// sample: atan2 of the conjugate product, NaN to 0.
template <bool kPrecise>
__device__ __forceinline__ float demod_pairs(float a, float b, float c, float d) {
  const float zr = __fadd_rn(__fmul_rn(a, c), __fmul_rn(b, d));
  const float zj = __fsub_rn(__fmul_rn(b, c), __fmul_rn(a, d));
  const float x = atan2_poly<kPrecise>(zj, zr);
  return isnan(x) ? 0.0f : x;
}

inline Taps make_taps(const float* host, int n) {
  Taps taps{};
  for (int i = 0; i < n; ++i) taps.t[i] = host[i];
  taps.n = n;
  return taps;
}

}  // namespace nbfm
