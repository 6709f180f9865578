// Device helpers shared by K6's two sources (fused_pfb.cu and
// fused_pfb_cluster.cu): complex products, the bit reversal of a radix-2
// network and the compiled-in stages' factors w_N^m as constants (the
// float64 FFT), a conditioned sample of the input or the history, a shared
// memory address, and a 16-byte asynchronous copy into shared memory.  Every name has internal linkage: one copy a
// translation unit, no symbol shared at link time.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "nbfm_device.cuh"

namespace {

__host__ __device__ constexpr bool is_radix(int n) {
  return n == 2 || n == 4 || n == 8 || n == 16;
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

// e^{+j 2 pi m / n} for n = 16, 3 and 5: numpy's cos and sin of 2 pi m / n,
// the table's entries m*C/n (tests/test_torch_kernel_plans.py)
__constant__ double2 kW16[16] = {
    {0x1.0000000000000p+0, 0x0.0p+0},
    {0x1.d906bcf328d46p-1, 0x1.87de2a6aea963p-2},
    {0x1.6a09e667f3bcdp-1, 0x1.6a09e667f3bccp-1},
    {0x1.87de2a6aea964p-2, 0x1.d906bcf328d46p-1},
    {0x1.1a62633145c07p-54, 0x1.0000000000000p+0},
    {-0x1.87de2a6aea962p-2, 0x1.d906bcf328d46p-1},
    {-0x1.6a09e667f3bccp-1, 0x1.6a09e667f3bcdp-1},
    {-0x1.d906bcf328d46p-1, 0x1.87de2a6aea965p-2},
    {-0x1.0000000000000p+0, 0x1.1a62633145c07p-53},
    {-0x1.d906bcf328d47p-1, -0x1.87de2a6aea961p-2},
    {-0x1.6a09e667f3bcep-1, -0x1.6a09e667f3bccp-1},
    {-0x1.87de2a6aea96dp-2, -0x1.d906bcf328d44p-1},
    {-0x1.a79394c9e8a0ap-53, -0x1.0000000000000p+0},
    {0x1.87de2a6aea967p-2, -0x1.d906bcf328d45p-1},
    {0x1.6a09e667f3bcbp-1, -0x1.6a09e667f3bcep-1},
    {0x1.d906bcf328d44p-1, -0x1.87de2a6aea96ep-2}};
__constant__ double2 kW3[3] = {{0x1.0000000000000p+0, 0x0.0p+0},
                               {-0x1.ffffffffffffcp-2, 0x1.bb67ae8584cabp-1},
                               {-0x1.0000000000004p-1, -0x1.bb67ae8584ca8p-1}};
__constant__ double2 kW5[5] = {{0x1.0000000000000p+0, 0x0.0p+0},
                               {0x1.3c6ef372fe950p-2, 0x1.e6f0e134454ffp-1},
                               {-0x1.9e3779b97f4a7p-1, 0x1.2cf2304755a5fp-1},
                               {-0x1.9e3779b97f4a9p-1, -0x1.2cf2304755a5dp-1},
                               {0x1.3c6ef372fe94cp-2, -0x1.e6f0e13445500p-1}};

// w_N^m, N a radix size, 3 or 5
template <int N>
__device__ __forceinline__ double2 wconst(int m) {
  static_assert(N == 3 || N == 5 || (is_radix(N)),
                "a compiled-in stage is 2, 3, 4, 5, 8 or 16 points");
  if constexpr (N == 3) {
    return kW3[m];
  } else if constexpr (N == 5) {
    return kW5[m];
  } else {
    return kW16[m * (16 / N)];
  }
}

// fft_pass with the constant factors
template <int N, int LEN>
__device__ __forceinline__ void wide_pass(double2 (&v)[N]) {
#pragma unroll
  for (int j = 0; j < LEN / 2; ++j) {
    const double2 w = wconst<LEN>(j);
#pragma unroll
    for (int i = 0; i < N; i += LEN) {
      const double2 a = v[i + j];
      const double2 c = v[i + j + LEN / 2];
      const double2 b = j == 0 ? c : (4 * j == LEN ? make_double2(-c.y, c.x) : cmul(c, w));
      v[i + j] = make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
      v[i + j + LEN / 2] = make_double2(__dsub_rn(a.x, b.x), __dsub_rn(a.y, b.y));
    }
  }
  if constexpr (LEN < N) wide_pass<N, 2 * LEN>(v);
}

// The N-point DFT of v in place, natural order in and out: v[k] = sum_c v[c]
// w_N^(k c).  A radix size is the butterfly network, 3 the direct sum.
template <int N>
__device__ __forceinline__ void wide_fft(double2 (&v)[N]) {
  if constexpr (is_radix(N)) {
    double2 a[N];
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = v[bitrev<N>(i)];
    wide_pass<N, 2>(a);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = a[i];
  } else {
    double2 y[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      double2 acc = make_double2(0.0, 0.0);
#pragma unroll
      for (int c = 0; c < N; ++c) acc = cmac(acc, v[c], wconst<N>((k * c) % N));
      y[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = y[k];
  }
}

// Conditioned sample s of the launch: from the history where s < 0
__device__ __forceinline__ float2 big_sample(const uint16_t* __restrict__ in,
                                             const float* __restrict__ hist, int PC,
                                             long long s) {
  if (s < 0) return make_float2(hist[PC + s], hist[2 * PC + s]);
  const float4 c = nbfm::condition_word<false>(__ldg(in + s));  // bytes 2, 3 unused
  return make_float2(c.x, c.y);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src into shared dst, asynchronously (cp.async,
// through L2 only; cp.async.commit_group and wait_all complete it)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ float2 wide_cond(uint32_t w) {
  const float4 c = nbfm::condition_word<false>(w);  // bytes 2, 3 unused
  return make_float2(c.x, c.y);
}

}  // namespace
