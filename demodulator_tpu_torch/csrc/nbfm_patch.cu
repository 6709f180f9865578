// The NBFM step's float64 patches (P1-P4), for Hopper (sm_90a).
//
// K1, K3 and K4 compute stationary rows everywhere in a block; the rows the
// reference's zero-state filters compute otherwise (the head, the -q 2 -L
// tail, the couplings of a stage's arena overrun) are patched in float64.
// The JAX package has no Pallas kernel for them: each path's patch sits in
// the jitted program beside its pallas_call, and XLA fuses it into a few
// fusions.  Here each path's patch is one launch after its main kernel on
// the same stream, in place of the 20-174 torch ops of its plain version
// (ops/cuda/nbfm_patch.py, the *_ref functions, which these kernels follow
// operation for operation):
//
//   P1 patch_fused_kernel   K1 (q0, q3): demodulator_tpu/models/nbfm.py:159-168
//      (fused_call_u32_3d): condition the first Wh words, discriminator,
//      NaN -> 0, the [H, Wh] float64 head dot, the first H rows.
//   P2 patch_q1_kernel      K4 (-q 1): _q1_head_patch, nbfm.py:215-246: the
//      front and mirrored back Wh words -> 2Wh tracker steps, their prefix
//      from K4's entering offset (T, apow), condition, discriminator, head.
//   P3 patch_cplx1_kernel   K3, one stage (-L, -q 2): fused_call_inlpf_u32_3d,
//      nbfm.py:288-329: the stage's float64 head rows, discriminator, head
//      dot; with an audio coupling, the stage's overrun from the head and
//      tail windows and its float64 y_coup add on the first hy rows.
//   P4 patch_cplx2_kernel   K3, two stages (-q 2 -L): fused_call_q2l_u32_3d,
//      nbfm.py:385-486: the head through both stages with the dc overrun's
//      yc_head coupling, head dot and stationary rows to a_p; the tail
//      recomputed stationary through both stages with yc_tail; the tail
//      audio rows; the y_coup add from the in-stage overrun.
//
// Each writes rows of its main kernel's output in place (the port mutates
// where JAX used .at[].set), so it runs after that kernel; P2 also reads
// K4's entering offsets.
//
// What bounds them: latency.  A block reads its head and tail windows (tens
// of words) and a few KB of constants, and writes tens of rows: chains of
// dependent float64 dots, microseconds, nothing near the card's bytes or
// operations (the CLI's P4: 5.9 KB of constants, 100 bytes and ~2200
// float64 operations a block).
//
// P1 and P2: one CTA of kPatchThreads per block, the windows read straight
// from the raw bytes into shared memory sized from the geometry at launch,
// each phase a loop of the CTA's threads over its rows with a barrier
// between phases, the constants read from the filters' device buffers.
//
// P3 and P4 (after K3) are built for the latency:
//   - each is launched as a programmatic dependent of K3 (Hopper's
//     programmatic dependent launch): K3 triggers its dependents at entry
//     (fused_nbfm_cplx.cu), so the patch's CTAs start while K3 runs and do
//     everything that reads only the raw bytes and the constants (the
//     windows, both stages, the overruns and couplings, the discriminator,
//     the rows it writes) before griddepcontrol.wait; after the wait come
//     only the stores into K3's output and P3's read-modify-write of K3's
//     rows [H, hy);
//   - their constants are one contiguous buffer per path, packed once on
//     the filters' device when the pipeline is built (ops/cuda/nbfm_patch.py
//     packed_consts; the layout is checked here, ConstPack), staged into
//     shared memory by one bulk asynchronous copy (cp.async.bulk, completing
//     on an mbarrier) issued at entry, which overlaps the conditioning of
//     the windows; every dot then reads shared memory;
//   - each dependency chain is one warp, not the whole CTA: P4's head chain
//     (y1h -> y2h -> dh -> the head rows), tail chain (y1t -> y2t -> dt ->
//     the tail rows) and overrun chain (dc_over -> add_t -> in_over -> the
//     coupling); P3's head chain and overrun chain.  A warp's phases are
//     separated by __syncwarp; where two chains meet, a named barrier
//     (bar.arrive by the producer warp, bar.sync by the consumer):
//     dc_over into y2h, add_t into y2t, y1h and y1t into in_over.  The
//     chains join once, for the stores.
// The struct pointers P3 and P4 receive point into the pack, in its order;
// the kernel reads each at the same offset in shared memory.
//
// Arithmetic: every float32 operation is an explicit __f*_rn intrinsic in
// the plain version's order (nvcc contracts nothing into FMAs), so the
// float32 parts round where torch rounds.  The discriminator is the plain
// version's, not nbfm_device.cuh's kernel one: precise is atan2f
// (torch.atan2), fast the 6-term polynomial with an exact division (the
// JAX atan2_fast).  The float64 dots (head, c_head, tail, y_coup, yc_*, the
// -q 1 prefix T) are fused multiply-adds in index order, each dot in one
// thread; torch.einsum on the card sums in cuBLAS's order, so a dot may
// differ from it in the last float64 bit, which moves the float32 row it
// rounds to by an ULP at most once in ~2^29 rows: the kernels are held to
// their plain versions equal, or within 2 float32 ULP and > 140 dB where a
// dot differs (chip_smoke.py phase 3).

#include "nbfm_device.cuh"

namespace {

using namespace nbfm;

constexpr int kPatchThreads = 128;   // P1, P2
constexpr int kCplx1Threads = 64;    // P3: the head warp, the overrun warp
constexpr int kCplx2Threads = 96;    // P4: the head, tail and overrun warps
// ops/cuda/nbfm_patch.py MAX_SMEM: a block's opt-in maximum on Hopper.
// P3's and P4's launches raise their kernel's limit above the default 48
// KiB (the pack of -d 20 -q 2 -L needs it); P1's and P2's windows stay far
// below it.
constexpr size_t kMaxPatchSmem = 227 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kBarBytes = 16;        // P3, P4: the mbarrier, padded to 16

}  // namespace

// The filters as the device holds them (ops/fir_apply.py); the Python side
// (ops/cuda/nbfm_patch.py) mirrors these layouts with ctypes.
struct PatchAudioFir {     // RealFir
  const float* taps;       // [ntaps] float32
  const double* head;      // [H, Wh]
  const double* y_coup;    // [hy, ky], or null with hy = 0
  int ntaps, H, Wh, hy, ky;
};

struct PatchStage {        // CplxFir
  const float* taps;       // [ntaps] float32
  const float* c_int;      // [2] float32
  const double* head;      // [Hc, Whc]
  const double* c_head;    // [Hc, 2]
  const double* tail;      // [Kc, Wtc]
  const double* tail_alias;  // [Kc, Whc]
  const double* c_tail;    // [Kc, 2]
  const double* yc_head;   // [hp, 2, ky], or null with hp = 0
  const double* yc_tail;   // [tp, 2, ky], or null with tp = 0
  int ntaps, Hc, Whc, Kc, Wtc, hp, tp, ky;
};

// The windows of the two-stage patch (ops/cuda/nbfm_patch.py q2l_geometry).
struct PatchQ2lGeometry {
  int n_pairs, a_p, nd, m1, w1_words, hy, tc2, at, pt, m1t, wt_words, hp2;
};

namespace {

// A bump allocator over the dynamic shared memory, each array rounded up to
// 16 bytes; the launch functions (and ops/cuda/nbfm_patch.py smem_bytes)
// count the same way on the host.
struct Arena {
  char* p;
  template <class T>
  __device__ T* take(int n) {
    T* r = reinterpret_cast<T*>(p);
    p += (static_cast<size_t>(n) * sizeof(T) + 15) / 16 * 16;
    return r;
  }
};

inline size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// -- P3, P4: the constants' bulk copy, the chains' barriers, the launch edge

// One thread: initialise the mbarrier `bar` for one arrival and `bytes` of
// transactions, and copy [src, src + bytes) of global memory to `dst` in
// shared memory by one bulk asynchronous copy completing on it (src, dst
// and bytes multiples of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(d), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Wait for the bulk copy's phase (0) of `bar` to complete.
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

// Named barriers between chains: the producer warp arrives, the consumer
// syncs; `n` counts the threads of every warp taking part.
__device__ __forceinline__ void chain_arrive(int id, int n) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void chain_sync(int id, int n) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Wait until the grid this one depends on (K3) has completed and its
// stores are visible: every store into `audio` comes after it.
__device__ __forceinline__ void wait_main_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A pointer into the pack at `pack` → the same offset in `consts` (shared
// memory); null stays null.
template <class T>
__device__ __forceinline__ const T* in_consts(const T* p, const char* pack, const char* consts) {
  return p ? reinterpret_cast<const T*>(consts + (reinterpret_cast<const char*>(p) - pack))
           : nullptr;
}

__device__ PatchAudioFir in_consts(PatchAudioFir f, const char* pack, const char* c) {
  f.taps = in_consts(f.taps, pack, c);
  f.head = in_consts(f.head, pack, c);
  f.y_coup = in_consts(f.y_coup, pack, c);
  return f;
}

__device__ PatchStage in_consts(PatchStage s, const char* pack, const char* c) {
  s.taps = in_consts(s.taps, pack, c);
  s.c_int = in_consts(s.c_int, pack, c);
  s.head = in_consts(s.head, pack, c);
  s.c_head = in_consts(s.c_head, pack, c);
  s.tail = in_consts(s.tail, pack, c);
  s.tail_alias = in_consts(s.tail_alias, pack, c);
  s.c_tail = in_consts(s.c_tail, pack, c);
  s.yc_head = in_consts(s.yc_head, pack, c);
  s.yc_tail = in_consts(s.yc_tail, pack, c);
  return s;
}

// JAX's atan2_fast (ops/demod.py atan2_fast): octant reduction, z = lo / hi
// by IEEE division, the 6-term polynomial; fixups in the kernel order.
__device__ __forceinline__ float atan2_fast_div(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  float hi = fmaxf(ax, ay);
  const float lo = fminf(ax, ay);
  hi = (hi == 0.0f) ? 1.0f : hi;
  const float z = __fdiv_rn(lo, hi);
  const float z2 = __fmul_rn(z, z);
  float at = __fadd_rn(z, __fmul_rn(__fmul_rn(z, z2), atan_poly<false>(z2)));
  if (ay > ax) at = __fsub_rn(kHalfPi, at);
  if (__float_as_uint(x) >> 31) at = __fsub_rn(kPi, at);
  if (__float_as_uint(y) >> 31) at = -at;
  return at;
}

// ops/demod.py fm_demod on one pair of pairs (a + bi, c + di).
template <bool kPrecise>
__device__ __forceinline__ float demod4(const float* q) {
  const float a = q[0], b = q[1], c = q[2], d = q[3];
  const float zr = __fadd_rn(__fmul_rn(a, c), __fmul_rn(b, d));
  const float zj = __fsub_rn(__fmul_rn(b, c), __fmul_rn(a, d));
  const float x = kPrecise ? atan2f(zj, zr) : atan2_fast_div(zj, zr);
  return isnan(x) ? 0.0f : x;
}

// Words [w0, w0 + count) of a row conditioned into x[4 * count], byte k of
// word v at x[4v + k].
template <bool kNormalize>
__device__ void condition_words(const uint32_t* row, long long w0, int count, float* x) {
  for (int v = threadIdx.x; v < count; v += blockDim.x) {
    const float4 f = condition_word<kNormalize>(__ldg(row + w0 + v));
    x[4 * v] = f.x;
    x[4 * v + 1] = f.y;
    x[4 * v + 2] = f.z;
    x[4 * v + 3] = f.w;
  }
}

// RealFir.head_only row h: the float64 head dot of x[0..Wh), rounded.
__device__ __forceinline__ float head_row(const PatchAudioFir& f, const float* x, int h) {
  const double* m = f.head + static_cast<long long>(h) * f.Wh;
  double acc = 0.0;
  for (int w = 0; w < f.Wh; ++w) acc = __fma_rn(m[w], static_cast<double>(x[w]), acc);
  return __double2float_rn(acc);
}

// The helpers below serve P3 and P4 only.  Their loops are unrolled by 2,
// not by the compiler's default (16 in the dots' loops): with a
// dot's terms in one dependent chain the longer unroll only lengthens the
// code each warp runs once, and measured slower for P4 on the H100.

// The float64 y_coup row h over an overrun of ky float32 values, rounded.
__device__ __forceinline__ float coup_row(const PatchAudioFir& f, const float* over, int h) {
  const double* m = f.y_coup + static_cast<long long>(h) * f.ky;
  double acc = 0.0;
  #pragma unroll 2
  for (int k = 0; k < f.ky; ++k) acc = __fma_rn(m[k], static_cast<double>(over[k]), acc);
  return __double2float_rn(acc);
}

// RealFir._stationary_rows row q: sum_d taps[d] * x[q + d], zero at and
// past n, accumulated in tap order.
__device__ __forceinline__ float audio_row(const PatchAudioFir& f, const float* x, int n, int q) {
  float y = __fmul_rn(f.taps[0], q < n ? x[q] : 0.0f);
  #pragma unroll 2
  for (int d = 1; d < f.ntaps; ++d) y = __fadd_rn(y, __fmul_rn(f.taps[d], q + d < n ? x[q + d] : 0.0f));
  return y;
}

// CplxFir._stationary at pair s, lane l, of pairs x[n][2] (zero at and past
// n): c_int + sum_d taps[d] * x[s + d], the constant added last.
__device__ __forceinline__ float stage_row(const PatchStage& st, const float* x, int n, int s,
                                           int l) {
  float y = __fmul_rn(st.taps[0], s < n ? x[2 * s + l] : 0.0f);
  #pragma unroll 2
  for (int d = 1; d < st.ntaps; ++d) {
    y = __fadd_rn(y, __fmul_rn(st.taps[d], s + d < n ? x[2 * (s + d) + l] : 0.0f));
  }
  return __fadd_rn(y, st.c_int[l]);
}

// CplxFir.pairs_head at pair s, lane l, of the head pairs x[n][2]: the
// float64 head rows below Hc, the stationary filter above.
__device__ __forceinline__ float stage_head(const PatchStage& st, const float* x, int n, int s,
                                            int l) {
  if (s >= st.Hc) return stage_row(st, x, n, s, l);
  const double* m = st.head + static_cast<long long>(s) * st.Whc;
  double acc = 0.0;
  #pragma unroll 2
  for (int w = 0; w < st.Whc; ++w) acc = __fma_rn(m[w], static_cast<double>(x[2 * w + l]), acc);
  return __double2float_rn(__dadd_rn(acc, st.c_head[2 * s + l]));
}

// CplxFir.over_only row k, lane l: the float64 tail dot of the last Wtc of
// the nt pairs xt plus the alias dot of the first Whc pairs xh, plus c_tail.
__device__ __forceinline__ float stage_over(const PatchStage& st, const float* xh,
                                            const float* xt, int nt, int k, int l) {
  const double* mt = st.tail + static_cast<long long>(k) * st.Wtc;
  const double* ma = st.tail_alias + static_cast<long long>(k) * st.Whc;
  const float* t0 = xt + 2 * (nt - st.Wtc);
  double s1 = 0.0, s2 = 0.0;
  #pragma unroll 2
  for (int w = 0; w < st.Wtc; ++w) s1 = __fma_rn(mt[w], static_cast<double>(t0[2 * w + l]), s1);
  #pragma unroll 2
  for (int w = 0; w < st.Whc; ++w) s2 = __fma_rn(ma[w], static_cast<double>(xh[2 * w + l]), s2);
  return __double2float_rn(__dadd_rn(__dadd_rn(s1, s2), st.c_tail[2 * k + l]));
}

// A stage's float64 coupling yc[p, l, :] over the ky float32 values of an
// earlier stage's overrun, rounded.
__device__ __forceinline__ float stage_coup(const double* yc, int ky, const float* over, int p,
                                            int l) {
  const double* m = yc + static_cast<long long>(2 * p + l) * ky;
  double acc = 0.0;
  #pragma unroll 2
  for (int k = 0; k < ky; ++k) acc = __fma_rn(m[k], static_cast<double>(over[k]), acc);
  return __double2float_rn(acc);
}

// P1: condition the first Wh words, discriminator, the H head rows.
template <bool kPrecise, bool kNormalize>
__global__ void __launch_bounds__(kPatchThreads)
patch_fused_kernel(const uint32_t* __restrict__ raw, float* __restrict__ audio, long long words,
                   PatchAudioFir out) {
  extern __shared__ double smem[];
  Arena arena{reinterpret_cast<char*>(smem)};
  float* x = arena.take<float>(4 * out.Wh);
  float* dh = arena.take<float>(out.Wh);
  const uint32_t* row = raw + static_cast<long long>(blockIdx.x) * words;
  float* arow = audio + static_cast<long long>(blockIdx.x) * words;
  condition_words<kNormalize>(row, 0, out.Wh, x);
  __syncthreads();
  for (int w = threadIdx.x; w < out.Wh; w += blockDim.x) dh[w] = demod4<kPrecise>(x + 4 * w);
  __syncthreads();
  for (int h = threadIdx.x; h < out.H; h += blockDim.x) arow[h] = head_row(out, dh, h);
}

// P2: the -q 1 head.  Step 2v takes front word v's first pair and back word
// (words - 1 - v)'s second, step 2v + 1 the other two; the offset entering
// step k is apow[k] * off + sum_{j<k} T[k, j] * s_j (float64), and the front
// pair of step k less it, rounded, is conditioned pair k.
template <bool kPrecise>
__global__ void __launch_bounds__(kPatchThreads)
patch_q1_kernel(const uint32_t* __restrict__ raw, float* __restrict__ audio, long long words,
                const float* __restrict__ offs_in, const double* __restrict__ T,
                const double* __restrict__ apow, double esr, PatchAudioFir out) {
  extern __shared__ double smem[];
  const int W = out.Wh, S = 2 * W;
  Arena arena{reinterpret_cast<char*>(smem)};
  double* s = arena.take<double>(2 * S);   // [S][2]
  float* x = arena.take<float>(4 * W);     // conditioned pairs [S][2]
  float* dh = arena.take<float>(W);
  const uint32_t* row = raw + static_cast<long long>(blockIdx.x) * words;
  float* arow = audio + static_cast<long long>(blockIdx.x) * words;
  for (int v = threadIdx.x; v < W; v += blockDim.x) {
    const uint32_t f = __ldg(row + v), b = __ldg(row + words - 1 - v);
    for (int l = 0; l < 2; ++l) {
      const double f0 = (f >> (8 * l)) & 255u, f1 = (f >> (8 * (2 + l))) & 255u;
      const double b0 = (b >> (8 * l)) & 255u, b1 = (b >> (8 * (2 + l))) & 255u;
      s[2 * (2 * v) + l] = __dmul_rn(__dadd_rn(f0, b1), esr);
      s[2 * (2 * v + 1) + l] = __dmul_rn(__dadd_rn(f1, b0), esr);
    }
  }
  __syncthreads();
  const double off[2] = {static_cast<double>(offs_in[2 * blockIdx.x]),
                         static_cast<double>(offs_in[2 * blockIdx.x + 1])};
  for (int i = threadIdx.x; i < 2 * S; i += blockDim.x) {
    const int k = i >> 1, l = i & 1;
    const double* t = T + static_cast<long long>(k) * S;
    double pref = 0.0;
    for (int j = 0; j < k; ++j) pref = __fma_rn(t[j], s[2 * j + l], pref);
    const double o = __dadd_rn(__dmul_rn(apow[k], off[l]), pref);
    const double byte = (__ldg(row + (i >> 2)) >> (8 * (i & 3))) & 255u;  // front byte 2k + l
    x[i] = __double2float_rn(__dsub_rn(byte, o));
  }
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x) dh[w] = demod4<kPrecise>(x + 4 * w);
  __syncthreads();
  for (int h = threadIdx.x; h < out.H; h += blockDim.x) arow[h] = head_row(out, dh, h);
}

// P3: one complex stage.  Warp 0 is the head chain (the stage's head
// pairs, the discriminator, the head rows), warp 1 the overrun chain (the
// stage's overrun, its coupling into the first hy rows).  Shared memory:
// the mbarrier, the pack, then the windows and chain values.
template <bool kPrecise, bool kNormalize>
__global__ void __launch_bounds__(kCplx1Threads)
patch_cplx1_kernel(const uint32_t* __restrict__ raw, float* __restrict__ audio, long long words,
                   PatchStage st_g, PatchAudioFir out_g, const char* __restrict__ pack,
                   unsigned pack_bytes, int n_pairs, int w1_words, int wt_words) {
  extern __shared__ __align__(16) unsigned char patch_smem[];
  auto* bar = reinterpret_cast<uint64_t*>(patch_smem);
  char* consts = reinterpret_cast<char*>(patch_smem) + kBarBytes;
  const int P = 2 * w1_words, Pt = 2 * wt_words, hy = out_g.hy, H = out_g.H;
  Arena arena{consts + pack_bytes};
  float* hp = arena.take<float>(2 * P);
  float* tp = arena.take<float>(hy ? 2 * Pt : 0);
  float* filt = arena.take<float>(2 * n_pairs);
  float* over = arena.take<float>(hy ? 2 * st_g.Kc : 0);
  float* dh = arena.take<float>(out_g.Wh);
  float* hv = arena.take<float>(H);        // the head rows
  float* cy = arena.take<float>(hy);       // y_coup . over
  const uint32_t* row = raw + static_cast<long long>(blockIdx.x) * words;
  float* arow = audio + static_cast<long long>(blockIdx.x) * words;
  if (threadIdx.x == 0) bulk_load(consts, pack, pack_bytes, bar);
  condition_words<kNormalize>(row, 0, w1_words, hp);
  if (hy) condition_words<kNormalize>(row, words - wt_words, wt_words, tp);
  __syncthreads();
  bulk_wait(bar);
  const PatchStage st = in_consts(st_g, pack, consts);
  const PatchAudioFir out = in_consts(out_g, pack, consts);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    for (int i = lane; i < 2 * n_pairs; i += 32) filt[i] = stage_head(st, hp, P, i >> 1, i & 1);
    __syncwarp();
    for (int w = lane; w < out.Wh; w += 32) dh[w] = demod4<kPrecise>(filt + 4 * w);
    __syncwarp();
    for (int h = lane; h < H; h += 32) hv[h] = head_row(out, dh, h);
  } else if (hy) {
    for (int i = lane; i < 2 * st.Kc; i += 32) over[i] = stage_over(st, hp, tp, Pt, i >> 1, i & 1);
    __syncwarp();
    for (int h = lane; h < hy; h += 32) cy[h] = coup_row(out, over, h);
  }
  __syncthreads();
  wait_main_kernel();
  // audio[:H] = head; then audio[:hy] += y_coup . over (K3's rows past H)
  const int rows = H > hy ? H : hy;
  for (int h = threadIdx.x; h < rows; h += blockDim.x) {
    float y = h < H ? hv[h] : arow[h];
    if (h < hy) y = __fadd_rn(y, cy[h]);
    arow[h] = y;
  }
}

// P4: two complex stages (dc block, then the input lowpass).  Warp 0 is the
// head chain, warp 1 the tail chain, warp 2 the overrun chain; named
// barriers 1 (dc_over -> y2h), 2 (add_t -> y2t) and 3 (y1h, y1t ->
// in_over) join them where one reads another's values.
template <bool kPrecise, bool kNormalize>
__global__ void __launch_bounds__(kCplx2Threads)
patch_cplx2_kernel(const uint32_t* __restrict__ raw, float* __restrict__ audio, long long words,
                   PatchStage dc_g, PatchStage in_g, PatchAudioFir out_g,
                   const char* __restrict__ pack, unsigned pack_bytes, PatchQ2lGeometry g) {
  extern __shared__ __align__(16) unsigned char patch_smem[];
  auto* bar = reinterpret_cast<uint64_t*>(patch_smem);
  char* consts = reinterpret_cast<char*>(patch_smem) + kBarBytes;
  const int P = 2 * g.w1_words, Pt = 2 * g.wt_words;
  Arena arena{consts + pack_bytes};
  float* hp = arena.take<float>(2 * P);             // conditioned head pairs
  float* tp = arena.take<float>(2 * Pt);            // conditioned tail pairs
  float* dc_over = arena.take<float>(2 * dc_g.Kc);
  float* y1h = arena.take<float>(2 * g.m1);         // dc stage, head
  float* y1t = arena.take<float>(2 * g.m1t);        // dc stage, tail (stationary)
  float* add_t = arena.take<float>(2 * in_g.tp);    // yc_tail . dc_over
  float* y2h = arena.take<float>(2 * g.n_pairs);    // in stage, head
  float* y2t = arena.take<float>(2 * g.pt);         // in stage, tail
  float* in_over = arena.take<float>(g.hy ? 2 * in_g.Kc : 0);
  float* dh = arena.take<float>(g.nd);
  float* dt = arena.take<float>(g.at);
  float* hv = arena.take<float>(g.a_p);             // the head rows
  float* tv = arena.take<float>(g.at);              // the tail rows
  float* cy = arena.take<float>(g.hy);              // y_coup . in_over
  const uint32_t* row = raw + static_cast<long long>(blockIdx.x) * words;
  float* arow = audio + static_cast<long long>(blockIdx.x) * words;
  if (threadIdx.x == 0) bulk_load(consts, pack, pack_bytes, bar);
  condition_words<kNormalize>(row, 0, g.w1_words, hp);
  condition_words<kNormalize>(row, words - g.wt_words, g.wt_words, tp);
  __syncthreads();
  bulk_wait(bar);
  const PatchStage dc = in_consts(dc_g, pack, consts);
  const PatchStage in = in_consts(in_g, pack, consts);
  const PatchAudioFir out = in_consts(out_g, pack, consts);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = out.H;
  if (warp == 0) {  // head: y1h -> y2h -> dh -> rows [0, a_p)
    for (int i = lane; i < 2 * g.m1; i += 32) y1h[i] = stage_head(dc, hp, P, i >> 1, i & 1);
    chain_arrive(3, 96);
    chain_sync(1, 64);
    for (int i = lane; i < 2 * g.n_pairs; i += 32) {
      const int p = i >> 1, l = i & 1;
      float y = stage_head(in, y1h, g.m1, p, l);
      if (p < g.hp2) y = __fadd_rn(y, stage_coup(in.yc_head, in.ky, dc_over, p, l));
      y2h[i] = y;
    }
    __syncwarp();
    for (int w = lane; w < g.nd; w += 32) dh[w] = demod4<kPrecise>(y2h + 4 * w);
    __syncwarp();
    for (int h = lane; h < g.a_p; h += 32) {
      hv[h] = h < H ? head_row(out, dh, h) : audio_row(out, dh, g.nd, h);
    }
  } else if (warp == 1) {  // tail: y1t -> y2t -> dt -> the last at rows
    // the last m1t outputs of the dc stage over the block's last pairs
    for (int i = lane; i < 2 * g.m1t; i += 32) {
      y1t[i] = stage_row(dc, tp, Pt, Pt - g.m1t + (i >> 1), i & 1);
    }
    chain_arrive(3, 96);
    chain_sync(2, 64);
    const int t0 = g.pt - g.tc2;
    for (int i = lane; i < 2 * g.pt; i += 32) {
      const int p = i >> 1;
      float y = stage_row(in, y1t, g.m1t, g.m1t - g.pt + p, i & 1);
      if (p >= t0) y = __fadd_rn(y, add_t[i - 2 * t0]);
      y2t[i] = y;
    }
    __syncwarp();
    for (int w = lane; w < g.at; w += 32) dt[w] = demod4<kPrecise>(y2t + 4 * w);
    __syncwarp();
    for (int q = lane; q < g.at; q += 32) tv[q] = audio_row(out, dt, g.at, q);
  } else {  // overrun: dc_over -> add_t -> in_over -> y_coup . in_over
    for (int i = lane; i < 2 * dc.Kc; i += 32) {
      dc_over[i] = stage_over(dc, hp, tp, Pt, i >> 1, i & 1);
    }
    chain_arrive(1, 64);
    for (int i = lane; i < 2 * in.tp; i += 32) {
      add_t[i] = stage_coup(in.yc_tail, in.ky, dc_over, i >> 1, i & 1);
    }
    chain_arrive(2, 64);
    chain_sync(3, 96);
    if (g.hy) {
      for (int i = lane; i < 2 * in.Kc; i += 32) {
        in_over[i] = __fadd_rn(stage_over(in, y1h, y1t, g.m1t, i >> 1, i & 1),
                               add_t[2 * g.tc2 + i]);
      }
      __syncwarp();
      for (int h = lane; h < g.hy; h += 32) cy[h] = coup_row(out, in_over, h);
    }
  }
  __syncthreads();
  wait_main_kernel();
  // each row as the plain version leaves it: the head rows and the
  // stationary rows to a_p, the tail rows, then the coupling added on the
  // first hy rows (over K3's rows past a_p)
  const int rows = g.a_p > g.hy ? g.a_p : g.hy;
  const long long tail0 = words - g.at;
  for (int h = threadIdx.x; h < rows + g.at; h += blockDim.x) {
    const long long r = h < rows ? h : tail0 + (h - rows);
    if (h < rows && r >= tail0) continue;  // a tail row: written below
    float y = r >= tail0 ? tv[r - tail0] : (r < g.a_p ? hv[r] : arow[r]);
    if (r < g.hy) y = __fadd_rn(y, cy[r]);
    arow[r] = y;
  }
}

bool fir_ok(const PatchAudioFir* f) {
  return f && f->taps && f->head && f->ntaps >= 1 && f->ntaps <= kMaxTaps && f->H >= 0 &&
         f->Wh >= 1 && f->hy >= 0 && (f->hy == 0 || (f->y_coup && f->ky >= 1));
}

bool stage_ok(const PatchStage* s) {
  return s && s->taps && s->c_int && s->head && s->c_head && s->tail && s->tail_alias &&
         s->c_tail && s->ntaps >= 1 && s->ntaps <= kMaxCplxTaps && s->Hc >= 0 &&
         s->Whc >= 1 && s->Kc >= 0 && s->Wtc >= 1 && (s->hp == 0 || s->yc_head) &&
         (s->tp == 0 || s->yc_tail);
}

// A grid of one CTA per block with `smem` bytes each that a launch refuses.
bool bad_grid(long long blocks, size_t smem) {
  return blocks < 1 || blocks > 2147483647LL || smem > kMaxPatchSmem;
}

// P3's and P4's constants as ops/cuda/nbfm_patch.py packed_consts lays
// them out: the audio filter's taps, head and y_coup, then each stage's
// taps, c_int, head, c_head, tail, tail_alias, c_tail, yc_head and yc_tail,
// each one present at the next multiple of 16 bytes from `base`.  Walking
// the structs' pointers in that order, `ok` stays true while each is where
// the layout puts it; `bytes` is then the pack's size.
struct ConstPack {
  const char* base;
  size_t bytes = 0;
  bool ok = true;

  template <class T>
  void take(const T* p, long long n) {
    if (!p) return;
    ok = ok && n >= 0 && reinterpret_cast<const char*>(p) == base + bytes;
    bytes += round16(static_cast<size_t>(n < 0 ? 0 : n) * sizeof(T));
  }
  void fir(const PatchAudioFir& f) {
    take(f.taps, f.ntaps);
    take(f.head, 1LL * f.H * f.Wh);
    take(f.y_coup, 1LL * f.hy * f.ky);
  }
  void stage(const PatchStage& s) {
    take(s.taps, s.ntaps);
    take(s.c_int, 2);
    take(s.head, 1LL * s.Hc * s.Whc);
    take(s.c_head, 2LL * s.Hc);
    take(s.tail, 1LL * s.Kc * s.Wtc);
    take(s.tail_alias, 1LL * s.Kc * s.Whc);
    take(s.c_tail, 2LL * s.Kc);
    take(s.yc_head, 2LL * s.hp * s.ky);
    take(s.yc_tail, 2LL * s.tp * s.ky);
  }
  // a pack one bulk copy can stage: 16-byte aligned, its size a multiple of
  // 16 (by construction) that fits the copy's 32-bit count
  bool good() const {
    return ok && reinterpret_cast<uintptr_t>(base) % 16 == 0 && bytes <= kMaxPatchSmem;
  }
};

// One CTA of `threads` a block, launched as a programmatic dependent of
// the kernel before it on `s` (its CTAs may start once every CTA of that
// kernel has triggered, and wait for it in griddepcontrol.wait).  Above
// the default 48 KiB of dynamic shared memory the kernel's limit is raised
// first.  → the launch's error, else cudaGetLastError().
template <class... Params, class... Args>
int launch_dependent(void (*kernel)(Params...), long long blocks, int threads, size_t smem,
                     cudaStream_t s, Args... args) {
  cudaError_t e = cudaSuccess;
  if (smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// C entry points (loaded with ctypes by ops/cuda/build.py).  Each launches
// one CTA per block on `stream` after the main kernel there (P3 and P4 as
// its programmatic dependents), does not synchronize, and returns the
// launch's error or cudaGetLastError() (cudaErrorInvalidValue for
// arguments it does not take, shared memory above kMaxPatchSmem and, for
// P3 and P4, constants not laid out as one pack among them).  `raw` is the
// uint8 [blocks, 4 * words] the main kernel read, `audio` its float32
// [blocks, words] output, patched in place.

extern "C" int patch_fused_launch(const void* raw, void* audio, long long blocks,
                                  long long words, const PatchAudioFir* out, int precise,
                                  int normalize, void* stream) {
  if (!fir_ok(out) || out->Wh > words || out->H > words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = round16(16 * out->Wh) + round16(4 * out->Wh);
  if (bad_grid(blocks, smem)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint32_t*>(raw);
  auto* o = static_cast<float*>(audio);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (precise) {
    if (normalize) patch_fused_kernel<true, true><<<grid, kPatchThreads, smem, s>>>(in, o, words, *out);
    else patch_fused_kernel<true, false><<<grid, kPatchThreads, smem, s>>>(in, o, words, *out);
  } else {
    if (normalize) patch_fused_kernel<false, true><<<grid, kPatchThreads, smem, s>>>(in, o, words, *out);
    else patch_fused_kernel<false, false><<<grid, kPatchThreads, smem, s>>>(in, o, words, *out);
  }
  return static_cast<int>(cudaGetLastError());
}

// offs_in: float32 [blocks, 2] (K4's entering offsets); T: float64 [2Wh,
// 2Wh], apow: float64 [2Wh] (models/nbfm.py _q1_head_consts); esr the
// float32 esr as a double.
extern "C" int patch_q1_launch(const void* raw, void* audio, const void* offs_in,
                               const void* T, const void* apow, double esr, long long blocks,
                               long long words, const PatchAudioFir* out, int precise,
                               void* stream) {
  if (!fir_ok(out) || !offs_in || !T || !apow || 2 * out->Wh > words || out->H > words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = out->Wh;
  const size_t smem = round16(8 * 4 * W) + round16(4 * 4 * W) + round16(4 * W);
  if (bad_grid(blocks, smem)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint32_t*>(raw);
  auto* o = static_cast<float*>(audio);
  const auto* off = static_cast<const float*>(offs_in);
  const auto* t = static_cast<const double*>(T);
  const auto* ap = static_cast<const double*>(apow);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (precise) patch_q1_kernel<true><<<grid, kPatchThreads, smem, s>>>(in, o, words, off, t, ap, esr, *out);
  else patch_q1_kernel<false><<<grid, kPatchThreads, smem, s>>>(in, o, words, off, t, ap, esr, *out);
  return static_cast<int>(cudaGetLastError());
}

// st and out: the stage's and the audio filter's constants, pointing into
// one pack (ConstPack; ops/cuda/nbfm_patch.py packed_consts).
extern "C" int patch_cplx1_launch(const void* raw, void* audio, long long blocks,
                                  long long words, const PatchStage* st,
                                  const PatchAudioFir* out, int n_pairs, int w1_words,
                                  int wt_words, int precise, int normalize, void* stream) {
  if (!fir_ok(out) || !stage_ok(st) || n_pairs < 2 * out->Wh || n_pairs < st->Hc ||
      2 * w1_words < st->Whc || 2 * w1_words < n_pairs + st->ntaps - 1 ||
      w1_words > words || wt_words > words || out->H > words || out->hy > words ||
      (out->hy && (2 * wt_words < st->Wtc || out->ky != 2 * st->Kc))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConstPack pack{reinterpret_cast<const char*>(out->taps)};
  pack.fir(*out);
  pack.stage(*st);
  if (!pack.good()) return static_cast<int>(cudaErrorInvalidValue);
  const int hy = out->hy;
  // the mbarrier, the pack, then the kernel's Arena in its order
  const size_t smem = kBarBytes + pack.bytes + round16(16 * w1_words) +
                      round16(hy ? 16 * wt_words : 0) + round16(8 * n_pairs) +
                      round16(hy ? 8 * st->Kc : 0) + round16(4 * out->Wh) +
                      round16(4 * out->H) + round16(4 * hy);
  if (bad_grid(blocks, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = precise ? (normalize ? &patch_cplx1_kernel<true, true>
                                           : &patch_cplx1_kernel<true, false>)
                              : (normalize ? &patch_cplx1_kernel<false, true>
                                           : &patch_cplx1_kernel<false, false>);
  return launch_dependent(kernel, blocks, kCplx1Threads, smem,
                          static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(raw),
                          static_cast<float*>(audio), words, *st, *out, pack.base,
                          static_cast<unsigned>(pack.bytes), n_pairs, w1_words, wt_words);
}

// dc, in and out: the stages' and the audio filter's constants, pointing
// into one pack (ConstPack), the audio filter's first.
extern "C" int patch_cplx2_launch(const void* raw, void* audio, long long blocks,
                                  long long words, const PatchStage* dc, const PatchStage* in,
                                  const PatchAudioFir* out, const PatchQ2lGeometry* geom,
                                  int precise, int normalize, void* stream) {
  if (!fir_ok(out) || !stage_ok(dc) || !stage_ok(in) || !geom || !in->yc_tail) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PatchQ2lGeometry& g = *geom;
  const int P = 2 * g.w1_words, Pt = 2 * g.wt_words;
  if (g.n_pairs != 2 * g.nd || g.pt != 2 * g.at || g.nd < out->Wh || g.nd < g.a_p + out->ntaps - 1 ||
      g.a_p < out->H || g.hp2 > g.n_pairs || g.hp2 > in->hp || in->ky != 2 * dc->Kc ||
      g.m1 < dc->Hc || g.m1 < in->Whc || P < dc->Whc || P < g.m1 + dc->ntaps - 1 ||
      g.m1 < g.n_pairs + in->ntaps - 1 || g.n_pairs < in->Hc || Pt < dc->Wtc ||
      Pt < g.m1t || g.m1t < g.pt || g.m1t < in->Wtc || g.tc2 > g.pt ||
      in->tp < g.tc2 + (g.hy ? in->Kc : 0) || g.hy != out->hy ||
      (g.hy && out->ky != 2 * in->Kc) || g.w1_words > words || g.wt_words > words ||
      g.a_p + g.at > words || g.hy > words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConstPack pack{reinterpret_cast<const char*>(out->taps)};
  pack.fir(*out);
  pack.stage(*dc);
  pack.stage(*in);
  if (!pack.good()) return static_cast<int>(cudaErrorInvalidValue);
  // the mbarrier, the pack, then the kernel's Arena in its order
  const size_t smem = kBarBytes + pack.bytes + round16(8 * P) + round16(8 * Pt) +
                      round16(8 * dc->Kc) + round16(8 * g.m1) + round16(8 * g.m1t) +
                      round16(8 * in->tp) + round16(8 * g.n_pairs) + round16(8 * g.pt) +
                      round16(g.hy ? 8 * in->Kc : 0) + round16(4 * g.nd) + round16(4 * g.at) +
                      round16(4 * g.a_p) + round16(4 * g.at) + round16(4 * g.hy);
  if (bad_grid(blocks, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = precise ? (normalize ? &patch_cplx2_kernel<true, true>
                                           : &patch_cplx2_kernel<true, false>)
                              : (normalize ? &patch_cplx2_kernel<false, true>
                                           : &patch_cplx2_kernel<false, false>);
  return launch_dependent(kernel, blocks, kCplx2Threads, smem,
                          static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(raw),
                          static_cast<float*>(audio), words, *dc, *in, *out, pack.base,
                          static_cast<unsigned>(pack.bytes), g);
}
