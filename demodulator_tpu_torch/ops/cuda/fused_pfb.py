"""Wrapper of the polyphase channel-bank front (K6), beside its plain version.

Counterpart of ``demodulator_tpu/ops/pallas/fused_pfb.py::fused_pfb_demod``
(``:196``): uint16 IQ → shiftOrigin → P-tap polyphase branch filter over a
carried ``[2, P·C]`` history → C-point DFT → even/odd conjugate product →
fast discriminator.  The kernel (``csrc/fused_pfb.cu``) takes the raw bytes
(one little-endian 16-bit word per complex sample, low byte I) and returns
``d [T/(2C), C]``, row m2 column k channel k's output for frame pair
(2·m2, 2·m2 + 1): no 64-column lane packing.  Any C with ``T % 2C == 0``
runs.  Its DFT is a float64 FFT (:func:`fft_plan`): in two factors C =
C1·C2 up to :data:`MAX_STAGED` channels, whose tiles the kernel stages
whole in shared memory, and in three, C = C1·C2·C3, up to
:data:`MAX_CTA_CHANNELS`: the grids of :data:`WIDE_PLANS` with the 12-tap
prototype on compiled-in plans, a CTA walking units of consecutive frame
pairs over input rows staged by bulk copies, any other C a frame pair a
CTA.  Above, where a CTA cannot hold a frame pair's spectra, a four-step
FFT C = N1·N2 (:func:`four_step_plan`): for the grids of
:data:`CLUSTER_PLANS` with the 12-tap prototype one launch of
``pfb_cluster_kernel`` (``csrc/fused_pfb_cluster.cu``), a thread block
cluster holding a frame pair's spectra in its CTAs' shared memory; any
other C in two kernels through a float64 scratch buffer, all of a call's
frame pairs in one pass-1 and one pass-2 launch unless the scratch would
pass :data:`SCRATCH_BYTES` (:func:`group_pairs`).  Every factor is read
from one float64 table (:func:`fft_table`).

Given CUDA tensors the wrapper launches the kernel (the two-pass route:
its two kernels a group of pairs), adds one to
``fused_pfb_demod.launches`` a kernel launched (:func:`launches_per_call`)
and returns; a P beyond the kernel's limit (:func:`kernel_refusal`), a
failed build or a failed launch raises.  Given CPU tensors it returns
:func:`fused_pfb_demod_ref`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import build
from ..channelizer import PolyphaseChannelizer, pfb_twiddles
from ..conditioning import split_iq
from ..demod import _ATAN_COEFFS, _ATAN_COEFFS_FAST, atan2_poly
from .fused_nbfm import _raise_on

__all__ = ["CLUSTER_PLANS", "MAX_CTA_CHANNELS", "MAX_PHASES", "MAX_FACTOR",
           "MAX_STAGED", "SCRATCH_BYTES", "SMEM_LIMIT", "STEP_SMEM",
           "WIDE_PLANS", "WIDE_TAPS", "fft_plan", "fft_table",
           "four_step_plan", "four_step_smem", "four_step_tiles",
           "fused_pfb_demod", "fused_pfb_demod_ref", "group_pairs",
           "kernel_attrs", "kernel_refusal", "launches_per_call",
           "on_cluster", "pair_smem_bytes", "sub_plan"]

# the largest C whose frame pair's spectra a CTA holds (csrc/fused_pfb.cu
# kMaxCtaChannels); above, the four-step route
MAX_CTA_CHANNELS = 4096
MAX_STAGED = 256     # csrc/fused_pfb.cu kMaxStaged: the two-factor route
MAX_PHASES = 32      # csrc/fused_pfb.cu kMaxPhases
MAX_FACTOR = 16      # the largest FFT factor the kernel plans for
SMEM_LIMIT = 232448  # dynamic shared memory an H100 CTA can have
# The three-factor plans compiled in (csrc/fused_pfb.cu PFB_WIDE, with
# WIDE_TAPS taps a branch): C -> (frame pairs a unit G, one frame's spectrum
# in shared memory at a time, threads a CTA, CTAs an SM its registers are
# held to).  The 6.25 kHz grids of 2.4, 3.2, 6.4, 12.8 and 25.6 Msps.
WIDE_PLANS = {384: (4, False, 96, 3), 512: (2, False, 128, 4),
              1024: (1, False, 128, 3), 2048: (1, True, 128, 2),
              4096: (1, True, 256, 1)}
WIDE_TAPS = 12       # csrc/fused_pfb.cu kTaps
# the four-step route: a tile's shared memory, sized for two CTAs an SM
# (each with its 1 KiB reserve in the SM's 228 KiB), and the most scratch a
# launch pair takes (a bound on memory: 16 bytes a complex sample; on the
# H100 one group of a 0.25 s block's pairs ran 10-25% faster than groups
# whose scratch stays in the 50 MB L2: PERF.md, the four-step route)
STEP_SMEM = 113 << 10
SCRATCH_BYTES = 512 << 20
# The four-step plans compiled in on thread block clusters
# (csrc/fused_pfb_cluster.cu PFB_CLUSTER, with WIDE_TAPS taps a branch): C
# -> (N1, N2, CTAs a cluster, threads a CTA, step A's N2-point stages,
# step B's N1-point stages, each thread's taps held in registers).  The
# 6.25 kHz grids of 30, 38.4, 51.2 and 102.4 Msps; one launch a call, no
# scratch.
CLUSTER_PLANS = {4800: (64, 75, 4, 512, (3, 5, 5), (8, 8), True),
                 6144: (64, 96, 4, 512, (8, 4, 3), (8, 8), False),
                 8192: (64, 128, 4, 512, (16, 8), (8, 8), False),
                 16384: (128, 128, 8, 512, (8, 4, 4), (8, 4, 4), False)}


def _check(raw: torch.Tensor, hist: torch.Tensor, h, C: int):
    """→ (n complex samples, h as float64 [P, C])."""
    if raw.dtype != torch.uint8 or raw.dim() != 1 or not raw.is_contiguous():
        raise ValueError(f"expected contiguous uint8 [2·T] raw bytes, got "
                         f"{raw.dtype} {tuple(raw.shape)}")
    n = raw.shape[0] // 2
    if raw.shape[0] % 2 or n < 2 * C or n % (2 * C):
        raise ValueError(f"{raw.shape[0]} bytes are not a whole number of "
                         f"2C = {2 * C}-sample frame pairs")
    h = np.asarray(h, np.float64)
    if h.size % C or h.size == 0:
        raise ValueError(f"prototype of {h.size} taps is not P·{C}")
    h = h.reshape(-1, C)
    if (hist.dtype != torch.float32 or hist.shape != (2, h.size)
            or hist.device != raw.device):
        raise ValueError(f"hist must be float32 [2, {h.size}] on "
                         f"{raw.device}, got {hist.dtype} "
                         f"{tuple(hist.shape)} on {hist.device}")
    return n, h


def fused_pfb_demod_ref(raw: torch.Tensor, hist: torch.Tensor, h, C: int,
                        precise: bool = False):
    """Plain version of K6 on ``raw``'s device: (d [T/(2C), C],
    new_hist [2, P·C]).  The branch filter is the channelizer's (float32,
    p order, as the kernel sums); the DFT a float64 matrix product rounded
    once to float32, as the kernel accumulates; fast means the 6-term
    polynomial with the Newton-refined reciprocal the kernel uses."""
    _, h = _check(raw, hist, h, C)
    xi, xq = split_iq(raw)
    pfb = _plain_front(h.tobytes(), C)
    yer, yei, yor, yoi, new_hist = pfb.call_split(
        torch.stack([xi, xq]), hist, dft_dtype=torch.float64)
    zr = yer * yor + yei * yoi
    zj = yei * yor - yer * yoi
    s = atan2_poly(zj, zr, _ATAN_COEFFS if precise else _ATAN_COEFFS_FAST,
                   newton_recip=not precise)
    return torch.where(torch.isnan(s), torch.zeros_like(s), s), new_hist


@functools.lru_cache(maxsize=4)
def _plain_front(h64: bytes, C: int) -> PolyphaseChannelizer:
    """The plain version's channelizer of a float64 prototype, kept with its
    tables (the C×C DFT's on a device once used) across calls."""
    return PolyphaseChannelizer(C, prototype=np.frombuffer(h64, np.float64))


@functools.cache
def fft_plan(C: int) -> tuple[int, ...]:
    """The kernel's factorisation of C.

    Up to :data:`MAX_STAGED`, two factors C = C1·C2: both at most
    :data:`MAX_FACTOR` and as close as possible, C1 <= C2 (8·8 at 64, 3·4
    at 12, 1·p for a prime p <= 16); (C, 1), the direct DFT, where no such
    split exists (a prime above 16, or 200).

    Above, three factors C = C1·C2·C3 with C2 <= :data:`MAX_FACTOR` (the
    stage the kernel runs in place in registers); C1 and C3 may be any
    size.  Of those: every factor at most 16 where such a plan exists, then
    the least work (log2 n a point for a stage of n = 2, 4, 8 or 16, a
    butterfly network; n for any other n, a direct sum), then the smallest
    largest factor, then the first in lexicographic order: 8·8·8 at 512,
    3·8·16 at 384, 16·16·16 at 4096, 10·10·10 at 1000, 1·1·257 at 257,
    17·1·19 at 323."""
    if C <= MAX_STAGED:
        for c1 in range(math.isqrt(C), 0, -1):
            if C % c1 == 0 and C // c1 <= MAX_FACTOR:
                return c1, C // c1
        return C, 1
    best = None
    for c1 in range(1, C + 1):
        if C % c1:
            continue
        for c2 in range(1, MAX_FACTOR + 1):
            if (C // c1) % c2:
                continue
            plan = (c1, c2, C // (c1 * c2))
            key = (max(plan) > MAX_FACTOR, sum(_stage_cost(n) for n in plan),
                   sorted(plan, reverse=True), plan)
            if best is None or key < best:
                best = key
    return best[-1]


def _stage_cost(n: int) -> int:
    """Work a point of a stage of n points: log2 n for a radix size, n for
    a direct sum (0 for n = 1)."""
    if n in (2, 4, 8, 16):
        return n.bit_length() - 1
    return 0 if n == 1 else n


def fft_table(C: int) -> np.ndarray:
    """The kernel's float64 twiddle table (cos, sin).

    Two factors: [C + C1·RS, 2], e^{+j2π i/C} for i < C (stage factors
    w_C1^m = entry m·C2, w_C2^m = entry m·C1), then the twiddles between
    the stages, e^{+j2π k1·c2/C} at C + k1·RS + c2 in the kernel's padded
    row stride RS = C2 + 1 (C2 > 1; else 1).

    Three factors: [C, 2], e^{+j2π i/C} for i < C alone.  With D = C2·C3
    the stage factors are w_C1^m = entry m·D, w_C2^m = entry m·C1·C3 and
    w_C3^m = entry m·C1·C2, and the twiddles between the stages, w_C^(k1·d)
    (k1 < C1, d < D) and w_C^(C1·k2·c3) (k2 < C2, c3 < C3), have exponents
    below C: entries k1·d and C1·k2·c3.

    Four steps (C > :data:`MAX_CTA_CHANNELS`): [C, 2], e^{+j2π i/C} for i <
    C alone.  The twiddle between the passes, w_C^(n1·k2), is entry n1·k2;
    an N-point FFT of either pass (N = N1 or N2) reads w_N^m as entry
    m·C/N, its stages' factors and twiddles as the three-factor route's
    with N for C."""
    cos, sin = pfb_twiddles(C)
    if C > MAX_CTA_CHANNELS or len(fft_plan(C)) == 3:
        return np.stack([cos, sin], axis=-1)
    C1, C2 = fft_plan(C)
    rs = C2 + 1 if C2 > 1 else 1
    k1c2 = np.zeros((C1, rs), np.int64)
    k1c2[:, :C2] = np.arange(C1)[:, None] * np.arange(C2)[None, :]
    idx = np.concatenate([np.arange(C), k1c2.ravel()])
    return np.stack([cos[idx], sin[idx]], axis=-1)


def _odd(n: int) -> int:
    return n if n % 2 else n + 1


def _stage_words(C1: int, C2: int, C3: int) -> int:
    """double2 words of one column's stage buffer on the plan C1·C2·C3
    (csrc/fused_pfb.cu make_sub): C1 rows of S1 = C2·C3 made odd."""
    return C1 * _odd(C2 * C3)


def pair_smem_bytes(C: int, P: int = WIDE_TAPS) -> int:
    """Shared memory of a CTA of the three-factor route for C channels of P
    taps a branch.  A compiled-in plan (:data:`WIDE_PLANS`, csrc/fused_pfb.cu
    Wide::kSmem): the float64 spectra of the frames it holds at once,
    double2 [F, C1·S1] (F = 2G, or 1), with S1 = D, or D + 1 where D = C2·C3
    is even; the odd frame's float32 branch outputs, float2 [C], where F =
    1; the staged input, P + 2G rows of C 16-bit words; a 16-byte mbarrier
    (213 264 bytes at C = 4096).  Any other (big_smem_bytes): the frame
    pair's spectra, double2 [2, C1·S1], and its branch outputs, float2 [2,
    C]."""
    if C > MAX_CTA_CHANNELS:
        raise ValueError(f"C = {C} is on the four-step route: "
                         f"four_step_smem")
    FS = _stage_words(*fft_plan(C))
    if C in WIDE_PLANS and P == WIDE_TAPS:
        G, seq = WIDE_PLANS[C][:2]
        return (16 * (1 if seq else 2 * G) * FS + (8 * C if seq else 0)
                + 2 * (P + 2 * G) * C + 16)
    return 16 * 2 * FS + 8 * 2 * C


def kernel_refusal(P: int) -> str | None:
    """Why the kernel cannot take a prototype of P taps a branch, or None
    (any C runs)."""
    if not 1 <= P <= MAX_PHASES:
        return (f"the PFB kernel takes 1..{MAX_PHASES} taps per branch, got "
                f"P = {P}")
    return None


def four_step_plan(C: int) -> tuple[int, int]:
    """(N1, N2), N1·N2 = C > :data:`MAX_CTA_CHANNELS`: N1 the largest
    divisor of C up to √C (64 × 128 at 8192, 64 × 75 at 4800, 128 × 128 at
    16384).  Where that leaves N2 above :data:`MAX_CTA_CHANNELS` (a prime
    factor that large: 8198 = 2·4099, a prime C), the two swap: pass 2's
    N1 is then a direct sum read from global memory, and pass 1's N2 (at
    most √C) a CTA's FFT."""
    if C <= MAX_CTA_CHANNELS:
        raise ValueError(f"C = {C} is not on the four-step route (C > "
                         f"{MAX_CTA_CHANNELS})")
    n1 = next(d for d in range(math.isqrt(C), 0, -1) if C % d == 0)
    n2 = C // n1
    return (n2, n1) if n2 > MAX_CTA_CHANNELS else (n1, n2)


def sub_plan(N: int) -> tuple[int, int, int]:
    """The three stages (C1, C2, C3) of a four-step pass's N-point FFT in a
    CTA (N <= :data:`MAX_CTA_CHANNELS`): :func:`fft_plan`'s, a two-factor
    plan (a, b) as (a, 1, b)."""
    plan = fft_plan(N)
    return plan if len(plan) == 3 else (plan[0], 1, plan[1])


def _column_bytes(N: int) -> int:
    """Shared memory of one column of a pass's N-point FFT (csrc/fused_pfb.cu
    step_smem): its stage buffer, double2 [FS] (FS = C1·S1 made odd, S1 =
    C2·C3 made odd), and its float2 z or y [N made odd]."""
    return 16 * _odd(_stage_words(*sub_plan(N))) + 8 * _odd(N)


def four_step_tiles(C: int) -> tuple[int, int]:
    """(T1, T2): the columns a CTA takes, consecutive n1 in pass 1 and k2
    in pass 2, each of both frames of a pair: as many as fit
    :data:`STEP_SMEM` (at least one), evened out over the tiles a pair
    needs.  T2 = 0 where N1 > :data:`MAX_CTA_CHANNELS` (the direct sum, a
    thread an output)."""
    N1, N2 = four_step_plan(C)

    def tile(N, cols):
        t = min(cols, max(1, STEP_SMEM // (2 * _column_bytes(N))))
        return -(-cols // -(-cols // t))
    return tile(N2, N1), 0 if N1 > MAX_CTA_CHANNELS else tile(N1, N2)


def four_step_smem(C: int) -> tuple[int, int]:
    """Dynamic shared memory of a CTA of pass 1 and of pass 2."""
    N1, N2 = four_step_plan(C)
    T1, T2 = four_step_tiles(C)
    return 2 * T1 * _column_bytes(N2), 2 * T2 * _column_bytes(N1) if T2 else 0


def group_pairs(C: int) -> int:
    """Frame pairs a launch of the four-step route's two kernels takes:
    their scratch (32 bytes a channel a pair) within
    :data:`SCRATCH_BYTES`, at least one pair (every pair of a 0.25 s block
    up to 16 384 channels)."""
    return max(1, SCRATCH_BYTES // (32 * C))


def on_cluster(C: int, P: int = WIDE_TAPS) -> bool:
    """Whether C channels of P taps a branch run a compiled-in cluster plan
    (:data:`CLUSTER_PLANS`)."""
    return C in CLUSTER_PLANS and P == WIDE_TAPS


def launches_per_call(C: int, n: int, P: int = WIDE_TAPS) -> int:
    """Kernel launches of one call on n complex samples of C channels of P
    taps a branch: 1, or, on the two-pass four-step route, 2 a group of
    :func:`group_pairs`."""
    if C <= MAX_CTA_CHANNELS or on_cluster(C, P):
        return 1
    return 2 * -(-(n // (2 * C)) // group_pairs(C))


def step_plan(C: int) -> tuple[int, ...]:
    """The four-step route's plan as csrc/fused_pfb.cu takes it: N1, T1,
    T2, then C1 and C2 of pass 1's N2-point FFT and of pass 2's N1-point
    one (0, 0 for the direct sum)."""
    N1, N2 = four_step_plan(C)
    T1, T2 = four_step_tiles(C)
    s1 = sub_plan(N2)[:2]
    s2 = sub_plan(N1)[:2] if T2 else (0, 0)
    return (N1, T1, T2, *s1, *s2)


def kernel_attrs(C: int, P: int = WIDE_TAPS) -> dict:
    """The card's attributes of the kernel a three-factor launch of C
    channels of P taps runs (``pfb_wide_kernel`` for a compiled-in plan,
    else ``pfb_big_kernel``): registers a thread, local memory a thread
    (stack and spills, bytes), dynamic shared memory (bytes), CTAs an SM;
    for a cluster plan (:func:`on_cluster`) those of ``pfb_cluster_kernel``
    with its CTAs a cluster (``cluster_size``) and the clusters the card
    holds at once (``active_clusters``); on the two-pass four-step route
    those of its two kernels, {"pfb_pass1_kernel": {...},
    "pfb_pass2_kernel": {...}}.  Builds the library; needs a card."""
    if C <= MAX_STAGED:
        raise ValueError(f"C = {C} is on the two-factor route")
    keys = ("regs", "local_bytes", "smem_bytes", "ctas_per_sm")
    if on_cluster(C, P):
        out = (ctypes.c_int * 6)()
        _raise_on(build.load().fused_pfb_cluster_attrs(C, out),
                  "fused_pfb_cluster_attrs")
        return dict(zip(keys + ("cluster_size", "active_clusters"), out))
    if C > MAX_CTA_CHANNELS:
        out = (ctypes.c_int * 8)()
        _raise_on(build.load().fused_pfb_step_attrs(
            C, (ctypes.c_int * 7)(*step_plan(C)), P, out),
            "fused_pfb_step_attrs")
        return {"pfb_pass1_kernel": dict(zip(keys, out[:4])),
                "pfb_pass2_kernel": dict(zip(keys, out[4:]))}
    C1, C2 = fft_plan(C)[:2]
    out = (ctypes.c_int * 4)()
    _raise_on(build.load().fused_pfb_kernel_attrs(C, C1, C2, P, out),
              "fused_pfb_kernel_attrs")
    return dict(zip(keys, out))


@functools.cache
def _table(C: int, device: torch.device) -> torch.Tensor:
    """:func:`fft_table` on ``device``, once per (C, device)."""
    return torch.from_numpy(fft_table(C)).to(device)


@functools.cache
def _taps(h64: bytes, P: int, C: int, device: torch.device) -> torch.Tensor:
    """The float64 prototype's bytes as float32 [P, C] on ``device``, once
    per prototype and device."""
    h = np.frombuffer(h64, np.float64).reshape(P, C)
    return torch.from_numpy(h.astype(np.float32)).to(device)


def fused_pfb_demod(raw: torch.Tensor, hist: torch.Tensor, h, C: int,
                    precise: bool = False, h_dev: torch.Tensor | None = None):
    """raw: uint8 [2·T] bytes of T complex samples (T % 2C == 0); hist:
    float32 [2, P·C] conditioned samples before them; h: the host
    prototype, P·C taps (float64, rounded to float32 here) → (d [T/(2C), C]
    float32, new_hist [2, P·C]).  ``h_dev``: the float32 [P, C] taps already
    on the card; without it the wrapper keeps its own copy per prototype
    and device."""
    n, h = _check(raw, hist, h, C)
    if raw.device.type == "cpu":
        return fused_pfb_demod_ref(raw, hist, h, C, precise)
    P = h.shape[0]
    refusal = kernel_refusal(P)
    if refusal is not None:
        raise ValueError(refusal)
    if raw.data_ptr() % 2:
        raise ValueError("raw bytes must be 2-byte aligned")
    dev = raw.device
    if h_dev is None:
        h_dev = _taps(h.tobytes(), P, C, dev)
    if (h_dev.dtype != torch.float32 or h_dev.shape != (P, C)
            or h_dev.device != dev or not h_dev.is_contiguous()):
        raise ValueError(f"h_dev must be contiguous float32 [{P}, {C}] on "
                         f"{dev}")
    hist = hist.contiguous()
    table = _table(C, dev)
    d = torch.empty((n // (2 * C), C), dtype=torch.float32, device=dev)
    new_hist = torch.empty_like(hist)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if on_cluster(C, P):
            rc = lib.fused_pfb_cluster_launch(
                raw.data_ptr(), hist.data_ptr(), h_dev.data_ptr(),
                table.data_ptr(), d.data_ptr(), new_hist.data_ptr(), n, C, P,
                int(bool(precise)), stream)
            _raise_on(rc, "fused_pfb (cluster)")
            fused_pfb_demod.launches += 1
            return d, new_hist
        if C > MAX_CTA_CHANNELS:
            _four_step(lib, raw, hist, h_dev, table, d, new_hist, n, C, P,
                       precise, stream)
            return d, new_hist
        C1, C2 = fft_plan(C)[:2]  # the kernel takes C3 = C / (C1·C2)
        rc = lib.fused_pfb_launch(raw.data_ptr(), hist.data_ptr(),
                                  h_dev.data_ptr(), table.data_ptr(),
                                  d.data_ptr(), new_hist.data_ptr(), n, C, C1,
                                  C2, P, int(bool(precise)), stream)
    _raise_on(rc, "fused_pfb")
    fused_pfb_demod.launches += 1
    return d, new_hist


def _four_step(lib, raw, hist, h_dev, table, d, new_hist, n, C, P, precise,
               stream):
    """The two-pass four-step route: pass 1 and pass 2 over each group of
    :func:`group_pairs` frame pairs, into d and new_hist, through one
    float64 scratch buffer [group, 2, N2, N1] of complex values (allocated
    on the caller's stream: a captured step keeps its address)."""
    N1, N2 = four_step_plan(C)
    pairs = n // (2 * C)
    g = min(group_pairs(C), pairs)
    y = torch.empty((g, 2, N2, N1, 2), dtype=torch.float64, device=raw.device)
    plan = (ctypes.c_int * 7)(*step_plan(C))
    for p0 in range(0, pairs, g):
        rc = lib.fused_pfb_step_launch(
            raw.data_ptr(), hist.data_ptr(), h_dev.data_ptr(),
            table.data_ptr(), y.data_ptr(), d.data_ptr(), new_hist.data_ptr(),
            n, C, plan, P, p0, min(g, pairs - p0), int(bool(precise)), stream)
        _raise_on(rc, "fused_pfb (four-step)")
        fused_pfb_demod.launches += 2


fused_pfb_demod.launches = 0
