"""Wrapper of the polyphase channel-bank front (K6), beside its plain version.

Counterpart of ``demodulator_tpu/ops/pallas/fused_pfb.py::fused_pfb_demod``
(``:196``): uint16 IQ → shiftOrigin → P-tap polyphase branch filter over a
carried ``[2, P·C]`` history → C-point DFT → even/odd conjugate product →
fast discriminator.  The kernel (``csrc/fused_pfb.cu``) takes the raw bytes
(one little-endian 16-bit word per complex sample, low byte I) and returns
``d [T/(2C), C]``, row m2 column k channel k's output for frame pair
(2·m2, 2·m2 + 1): no 64-column lane packing.  Any C up to
:data:`MAX_CHANNELS` with ``T % 2C == 0`` runs.  Its DFT is a float64 FFT
(:func:`fft_plan`): in two factors C = C1·C2 up to :data:`MAX_STAGED`
channels, whose tiles the kernel stages whole in shared memory, and in
three, C = C1·C2·C3, above: the grids of :data:`WIDE_PLANS` with the
12-tap prototype on compiled-in plans, a CTA walking units of consecutive
frame pairs over input rows staged by bulk copies, any other C a frame
pair a CTA; every factor is read from one float64 table (:func:`fft_table`).

Given CUDA tensors the wrapper launches the kernel, adds one to
``fused_pfb_demod.launches`` and returns; a C or P beyond the kernel's
limits (:func:`kernel_refusal`), a failed build or a failed launch raises.
Given CPU tensors it returns :func:`fused_pfb_demod_ref`.
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

__all__ = ["MAX_CHANNELS", "MAX_PHASES", "MAX_FACTOR", "MAX_STAGED",
           "SMEM_LIMIT", "WIDE_PLANS", "WIDE_TAPS", "fft_plan", "fft_table",
           "fused_pfb_demod", "fused_pfb_demod_ref", "kernel_attrs",
           "kernel_refusal", "pair_smem_bytes"]

MAX_CHANNELS = 4096  # csrc/fused_pfb.cu kMaxChannels
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
    below C: entries k1·d and C1·k2·c3."""
    plan = fft_plan(C)
    cos, sin = pfb_twiddles(C)
    if len(plan) == 3:
        return np.stack([cos, sin], axis=-1)
    C1, C2 = plan
    rs = C2 + 1 if C2 > 1 else 1
    k1c2 = np.zeros((C1, rs), np.int64)
    k1c2[:, :C2] = np.arange(C1)[:, None] * np.arange(C2)[None, :]
    idx = np.concatenate([np.arange(C), k1c2.ravel()])
    return np.stack([cos[idx], sin[idx]], axis=-1)


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
    C1, C2, C3 = fft_plan(C)
    D = C2 * C3
    S1 = D if D % 2 else D + 1
    if C in WIDE_PLANS and P == WIDE_TAPS:
        G, seq = WIDE_PLANS[C][:2]
        return (16 * (1 if seq else 2 * G) * C1 * S1 + (8 * C if seq else 0)
                + 2 * (P + 2 * G) * C + 16)
    return 16 * 2 * C1 * S1 + 8 * 2 * C


def kernel_refusal(C: int, P: int) -> str | None:
    """Why the kernel cannot take C channels of P taps a branch, or None."""
    if not 1 <= P <= MAX_PHASES:
        return (f"the PFB kernel takes 1..{MAX_PHASES} taps per branch, got "
                f"P = {P}")
    if not 1 <= C <= MAX_CHANNELS:
        return (f"the PFB kernel takes 1..{MAX_CHANNELS} grid channels, got "
                f"C = {C}: above {MAX_STAGED} a CTA holds one frame pair's "
                f"float64 spectrum (2·C·16 bytes, and its float32 branch "
                f"outputs) in shared memory, {SMEM_LIMIT} bytes at most")
    return None


def kernel_attrs(C: int, P: int = WIDE_TAPS) -> dict:
    """The card's attributes of the kernel a three-factor launch of C
    channels of P taps runs (``pfb_wide_kernel`` for a compiled-in plan,
    else ``pfb_big_kernel``): registers a thread, local memory a thread
    (stack and spills, bytes), dynamic shared memory (bytes), CTAs an SM.
    Builds the library; needs a card."""
    if C <= MAX_STAGED:
        raise ValueError(f"C = {C} is on the two-factor route")
    C1, C2 = fft_plan(C)[:2]
    out = (ctypes.c_int * 4)()
    _raise_on(build.load().fused_pfb_kernel_attrs(C, C1, C2, P, out),
              "fused_pfb_kernel_attrs")
    return dict(zip(("regs", "local_bytes", "smem_bytes", "ctas_per_sm"),
                    out))


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
    refusal = kernel_refusal(C, P)
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
    C1, C2 = fft_plan(C)[:2]  # the kernel takes C3 = C / (C1·C2)
    table = _table(C, dev)
    d = torch.empty((n // (2 * C), C), dtype=torch.float32, device=dev)
    new_hist = torch.empty_like(hist)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_pfb_launch(raw.data_ptr(), hist.data_ptr(),
                                  h_dev.data_ptr(), table.data_ptr(),
                                  d.data_ptr(), new_hist.data_ptr(), n, C, C1,
                                  C2, P, int(bool(precise)), stream)
    _raise_on(rc, "fused_pfb")
    fused_pfb_demod.launches += 1
    return d, new_hist


fused_pfb_demod.launches = 0
