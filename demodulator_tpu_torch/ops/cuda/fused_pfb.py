"""Wrapper of the polyphase channel-bank front (K6), beside its plain version.

Counterpart of ``demodulator_tpu/ops/pallas/fused_pfb.py::fused_pfb_demod``
(``:196``): uint16 IQ → shiftOrigin → P-tap polyphase branch filter over a
carried ``[2, P·C]`` history → C-point DFT → even/odd conjugate product →
fast discriminator.  The kernel (``csrc/fused_pfb.cu``) takes the raw bytes
(one little-endian 16-bit word per complex sample, low byte I) and returns
``d [T/(2C), C]``, row m2 column k channel k's output for frame pair
(2·m2, 2·m2 + 1): no 64-column lane packing.  Any C up to
:data:`MAX_CHANNELS` with ``T % 2C == 0`` runs.  Its DFT is a float64 FFT
in two factors C = C1·C2 (:func:`fft_plan`), every factor read from one
float64 table (:func:`fft_table`).

Given CUDA tensors the wrapper launches the kernel, adds one to
``fused_pfb_demod.launches`` and returns; a C or P beyond the kernel's
limits, a failed build or a failed launch raises.  Given CPU tensors it
returns :func:`fused_pfb_demod_ref`.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import build
from ..channelizer import PolyphaseChannelizer, pfb_twiddles
from ..conditioning import split_iq
from ..demod import _ATAN_COEFFS, _ATAN_COEFFS_FAST, atan2_poly
from .fused_nbfm import _raise_on

__all__ = ["MAX_CHANNELS", "MAX_PHASES", "MAX_FACTOR", "fft_plan",
           "fft_table", "fused_pfb_demod", "fused_pfb_demod_ref"]

MAX_CHANNELS = 256  # csrc/fused_pfb.cu kMaxChannels
MAX_PHASES = 32     # csrc/fused_pfb.cu kMaxPhases
MAX_FACTOR = 16     # the largest FFT factor the kernel plans for


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
    pfb = PolyphaseChannelizer(C, prototype=h.ravel())
    yer, yei, yor, yoi, new_hist = pfb.call_split(
        torch.stack([xi, xq]), hist, dft_dtype=torch.float64)
    zr = yer * yor + yei * yoi
    zj = yei * yor - yer * yoi
    s = atan2_poly(zj, zr, _ATAN_COEFFS if precise else _ATAN_COEFFS_FAST,
                   newton_recip=not precise)
    return torch.where(torch.isnan(s), torch.zeros_like(s), s), new_hist


def fft_plan(C: int) -> tuple[int, int]:
    """The kernel's factorisation C = C1·C2: both factors at most
    :data:`MAX_FACTOR` and as close as possible, C1 <= C2 (8·8 at 64, 3·4
    at 12, 1·p for a prime p <= 16); (C, 1), the direct DFT, where no such
    split exists (a prime above 16, or 200)."""
    for c1 in range(math.isqrt(C), 0, -1):
        if C % c1 == 0 and C // c1 <= MAX_FACTOR:
            return c1, C // c1
    return C, 1


def fft_table(C: int) -> np.ndarray:
    """The kernel's float64 twiddle table [C + C1·RS, 2] (cos, sin): e^{+j2π
    i/C} for i < C (stage factors w_C1^m = entry m·C2, w_C2^m = entry m·C1),
    then the twiddles between the stages, e^{+j2π k1·c2/C} at C + k1·RS + c2
    in the kernel's padded row stride RS = C2 + 1 (C2 > 1; else 1)."""
    C1, C2 = fft_plan(C)
    rs = C2 + 1 if C2 > 1 else 1
    cos, sin = pfb_twiddles(C)
    k1c2 = np.zeros((C1, rs), np.int64)
    k1c2[:, :C2] = np.arange(C1)[:, None] * np.arange(C2)[None, :]
    idx = np.concatenate([np.arange(C), k1c2.ravel()])
    return np.stack([cos[idx], sin[idx]], axis=-1)


@functools.cache
def _table(C: int, device: torch.device) -> torch.Tensor:
    """:func:`fft_table` on ``device``, once per (C, device)."""
    return torch.from_numpy(fft_table(C)).to(device)


def fused_pfb_demod(raw: torch.Tensor, hist: torch.Tensor, h, C: int,
                    precise: bool = False, h_dev: torch.Tensor | None = None):
    """raw: uint8 [2·T] bytes of T complex samples (T % 2C == 0); hist:
    float32 [2, P·C] conditioned samples before them; h: the host
    prototype, P·C taps (float64, rounded to float32 here) → (d [T/(2C), C]
    float32, new_hist [2, P·C]).  ``h_dev``: the float32 [P, C] taps already
    on the card (saves a copy per call)."""
    n, h = _check(raw, hist, h, C)
    if raw.device.type == "cpu":
        return fused_pfb_demod_ref(raw, hist, h, C, precise)
    P = h.shape[0]
    if not 1 <= C <= MAX_CHANNELS or not 1 <= P <= MAX_PHASES:
        raise ValueError(f"the PFB kernel takes 1..{MAX_CHANNELS} channels "
                         f"and 1..{MAX_PHASES} taps per branch, got C = {C}, "
                         f"P = {P}")
    if raw.data_ptr() % 2:
        raise ValueError("raw bytes must be 2-byte aligned")
    dev = raw.device
    if h_dev is None:
        h_dev = torch.from_numpy(h.astype(np.float32)).to(dev)
    if (h_dev.dtype != torch.float32 or h_dev.shape != (P, C)
            or h_dev.device != dev or not h_dev.is_contiguous()):
        raise ValueError(f"h_dev must be contiguous float32 [{P}, {C}] on "
                         f"{dev}")
    hist = hist.contiguous()
    C1, C2 = fft_plan(C)
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
