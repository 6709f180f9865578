"""The least time the card could take for a piece of work: the roofline.

One copy of the peaks and the operation counts that ``chip_smoke.py``
(the kernels' bounds) and ``demodulator_tpu_torch.bench`` (each row's
bound) both use.  A bound is the larger of two times: the bytes the work
must move (each input byte read once, each output byte written once) over
the card's memory rate, and the float32 operations it does over the
card's float32 rate outside the tensor cores.  Computed from shapes, so it
holds on any host; only a time measured on the card is set against it.
"""
from __future__ import annotations

import math

__all__ = ["PEAK_BYTES", "PEAK_FP32", "L2_BYTES", "CORRECT_IQ_OPS",
           "demod_ops", "stage_ops", "pfb_ops", "bound"]

# The data sheet's peaks of one H100 SXM at its 700 W limit: HBM3 bytes/s
# and float32 operations/s outside the tensor cores; and its L2 cache,
# below which a working set may be served from L2 rather than HBM.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
L2_BYTES = 50e6

# Operations per output word (4 input bytes, 2 complex samples) of the
# NBFM kernels: conditioning of 4 bytes (8), the conjugate product (6),
# atan2 (abs x2, max, min, division, z*z, Horner 2 per term after the
# first, z*z2*p and the add, 3 quadrant fixups: 26 precise, 20 fast),
# NaN -> 0 (1), the audio FIR (2 per tap - 1).  A complex FIR stage adds
# 2·(4·taps + 2) per word (2 complex samples, both lanes, the constant),
# correctIq 12 (4 offset subtractions and the two steps' recurrence on
# both lanes).
CORRECT_IQ_OPS = 12


def demod_ops(precise: bool, ntaps: int) -> int:
    """Operations per output word of K1: conditioning, discriminator and
    an audio FIR of ``ntaps`` taps."""
    return 8 + 6 + (26 if precise else 20) + 1 + 2 * ntaps - 1


def stage_ops(ntaps: int) -> int:
    """Operations per output word of one complex FIR stage of ``ntaps``
    taps (K3)."""
    return 2 * (4 * ntaps + 2)


def pfb_ops(n: int, C: int, P: int) -> float:
    """Operations of K6 on ``n`` complex samples: per sample 4·P for the
    P-tap branch filter (both lanes) and 5·log2 C for the C-point DFT as an
    FFT, and per output (n/2) 6 + 20 + 1 for the fast discriminator."""
    return n * (4 * P + 5 * math.log2(C)) + n / 2 * 27


def bound(nbytes: float, ops: float | None) -> tuple[float, str]:
    """(least time in ms, what bounds it: "bytes" or "operations") of work
    that moves ``nbytes`` and does ``ops`` float32 operations (None: no
    kernel, the bytes alone)."""
    t_b, t_o = nbytes / PEAK_BYTES, (ops or 0) / PEAK_FP32
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"
