"""The bars a kernel's output is held to against its plain version's, and
the comparisons they are read from.

One copy for ``chip_smoke.py`` (phase 3 and the main path) and the rows of
``demodulator_tpu_torch.bench``: the float32 chains above 110 dB (their
precise kernels bit-equal), the correctIq offsets within 1e-3, the PFB's
discriminator output angle-wrapped within 0.01 rad and above 80 dB.
"""
from __future__ import annotations

import math

import torch

__all__ = ["BAR_KERNEL_DB", "BAR_OFFSET", "BAR_BANK_DB", "BAR_ANGLE",
           "snr_db", "max_err", "wrapped"]

BAR_KERNEL_DB = 110.0    # fused chains vs their twins (tests/test_fused.py)
BAR_OFFSET = 1e-3        # correctIq offsets (tests/test_fused.py:209-210)
BAR_BANK_DB = 80.0       # the PFB front (tests/test_fused_pfb.py:55)
BAR_ANGLE = 0.01         # rad, angle-wrapped (tests/test_fused_pfb.py:52)


def snr_db(want: torch.Tensor, got: torch.Tensor) -> float:
    """SNR in dB of ``got`` against ``want``: inf where they are equal
    (or empty), -inf where ``want`` is zero and ``got`` is not."""
    if want.numel() == 0:
        return math.inf
    w, g = want.double(), got.double()
    err = float(((w - g) ** 2).mean())
    power = float((w ** 2).mean())
    if err == 0:
        return math.inf
    return -math.inf if power == 0 else 10 * math.log10(power / err)


def max_err(want: torch.Tensor, got: torch.Tensor) -> float:
    if want.numel() == 0:
        return 0.0
    return float((want.double() - got.double()).abs().max())


def wrapped(want: torch.Tensor, got: torch.Tensor) -> tuple:
    """(max |err|, SNR dB) of the angle-wrapped difference (a discriminator
    output near ±pi may land on either side)."""
    w, g = want.double(), got.double()
    e = torch.remainder(g - w + math.pi, 2 * math.pi) - math.pi
    p = float((w ** 2).mean())
    m = float((e ** 2).mean())
    return float(e.abs().max()), math.inf if m == 0 else 10 * math.log10(p / m)
