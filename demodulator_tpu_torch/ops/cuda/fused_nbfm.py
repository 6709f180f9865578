"""Wrappers of the fused NBFM CUDA kernels, beside their plain versions.

Counterpart of ``demodulator_tpu/ops/pallas/fused_nbfm.py``:

* :func:`fused_nbfm` (K1) ↔ ``fused_nbfm_u32_3d`` (``:214``);
* :func:`dma_floor` (K2) ↔ ``dma_floor_u32_3d`` (``:304``);
* :func:`fused_nbfm_cplx` (K3) ↔ ``fused_nbfm_cplx_u32_3d`` (``:253``) and
  ``fused_nbfm_inlpf_u32_3d`` (``:283``);
* :func:`fused_nbfm_q1` (K4) ↔ ``fused_nbfm_q1_twopass_u32_3d`` (``:644``);
* :func:`fused_nbfm_q1_seq` (K5) ↔ ``fused_nbfm_q1_u32_3d`` (``:739``), the
  same function with the blocks chained in order; no path calls it (nor
  its JAX counterpart): K4 is held to it.

The kernels (``csrc/*.cu``) take the raw bytes directly, uint8 ``[B, n]``,
and read them as little-endian 32-bit words, one word per output: no
[rows, 128] lane layout.  The TPU package's flat wrappers
(``fused_nbfm_u32``, ``fused_nbfm``) existed only to avoid TPU relayouts,
so this flat entry covers them.  K1 and K3 cut each row into warp spans
(:func:`span_plan`): a lane loads 4 consecutive words per 16-byte chunk
(:func:`lane_words`) and the spans overlap by the look-ahead their stages
and audio FIR read (:func:`span_halo`).

A wrapper given a CUDA tensor launches its kernel, adds one to its
``launches`` count and returns; a failed build or launch raises.  Given a
CPU tensor it returns its plain PyTorch version (``*_ref``), which does the
kernel's arithmetic in the kernel's order.  Nothing else falls back.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import conditioning as cond_ops
from ..conditioning import condition
from . import build
from ..demod import _ATAN_COEFFS, _ATAN_COEFFS_FAST, atan2_poly

__all__ = ["MAX_TAPS", "MAX_CPLX_TAPS", "Q1_TILE", "Q1_MAX_TILE",
           "SPAN_VECS", "span_halo", "span_plan", "lane_words",
           "fused_nbfm", "fused_nbfm_ref", "dma_floor", "dma_floor_ref",
           "fused_nbfm_cplx", "fused_nbfm_cplx_ref", "fused_nbfm_q1",
           "fused_nbfm_q1_ref", "fused_nbfm_q1_seq", "fused_nbfm_q1_seq_ref",
           "q1_pow_table", "q1_tiles"]

MAX_TAPS = 32  # csrc/nbfm_device.cuh kMaxTaps
MAX_CPLX_TAPS = 32  # csrc/nbfm_device.cuh kMaxCplxTaps
MAX_STAGES = 2  # complex stages in one K3 launch
# step pairs per K4/K5 tile (the block's last tile takes the rest), chosen
# by measurement (ops/cuda/sections.py, PERF.md); csrc/fused_nbfm_q1.cu
# takes 1..Q1_MAX_TILE
Q1_TILE = 2048
Q1_MAX_TILE = 4096  # csrc/fused_nbfm_q1.cu kMaxTile
MAX_BLOCKS = 65535  # the kernels' grid.y
# K1's and K3's 16-byte chunks per lane (csrc/nbfm_span.cuh kVecs),
# chosen by measurement (ops/cuda/sections.py, PERF.md)
SPAN_VECS = 1
SPAN_CHUNK = 128  # words of a chunk: 32 lanes of 4


def span_halo(ntaps: int, stage_taps=()) -> int:
    """Words past its written ones that a K1 or K3 warp span reads: the
    stages' reach in complex samples, Σ (n − 1), halved up to words, plus
    the audio FIR's D = ntaps − 1 (csrc/nbfm_span.cuh ``span_step``)."""
    reach = sum(int(n) - 1 for n in stage_taps)
    return (reach + 1) // 2 + int(ntaps) - 1


def span_plan(words: int, ntaps: int, stage_taps=(),
              vecs: int = SPAN_VECS) -> tuple[int, int]:
    """(step, spans) of K1's and K3's warps over a row of ``words`` words.
    Span j loads words [j·step, j·step + 128·vecs), zero past the row's
    end, and writes [j·step, j·step + step) ∩ the row: its last words only
    feed the look-ahead of the written ones.  The halo is rounded up to
    whole lanes of 4 words, so every span starts 16-byte aligned."""
    halo = -(-span_halo(ntaps, stage_taps) // 4) * 4
    step = SPAN_CHUNK * vecs - halo
    return step, -(-words // step)


def lane_words(lane: int, vecs: int = SPAN_VECS) -> np.ndarray:
    """The words of its span that lane ``lane`` (0..31) loads, one 16-byte
    chunk of 4 consecutive words per 128: it writes those below ``step``."""
    return np.array([SPAN_CHUNK * c + 4 * lane + i for c in range(vecs)
                     for i in range(4)])


def _taps32(taps) -> np.ndarray:
    """float32 roundings of the float64 host taps, as the kernel gets them
    (the JAX kernel rounds the same way: jnp.float32(taps[d]))."""
    t = np.asarray(taps, np.float64).astype(np.float32)
    if t.ndim != 1 or not 1 <= len(t) <= MAX_TAPS:
        raise ValueError(f"need 1..{MAX_TAPS} audio taps, got {t.shape}")
    return t


def _check_raw(raw: torch.Tensor) -> tuple[int, int]:
    if raw.dtype != torch.uint8 or raw.dim() != 2:
        raise ValueError(f"expected uint8 [B, n], got {raw.dtype} "
                         f"{tuple(raw.shape)}")
    B, n = raw.shape
    if B < 1 or n < 4 or n % 4:
        raise ValueError(f"expected B >= 1 blocks of n % 4 == 0 bytes, got "
                         f"{tuple(raw.shape)}")
    if not raw.is_contiguous():
        raise ValueError("raw bytes must be contiguous")
    if raw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {raw.device}")
    return B, n


def _check_aligned(raw: torch.Tensor) -> None:
    """The kernels read 32-bit words."""
    if raw.data_ptr() % 4:
        raise ValueError("raw bytes must be 4-byte aligned")


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check_device(raw: torch.Tensor) -> int:
    """Checks for a launch; returns the block count."""
    B = raw.shape[0]
    if B > MAX_BLOCKS:
        raise ValueError(f"at most {MAX_BLOCKS} blocks per launch, got {B}")
    _check_aligned(raw)
    return B


def _demod_fir_ref(x4: torch.Tensor, t: list, precise: bool) -> torch.Tensor:
    """The kernels' common tail on conditioned words x4 [B, N, 4] (I0, Q0,
    I1, Q1): conjugate product, polynomial atan2, NaN → 0, stationary
    audio FIR with zeros past the block's end."""
    a, b, c, d = x4.unbind(-1)
    zr = a * c + b * d
    zj = b * c - a * d
    coeffs = _ATAN_COEFFS if precise else _ATAN_COEFFS_FAST
    s = atan2_poly(zj, zr, coeffs, newton_recip=not precise)
    s = torch.where(torch.isnan(s), torch.zeros_like(s), s)
    sp = torch.nn.functional.pad(s, (0, len(t) - 1))
    N = x4.shape[1]
    y = t[0] * s
    for k in range(1, len(t)):
        y = y + t[k] * sp[:, k: k + N]
    return y


def fused_nbfm_ref(raw: torch.Tensor, taps, conditioning: str = "shift",
                   precise: bool = True) -> torch.Tensor:
    """Plain version of the kernel: uint8 [B, n] → float32 [B, n/4], on
    ``raw``'s device.  Fast means the 6-term polynomial with an exact
    reciprocal refined by the kernel's Newton step (the kernel starts from
    the hardware estimate)."""
    B, n = _check_raw(raw)
    t = [float(v) for v in _taps32(taps)]
    x = condition(raw.view(B, n // 4, 4), conditioning)
    return _demod_fir_ref(x, t, precise)


def fused_nbfm(raw: torch.Tensor, taps, conditioning: str = "shift",
               precise: bool = True) -> torch.Tensor:
    """uint8 [B, n] raw IQ bytes → float32 [B, n/4] audio: conditioning,
    discriminator and the stationary audio FIR everywhere (the caller
    patches the first H outputs of each block with the float64 head)."""
    B, n = _check_raw(raw)
    t = _taps32(taps)
    if conditioning not in ("shift", "normalize"):
        raise ValueError(f"unknown conditioning {conditioning!r}")
    if raw.device.type == "cpu":
        return fused_nbfm_ref(raw, taps, conditioning, precise)
    _check_device(raw)
    lib = build.load()
    out = torch.empty((B, n // 4), dtype=torch.float32, device=raw.device)
    taps_c = (ctypes.c_float * len(t))(*t.tolist())
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_nbfm_launch(raw.data_ptr(), out.data_ptr(), B, n // 4,
                                   taps_c, len(t), int(bool(precise)),
                                   int(conditioning == "normalize"), stream)
    _raise_on(rc, "fused_nbfm")
    fused_nbfm.launches += 1
    return out


fused_nbfm.launches = 0


def dma_floor_ref(raw: torch.Tensor) -> torch.Tensor:
    """Plain version: the float32 sum of each 32-bit word's four bytes."""
    B, n = _check_raw(raw)
    return raw.view(B, n // 4, 4).to(torch.int32).sum(-1).to(torch.float32)


def dma_floor(raw: torch.Tensor) -> torch.Tensor:
    """uint8 [B, n] → float32 [B, n/4] with fused_nbfm's memory traffic and
    almost no arithmetic: the measured floor fused_nbfm is reported
    against."""
    B, n = _check_raw(raw)
    if raw.device.type == "cpu":
        return dma_floor_ref(raw)
    _check_aligned(raw)
    lib = build.load()
    out = torch.empty((B, n // 4), dtype=torch.float32, device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dma_floor_launch(raw.data_ptr(), out.data_ptr(),
                                  B * (n // 4), stream)
    _raise_on(rc, "dma_floor")
    dma_floor.launches += 1
    return out


dma_floor.launches = 0


def _stages32(stages) -> list:
    """[(taps float32, (ci, cq) float32), ...] with the kernel's bounds."""
    if not 1 <= len(stages) <= MAX_STAGES:
        raise ValueError(f"need 1..{MAX_STAGES} complex stages, got "
                         f"{len(stages)}")
    out = []
    for taps, c_int in stages:
        t = np.asarray(taps, np.float64).astype(np.float32)
        c = np.asarray(c_int, np.float64).astype(np.float32)
        if t.ndim != 1 or not 1 <= len(t) <= MAX_CPLX_TAPS or c.shape != (2,):
            raise ValueError(f"need 1..{MAX_CPLX_TAPS} complex taps and an "
                             f"(I, Q) constant, got {t.shape}, {c.shape}")
        out.append((t, c))
    return out


def fused_nbfm_cplx_ref(raw: torch.Tensor, stages, taps,
                        conditioning: str = "shift",
                        precise: bool = True) -> torch.Tensor:
    """Plain version of K3: uint8 [B, n] → float32 [B, n/4].  Each stage
    is z'_s = c + Σ_k t[k]·z_{s+k} over complex samples s, started from the
    constant and summed in tap order as the kernel sums, with its input
    zero past the block's end (so a second stage reads zeros, not c, there)."""
    B, n = _check_raw(raw)
    t = [float(v) for v in _taps32(taps)]
    x = condition(raw.view(B, n // 2, 2), conditioning)      # [B, S, 2]
    S = n // 2
    for st, c in _stages32(stages):
        xp = torch.nn.functional.pad(x, (0, 0, 0, len(st) - 1))
        y = torch.tensor(c, device=x.device) + float(st[0]) * x
        for k in range(1, len(st)):
            y = y + float(st[k]) * xp[:, k: k + S]
        x = y
    return _demod_fir_ref(x.reshape(B, n // 4, 4), t, precise)


def fused_nbfm_cplx(raw: torch.Tensor, stages, taps,
                    conditioning: str = "shift",
                    precise: bool = True) -> torch.Tensor:
    """uint8 [B, n] → float32 [B, n/4]: K1 with one or two stationary
    complex FIR stages between conditioning and the discriminator.
    ``stages``: ((taps, (c_i, c_q)), ...) in application order (-L or
    -q 2: one; -q 2 -L: the DC block, then the input lowpass).  The caller
    patches the head (and, two-stage, tail) outputs in float64."""
    B, n = _check_raw(raw)
    t = _taps32(taps)
    st = _stages32(stages)
    if conditioning not in ("shift", "normalize"):
        raise ValueError(f"unknown conditioning {conditioning!r}")
    if raw.device.type == "cpu":
        return fused_nbfm_cplx_ref(raw, stages, taps, conditioning, precise)
    _check_device(raw)
    lib = build.load()
    out = torch.empty((B, n // 4), dtype=torch.float32, device=raw.device)
    taps_c = (ctypes.c_float * len(t))(*t.tolist())
    stage_taps = np.zeros((MAX_STAGES, MAX_CPLX_TAPS), np.float32)
    stage_n = (ctypes.c_int * MAX_STAGES)()
    stage_c = np.zeros((MAX_STAGES, 2), np.float32)
    for i, (s, c) in enumerate(st):
        stage_taps[i, : len(s)] = s
        stage_n[i] = len(s)
        stage_c[i] = c
    st_c = (ctypes.c_float * stage_taps.size)(*stage_taps.ravel().tolist())
    sc_c = (ctypes.c_float * stage_c.size)(*stage_c.ravel().tolist())
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_nbfm_cplx_launch(
            raw.data_ptr(), out.data_ptr(), B, n // 4, taps_c, len(t), st_c,
            stage_n, sc_c, len(st), int(bool(precise)),
            int(conditioning == "normalize"), stream)
    _raise_on(rc, "fused_nbfm_cplx")
    fused_nbfm_cplx.launches += 1
    return out


fused_nbfm_cplx.launches = 0


def _check_q1(raw: torch.Tensor, off_in: torch.Tensor) -> tuple[int, int]:
    B, n = _check_raw(raw)
    if n % 8:
        raise ValueError(f"correctIq needs whole front and mirror words: "
                         f"n % 8 == 0, got n = {n}")
    if (off_in.dtype != torch.float32 or off_in.shape != (2,)
            or off_in.device != raw.device):
        raise ValueError(f"off_in must be float32 [2] on {raw.device}, got "
                         f"{off_in.dtype} {tuple(off_in.shape)} on "
                         f"{off_in.device}")
    return B, n


def fused_nbfm_q1_ref(raw: torch.Tensor, off_in: torch.Tensor, taps,
                      esr: float, precise: bool = True):
    """Plain version of K4: what ``fused_nbfm_q1_twopass_u32_3d`` computes.
    Pass 1, each block's summary at zero offset; the exclusive prefix over
    the blocks from ``off_in``; pass 2, correctIq from each block's
    entering offset, then the kernels' discriminator and audio FIR.
    → (audio [B, n/4], off_entering [B, 2], off_final [2])."""
    B, n = _check_q1(raw, off_in)
    t = [float(v) for v in _taps32(taps)]
    a = cond_ops.decay_of(esr)
    _, b_tot = cond_ops.correct_iq_zero(raw, esr)
    a_blk = torch.tensor(float(np.float32(a ** (n // 4))), device=raw.device)
    off_before, (A, b) = cond_ops.correct_iq_block_prefix(a_blk, b_tot,
                                                          off_in)
    cond, _ = cond_ops.correct_iq(raw, off_before, esr)
    audio = _demod_fir_ref(cond.view(B, n // 4, 4), t, precise)
    return audio, off_before, A * off_in + b


def q1_tiles(B: int, n: int, tile: int = Q1_TILE) -> int:
    """K4's and K5's tiles: ceil(n/8 / tile) per block of n bytes."""
    return B * -(-(n // 8) // tile)


def q1_pow_table(esr: float, tile: int = Q1_TILE) -> np.ndarray:
    """float32(q^m) for m < tile + MAX_TAPS, q = decay², each power taken
    in float64 and rounded once: every power K4's and K5's scans and
    look-back meet (csrc/fused_nbfm_q1.cu)."""
    d = cond_ops.decay_of(esr)
    q = d * d
    return np.array([q ** m for m in range(tile + MAX_TAPS)],
                    np.float64).astype(np.float32)


@functools.cache
def _pow_table(esr: float, tile: int, device: torch.device) -> torch.Tensor:
    """:func:`q1_pow_table` on ``device``, once per (esr, tile, device)."""
    return torch.from_numpy(q1_pow_table(esr, tile)).to(device)


def _q1_launch_args(raw: torch.Tensor, off_in: torch.Tensor, esr: float,
                    tile: int) -> tuple:
    """(off_in, pow_table, tiles) of a K4 or K5 launch with tiles of
    ``tile`` (1..Q1_MAX_TILE) step pairs."""
    _check_aligned(raw)
    B, n = raw.shape
    return (off_in.contiguous(),
            _pow_table(float(np.float32(esr)), tile, raw.device),
            q1_tiles(B, n, tile))


def fused_nbfm_q1(raw: torch.Tensor, off_in: torch.Tensor, taps,
                  esr: float, precise: bool = True):
    """uint8 [B, n] raw bytes of consecutive blocks, off_in float32 [2]
    (the tracker state entering block 0) → (audio [B, n/4], off_entering
    [B, 2], off_final [2]): correctIq chained through the blocks, the
    discriminator and the stationary audio FIR.  The caller patches the
    first H outputs of each block in float64 from off_entering."""
    B, n = _check_q1(raw, off_in)
    t = _taps32(taps)
    if raw.device.type == "cpu":
        return fused_nbfm_q1_ref(raw, off_in, taps, esr, precise)
    off_in, table, tiles = _q1_launch_args(raw, off_in, esr, Q1_TILE)
    lib = build.load()
    dev = raw.device
    audio = torch.empty((B, n // 4), dtype=torch.float32, device=dev)
    off_entering = torch.empty((B, 2), dtype=torch.float32, device=dev)
    off_final = torch.empty((2,), dtype=torch.float32, device=dev)
    # the ticket counter and the published maps of each tile and block and
    # each block's prefix: every bit set (unpublished) before every launch
    sync = torch.full((2 + 2 * (tiles + 2 * B),), -1, dtype=torch.int32,
                      device=dev)
    taps_c = (ctypes.c_float * len(t))(*t.tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_nbfm_q1_launch(
            raw.data_ptr(), audio.data_ptr(), off_in.data_ptr(),
            off_entering.data_ptr(), off_final.data_ptr(), sync.data_ptr(),
            table.data_ptr(), tiles, B, n // 4, Q1_TILE, taps_c, len(t),
            float(np.float32(esr)), cond_ops.decay_of(esr), _a_words(esr, n),
            int(bool(precise)), stream)
    _raise_on(rc, "fused_nbfm_q1")
    fused_nbfm_q1.launches += 1
    return audio, off_entering, off_final


fused_nbfm_q1.launches = 0


def _a_words(esr: float, n: int) -> float:
    """float32 of decay^(n/4), one float64 power rounded (``_q1_kernel``'s
    ``a_n``): the per-block factor of the block chain."""
    return float(np.float32(cond_ops.decay_of(esr) ** (n // 4)))


def fused_nbfm_q1_seq_ref(raw: torch.Tensor, off_in: torch.Tensor, taps,
                          esr: float, precise: bool = True):
    """Plain version of K5: the blocks chained in a loop, each block's
    summary at zero offset composed as off' = a^(n/4)·off + tot, then
    correctIq from each block's entering offset, the discriminator and the
    audio FIR.  → (audio [B, n/4], off_entering [B, 2], off_final [2])."""
    B, n = _check_q1(raw, off_in)
    t = [float(v) for v in _taps32(taps)]
    a_n = _a_words(esr, n)
    off, offs, conds = off_in, [], []
    for b in range(B):
        _, tot = cond_ops.correct_iq_zero(raw[b], esr)
        cond, _ = cond_ops.correct_iq(raw[b], off, esr)
        offs.append(off)
        conds.append(cond)
        off = a_n * off + tot
    audio = _demod_fir_ref(torch.stack(conds).view(B, n // 4, 4), t, precise)
    return audio, torch.stack(offs), off


def fused_nbfm_q1_seq(raw: torch.Tensor, off_in: torch.Tensor, taps,
                      esr: float, precise: bool = True):
    """K4's function with the blocks chained in block order in one launch
    (a chained look-back over an atomic ticket, csrc/fused_nbfm_q1.cu):
    uint8 [B, n], off_in float32 [2] → (audio [B, n/4], off_entering
    [B, 2], off_final [2])."""
    B, n = _check_q1(raw, off_in)
    t = _taps32(taps)
    if raw.device.type == "cpu":
        return fused_nbfm_q1_seq_ref(raw, off_in, taps, esr, precise)
    off_in, table, tiles = _q1_launch_args(raw, off_in, esr, Q1_TILE)
    lib = build.load()
    dev = raw.device
    audio = torch.empty((B, n // 4), dtype=torch.float32, device=dev)
    off_entering = torch.empty((B, 2), dtype=torch.float32, device=dev)
    off_final = torch.empty((2,), dtype=torch.float32, device=dev)
    # ticket counter, tile flags, block flags: zeroed before every launch
    sync = torch.zeros((1 + tiles + B,), dtype=torch.int32, device=dev)
    tile_b = torch.empty((tiles, 2), dtype=torch.float32, device=dev)
    taps_c = (ctypes.c_float * len(t))(*t.tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_nbfm_q1_seq_launch(
            raw.data_ptr(), audio.data_ptr(), off_in.data_ptr(),
            off_entering.data_ptr(), off_final.data_ptr(), sync.data_ptr(),
            tile_b.data_ptr(), table.data_ptr(), tiles, B, n // 4, Q1_TILE,
            taps_c, len(t), float(np.float32(esr)), cond_ops.decay_of(esr),
            _a_words(esr, n), int(bool(precise)), stream)
    _raise_on(rc, "fused_nbfm_q1_seq")
    fused_nbfm_q1_seq.launches += 1
    return audio, off_entering, off_final


fused_nbfm_q1_seq.launches = 0
