"""Throughput benchmark of the port: the headline line, the hot-config
matrix and the end-to-end rows.

Counterpart of the root ``bench.py`` (the JAX package's benchmark)::

    python -m demodulator_tpu_torch.bench [--matrix] [--rows a,b]
        [--out PATH] [--device cuda|cpu]

By default it prints ONE JSON line on stdout, the headline: complex IQ
Msamples/s of the main path's block step, ``BlockPipeline.fused_call`` with
``--fast-atan2`` (K1 and its float64 head patch) on 256 device-resident
blocks of 256 KiB, under the metric ``nbfm_demod_iq_throughput_per_gpu``,
with the card's name and power limit.  ``--matrix`` measures every row of
:data:`MATRIX` (the JAX bench's hot configurations, one builder each, at
its default sizes) and the end-to-end rows of :data:`E2E`, prints a line
per row as it is measured, rewrites ``--out`` (default
``BENCH_MATRIX_H100.json``) after each, and prints the headline last.
``--rows a,b`` measures the named rows (and the headline) and keeps every
other row of the prior ``--out`` file; a row with no prior entry gets a
``"skipped"`` placeholder.

Timing.  A row's step runs N times inside ONE CUDA graph
(``runtime.graphs.CapturedStep``): each step's input is the previous
step's output bytes (the uint8 view of its audio: the same memory, no
copy), or, in the state-carried rows (WBFM, the banks, ``-q 1``), the
state stays in the graph's static buffers and the input is a slice of a
fixed base that rotates by 997 samples a step.  Graphs of N_lo and N_hi
steps (JAX's lengths: 20/120, 10/60 for the float64 and sharded rows) are
each replayed ``reps`` times between two CUDA events; the step time is the
slope between the two lengths' minima, so the fixed cost of a replay
cancels.  The sharded row replays the per-position captures of
``ShardedPipeline.capture`` N times from the host instead (a graph holds
one card's work), on a chunk placed once: its slope is the larger of the
device time and the host's time to launch a step.  The end-to-end rows
time whole stream runs with the host clock, one warm-up then the best of
3, on a file in ``$TMPDIR`` (in the page cache: written just before).

Correctness.  Before it is timed each row checks what it times, three
ways (``tools/bars.py``).  ``kernel``: a row with a kernel holds that
kernel, on the row's input and shape, against its plain PyTorch version
under ``chip_smoke.py`` phase 3's bar: precise K1 and K3 bit-equal; fast
K1 and K3, and K4, above 110 dB (K4's offsets within 1e-3); K6 within
0.01 rad angle-wrapped, above 80 dB, its history bit-equal; K2 equal.
``step``: an NBFM row's whole first step (the kernel and its float64
patches, ``fused_call``) against the plain chain's step
(``BlockPipeline.plain_call``) on the same card, above 110 dB, the carried
offset within 1e-3; every row's first output finite.  ``replay``: one
replay of the timed graph of N_lo chained steps, from the row's first
state, against the same N_lo steps run eagerly, above 110 dB on every
output and state tensor (equal where the kernels are deterministic; a
chained row's steps feed on the bytes before them, so any difference
there leaves no dB to speak of).  The NBFM rows' input is an FM tone plus
noise from the row's seed (a kernel's time does not depend on the bytes;
on uniform noise the discriminator flips between +pi and -pi on a
last-bit difference, which no dB bar survives).  An end-to-end row checks
its output's length, its finiteness and its kernel's launches.  A row
records ``"correct"``, true when each of its checks holds.

Roofline (``tools/roofline.py``): the step's least traffic (each input
byte read once, each output byte written once), its float32 operations
where it runs a kernel, the bound (the larger of bytes over 3.35 TB/s and
operations over 67 TFLOP/s, and which of the two), ``achieved_frac`` =
bound / step time, and ``fits_l2`` (the traffic fits the 50 MB L2, so the
rate may be L2's, not HBM's).  A row whose ``achieved_frac`` exceeds 1.05
has a wrong count or a wrong window.  The end-to-end rows, timed by the
host clock, have no device bound: their ``bound_ms``, ``bound_by`` and
``achieved_frac`` are null, and ``e2e_frac_of_link`` is their measure.

A row that raises is written with its ``error``, one whose check fails
with ``"correct": false``; the other rows still run, and the exit code is
then 1.  Without a card and without ``--device cpu`` it exits 2 and prints
nothing: nothing falls back to the CPU.  ``--device cpu`` rehearses the
bench at each builder's smallest size (2 blocks, 2 a time position, 2-4
end-to-end blocks, loop lengths 1 and 2, one rep); its rows say
``"device": "cpu"``, its headline is ``nbfm_demod_iq_throughput_cpu_
rehearsal``, no ``achieved_frac`` is computed, and it writes a file only
to an explicit ``--out`` (never one named ``BENCH_MATRIX_H100.json``).

Not ported: JAX's ``e2e_stream_q0_xla`` row (its ``--backend xla``; the
port's counterpart is ``--device``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .config import DemodConfig
from .models.channel_bank import ChannelBankConfig, ChannelBankPipeline
from .models.nbfm import BlockPipeline
from .models.wbfm import WbfmConfig, WbfmPipeline
from .ops.cuda.fused_nbfm import (dma_floor, dma_floor_ref, fused_nbfm,
                                  fused_nbfm_cplx, fused_nbfm_cplx_ref,
                                  fused_nbfm_q1, fused_nbfm_q1_ref,
                                  fused_nbfm_ref)
from .ops.cuda.fused_pfb import fused_pfb_demod, fused_pfb_demod_ref
from .parallel.mesh import make_demod_mesh
from .parallel.sharding import ShardedPipeline
from .runtime.checkpoint import tree_map
from .runtime.graphs import CapturedStep, _counters
from .runtime.stream import (BankStreamProcessor, StreamProcessor,
                             WbfmStreamProcessor)
from .tools import card
from .tools.bars import (BAR_ANGLE, BAR_BANK_DB, BAR_KERNEL_DB, BAR_OFFSET,
                         max_err, snr_db, wrapped)
from .tools.roofline import (CORRECT_IQ_OPS, L2_BYTES, bound, demod_ops,
                             pfb_ops, stage_ops)

__all__ = ["Row", "Sizes", "MATRIX", "E2E", "FULL", "REHEARSAL",
           "memcpy_floor", "flagship", "inlpf", "q1", "f64", "wbfm", "bank",
           "sharded", "main"]

HEADLINE = "nbfm_demod_iq_throughput_per_gpu"
HEADLINE_CPU = "nbfm_demod_iq_throughput_cpu_rehearsal"
DEFAULT_OUT = "BENCH_MATRIX_H100.json"
BASELINE_SPS = 192000.0   # the reference's demonstrated real-time rate
BLOCK = 262144            # bytes per NBFM block (config.DEFAULT_BUF_SIZE)
BAR_FRAC = 1.05           # an achieved_frac above it is a fault


class Sizes(NamedTuple):
    """A run's sizes: blocks of the NBFM rows and of the float64 row, blocks
    a time position of the sharded row, loop lengths (long rows, short
    rows), reps, blocks of each end-to-end row, its timed runs."""
    B: int
    f64_B: int
    shard_blocks: int
    lengths: tuple
    short_lengths: tuple
    reps: int
    e2e_blocks: dict
    e2e_reps: int


# the JAX bench's sizes (bench.py:91-310, :556-563, :588-620)
FULL = Sizes(256, 64, 128, (20, 120), (10, 60), 4,
             {"e2e_stream_q0": 96, "e2e_stream_wbfm": 24,
              "e2e_bank4_pfb": 12}, 3)
REHEARSAL = Sizes(2, 2, 2, (1, 2), (1, 2), 1,
                  {"e2e_stream_q0": 4, "e2e_stream_wbfm": 2,
                   "e2e_bank4_pfb": 4}, 1)


@dataclasses.dataclass
class Row:
    """One matrix row, built on its device.

    ``step(state, x, k) -> (state, out)`` is the row's step k on the input
    ``x``; ``feed(out, x)`` the next step's input (the output's bytes, or
    ``x`` itself where the step slices a fixed base).  ``check()`` holds
    the row's kernel against its plain version on ``x`` → a dict with
    ``correct``; None where the row runs no kernel, as ``ops``.
    ``plain(state, x) -> (state, out)``, where set, is the plain chain's
    whole step the first step is held to.  ``call``, where set, replaces
    the graph of chained steps with host-launched replays of a step
    captured elsewhere (the sharded row), and ``eager()`` is that step run
    eagerly."""
    step: Callable
    feed: Callable
    state: Any
    x: Any
    iq_per_step: int
    traffic: int
    ops: float | None
    check: Callable[[], dict] | None
    note: str = ""
    extra: dict = dataclasses.field(default_factory=dict)
    plain: Callable | None = None
    call: Callable | None = None
    eager: Callable | None = None
    devices: tuple = ()


# ---------------------------------------------------------------------------
# inputs and checks
# ---------------------------------------------------------------------------

def tone_blocks(B: int, n: int, seed: int) -> np.ndarray:
    """uint8 IQ [B, n]: one block of a 1 kHz FM tone at 2.5 kHz deviation
    (fs 192 kHz) plus noise from ``default_rng(seed)``, built as the tests'
    ``iq_data``, repeated over the B blocks."""
    rng = np.random.default_rng(seed)
    t = np.arange(n // 2) / 192000.0
    phase = 2 * np.pi * np.cumsum(2500.0 * np.sin(2 * np.pi * 1000.0 * t)) \
        / 192000.0
    iq = np.exp(1j * phase) * 80
    iq += (rng.standard_normal(n // 2) + 1j * rng.standard_normal(n // 2)) * 4
    blk = np.empty(n, dtype=np.uint8)
    blk[0::2] = np.clip(np.round(iq.real + 127.4), 0, 255)
    blk[1::2] = np.clip(np.round(iq.imag + 127.4), 0, 255)
    return np.tile(blk, (B, 1))


def _uniform(shape, seed: int, dtype=np.uint8) -> np.ndarray:
    high = 1 << (8 * np.dtype(dtype).itemsize)
    return np.random.default_rng(seed).integers(0, high, size=shape,
                                                dtype=dtype)


def _as_input(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The first ``x.numel()`` bytes of ``out`` as a tensor of ``x``'s
    shape: a view, never a copy (a copy of the batch per step would be
    timed with the step)."""
    if not out.is_contiguous():
        raise RuntimeError("a step's output is not contiguous: feeding it "
                           "back would copy it")
    return out.view(-1).view(torch.uint8)[: x.numel()].view(x.shape)


def _keep(out, x):
    return x


def _flat(tree) -> list:
    """The tensors of a state or an output, in order (a dict's by key)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flat(v)]
    return []


def _finite(out) -> bool:
    return all(bool(torch.isfinite(o).all()) for o in _flat(out))


def _vs_plain(kernel: str, got: torch.Tensor, want: torch.Tensor,
              exact: bool) -> dict:
    """A kernel's output against its plain version's: equal (``exact``)
    or above 110 dB."""
    snr = snr_db(want, got)
    if exact:
        return {"kernel": kernel, "bar": "equal", "snr_db": snr,
                "max_abs_err": max_err(want, got),
                "correct": bool(torch.equal(got, want))}
    return {"kernel": kernel, "bar": f"> {BAR_KERNEL_DB:g} dB",
            "snr_db": snr, "max_abs_err": max_err(want, got),
            "correct": snr > BAR_KERNEL_DB}


def _vs_step(got, want) -> dict:
    """A whole step's (state, out) against the plain chain's: the output
    above 110 dB, the carried state (the -q 1 offset) within 1e-3."""
    (s_got, got), (s_want, want) = got, want
    pairs = list(zip(_flat(want), _flat(got)))
    snr = min(snr_db(w, g) for w, g in pairs)
    d = max((max_err(w, g) for w, g in zip(_flat(s_want), _flat(s_got))),
            default=0.0)
    return {"bar": f"> {BAR_KERNEL_DB:g} dB, state within {BAR_OFFSET:g}",
            "snr_db": snr, "max_abs_err": max(max_err(w, g)
                                              for w, g in pairs),
            "state_max_abs_err": d,
            "correct": snr > BAR_KERNEL_DB and d < BAR_OFFSET}


def _vs_eager(got, want) -> dict:
    """A replay's (state, out) against the same steps run eagerly: every
    tensor of the same shape and above 110 dB."""
    g, w = _flat(got), _flat(want)
    same = len(g) == len(w) and all(a.shape == b.shape for a, b in zip(g, w))
    equal = same and all(torch.equal(a, b) for a, b in zip(g, w))
    snr = min((snr_db(b, a) for a, b in zip(g, w)), default=math.inf) \
        if same else -math.inf
    return {"bar": f"> {BAR_KERNEL_DB:g} dB on every tensor",
            "tensors": len(g), "equal": equal, "snr_db": snr,
            "correct": equal or snr > BAR_KERNEL_DB}


def _first_step(row: Row):
    """The row's first step on a copy of its state → (state, output)."""
    if row.call is not None:
        return row.call()
    return row.step(tree_map(torch.clone, row.state), row.x, 0)


def _nbfm_cfg(q: int = 0, lowpass_in: bool = False) -> DemodConfig:
    kw = dict(sample_rate=192000.0, lowpass_out=12500.0, mode=0x10 | (q << 2))
    if lowpass_in:
        kw["lowpass_in"] = 12500.0
    return DemodConfig(**kw)


def _fused_step(pipe: BlockPipeline):
    return lambda state, x, k: pipe.fused_call(state, x)


# ---------------------------------------------------------------------------
# the matrix's builders (the JAX bench's, bench.py:91-327)
# ---------------------------------------------------------------------------

def memcpy_floor(dev, B: int = 256) -> Row:
    """K2 at the flagship's shapes: the measured memory floor the fused
    rows are set against (``frac_of_measured_memcpy``)."""
    n = BLOCK
    x = torch.from_numpy(_uniform((B, n), 8)).to(dev)
    return Row(step=lambda state, x, k: (state, dma_floor(x)),
               feed=_as_input, state=(), x=x, iq_per_step=B * n // 2,
               traffic=2 * B * n, ops=4 * (B * n // 4),
               check=lambda: _vs_plain("dma_floor", dma_floor(x),
                                       dma_floor_ref(x), exact=True))


def flagship(dev, fast_atan2: bool, q: int = 0, B: int = 256) -> Row:
    """K1 (q0 shiftOrigin, q3 normalizeInput) and its float64 head patch:
    ``fused_call``."""
    pipe = BlockPipeline(_nbfm_cfg(q), fast_atan2=fast_atan2, device=dev)
    n, taps, cond = pipe.cfg.buf_size, pipe.out_fir.host_taps, \
        pipe.conditioning
    x = torch.from_numpy(tone_blocks(B, n, 0)).to(dev)
    precise = not fast_atan2
    return Row(step=_fused_step(pipe), feed=_as_input,
               state=pipe.init_state(), x=x, iq_per_step=B * n // 2,
               traffic=2 * B * n,
               ops=demod_ops(precise, len(taps)) * (B * n // 4),
               check=lambda: _vs_plain(
                   "fused_nbfm", fused_nbfm(x, taps, cond, precise),
                   fused_nbfm_ref(x, taps, cond, precise), exact=precise),
               plain=pipe.plain_call)


def inlpf(dev, q: int = 0, lowpass_in: bool = True, B: int = 256) -> Row:
    """K3 with one complex stage (-L, -q 2) or two (-q 2 -L), fast."""
    pipe = BlockPipeline(_nbfm_cfg(q, lowpass_in), fast_atan2=True,
                         device=dev)
    n, taps, cond = pipe.cfg.buf_size, pipe.out_fir.host_taps, \
        pipe.conditioning
    stages = pipe.stage_consts()
    x = torch.from_numpy(tone_blocks(B, n, 1)).to(dev)
    ops = demod_ops(False, len(taps)) + sum(stage_ops(len(t))
                                            for t, _ in stages)
    return Row(step=_fused_step(pipe), feed=_as_input,
               state=pipe.init_state(), x=x, iq_per_step=B * n // 2,
               traffic=2 * B * n, ops=ops * (B * n // 4),
               check=lambda: _vs_plain(
                   "fused_nbfm_cplx",
                   fused_nbfm_cplx(x, stages, taps, cond, False),
                   fused_nbfm_cplx_ref(x, stages, taps, cond, False),
                   exact=False),
               plain=pipe.plain_call, extra={"stages": len(stages)})


def q1(dev, B: int = 256) -> Row:
    """K4 (-q 1, correctIq chained through the blocks), fast: the offset
    is the carried state."""
    pipe = BlockPipeline(_nbfm_cfg(1), fast_atan2=True, device=dev)
    n, taps, esr = pipe.cfg.buf_size, pipe.out_fir.host_taps, float(pipe.esr)
    x = torch.from_numpy(tone_blocks(B, n, 2)).to(dev)

    def check():
        off = torch.zeros(2, dtype=torch.float32, device=x.device)
        got = fused_nbfm_q1(x, off, taps, esr, False)
        want = fused_nbfm_q1_ref(x, off, taps, esr, False)
        res = _vs_plain("fused_nbfm_q1", got[0], want[0], exact=False)
        d = max(max_err(want[1], got[1]), max_err(want[2], got[2]))
        res.update(offsets_max_abs_err=d,
                   correct=res["correct"] and d < BAR_OFFSET)
        return res
    return Row(step=_fused_step(pipe), feed=_as_input,
               state=pipe.init_state(), x=x, iq_per_step=B * n // 2,
               traffic=2 * B * n,
               ops=(demod_ops(False, len(taps)) + CORRECT_IQ_OPS)
               * (B * n // 4), check=check, plain=pipe.plain_call,
               note="traffic counts the input once (2·B·n); the JAX bench "
                    "counts it twice, 3·B·n, for its two-pass kernel")


def f64(dev, B: int = 64) -> Row:
    """The float64 chain (the reference's -DSET_PRECISION build): torch
    ops, no kernel, float64 audio (2n bytes a block) out."""
    pipe = BlockPipeline(DemodConfig(sample_rate=192000.0,
                                     lowpass_out=12500.0,
                                     precision="float64"), device=dev)
    n = pipe.cfg.buf_size
    x = torch.from_numpy(tone_blocks(B, n, 3)).to(dev)
    return Row(step=lambda state, x, k: pipe(state, x), feed=_as_input,
               state=pipe.init_state(), x=x, iq_per_step=B * n // 2,
               traffic=3 * B * n, ops=None, check=None)


def _slice_step(call, T: int):
    """Step k of a state-carried row on its base of 2·T samples: ``call``
    on the T samples from (997·k) mod T."""
    def step(state, base, k):
        o = (k * 997) % T
        return call(state, base[o: o + T])
    return step


def wbfm(dev) -> Row:
    """The WBFM receiver at 2.4 Msps (torch ops and float32
    ``torch.matmul``), one block a step, its histories carried."""
    pipe = WbfmPipeline(WbfmConfig(), device=dev)
    T = pipe.block_complex
    base = torch.from_numpy(_uniform(2 * T, 4, np.uint16)).to(dev)
    return Row(step=_slice_step(pipe.call_u16, T), feed=_keep,
               state=pipe.init_state(), x=base, iq_per_step=T,
               traffic=2 * T + 4 * pipe.audio_per_block, ops=None,
               check=None,
               note="traffic is the bytes in and the audio out; the JAX "
                    "bench counts the channel filter's quad-rate output "
                    "(4·T·L/M) as the output")


def bank(dev, n_chan: int = 8, on_grid: bool = False) -> Row:
    """The channel bank at n_chan × 192 kHz, one 0.25 s block a step (0.01
    s on the CPU), its state carried: half-channel offsets take the mixer
    (torch ops), grid offsets the PFB (K6, then the audio FIR)."""
    fs = n_chan * 192000.0
    half = 0.0 if on_grid else 0.5
    offs = tuple((c - n_chan / 2 + half) * 192000.0 for c in range(n_chan))
    pipe = ChannelBankPipeline(ChannelBankConfig(
        sample_rate=fs, channel_rate=192000.0, offsets_hz=offs,
        lowpass_out=12500.0), device=dev)
    if pipe.method != ("pfb" if on_grid else "mixer"):
        raise RuntimeError(f"bank of {n_chan} took the {pipe.method}")
    T = pipe.block_complex
    base = torch.from_numpy(_uniform(2 * T, 5, np.uint16)).to(dev)

    def call(state, u16):
        return pipe.call_u16(state, u16.view(torch.uint8)[None])

    C, P = pipe.pfb.C, pipe.pfb.P
    state = pipe.init_state()

    def check():
        raw, hist = base[:T].view(torch.uint8), state.chan_hist
        d, h_k = fused_pfb_demod(raw, hist, pipe.pfb._h_np, C,
                                 h_dev=pipe._h_dev)
        want, h_r = fused_pfb_demod_ref(raw, hist, pipe.pfb._h_np, C)
        err, snr = wrapped(want, d)
        hist_equal = bool(torch.equal(h_k, h_r))
        return {"kernel": "fused_pfb", "bar": f"< {BAR_ANGLE:g} rad "
                f"angle-wrapped, > {BAR_BANK_DB:g} dB, history equal",
                "max_abs_err": err, "snr_db": snr, "history_equal": hist_equal,
                "correct": err < BAR_ANGLE and snr > BAR_BANK_DB
                and hist_equal}
    return Row(step=_slice_step(call, T), feed=_keep, state=state, x=base,
               iq_per_step=T,
               traffic=2 * T + n_chan * pipe.audio_per_block * 4,
               ops=pfb_ops(T, C, P) if on_grid else None,
               check=check if on_grid else None,
               extra={"method": pipe.method})


def sharded(dev, blocks: int = 128) -> Row:
    """One sharded step (compat q0, fast) on ``make_demod_mesh()`` over
    every visible card, ``blocks`` blocks a time position: K1 per position,
    each position's step captured on its card (``ShardedPipeline.capture``)
    and replayed from the host on a chunk placed once."""
    mesh = make_demod_mesh(device=dev)
    n_t, n_c = mesh.shape
    cfg = _nbfm_cfg()
    n = cfg.buf_size
    sp = ShardedPipeline(cfg, mesh, fast_atan2=True)
    NB = n_t * blocks
    step = sp.capture(blocks)
    placed = step.place(tone_blocks(NB, n, 6)[None])
    off0 = torch.zeros((1, 2), dtype=torch.float32, device=sp.home)
    taps = sp.pipe.out_fir.host_taps

    def call():
        return step.step(off0, placed)

    def plain(state, x):
        # each position's shard through its card's plain chain
        return off0, {p: sp.pipes[mesh.devices[p]].plain_call(
            sp.pipe.init_state(), r)[1] for p, r in placed.items()}

    def check():
        res = [_vs_plain("fused_nbfm", fused_nbfm(r[0], taps, "shift", False),
                         fused_nbfm_ref(r[0], taps, "shift", False), False)
               for r in placed.values()]
        worst = min(res, key=lambda r: r["snr_db"])
        return {**worst, "correct": all(r["correct"] for r in res)}
    devices = tuple(dict.fromkeys(mesh.devices[p] for p in mesh.positions()))
    return Row(step=None, feed=None, state=None, x=None,
               iq_per_step=NB * n // 2, traffic=2 * NB * n,
               ops=demod_ops(False, len(taps)) * (NB * n // 4), check=check,
               plain=plain, call=call,
               eager=lambda: sp.step(off0, placed), devices=devices,
               extra={"mesh": [n_t, n_c], "blocks_per_position": blocks,
                      "graph": step.graph},
               note="per-position captures replayed from the host, so the "
                    "step time is the larger of the device's and the "
                    "host's launch time")


# name -> builder(device, sizes); the JAX bench's MATRIX, in its order
MATRIX = (
    ("hbm_memcpy_floor", lambda d, s: memcpy_floor(d, s.B)),
    ("nbfm_q0_fused_precise", lambda d, s: flagship(d, False, 0, s.B)),
    ("nbfm_q0_fused_fast", lambda d, s: flagship(d, True, 0, s.B)),
    ("nbfm_q3_fused_fast", lambda d, s: flagship(d, True, 3, s.B)),
    ("nbfm_q1_correctiq", lambda d, s: q1(d, s.B)),
    ("nbfm_q2_dcblock_fused", lambda d, s: inlpf(d, 2, False, s.B)),
    ("nbfm_inlpf_fused", lambda d, s: inlpf(d, 0, True, s.B)),
    ("nbfm_q2_inlpf_fused", lambda d, s: inlpf(d, 2, True, s.B)),
    ("nbfm_f64", lambda d, s: f64(d, s.f64_B)),
    ("wbfm_2p4msps", lambda d, s: wbfm(d)),
    ("channel_bank_8ch", lambda d, s: bank(d, 8, False)),
    ("channel_bank_8ch_pfb", lambda d, s: bank(d, 8, True)),
    ("channel_bank_64ch_pfb", lambda d, s: bank(d, 64, True)),
    ("sharded_step", lambda d, s: sharded(d, s.shard_blocks)),
)
FLAGSHIP = "nbfm_q0_fused_fast"
SHORT = ("nbfm_f64", "sharded_step")     # JAX's 10/60 rows


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _seconds(run, devices, reps: int) -> list:
    """Seconds of each of ``reps`` runs of ``run()`` after one warm-up: by
    CUDA events on each card (the longest card's), or the host clock on
    the CPU."""
    run()
    _sync(devices)
    out = []
    for _ in range(reps):
        if devices[0].type != "cuda":
            t0 = time.perf_counter()
            run()
            out.append(time.perf_counter() - t0)
            continue
        ev = {}
        for d in devices:
            with torch.cuda.device(d):
                ev[d] = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                ev[d][0].record()
        run()
        for d in devices:
            with torch.cuda.device(d):
                ev[d][1].record()
        for s, e in ev.values():
            e.synchronize()
        out.append(max(s.elapsed_time(e) for s, e in ev.values()) / 1e3)
    return out


def _chained(row: Row, n: int):
    """n steps of the row, each fed the one before's output → (state,
    the last step's output)."""
    def fn(state, x):
        for k in range(n):
            state, out = row.step(state, x, k)
            x = row.feed(out, x)
        return state, out
    return fn


def _runner(row: Row, n: int, dev, name: str):
    """→ (run, once, eager): ``run()`` does n steps, one replay of a graph
    of the n chained steps on the card (its own, freed with it), the steps
    themselves on the CPU, or the row's ``call`` n times; ``once()`` the
    same, from the row's first state, → (state, output); ``eager()`` what
    ``once`` runs, eagerly."""
    if row.call is not None:
        def run():
            for _ in range(n):
                row.call()
        return run, row.call, row.eager
    fn = _chained(row, n)
    cap = CapturedStep(fn, row.state, tuple(row.x.shape), dev,
                       f"bench:{name}:{n}", static_in=row.x)
    if dev.type == "cuda" and cap.graph is None:
        raise RuntimeError("the bench times CUDA graphs: unset "
                           "DEMODULATOR_TPU_TORCH_GRAPHS=0")
    state = row.state if cap.graph is None else cap.static_state
    return (lambda: cap(state, row.x),
            lambda: cap(tree_map(torch.clone, row.state), row.x),
            lambda: fn(tree_map(torch.clone, row.state), row.x))


def _launches() -> dict:
    return {c.__name__: c.launches for c in _counters()}


def _roofline(traffic: int, ops, step_s: float | None) -> dict:
    """The roofline of a step timed on the card in ``step_s`` seconds;
    None: not timed on the card (the CPU rehearsal, or the host clock),
    so no achieved_frac."""
    b_ms, by = bound(traffic, ops)
    return {"min_traffic_bytes_per_step": int(traffic),
            "ops_per_step": None if ops is None else float(ops),
            "bound_ms": b_ms, "bound_by": by,
            "achieved_frac": None if step_s is None else b_ms / 1e3 / step_s,
            "fits_l2": traffic <= L2_BYTES}


def measure(name: str, build, dev, sz: Sizes, info: dict,
            lengths: tuple) -> dict:
    """One matrix row: build, check its kernel, its first step and one
    replay of what is timed, time N_lo and N_hi steps, → the row's dict."""
    row = build(dev, sz)
    devices = row.devices or (dev,)
    check = {}
    if row.check is not None:
        check["kernel"] = row.check()
    first = _first_step(row)
    check["first_step_finite"] = _finite(first[1])
    if row.plain is not None:
        init = None if row.state is None else tree_map(torch.clone,
                                                       row.state)
        check["step"] = _vs_step(first, row.plain(init, row.x))
    del first
    before, steps, seconds = None, 0, {}
    for n in lengths:
        run, once, eager = _runner(row, n, dev, name)
        if before is None:      # the launches count the timed runs alone
            check["replay"] = {"steps": n, **_vs_eager(once(), eager())}
            before = _launches()
        seconds[str(n)] = _seconds(run, devices, sz.reps)
        steps += n * (sz.reps + 1)
        del run, once, eager
    check["correct"] = check["first_step_finite"] and all(
        c["correct"] for c in check.values() if isinstance(c, dict))
    n_lo, n_hi = lengths
    t_lo, t_hi = min(seconds[str(n_lo)]), min(seconds[str(n_hi)])
    dt = (t_hi - t_lo) / (n_hi - n_lo)
    if dt <= 0:     # a hiccup: the long run alone
        dt = t_hi / n_hi
    msps = row.iq_per_step / dt / 1e6
    after = _launches()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    cuda = dev.type == "cuda"
    return {
        "metric": f"iq_throughput_{name}", "value": msps,
        "unit": "Msamples/s", "vs_baseline": msps * 1e6 / BASELINE_SPS,
        "correct": bool(check["correct"]), "check": check,
        "iq_per_step": row.iq_per_step, "step_s": dt,
        "timing": ("host replays" if row.call is not None else "cuda graph")
        if cuda else "host clock, cpu rehearsal",
        "lengths": list(lengths), "reps": sz.reps, "seconds": seconds,
        "steps": steps, "launches": launches,
        "roofline": _roofline(row.traffic, row.ops, dt if cuda else None),
        **row.extra, **({"note": row.note} if row.note else {}), **info}


# ---------------------------------------------------------------------------
# end to end (bench.py:331-465)
# ---------------------------------------------------------------------------

class _Sink:
    """A write-only output that counts the float32 values written and
    whether every one was finite."""

    def __init__(self):
        self.values, self.finite = 0, True

    def write(self, buf) -> int:
        a = np.frombuffer(buf, np.float32)
        self.values += a.size
        self.finite = self.finite and bool(np.isfinite(a).all())
        return len(buf)

    def flush(self) -> None:
        pass


def host_link_msps(n: int, dev, reps: int = 6) -> float:
    """The serialized per-block round trip of this host and card: one
    block's uint32 view from a pinned buffer to the card (as ChunkReader
    feeds it), a trivial op, the audio-sized float32 back into pinned
    memory, then synchronize; complex Msamples/s at the best of ``reps``."""
    host = torch.from_numpy(_uniform(n, 11)).pin_memory()
    back = torch.empty(n // 4, dtype=torch.float32, pin_memory=True)

    def once():
        x = host.to(dev, non_blocking=True).view(torch.int32)
        back.copy_(x.to(torch.float32) * 1.5, non_blocking=True)
        torch.cuda.synchronize(dev)
    once()
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    return n / 2 / best / 1e6


class Stream(NamedTuple):
    """An end-to-end row's processor and what its runs are held to."""
    proc: Any
    block_bytes: int
    outputs: int               # output files
    values_per_block: int      # float32 values an output gets a block
    run: Callable              # run(fin, outs)
    kernel: Callable | None    # the kernel wrapper its chunk step launches
    blocks_per_launch: int
    ops_per_block: float | None
    seed: int
    host_link: bool            # the row reports host_link_bound_msps


def _e2e_q0(dev) -> Stream:
    proc = StreamProcessor(_nbfm_cfg(), fast_atan2=True, device=dev)
    bb, ntaps = proc.block_bytes, len(proc.pipe.out_fir.host_taps)
    return Stream(proc, bb, 1, bb // 4,
                  lambda fin, outs: proc.run(fin, outs[0]), fused_nbfm,
                  proc.chunk_blocks, demod_ops(False, ntaps) * (bb // 4), 7,
                  True)


def _e2e_wbfm(dev) -> Stream:
    proc = WbfmStreamProcessor(WbfmConfig(sample_rate=2.4e6), device=dev)
    return Stream(proc, proc.block_bytes, 1, proc.pipe.audio_per_block,
                  lambda fin, outs: proc.run([fin], outs), None, 1, None, 7,
                  True)


def _e2e_bank4(dev) -> Stream:
    """The --bank loop: 4 on-grid channels at 768 ksps, one block a call
    (the JAX bench's hand-written loop, bench.py:409-423), a file a
    channel."""
    n_chan = 4
    offs = tuple((c - n_chan / 2) * 192000.0 for c in range(n_chan))
    proc = BankStreamProcessor(ChannelBankConfig(
        sample_rate=n_chan * 192000.0, channel_rate=192000.0,
        offsets_hz=offs, lowpass_out=12500.0), device=dev)
    pipe = proc.pipe
    return Stream(proc, pipe.block_bytes, n_chan, pipe.audio_per_block,
                  lambda fin, outs: proc.run(fin, outs), fused_pfb_demod,
                  proc.chunk_blocks,
                  pfb_ops(pipe.block_complex, pipe.pfb.C, pipe.pfb.P), 13,
                  False)


E2E = (("e2e_stream_q0", _e2e_q0), ("e2e_stream_wbfm", _e2e_wbfm),
       ("e2e_bank4_pfb", _e2e_bank4))


def measure_e2e(name: str, build, dev, sz: Sizes, info: dict) -> dict:
    """File → device → file wall clock of a stream processor (built once:
    its constructor captures the chunk step; ``run`` resets the state):
    one warm-up run into checking sinks, then the best of ``e2e_reps``
    runs into /dev/null."""
    st = build(dev)
    n_blocks = sz.e2e_blocks[name]
    nbytes = n_blocks * st.block_bytes
    values = st.values_per_block * st.outputs * n_blocks
    cuda = dev.type == "cuda"
    with tempfile.NamedTemporaryFile(prefix="bench_e2e_") as f:
        f.write(_uniform(nbytes, st.seed).tobytes())
        f.flush()
        sinks = [_Sink() for _ in range(st.outputs)]
        n0 = st.kernel.launches if st.kernel is not None else 0
        with open(f.name, "rb") as fin:
            st.run(fin, sinks)
        launches = st.kernel.launches - n0 if st.kernel is not None else 0
        want = (-(-n_blocks // st.blocks_per_launch)
                if cuda and st.kernel is not None else 0)
        seconds = []
        with open(os.devnull, "wb") as devnull:
            for _ in range(sz.e2e_reps):
                with open(f.name, "rb") as fin:
                    t0 = time.perf_counter()
                    st.run(fin, [devnull] * st.outputs)
                    seconds.append(time.perf_counter() - t0)
    check = {"bar": "every value written, finite; the kernel's launches",
             "values": sum(s.values for s in sinks), "want_values": values,
             "launches": launches, "want_launches": want}
    check["correct"] = (all(s.finite for s in sinks)
                        and check["values"] == check["want_values"]
                        and launches == want)
    best = min(seconds)
    msps = nbytes / 2 / best / 1e6
    row = {"metric": f"iq_throughput_{name}", "value": msps,
           "unit": "Msamples/s", "vs_baseline": msps * 1e6 / BASELINE_SPS,
           "correct": check["correct"], "check": check, "blocks": n_blocks,
           "timing": "host clock, file → device → file",
           "lengths": [n_blocks], "reps": sz.e2e_reps,
           "seconds": {str(n_blocks): seconds},
           # timed by the host clock, file to file: no device bound
           "roofline": {"min_traffic_bytes_per_step": nbytes + 4 * values,
                        "ops_per_step": None if st.ops_per_block is None
                        else float(st.ops_per_block * n_blocks),
                        "bound_ms": None, "bound_by": None,
                        "achieved_frac": None,
                        "fits_l2": nbytes + 4 * values <= L2_BYTES},
           "note": "input in $TMPDIR (page cache), output /dev/null; one "
                   "warm-up run, then the best of the timed runs"}
    if st.host_link:
        link = host_link_msps(st.block_bytes, dev) if cuda else None
        row["host_link_bound_msps"] = link
        row["e2e_frac_of_link"] = None if link is None else msps / link
        row["note"] += ("; host_link_bound_msps: one block's serialized "
                        "round trip through pinned buffers")
    return {**row, **info}


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def _failed(row: dict) -> bool:
    return "error" in row or row.get("correct") is False


def _guard(metric: str, fn, info: dict) -> dict:
    """fn() → its row; one that raises → a row with its ``error`` (the
    traceback to stderr): one broken row must not hide the rest."""
    try:
        row = fn()
    except Exception as e:
        traceback.print_exc()
        row = {"metric": metric, "error": repr(e)[:400], **info}
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return row


def headline(row: dict, dev) -> dict:
    """The default line: the flagship row under the headline's name."""
    name = HEADLINE if dev.type == "cuda" else HEADLINE_CPU
    keep = ("value", "unit", "vs_baseline", "correct", "error", "device",
            "device_count", "power_limit")
    return {"metric": name, **{k: row[k] for k in keep if k in row}}


def _write(path, rows: list) -> None:
    if path is None:
        return
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", action="store_true",
                    help="measure every matrix row and the end-to-end rows")
    ap.add_argument("--rows", default="",
                    help="comma list of rows to measure (with --matrix); "
                         "the others keep their prior --out values")
    ap.add_argument("--out", default=None,
                    help=f"the matrix's file (default {DEFAULT_OUT} on the "
                         f"card; on the CPU none)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    names = [n for n, _ in MATRIX] + [n for n, _ in E2E]
    keep = [r for r in args.rows.split(",") if r]
    unknown = sorted(set(keep) - set(names))
    if unknown:
        ap.error(f"unknown rows {unknown}; rows: {', '.join(names)}")
    if keep and not args.matrix:
        ap.error("--rows needs --matrix")
    dev = torch.device(args.device)
    out = args.out
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("bench: CUDA device not available (--device cpu runs the "
                  "rehearsal on the CPU)", file=sys.stderr)
            return 2
        out = out or DEFAULT_OUT
        smi = card()
        info = {"device": torch.cuda.get_device_name(0),
                "device_count": torch.cuda.device_count(),
                "power_limit": None if smi is None else smi["power_limit"]}
        sz = FULL
    else:
        if out is not None and os.path.basename(out) == DEFAULT_OUT:
            ap.error(f"--device cpu never writes {DEFAULT_OUT}")
        info = {"device": "cpu", "device_count": 1, "power_limit": None}
        sz = REHEARSAL
    builders = dict(MATRIX)
    flag = _guard(f"iq_throughput_{FLAGSHIP}", functools.partial(
        measure, FLAGSHIP, builders[FLAGSHIP], dev, sz, info, sz.lengths),
        info)
    line = headline(flag, dev)
    if not args.matrix:
        print(json.dumps(line), flush=True)
        return 1 if _failed(flag) else 0

    prior = {}
    if keep and out is not None and os.path.exists(out):
        with open(out) as f:
            prior = {r["metric"]: r for r in json.load(f)}
    rows, failed = [], _failed(flag)
    e2e = dict(E2E)
    for name in names:
        metric = f"iq_throughput_{name}"
        if name == FLAGSHIP:
            row = flag
        elif keep and name not in keep:
            row = prior.get(metric) or {
                "metric": metric,
                "skipped": "not in --rows and no prior value"}
        else:
            if name in e2e:
                fn = functools.partial(measure_e2e, name, e2e[name], dev, sz,
                                       info)
            else:
                fn = functools.partial(
                    measure, name, builders[name], dev, sz, info,
                    sz.short_lengths if name in SHORT else sz.lengths)
            row = _guard(metric, fn, info)
            failed = failed or _failed(row)
        rows.append(row)
        print(json.dumps(row), flush=True)
        _write(out, rows)
    floor = next((r for r in rows if r["metric"] ==
                  "iq_throughput_hbm_memcpy_floor" and "value" in r), None)
    if floor is not None and dev.type == "cuda":
        # the fraction of the MEASURED memory floor, for every row that
        # moves the floor's bytes
        t = floor["roofline"]["min_traffic_bytes_per_step"]
        for r in rows:
            if "value" in r and r.get("roofline", {}).get(
                    "min_traffic_bytes_per_step") == t and r is not floor:
                r["roofline"]["frac_of_measured_memcpy"] = \
                    r["value"] / floor["value"]
        _write(out, rows)
    print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
