#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demodulator_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. device: the card's name and power limit; fails without CUDA;
2. build: nvcc builds csrc/*.cu into demodulator_tpu_torch/_build/;
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes:
   - NBFM (16 blocks of 256 KiB), > 110 dB on an FM tone capture (SNR and
     max error also printed on noise), the precise K1 and K3 equal to their
     plain versions on the tone and on noise: fused_nbfm (K1) precise/fast
     x shift/normalize x Butterworth/Chebyshev taps; fused_nbfm_cplx (K3)
     with one -L stage and one -q 2 stage x shift/normalize x precise/fast,
     and with both stages precise/fast; K1 and K3 (two stages) precise,
     equal, on rows of 4·(4k + 3) bytes starting 4 bytes past a 16-byte
     boundary, with the CLI's taps and with 32; fused_nbfm_q1 (K4) and
     fused_nbfm_q1_seq (K5) precise/fast, their entering and final offsets
     within 1e-3, K5 also against K4; dma_floor (K2) exactly;
   - fused_pfb (K6) for every C of tests/test_torch_cuda.py (2 to 256,
     radix and direct FFT factors, the primes 17 and 251 on the direct
     DFT) on two streamed 0.25 s blocks of an on-grid FM bank capture and
     of noise (C = 4 also on one 10-block bank4 chunk): angle-wrapped error
     < 0.01 rad, > 80 dB, the carried history bit-equal;
4. the main paths through their entry point, each in its own process, so
   its launch counts start at 0 (PHASES line):
   - ``python -m demodulator_tpu_torch -i cap.iq -o out.raw -S 96000 -l
     12500`` on a 256 MiB capture (1024 blocks + a 100-byte tail),
     precise and with --fast-atan2, then precise with each of -L 12500,
     -q 2, -q 2 -L 12500 and -q 1, and -q 2 -L 12500 with --fast-atan2.
     Each run is checked for its output length, > 110 dB against the
     --device cpu plain path on the first and last 32 blocks (-q 1: the
     plain path starts a block earlier, so the carried offset is in
     place), > 60 dB against the numpy golden model on the first 2
     blocks, and launches of its mode's kernel;
   - the channel bank, ``--bank`` with 64 channels at 12.288 Msps (bank64:
     0.25 s blocks, a 256 MiB capture with FM carriers on 8 channels) and
     4 channels at 768 ksps (bank4: 10 blocks per call, a 64 MiB capture,
     a carrier on each).  Each run is checked for fused_pfb launches, the
     length and finiteness of every channel file, and against the --device
     cpu plain pipeline (built with the run's block geometry) on the first
     and last 2 blocks: carrier channels > 80 dB and within 1e-4;
     every channel's discriminator output, recovered from the audio
     through the causal FIR, within 0.01 rad angle-wrapped and > 80 dB
     (noise channels flip at +-pi on a last-ulp difference; that is the
     bar of tests/test_fused_pfb.py); bank64's carrier tones within 15 Hz;
5. timings with CUDA events (median of 20 runs after warm-up; 5 runs of
   one call for a call slower than 5 ms) beside the
   plain versions, and each kernel's device time from torch.profiler,
   with GB/s against dma_floor's and the least time the card could take
   (bound): NBFM kernels at 16 and 256 blocks (K5 beside K4; K4 held to
   one kernel launch per call); fused_pfb at
   C = 64 on one bank64 block and at C = 4 on one bank4 chunk, with its FFT
   plan; the bank's audio FIR.

The line before the last is a JSON object with the kernels' launches,
errors, times and bounds; the last line is ``{"ok": true, "device":
{...}}``.  Imports only the port, torch and numpy.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from demodulator_tpu_torch.config import config_from_cli_opts
from demodulator_tpu_torch.models.channel_bank import (ChannelBankConfig,
                                                       ChannelBankPipeline)
from demodulator_tpu_torch.models.nbfm import BlockPipeline
from demodulator_tpu_torch.ops.channelizer import PolyphaseChannelizer
from demodulator_tpu_torch.ops.cuda import build
from demodulator_tpu_torch.ops.cuda.fused_nbfm import (
    dma_floor, dma_floor_ref, fused_nbfm, fused_nbfm_cplx,
    fused_nbfm_cplx_ref, fused_nbfm_q1, fused_nbfm_q1_ref, fused_nbfm_q1_seq,
    fused_nbfm_q1_seq_ref, fused_nbfm_ref)
from demodulator_tpu_torch.ops.cuda.fused_pfb import (fft_plan,
                                                      fused_pfb_demod,
                                                      fused_pfb_demod_ref)
from demodulator_tpu_torch.oracle.pipeline import OraclePipeline

REPO = Path(__file__).resolve().parent
FS = 96000.0
BB = 262144              # bytes per block (config.DEFAULT_BUF_SIZE)
NB = 16                  # blocks per device call on the main path
CAPTURE_BLOCKS = 1024    # 256 MiB
TAIL_BYTES = 100
CLI_ARGS = ["-S", "96000", "-l", "12500"]
BAR_KERNEL_DB = 110.0    # fused chains vs their twins (tests/test_fused.py)
BAR_ORACLE_DB = 60.0     # acceptance bar (BASELINE.md)
BAR_OFFSET = 1e-3        # correctIq offsets (tests/test_fused.py:209-210)
CSRC = "demodulator_tpu_torch/csrc/"
PALLAS = "demodulator_tpu/ops/pallas/fused_nbfm.py:"
# kernel -> (source, the TPU kernel it replaces)
SOURCES = {"fused_nbfm": (CSRC + "fused_nbfm.cu", PALLAS + "214"),
           "dma_floor": (CSRC + "fused_nbfm.cu", PALLAS + "304"),
           "fused_nbfm_cplx": (CSRC + "fused_nbfm_cplx.cu", PALLAS + "253"),
           "fused_nbfm_q1": (CSRC + "fused_nbfm_q1.cu", PALLAS + "644"),
           "fused_nbfm_q1_seq": (CSRC + "fused_nbfm_q1.cu", PALLAS + "739"),
           "fused_pfb": (CSRC + "fused_pfb.cu",
                         "demodulator_tpu/ops/pallas/fused_pfb.py:196")}
# the card's data-sheet peaks (H100 SXM, 700 W): HBM bytes/s and float32
# operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
CR = 192000.0            # channel rate of both bank runs
BAR_BANK_DB = 80.0       # the PFB front (tests/test_fused_pfb.py:55)
BAR_ANGLE = 0.01         # rad, angle-wrapped (tests/test_fused_pfb.py:52)
BAR_BANK_ATOL = 1e-4     # tests/test_fused_pfb.py:107
# K6's channel counts in phase 3: tests/test_torch_cuda.py
# test_pfb_kernel_matches_ref
PFB_CHANNELS = (2, 3, 4, 5, 8, 12, 16, 17, 32, 48, 64, 128, 251, 256)
# bank CLI runs of phase 4: name -> (channels, capture bytes, carrier
# channels (indices into the --bank list), blocks per call)
BANK_RUNS = {"bank64": (64, 256 << 20, (4, 12, 20, 28, 35, 43, 51, 59), 1),
             "bank4": (4, 64 << 20, (0, 1, 2, 3), 10)}
# CLI runs of phase 4: name -> (extra options, the kernel the mode runs)
CLI_RUNS = {
    "precise": ([], "fused_nbfm"),
    "fast": (["--fast-atan2"], "fused_nbfm"),
    "-L": (["-L", "12500"], "fused_nbfm_cplx"),
    "-q 2": (["-q", "2"], "fused_nbfm_cplx"),
    "-q 2 -L": (["-q", "2", "-L", "12500"], "fused_nbfm_cplx"),
    "-q 1": (["-q", "1"], "fused_nbfm_q1"),
    "-q 2 -L fast": (["-q", "2", "-L", "12500", "--fast-atan2"],
                     "fused_nbfm_cplx"),
}


def say(*a):
    print(*a, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    ref = ref.astype(np.float64).ravel()
    err = ref - test.astype(np.float64).ravel()
    e = float(np.mean(err ** 2))
    return math.inf if e == 0 else 10 * math.log10(float(np.mean(ref ** 2)) / e)


def tone_iq(n_bytes: int, start: int, rng) -> np.ndarray:
    """uint8 IQ of a 1 kHz FM tone at 2.5 kHz deviation plus noise, built
    like tests/conftest.py ``iq_data``; ``start`` is the first complex
    sample's index, so consecutive pieces join without a phase jump."""
    t = (start + np.arange(n_bytes // 2)) / FS
    phase = 2.5 * (1.0 - np.cos(2 * np.pi * 1000.0 * t))
    iq = np.exp(1j * phase) * 80
    iq += (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t))) * 4
    out = np.empty(n_bytes, dtype=np.uint8)
    out[0::2] = np.clip(np.round(iq.real + 127.4), 0, 255)
    out[1::2] = np.clip(np.round(iq.imag + 127.4), 0, 255)
    return out


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def taps_of(opts: dict) -> np.ndarray:
    cfg = config_from_cli_opts(opts)
    return BlockPipeline(cfg, device="cpu").out_fir.host_taps


def pipe_of(extra: list) -> BlockPipeline:
    """The pipeline of ``CLI_ARGS + extra`` (no long options)."""
    args = CLI_ARGS + [a for a in extra if not a.startswith("--")]
    return BlockPipeline(config_from_cli_opts(
        {args[i][1]: args[i + 1] for i in range(0, len(args), 2)}),
        device="cpu")


def compare(label: str, pieces: dict, kernel, plain,
            exact: bool = False) -> float:
    """Kernel against plain version on each piece; > 110 dB on the tone,
    or, ``exact``, equal on every piece (the precise K1 and K3 do the plain
    version's float32 operations in its order).  Returns the tone's max
    |err|."""
    res = {}
    for fname, raw in pieces.items():
        got, want = kernel(raw), plain(raw)
        equal = torch.equal(got, want)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        res[fname] = (snr_db(want, got), float(np.max(np.abs(want - got))))
        check(equal or not exact, f"{label}: differs from its plain version "
              f"on the {fname}")
    (s_t, e_t), (s_n, e_n) = res["tone"], res["noise"]
    say(f"{label}: tone {s_t:.1f} dB max|err| {e_t:.3g}; noise {s_n:.1f} dB "
        f"max|err| {e_n:.3g}" + ("; equal on both" if exact else ""))
    check(s_t > BAR_KERNEL_DB, f"{label}: {s_t:.1f} dB <= {BAR_KERNEL_DB} dB "
          f"on the tone")
    return e_t


def phase_kernels_cplx_q1(pieces: dict, dev) -> dict:
    """Phase 3, K3 and K4: one -L stage, one -q 2 stage and both, and the
    correctIq kernel with its offsets."""
    taps = taps_of({"S": "96000", "l": "12500"})
    errs = {}
    for label, extra, conds in (
            ("-L", ["-L", "12500"], ("shift", "normalize")),
            ("-q 2", ["-q", "2"], ("shift", "normalize")),
            ("-q 2 -L", ["-q", "2", "-L", "12500"], ("shift",))):
        st = pipe_of(extra).stage_consts()
        for precise in (True, False):
            for cond in conds:
                e = compare(
                    f"fused_nbfm_cplx {label} ({len(st)} stage(s), Dc "
                    f"{[len(t) - 1 for t, _ in st]}) "
                    f"{'precise' if precise else 'fast'} {cond}", pieces,
                    lambda r: fused_nbfm_cplx(r, st, taps, cond, precise),
                    lambda r: fused_nbfm_cplx_ref(r, st, taps, cond, precise),
                    exact=precise)
                key = (label, precise)
                errs[key] = max(errs.get(key, 0.0), e)
    q1 = pipe_of(["-q", "1"])
    off_in = torch.tensor([127.3, 126.8], device=dev)
    esr = float(q1.esr)
    for precise in (True, False):
        label = f"fused_nbfm_q1 {'precise' if precise else 'fast'}"
        e = compare(label, pieces,
                    lambda r: fused_nbfm_q1(r, off_in, taps, esr, precise)[0],
                    lambda r: fused_nbfm_q1_ref(r, off_in, taps, esr,
                                                precise)[0])
        _, k_ent, k_fin = fused_nbfm_q1(pieces["tone"], off_in, taps, esr,
                                        precise)
        _, p_ent, p_fin = fused_nbfm_q1_ref(pieces["tone"], off_in, taps, esr,
                                            precise)
        d = max(float((k_ent - p_ent).abs().max()),
                float((k_fin - p_fin).abs().max()))
        say(f"{label} offsets on the tone: max|diff| {d:.3g} (final "
            f"{k_fin.cpu().tolist()})")
        check(d < BAR_OFFSET, f"{label} offsets differ by {d:.3g}")
        errs[("-q 1", precise)] = e
    for precise in (True, False):
        label = f"fused_nbfm_q1_seq {'precise' if precise else 'fast'}"
        e = compare(label, pieces,
                    lambda r: fused_nbfm_q1_seq(r, off_in, taps, esr,
                                                precise)[0],
                    lambda r: fused_nbfm_q1_seq_ref(r, off_in, taps, esr,
                                                    precise)[0])
        got = fused_nbfm_q1_seq(pieces["tone"], off_in, taps, esr, precise)
        for other, want in (
                ("its plain version", fused_nbfm_q1_seq_ref(
                    pieces["tone"], off_in, taps, esr, precise)),
                ("fused_nbfm_q1 (K4)", fused_nbfm_q1(
                    pieces["tone"], off_in, taps, esr, precise))):
            s_db = snr_db(want[0].cpu().numpy(), got[0].cpu().numpy())
            d = max(float((got[1] - want[1]).abs().max()),
                    float((got[2] - want[2]).abs().max()))
            say(f"{label} against {other} on the tone: {s_db:.1f} dB, "
                f"offsets max|diff| {d:.3g}")
            check(s_db > BAR_KERNEL_DB and d < BAR_OFFSET,
                  f"{label} against {other}: {s_db:.1f} dB, offsets {d:.3g}")
        errs[("q1_seq", precise)] = e
    return errs


def phase_kernels(dev) -> dict:
    """Phase 3: each kernel against its plain version on the same bytes."""
    say("== phase 3: kernels against their plain versions on the card")
    rng = np.random.default_rng(3)
    tone = torch.from_numpy(tone_iq(NB * BB, 0, rng).reshape(NB, BB)).to(dev)
    noise = torch.from_numpy(rng.integers(0, 256, (NB, BB), dtype=np.uint8)
                             ).to(dev)
    tap_sets = {"butterworth -l 12500": taps_of({"S": "96000", "l": "12500"}),
                "chebyshev -m 1 -d 8": taps_of({"S": "96000", "l": "12500",
                                                "m": "1", "d": "8"})}
    errs = {("default", True): 0.0, ("default", False): 0.0}
    pieces = {"tone": tone, "noise": noise}
    for tname, taps in tap_sets.items():
        for precise in (True, False):
            for cond in ("shift", "normalize"):
                e = compare(
                    f"fused_nbfm {tname} (D={len(taps) - 1}) "
                    f"{'precise' if precise else 'fast'} {cond}", pieces,
                    lambda r: fused_nbfm(r, taps, cond, precise),
                    lambda r: fused_nbfm_ref(r, taps, cond, precise),
                    exact=precise)
                key = ("default", precise)
                errs[key] = max(errs[key], e)
    phase_kernels_odd_rows(rng, dev)
    got = dma_floor(noise).cpu()
    check(torch.equal(got, dma_floor_ref(noise).cpu()),
          "dma_floor differs from dma_floor_ref")
    say("dma_floor: equal to dma_floor_ref")
    errs.update(phase_kernels_cplx_q1(pieces, dev))
    errs["pfb"] = phase_kernels_pfb(dev)
    return errs


def phase_kernels_odd_rows(rng, dev) -> None:
    """Phase 3, K1 and K3 precise on rows of 4·(4k + 3) bytes that start 4
    bytes past a 16-byte boundary (their scalar loads and stores), with the
    CLI's taps and with 32 audio and 32 stage taps (counts read at run
    time): equal to their plain versions."""
    n = 4 * (4 * (BB // 16) + 3)
    buf = torch.empty(NB * n + 32, dtype=torch.uint8, device=dev)
    base = (16 - buf.data_ptr() % 16) % 16 + 4
    raw = buf[base: base + NB * n].view(NB, n)
    raw.copy_(torch.from_numpy(tone_iq(NB * n, 0, rng).reshape(NB, n)))
    taps = taps_of({"S": "96000", "l": "12500"})
    taps32 = rng.uniform(-0.5, 0.5, 32)
    st2 = pipe_of(["-q", "2", "-L", "12500"]).stage_consts()
    st32 = tuple((rng.uniform(-0.3, 0.3, 32), tuple(rng.uniform(-1, 1, 2)))
                 for _ in range(2))
    for label, t, st in (("CLI taps", taps, st2),
                         ("32 audio and stage taps", taps32, st32)):
        got, want = (fused_nbfm(raw, t), fused_nbfm_ref(raw, t))
        got3, want3 = (fused_nbfm_cplx(raw, st, t),
                       fused_nbfm_cplx_ref(raw, st, t))
        check(torch.equal(got, want) and torch.equal(got3, want3),
              f"fused_nbfm / fused_nbfm_cplx on rows of {n} bytes, "
              f"{label}: differ from their plain versions")
        say(f"fused_nbfm and fused_nbfm_cplx (2 stages) precise on {NB} rows "
            f"of {n} bytes starting {raw.data_ptr() % 16} bytes past a "
            f"16-byte boundary, {label}: equal to their plain versions")


def bank_iq(fs: float, offsets, carriers, start: int, n: int, seed: int,
            amp: float, dev) -> torch.Tensor:
    """uint8 IQ [2n] made on the card: an FM carrier (5 kHz deviation, tone
    400 + 150·i Hz) on each offset of ``carriers``, plus Gaussian noise of
    0.05 of full scale (about 6 LSB rms, a receiver's noise floor) from
    ``seed``.  ``start`` is the first sample's index, so consecutive pieces
    join without a phase jump."""
    f64 = torch.float64
    idx = torch.arange(start, start + n, dtype=f64, device=dev)
    re = torch.zeros(n, dtype=f64, device=dev)
    im = torch.zeros(n, dtype=f64, device=dev)
    for i, c in enumerate(carriers):
        tone = 400.0 + 150.0 * i
        ph = (2 * math.pi * torch.remainder(idx * (offsets[c] / fs), 1.0)
              + 5000.0 / tone * (1 - torch.cos(2 * math.pi * tone / fs * idx)))
        re += amp * torch.cos(ph)
        im += amp * torch.sin(ph)
    g = torch.Generator(device=dev).manual_seed(seed)
    re += 0.05 * torch.randn(n, generator=g, dtype=f64, device=dev)
    im += 0.05 * torch.randn(n, generator=g, dtype=f64, device=dev)
    iq = torch.stack([re, im], dim=-1).reshape(-1)
    return torch.clamp(torch.round(iq * 127 + 127), 0, 255).to(torch.uint8)


def bank_offsets(nch: int) -> list:
    """The --bank list of a run: every channel of the grid, (c - nch/2)·CR."""
    return [(c - nch // 2) * CR for c in range(nch)]


def wrapped(want: torch.Tensor, got: torch.Tensor) -> tuple:
    """(max |err|, SNR dB) of the angle-wrapped difference."""
    w, g = want.double().cpu(), got.double().cpu()
    e = torch.remainder(g - w + math.pi, 2 * math.pi) - math.pi
    p = float((w ** 2).mean())
    m = float((e ** 2).mean())
    return float(e.abs().max()), math.inf if m == 0 else 10 * math.log10(p / m)


def phase_kernels_pfb(dev) -> float:
    """Phase 3, K6: two streamed 0.25 s blocks per C of an on-grid FM bank
    capture and of noise, and C = 4 on a 10-block bank4 chunk.  Returns
    the max angle-wrapped error on the bank capture."""
    worst = 0.0
    rng = np.random.default_rng(11)
    for C, blocks in [(C, 1) for C in PFB_CHANNELS] + [(4, 10)]:
        pfb = PolyphaseChannelizer(C)
        fs = C * CR
        n = int(0.25 * fs) * blocks
        offs = bank_offsets(C)
        car = tuple(range(0, C, max(1, C // 4)))
        for data in ("bank", "noise"):
            hist_k = torch.zeros((2, pfb.hist_len), device=dev)
            hist_r = hist_k.clone()
            res = []
            for b in range(2):
                raw = (bank_iq(fs, offs, car, b * n, n, 100 + C, 0.2, dev)
                       if data == "bank" else torch.from_numpy(
                           rng.integers(0, 256, 2 * n, np.uint8)).to(dev))
                d, hist_k = fused_pfb_demod(raw, hist_k, pfb._h_np, C)
                want, hist_r = fused_pfb_demod_ref(raw, hist_r, pfb._h_np, C)
                res.append(wrapped(want, d))
                check(torch.equal(hist_k, hist_r),
                      f"fused_pfb C={C} {data}: history differs")
            err = max(r[0] for r in res)
            snr = min(r[1] for r in res)
            say(f"fused_pfb C={C} (FFT {'x'.join(map(str, fft_plan(C)))}; "
                f"{blocks} block(s) of 0.25 s, {n} samples) "
                f"{data}: angle-wrapped max|err| {err:.3g} rad, {snr:.1f} dB,"
                f" history bit-equal")
            check(err < BAR_ANGLE and snr > BAR_BANK_DB,
                  f"fused_pfb C={C} {data}: {err:.3g} rad, {snr:.1f} dB")
            if data == "bank":
                worst = max(worst, err)
    return worst


def write_capture(path: Path) -> None:
    rng = np.random.default_rng(7)
    step = NB * BB
    with open(path, "wb") as f:
        for k in range(CAPTURE_BLOCKS // NB):
            f.write(tone_iq(step, k * step // 2, rng).tobytes())
        f.write(tone_iq(TAIL_BYTES, CAPTURE_BLOCKS * BB // 2, rng).tobytes())


def run_cli(cap: Path, out: Path, extra: list) -> dict:
    env = {**os.environ, "DEMODULATOR_TPU_TORCH_PHASES": "1"}
    # paths relative to the repository: an -i/-o argument containing '-'
    # selects stdin/stdout (the reference's strstr quirk)
    cmd = [sys.executable, "-m", "demodulator_tpu_torch",
           "-i", os.path.relpath(cap, REPO), "-o", os.path.relpath(out, REPO),
           *CLI_ARGS, *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"{' '.join(cmd)} exited {r.returncode}:\n"
          f"{r.stderr[-4000:]}")
    lines = [ln for ln in r.stderr.splitlines() if ln.startswith("PHASES ")]
    check(len(lines) == 1, f"no PHASES line from the CLI:\n{r.stderr}")
    phases = json.loads(lines[0][len("PHASES "):])
    phases["wall_s"] = round(wall, 3)
    return phases


def plain_blocks(cap: Path, first_block: int, count: int, fast: bool,
                 extra: list) -> np.ndarray:
    """The --device cpu plain path on ``count`` blocks of the capture.
    Under -q 1 it starts a block earlier (from block 0 it starts as the run
    did) and drops that block: a^(n/4) ~ e^-68 at 96 kHz, so the offset it
    carries out is the one the run carried in."""
    pipe = pipe_of(extra)
    pipe = BlockPipeline(pipe.cfg, fast_atan2=fast, device="cpu")
    lead = 1 if pipe.kind == 1 and first_block > 0 else 0
    raw = np.fromfile(cap, dtype=np.uint8, count=(count + lead) * BB,
                      offset=(first_block - lead) * BB).reshape(-1, BB)
    _, audio = pipe(pipe.init_state(), torch.from_numpy(raw))
    return audio.numpy()[lead:]


def phase_main_path(work: Path) -> dict:
    """Phase 4: the CLI on a 256 MiB capture in each mode."""
    say("== phase 4: main paths through python -m demodulator_tpu_torch")
    cap = work / "cap.iq"
    t0 = time.perf_counter()
    write_capture(cap)
    say(f"capture: {cap.stat().st_size} bytes ({CAPTURE_BLOCKS} blocks + "
        f"{TAIL_BYTES} bytes) written in {time.perf_counter() - t0:.1f} s")
    n_out = CAPTURE_BLOCKS * (BB // 4)
    results = {}
    for name, (extra, kernel) in CLI_RUNS.items():
        out = work / "out.raw"
        # the CLI process starts with its launch counts at 0 and reports
        # them at its end (PHASES line)
        phases = run_cli(cap, out, extra)
        counts = {k: int(v) for k, v in phases.items()
                  if k.endswith("_launches")}
        launches = counts[f"{kernel}_launches"]
        say(f"cli {name}: PHASES {json.dumps(phases)}")
        audio = np.fromfile(out, dtype=np.float32)
        check(audio.shape == (n_out,), f"cli {name}: {audio.shape[0]} "
              f"floats, want {n_out}")
        check(bool(np.all(np.isfinite(audio))), f"cli {name}: non-finite")
        audio = audio.reshape(CAPTURE_BLOCKS, BB // 4)
        fast = "--fast-atan2" in extra
        s_first = snr_db(plain_blocks(cap, 0, 32, fast, extra), audio[:32])
        s_last = snr_db(plain_blocks(cap, CAPTURE_BLOCKS - 32, 32, fast,
                                     extra), audio[-32:])
        say(f"cli {name} vs --device cpu plain path: first 32 blocks "
            f"{s_first:.1f} dB, last 32 blocks {s_last:.1f} dB")
        check(min(s_first, s_last) > BAR_KERNEL_DB,
              f"cli {name} vs plain path below {BAR_KERNEL_DB} dB")
        data = np.fromfile(cap, dtype=np.uint8, count=2 * BB).tobytes()
        oracle = OraclePipeline(pipe_of(extra).cfg).process_stream(data)
        s_or = snr_db(oracle, audio[:2])
        say(f"cli {name} vs OraclePipeline (first 2 blocks): {s_or:.1f} dB")
        check(s_or > BAR_ORACLE_DB, f"cli {name} vs oracle {s_or:.1f} dB")
        check(launches > 0, f"cli {name}: {kernel} was not launched")
        msps = CAPTURE_BLOCKS * BB / 2 / phases["run_s"] / 1e6
        say(f"cli {name}: launches {counts}; end to end {msps:.1f} "
            f"Msamples/s of complex input (run {phases['run_s']} s of "
            f"{phases['wall_s']} s wall)")
        results[name] = {"launches": launches, "msps": msps}
        out.unlink()
    return results


def bank_args(nch: int) -> list:
    return ["--bank", ",".join(f"{o:.0f}" for o in bank_offsets(nch)),
            "--iq-rate", f"{nch * CR:.0f}", "--channel-rate", f"{CR:.0f}"]


def write_bank_capture(path: Path, nch: int, n_bytes: int, carriers,
                       dev) -> None:
    """``n_bytes`` of synthetic IQ at nch·CR, written in pieces of 8 Mi
    samples made on the card with a running sample index."""
    offs, piece = bank_offsets(nch), 1 << 23
    amp = 0.8 / len(carriers)
    with open(path, "wb") as f:
        for k, start in enumerate(range(0, n_bytes // 2, piece)):
            n = min(piece, n_bytes // 2 - start)
            f.write(bank_iq(nch * CR, offs, carriers, start, n, 1000 + k, amp,
                            dev).cpu().numpy().tobytes())


def deconvolve(y: np.ndarray, h: np.ndarray) -> tuple[np.ndarray, int, int]:
    """x with y = causal FIR h of x over a span, per row → (x, head, tail):
    the first ``head`` and last ``tail`` samples of x depend on values
    outside the span (the recursion starts there from zeros; its error
    shrinks by the zeros' modulus per step).  A minimum-phase h (zeros
    inside the unit circle) runs forward, x[t] = (y[t] - sum_j h[j]
    x[t - j]) / h[0]; a maximum-phase one backward, solving for x[t - K + 1]
    from y[t]."""
    K = len(h)
    z = np.abs(np.roots(h)) if K > 1 else np.zeros(1)
    check(bool(np.all(z < 1) or np.all(z > 1)),
          f"audio taps {h}: zeros on both sides of the unit circle")
    fwd = bool(np.all(z < 1))
    r = float(np.max(z) if fwd else np.max(1 / z))
    settle = 0 if K == 1 else int(math.ceil(28 / -math.log(r))) * (K - 1)
    x = np.zeros_like(y, dtype=np.float64)
    T = y.shape[1]
    if fwd:
        for t in range(T):
            acc = y[:, t].astype(np.float64)
            for j in range(1, min(K, t + 1)):
                acc = acc - h[j] * x[:, t - j]
            x[:, t] = acc / h[0]
        return x, settle, 0
    for t in range(T - 1, K - 2, -1):
        acc = y[:, t].astype(np.float64)
        for j in range(K - 1):
            acc = acc - h[j] * x[:, t - j]
        x[:, t - K + 1] = acc / h[K - 1]
    return x, 0, settle


def bank_compare(name: str, cli: np.ndarray, plain: np.ndarray,
                 taps: np.ndarray, carriers, lo: int, hi: int) -> float:
    """Over samples [lo, hi) of the span: carrier channels > 80 dB and
    within 1e-4 of the plain pipeline; every channel's discriminator
    output, recovered from the audio by deconvolving the whole span (the
    plain path starts at the span's start from a zero state), within
    0.01 rad angle-wrapped and > 80 dB, where the deconvolution is pinned
    down.  Returns the carriers' max |err|."""
    diff = cli.astype(np.float64) - plain
    d_plain, _, tail = deconvolve(plain, taps)
    e, head, _ = deconvolve(diff, taps)
    a_lo, a_hi = max(lo, head), min(hi, plain.shape[1] - tail)
    d_plain, e = d_plain[:, a_lo:a_hi], e[:, a_lo:a_hi]
    flips = int(np.sum(np.abs(e) > 1.0))
    e = np.mod(e + np.pi, 2 * np.pi) - np.pi
    worst, snrs = 0.0, []
    for c in carriers:
        s_db = snr_db(plain[c, lo:hi], cli[c, lo:hi])
        m = float(np.abs(diff[c, lo:hi]).max())
        check(s_db > BAR_BANK_DB and m < BAR_BANK_ATOL,
              f"{name} channel {c}: {s_db:.1f} dB, max|err| {m:.3g}")
        worst = max(worst, m)
        snrs.append(round(s_db, 1))
    a_err = float(np.abs(e).max())
    a_snr = min(10 * math.log10(np.mean(d_plain[c] ** 2)
                                / max(np.mean(e[c] ** 2), 1e-300))
                for c in range(cli.shape[0]))
    say(f"{name}: carrier channels {snrs} dB, max|err| {worst:.3g}; "
        f"discriminator of all {cli.shape[0]} channels (samples {a_lo}-"
        f"{a_hi} of the span) angle-wrapped max|err| {a_err:.3g} rad, worst "
        f"channel {a_snr:.1f} dB, {flips} flip(s) at +-pi")
    check(a_err < BAR_ANGLE and a_snr > BAR_BANK_DB,
          f"{name}: discriminator {a_err:.3g} rad, {a_snr:.1f} dB")
    return worst


def phase_bank(work: Path, dev) -> dict:
    """Phase 4, the channel bank: bank64 and bank4 through the CLI."""
    results = {}
    for name, (nch, n_bytes, carriers, per_call) in BANK_RUNS.items():
        cap = work / f"{name}.iq"
        t0 = time.perf_counter()
        write_bank_capture(cap, nch, n_bytes, carriers, dev)
        cfg = ChannelBankConfig(sample_rate=nch * CR, channel_rate=CR,
                                offsets_hz=tuple(bank_offsets(nch)),
                                block_seconds=0.25)
        pipe = ChannelBankPipeline(cfg, device="cpu")
        bb, A = pipe.block_bytes, pipe.audio_per_block
        nblk = n_bytes // bb
        say(f"{name} capture: {n_bytes} bytes ({nblk} blocks of {bb} bytes "
            f"+ a {n_bytes - nblk * bb}-byte tail, dropped) written in "
            f"{time.perf_counter() - t0:.1f} s")
        out = work / name
        phases = run_cli(cap, out, bank_args(nch))
        say(f"cli {name}: PHASES {json.dumps(phases)}")
        launches = int(phases["fused_pfb_launches"])
        check(launches > 0, f"cli {name}: fused_pfb was not launched")
        check(launches == -(-nblk // per_call),
              f"cli {name}: {launches} launches for {nblk} blocks")
        audio = np.stack([np.fromfile(f"{out}.ch{c}.raw", np.float32)
                          for c in range(nch)])
        check(audio.shape == (nch, nblk * A), f"cli {name}: {audio.shape}, "
              f"want {(nch, nblk * A)}")
        check(bool(np.all(np.isfinite(audio))), f"cli {name}: non-finite")
        taps = np.asarray(pipe.audio.taps, np.float64)
        raw = np.fromfile(cap, np.uint8)
        err = 0.0
        # spans of blocks [b0, b1) run through the plain path from a fresh
        # state, compared on blocks [c0, c0 + 2): the first two with a block
        # after them, the last two with two before them to settle
        for b0, b1, c0 in ((0, 3, 0), (nblk - 4, nblk, nblk - 2)):
            blocks = torch.from_numpy(raw[b0 * bb:b1 * bb].reshape(-1, bb))
            _, plain = pipe.call_u16(pipe.init_state(), blocks)
            err = max(err, bank_compare(
                f"cli {name} blocks {c0}-{c0 + 1} vs --device cpu plain "
                f"pipeline", audio[:, b0 * A:b1 * A],
                plain.numpy().astype(np.float64), taps, carriers,
                (c0 - b0) * A, (c0 - b0 + 2) * A))
        if name == "bank64":
            f = np.fft.rfftfreq(audio.shape[1], 1 / (CR / 2))
            w = np.hanning(audio.shape[1])
            found = []
            for i, c in enumerate(carriers):
                mag = np.abs(np.fft.rfft(audio[c] * w))
                peak = float(f[np.argmax(mag[3:]) + 3])
                found.append(round(peak, 2))
                check(abs(peak - (400.0 + 150.0 * i)) < 15.0,
                      f"cli {name} channel {c}: tone at {peak} Hz, want "
                      f"{400.0 + 150.0 * i}")
            say(f"cli {name}: carrier tones found at {found} Hz (within 15 "
                f"Hz of 400 + 150·i)")
        msps = nblk * bb / 2 / phases["run_s"] / 1e6
        say(f"cli {name}: {nblk} blocks, {nch} channels; end to end "
            f"{msps:.1f} Msamples/s of complex input (run {phases['run_s']} "
            f"s of {phases['wall_s']} s wall)")
        results[name] = {"launches": launches, "msps": msps, "max_err": err,
                         "phases": phases}
        cap.unlink()
        for c in range(nch):
            Path(f"{out}.ch{c}.raw").unlink()
    return results


def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` runs of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after warm-up.  A call slower than 5 ms (a plain
    version at 256 blocks) gets 5 runs of one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 5e-3:
        reps, inner = 5, 1
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_us(fn, kernel: str, calls: int = 20) -> tuple:
    """(device time in µs per call of ``fn`` of the CUDA kernels whose
    names contain ``kernel``, their launches per call), from
    torch.profiler: the kernels alone, without the host's launch overhead.
    A kernel's time per call is its mean per recorded launch times its
    launches per call, rounded (the profiler can drop a record).  (None, 0)
    when the profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if kernel in e.key]
    if not evts:
        return None, 0
    if len(evts) > 1:
        names = [re.search(r"\w+_kernel", e.key).group(0) for e in evts]
        say("  device time per call by kernel: " + "; ".join(
            f"{name} {e.device_time_total / calls:.1f} us"
            for name, e in zip(names, evts)))
    return (sum(e.device_time_total / e.count * max(1, round(e.count / calls))
                for e in evts),
            sum(e.count for e in evts) / calls)


# Operations counted for the bounds (float32, outside the tensor cores),
# per output word of the NBFM kernels: conditioning of 4 bytes (8), the
# conjugate product (6), atan2 (abs x2, max, min, division, z*z, Horner
# 2 per term after the first, z*z2*p and the add, 3 quadrant fixups: 26
# precise, 20 fast), NaN -> 0 (1), the audio FIR (2 per tap - 1); a complex
# FIR stage adds 2·(4·taps + 2) per word (2 complex samples, both lanes,
# the constant), correctIq 12 per word (4 offset subtractions and the two
# steps' recurrence on both lanes).  The PFB front counts, per complex
# sample, 4·P for the branch filter (both lanes) and 5·log2 C for the DFT
# as an FFT, and per output 6 + 20 + 1 for the fast discriminator.
def demod_ops(precise: bool, ntaps: int) -> int:
    return 8 + 6 + (26 if precise else 20) + 1 + 2 * ntaps - 1


def pfb_ops(n: int, C: int, P: int) -> float:
    return n * (4 * P + 5 * math.log2(C)) + n / 2 * 27


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) on the data-sheet peaks."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def run_cases(out: dict, tag, cases: dict, gbytes: float, label: str) -> None:
    """Time each case (CUDA events) and, for a kernel, its device time and
    its bound; store them in ``out`` under (name, tag[, key])."""
    for name, (fn, kernel, nbytes, ops) in cases.items():
        ms = time_ms(fn)
        out[(name, tag)] = ms
        line = (f"{label} {name:34s} {ms * 1e3:9.1f} us "
                f"{gbytes / (ms / 1e3):8.1f} GB/s")
        if kernel is not None:
            us, per_call = device_us(fn, kernel)
            b_ms, b_by = bound(nbytes, ops)
            out[(name, tag, "device_us")] = us
            out[(name, tag, "bound")] = (b_ms, b_by)
            line += ("; device time not measured (no profiler record)"
                     if us is None else f"; device {us:8.1f} us "
                     f"{gbytes / (us / 1e6):8.1f} GB/s, "
                     f"{us / (b_ms * 1e3):.1f}x its bound, "
                     f"{per_call:g} launch(es) per call")
            line += f" ({b_ms * 1e3:.2f} us, {b_by})"
            # K4 is one kernel: more than one launch per call is a fault
            # (fewer would be a record the profiler dropped)
            check(not name.startswith("fused_nbfm_q1 ") or per_call <= 1,
                  f"{name}: {per_call:g} kernel launches per call")
        say(line)


def phase_timings(dev, smi: str) -> dict:
    say("== phase 5: timings per call, as the caller sees them (CUDA events "
        "around 10 back-to-back calls, median of 20 runs, or 5 single "
        "calls for a call slower than 5 ms; host launch "
        "overhead included), and each CUDA kernel's device time alone "
        "(torch.profiler, mean of 20 calls), against its bound: the larger "
        f"of its bytes over {PEAK_BYTES / 1e12} TB/s and its float32 "
        f"operations over {PEAK_FP32 / 1e12:.0f} TFLOP/s (data sheet)")
    say(f"card: {smi}")
    taps = taps_of({"S": "96000", "l": "12500"})
    nt = len(taps)
    st1 = pipe_of(["-L", "12500"]).stage_consts()
    st2 = pipe_of(["-q", "2", "-L", "12500"]).stage_consts()
    cplx = [2 * (4 * len(t) + 2) for t, _ in st2]   # per word, per stage
    cplx1 = 2 * (4 * len(st1[0][0]) + 2)
    esr = float(pipe_of(["-q", "1"]).esr)
    off_in = torch.tensor([127.3, 126.8], device=dev)
    rng = np.random.default_rng(5)
    piece = tone_iq(NB * BB, 0, rng).reshape(NB, BB)
    out = {}
    for B in (NB, 256):
        raw = torch.from_numpy(np.tile(piece, (B // NB, 1))).to(dev)
        nbytes = 2 * raw.numel()      # n bytes read + n bytes written
        words = raw.numel() // 4
        gbytes = nbytes / 1e9
        # name -> (call, the profiler's kernel name or None for a plain
        # version, bytes, operations)
        k1p, k1f = demod_ops(True, nt), demod_ops(False, nt)
        cases = {
            "fused_nbfm precise": (lambda: fused_nbfm(raw, taps, "shift", True),
                                   "fused_nbfm_kernel", nbytes, k1p * words),
            "fused_nbfm fast": (lambda: fused_nbfm(raw, taps, "shift", False),
                                "fused_nbfm_kernel", nbytes, k1f * words),
            "fused_nbfm_ref precise": (
                lambda: fused_nbfm_ref(raw, taps, "shift", True), None, 0, 0),
            "fused_nbfm_ref fast": (
                lambda: fused_nbfm_ref(raw, taps, "shift", False), None, 0, 0),
            "dma_floor": (lambda: dma_floor(raw), "dma_floor_kernel", nbytes,
                          4 * words),
            "fused_nbfm_cplx 1 stage": (
                lambda: fused_nbfm_cplx(raw, st1, taps), "fused_nbfm_cplx",
                nbytes, (k1p + cplx1) * words),
            "fused_nbfm_cplx_ref 1 stage": (
                lambda: fused_nbfm_cplx_ref(raw, st1, taps), None, 0, 0),
            "fused_nbfm_cplx 2 stages": (
                lambda: fused_nbfm_cplx(raw, st2, taps), "fused_nbfm_cplx",
                nbytes, (k1p + sum(cplx)) * words),
            "fused_nbfm_cplx_ref 2 stages": (
                lambda: fused_nbfm_cplx_ref(raw, st2, taps), None, 0, 0),
            "fused_nbfm_cplx 2 stages fast": (
                lambda: fused_nbfm_cplx(raw, st2, taps, precise=False),
                "fused_nbfm_cplx", nbytes, (k1f + sum(cplx)) * words),
            "fused_nbfm_cplx_ref 2 stages fast": (
                lambda: fused_nbfm_cplx_ref(raw, st2, taps, precise=False),
                None, 0, 0),
            "fused_nbfm_q1 precise": (
                lambda: fused_nbfm_q1(raw, off_in, taps, esr), "q1_",
                nbytes, (k1p + 12) * words),
            "fused_nbfm_q1_ref precise": (
                lambda: fused_nbfm_q1_ref(raw, off_in, taps, esr), None, 0, 0),
            "fused_nbfm_q1_seq precise": (
                lambda: fused_nbfm_q1_seq(raw, off_in, taps, esr),
                "q1_seq_kernel", nbytes, (k1p + 12) * words),
            "fused_nbfm_q1_seq_ref precise": (
                lambda: fused_nbfm_q1_seq_ref(raw, off_in, taps, esr), None,
                0, 0),
        }
        run_cases(out, B, cases, gbytes,
                  f"B={B:3d} ({raw.numel() >> 20} MiB in)")
        for name in ("fused_nbfm precise", "fused_nbfm fast",
                     "fused_nbfm_cplx 1 stage", "fused_nbfm_cplx 2 stages",
                     "fused_nbfm_cplx 2 stages fast",
                     "fused_nbfm_q1 precise", "fused_nbfm_q1_seq precise"):
            us, floor = (out[(name, B, "device_us")],
                         out[("dma_floor", B, "device_us")])
            if us is not None and floor is not None:
                say(f"B={B:3d} {name}: device time {us / floor:.2f}x "
                    f"dma_floor's ({gbytes / (us / 1e6):.1f} GB/s against "
                    f"its {gbytes / (floor / 1e6):.1f})")
        del raw
    floor_us = out[("dma_floor", NB, "device_us")]
    floor_gbs = None if floor_us is None else 2 * NB * BB / 1e3 / floor_us

    # the channel bank: K6 on one bank64 block (C = 64) and one bank4
    # chunk (C = 4, 10 blocks), its plain version, and the audio FIR
    for name, (nch, _, carriers, per_call) in BANK_RUNS.items():
        pipe = ChannelBankPipeline(ChannelBankConfig(
            sample_rate=nch * CR, channel_rate=CR,
            offsets_hz=tuple(bank_offsets(nch)), block_seconds=0.25),
            device=dev)
        C, P = pipe.pfb.C, pipe.pfb.P
        n = pipe.block_complex * per_call
        say(f"{name}: K6's FFT plan C = {C} = "
            f"{' x '.join(map(str, fft_plan(C)))}")
        raw = bank_iq(nch * CR, bank_offsets(nch), carriers, 0, n, 7,
                      0.8 / len(carriers), dev)
        hist = pipe.pfb.init_hist(device=dev)
        h, h_dev = pipe.pfb._h_np, pipe._h_dev
        d, _ = fused_pfb_demod(raw, hist, h, C, h_dev=h_dev)
        dsel = d.T.index_select(0, pipe._rows)
        ahist = pipe.audio.init_hist((nch,))
        nbytes = raw.numel() + 4 * d.numel() + 2 * 4 * hist.numel()
        label = f"{name} C={C} ({per_call} block(s), {n} samples)"
        run_cases(out, name, {
            "fused_pfb": (lambda: fused_pfb_demod(raw, hist, h, C,
                                                  h_dev=h_dev),
                          "pfb_kernel", nbytes, pfb_ops(n, C, P)),
            "fused_pfb_ref": (lambda: fused_pfb_demod_ref(raw, hist, h, C),
                              None, 0, 0),
            "audio FIR": (lambda: pipe.audio(dsel, ahist), None, 0, 0),
        }, nbytes / 1e9, label)
        us = out[("fused_pfb", name, "device_us")]
        if us is not None and floor_gbs is not None:
            say(f"{label} fused_pfb: {nbytes / 1e3 / us:.1f} GB/s against "
                f"dma_floor's {floor_gbs:.1f} GB/s (B=16)")
        del raw, d, dsel
    return out


def main() -> int:
    say("== phase 1: device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: torch.cuda.is_available() is "
                         "false; this smoke run needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device: {kind}")
    say(smi)

    say("== phase 2: build")
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    say(f"built {lib.relative_to(REPO)} with nvcc "
        f"{' '.join(build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s")

    errs = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as d:
        main_path = phase_main_path(Path(d))
        say("== phase 4b: the channel bank through python -m "
            "demodulator_tpu_torch --bank")
        main_path.update(phase_bank(Path(d), dev))
    times = phase_timings(dev, smi)
    say("roofline: " + json.dumps({
        "name": "dma_floor", "route": "cuda",
        "source": SOURCES["dma_floor"][0],
        "replaces": SOURCES["dma_floor"][1], "ms": times[("dma_floor", NB)],
        "ms_256_blocks": times[("dma_floor", 256)]}))

    say(smi)
    kernels = []
    # (name, kernel, CLI run whose launches count (None: on no path),
    #  phase-3 error, timing tag, timing case of the kernel and of its plain
    #  version)
    for name, kernel, run, err, tag, (case, plain) in (
            ("fused_nbfm", "fused_nbfm", "precise", errs[("default", True)],
             NB, ("fused_nbfm precise", "fused_nbfm_ref precise")),
            ("fused_nbfm[fast]", "fused_nbfm", "fast",
             errs[("default", False)], NB,
             ("fused_nbfm fast", "fused_nbfm_ref fast")),
            ("fused_nbfm_cplx[-L]", "fused_nbfm_cplx", "-L",
             errs[("-L", True)], NB,
             ("fused_nbfm_cplx 1 stage", "fused_nbfm_cplx_ref 1 stage")),
            ("fused_nbfm_cplx[-q 2]", "fused_nbfm_cplx", "-q 2",
             errs[("-q 2", True)], NB,
             ("fused_nbfm_cplx 1 stage", "fused_nbfm_cplx_ref 1 stage")),
            ("fused_nbfm_cplx[-q 2 -L]", "fused_nbfm_cplx", "-q 2 -L",
             errs[("-q 2 -L", True)], NB,
             ("fused_nbfm_cplx 2 stages", "fused_nbfm_cplx_ref 2 stages")),
            ("fused_nbfm_cplx[-q 2 -L, fast]", "fused_nbfm_cplx",
             "-q 2 -L fast", errs[("-q 2 -L", False)], NB,
             ("fused_nbfm_cplx 2 stages fast",
              "fused_nbfm_cplx_ref 2 stages fast")),
            ("fused_nbfm_q1", "fused_nbfm_q1", "-q 1", errs[("-q 1", True)],
             NB, ("fused_nbfm_q1 precise", "fused_nbfm_q1_ref precise")),
            ("fused_nbfm_q1_seq", "fused_nbfm_q1_seq", None,
             errs[("q1_seq", True)], NB,
             ("fused_nbfm_q1_seq precise", "fused_nbfm_q1_seq_ref precise")),
            ("fused_pfb[bank64]", "fused_pfb", "bank64", errs["pfb"],
             "bank64", ("fused_pfb", "fused_pfb_ref")),
            ("fused_pfb[bank4]", "fused_pfb", "bank4", errs["pfb"], "bank4",
             ("fused_pfb", "fused_pfb_ref"))):
        b_ms, b_by = times[(case, tag, "bound")]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[kernel][0],
            "replaces": SOURCES[kernel][1],
            # K5 runs on no path, in either package: held in phase 3
            "launches": 0 if run is None else main_path[run]["launches"],
            "on_main_path": run is not None,
            "max_abs_err": err,
            "ms": times[(case, tag)], "plain_ms": times[(plain, tag)],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
