"""Where K4's and K6's device time goes: each kernel timed on the card with
sections cut out of its source.

    python -m demodulator_tpu_torch.ops.cuda.sections

builds variants of ``csrc/fused_pfb.cu`` and ``csrc/fused_nbfm_q1.cu`` (each
a copy with one more section replaced by a plain write, into a temporary
directory, with the package's nvcc flags), times each with torch.profiler
at the main paths' shapes on seeded random bytes (the kernels' work does not
depend on the data), and prints one ``SECTIONS {json}`` line of device µs
per launch.  K6 at C = 64 on one 0.25 s block of 12.288 Msps (bank64) and at
C = 4 on a 10-block chunk of 768 ksps (bank4), cumulatively: the output
alone, then staging, the branch filter, the discriminator, the FFT (the
whole kernel).  K4 at 16 and 256 blocks of 256 KiB, with tiles of 1024,
2048 and 4096 step pairs, and at Q1_TILE without its block look-back.  The
variants compute wrong outputs; only their times mean anything.  Needs an
NVIDIA GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import build, fused_nbfm, fused_pfb
from .. import conditioning as cond_ops
from ..channelizer import PolyphaseChannelizer

Q1_TILES = (1024, 2048, 4096)  # K4's tile sizes timed (Q1_TILE among them)


def _cut(src: str, start: str, end: str, new: str = "") -> str:
    """src with [start, end) replaced by new; start and end must occur."""
    i = src.index(start)
    return src[:i] + new + src[src.index(end, i):]


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"marker not in the source: {old!r}")
    return src.replace(old, new)


def pfb_variants() -> dict:
    src = (build.CSRC / "fused_pfb.cu").read_text()
    stage = ("  // this thread's words:",
             "  __syncthreads();\n\n  // the carried history")
    bf = ("  const int groups = (Fe + kRun - 1) / kRun;",
          "  __syncthreads();\n\n  // FFT of the even")
    # the FFT's two stages out: the discriminator reads z
    fft = ("      stage1_of<2, kR>(s.C1, fr, fi, u, tw, 2 * np, s, lane);",
           "      __syncwarp();\n    }\n  }\n}")
    demod = ("        out[q] = demod_pairs<kPrecise>(fr[e], fi[e], fr[e + ZS], "
             "fi[e + ZS]);")
    on_z = ("      for (int q = lane; q < np * C; q += 32) {\n"
            "        const int e = 2 * (q / C) * ZS + q % C;\n"
            + demod + "\n      }\n")
    small = ("small_pairs<kPrecise, 2, 2>(zr, zi, s, tw, d + (m0 / 2) * C, "
             "pairs);")
    copy = ("for (int j = threadIdx.x; j < pairs * C; j += kThreads) "
            "d[(m0 / 2) * C + j] = zr[j];")
    no_fft = _sub(_cut(src, *fft, on_z), small, copy)
    no_demod = _sub(no_fft, demod, "        out[q] = fr[e];")
    no_bf = _cut(no_demod, *bf)
    return {"output only": _sub(_cut(no_bf, *stage), "        out[q] = fr[e];",
                                "        out[q] = 0.0f;"),
            "+ staging": no_bf, "+ branch filter": no_demod,
            "+ discriminator": no_fft, "+ FFT (whole kernel)": src}


def q1_variants() -> dict:
    src = (build.CSRC / "fused_nbfm_q1.cu").read_text()
    look = ("const float2 e_blk = block_look_back(blk, blk_agg, blk_pre, off_in,"
            " a_blk, q, g.half);")
    return {"whole kernel": src,
            "without the block look-back": _sub(
                src, look, "const float2 e_blk = make_float2(off_in[0], "
                "off_in[1]);")}


def _compile(variants: dict, name: str, tmp: Path) -> dict:
    """{variant: ctypes library}, all compiled at once."""
    procs = []
    for i, (label, src) in enumerate(variants.items()):
        d = tmp / f"{name}{i}"
        d.mkdir()
        (d / f"{name}.cu").write_text(src)
        for h in build.HEADERS:
            (d / h).write_bytes((build.CSRC / h).read_bytes())
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), str(d / f"{name}.cu")]
        procs.append((label, d, subprocess.Popen(
            cmd, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for label, d, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {label!r}:\n{err}")
        libs[label] = ctypes.CDLL(str(d / "lib.so"))
    return libs


def device_us(fn, pattern: str, calls: int = 20) -> float:
    """Mean device time per launch of the kernel whose name holds pattern
    (each variant launches it once per call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if pattern in e.key]
    return sum(e.device_time_total for e in evts) / sum(e.count for e in evts)


def time_pfb(libs: dict, dev) -> dict:
    out = {}
    rng = np.random.default_rng(0)
    for run, C, n in (("bank64", 64, 3_072_000), ("bank4", 4, 1_920_000)):
        pfb = PolyphaseChannelizer(C)
        raw = torch.from_numpy(rng.integers(0, 256, 2 * n, np.uint8)).to(dev)
        hist = torch.zeros((2, pfb.hist_len), device=dev)
        h = torch.from_numpy(pfb._h_np.astype(np.float32)).to(dev)
        C1, C2 = fused_pfb.fft_plan(C)
        table = fused_pfb._table(C, dev)
        d = torch.empty((n // (2 * C), C), device=dev)
        nh = torch.empty_like(hist)
        for label, lib in libs.items():
            fn = lib.fused_pfb_launch
            fn.argtypes = build._SIGNATURES["fused_pfb_launch"]

            def call():
                rc = fn(raw.data_ptr(), hist.data_ptr(), h.data_ptr(),
                        table.data_ptr(), d.data_ptr(), nh.data_ptr(), n, C,
                        C1, C2, pfb.P, 0,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"fused_pfb {label}: CUDA error {rc}")
            out[f"K6 {run} C={C}: {label}"] = round(
                device_us(call, "pfb_kernel"), 2)
    return out


def time_q1(libs: dict, dev) -> dict:
    out = {}
    esr = float(np.float32(50.0 / 96000.0))
    taps = fused_nbfm._taps32([0.5, 0.5])
    taps_c = (ctypes.c_float * len(taps))(*taps.tolist())
    off_in = torch.tensor([127.3, 126.8], device=dev)
    rng = np.random.default_rng(1)
    for B in (16, 256):
        raw = torch.from_numpy(rng.integers(0, 256, (B, 262144), np.uint8)
                               ).to(dev)
        n = raw.shape[1]
        audio = torch.empty((B, n // 4), device=dev)
        ent = torch.empty((B, 2), device=dev)
        fin = torch.empty(2, device=dev)
        runs = [("whole kernel", t) for t in Q1_TILES]
        runs += [(label, fused_nbfm.Q1_TILE) for label in libs
                 if label != "whole kernel"]
        for label, tile in runs:
            lib = libs[label]
            off, table, tiles = fused_nbfm._q1_launch_args(raw, off_in, esr,
                                                           tile)
            fn = lib.fused_nbfm_q1_launch
            fn.argtypes = build._SIGNATURES["fused_nbfm_q1_launch"]

            def call():
                sync = torch.full((2 + 2 * (tiles + 2 * B),), -1,
                                  dtype=torch.int32, device=dev)
                rc = fn(raw.data_ptr(), audio.data_ptr(), off.data_ptr(),
                        ent.data_ptr(), fin.data_ptr(), sync.data_ptr(),
                        table.data_ptr(), tiles, B, n // 4, tile, taps_c,
                        len(taps), esr, cond_ops.decay_of(esr),
                        fused_nbfm._a_words(esr, n), 1,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"fused_nbfm_q1 {label}: CUDA error {rc}")
            out[f"K4 B={B} tile={tile}: {label}"] = round(
                device_us(call, "q1_kernel"), 2)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sections: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        res = time_pfb(_compile(pfb_variants(), "fused_pfb", tmp), dev)
        res.update(time_q1(_compile(q1_variants(), "fused_nbfm_q1", tmp),
                           dev))
    print("SECTIONS " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
