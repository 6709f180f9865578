"""Where K1's, K3's, K4's and K6's device time goes: each kernel timed on
the card with sections cut out of its source.

    python -m demodulator_tpu_torch.ops.cuda.sections [span] [pfb] [q1]

builds variants of ``csrc/fused_nbfm.cu`` and ``csrc/fused_nbfm_cplx.cu``
(with ``csrc/nbfm_span.cuh`` cut), ``csrc/fused_pfb.cu`` and
``csrc/fused_nbfm_q1.cu`` (each a copy with one more section replaced by a
plain write, into a temporary directory, with the package's nvcc flags),
times each with torch.profiler at the main paths' shapes on seeded random
bytes (the kernels' work does not depend on the data), and prints one
``SECTIONS {json}`` line of device µs per launch.  K1 (precise, 2 audio
taps) and K3 with one stage (-L) and two (-q 2 -L) at 16 and 256 blocks of
256 KiB, cumulatively: the output store alone, then the loads and
conditioning, the stages, the discriminator, the audio FIR (the whole
kernel); the whole kernels and dma_floor (K2) with 1 and 2 16-byte chunks
per lane (SPAN_VECS), and the whole kernels with the halo by a
shared-memory exchange between warps instead of overlapping warp spans
(each alternative checked equal to the package's kernel).  K6 at C = 64 on one 0.25 s block of 12.288 Msps
(bank64) and at C = 4 on a 10-block chunk of 768 ksps (bank4),
cumulatively: the output alone, then staging, the branch filter, the
discriminator, the FFT (the whole kernel).  K4 at 16 and 256 blocks of
256 KiB, with tiles of 1024, 2048 and 4096 step pairs, and at Q1_TILE
without its block look-back.  The variants compute wrong outputs; only
their times mean anything.  The arguments pick the kernels (span: K1, K2
and K3; pfb: K6; q1: K4); none, all.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
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


# K1's and K3's span body (csrc/nbfm_span.cuh): what replaces the sections
# cut out; the sum keeps every conditioned (or staged) sample live
_SPAN_TAIL = "  // stores:"
_LOOPS = ("  float y[kVecs][4];\n#pragma unroll\n"
          "  for (int c = 0; c < kVecs; ++c)\n#pragma unroll\n"
          "    for (int i = 0; i < 4; ++i)\n")
_SUM_Z = (_LOOPS +
          "      y[c][i] = z[c][2 * i].x + z[c][2 * i].y + z[c][2 * i + 1].x"
          " + z[c][2 * i + 1].y;\n")


# The other way across the warp boundary: a CTA's 8 warps own consecutive
# chunks, a warp's look-ahead past its lane 31 comes from the next warp's
# first lanes through shared memory (one exchange per stage and one for
# the FIR, a __syncthreads before and after each read), and only the CTA's
# spans overlap by the halo.
_GATHER_XCHG = """template <int P, int M, class T>
__device__ __forceinline__ void gather(const T (&v)[kVecs][P], T (&e)[kVecs][M], int lane,
                                       int live) {
  __shared__ T xs[kWarps + 1][M];
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (m < live && lane == m / P) xs[warp][m] = v[0][m % P];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (m < live) {
      const int src = lane + 1 + m / P;
      T s[kVecs];
#pragma unroll
      for (int c = 0; c < kVecs; ++c) s[c] = shfl(v[c][m % P], src & 31);
#pragma unroll
      for (int c = 0; c < kVecs; ++c) {
        constexpr int kLast = kVecs - 1;
        if (src < 32) e[c][m] = s[c];
        else if (c < kLast) e[c][m] = s[c < kLast ? c + 1 : c];
        else e[c][m] = xs[warp + 1][(src - 32) * P + m % P];
      }
    }
  }
  __syncthreads();
}

"""


def _exchange(src: str) -> str:
    i = src.index("template <int P, int M, class T>")
    j = src.index("// Stage S:")
    src = src[:i] + _GATHER_XCHG + src[j:]
    for old, new in (
            ("  return kSpanWords - (halo + 3) / 4 * 4;",
             "  return kWarps * kSpanWords - (halo + 3) / 4 * 4;"),
            ("  const int span = blockIdx.x * kWarps + (threadIdx.x >> 5);\n"
             "  if (span >= a.spans) return;  // whole warps",
             "  const int span = blockIdx.x;\n"
             "  if (span >= a.spans) return;  // whole CTAs"),
            ("  const long long w0 = static_cast<long long>(span) * a.step;",
             "  const long long w0 = static_cast<long long>(span) * a.step"
             " + (threadIdx.x >> 5) * kSpanWords;"),
            ("    if (128 * c + 4 * lane >= a.step) continue;",
             "    if ((threadIdx.x >> 5) * kSpanWords + 128 * c + 4 * lane >="
             " a.step) continue;"),
            ("(spans + kWarps - 1) / kWarps", "spans")):
        src = _sub(src, old, new)
    return src


def span_variants(stages: bool) -> dict:
    """{label: {file: text}} of the span body cut cumulatively (K1 has no
    stages to add), and the whole body with 2 chunks per lane and with the
    halo by a shared-memory exchange."""
    src = (build.CSRC / "nbfm_span.cuh").read_text()
    out = {"output only": _cut(src, "  // loads", _SPAN_TAIL,
                               "  float y[kVecs][4] = {};\n"),
           "+ loads and conditioning": _cut(src, "  // the complex stages",
                                            _SPAN_TAIL, _SUM_Z)}
    if stages:
        out["+ stages"] = _cut(src, "  // the discriminator", _SPAN_TAIL,
                               _SUM_Z)
    out["+ discriminator"] = _cut(
        src, "  // the audio FIR", _SPAN_TAIL,
        _LOOPS + "      y[c][i] = x[c][i];\n")
    out["+ audio FIR (whole kernel)"] = src
    out["whole kernel, 2 chunks per lane"] = _sub(
        src, "constexpr int kVecs = 1;", "constexpr int kVecs = 2;")
    out["whole kernel, halo by a shared-memory exchange"] = _exchange(src)
    return {label: {"nbfm_span.cuh": text} for label, text in out.items()}


def _compile(variants: dict, name: str, tmp: Path) -> dict:
    """{variant: ctypes library}, all compiled at once.  A variant is the
    text of ``name``.cu, or {file: text} of the files it replaces."""
    procs = []
    for i, (label, files) in enumerate(variants.items()):
        d = tmp / f"{name}{i}"
        d.mkdir()
        if isinstance(files, str):
            files = {f"{name}.cu": files}
        for f in (f"{name}.cu", *build.HEADERS):
            (d / f).write_text(files.get(f, (build.CSRC / f).read_text()))
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
    if not evts:
        raise RuntimeError(f"no {pattern!r} kernel in the profile: "
                           f"{[e.key for e in prof.key_averages()]}")
    return sum(e.device_time_total for e in evts) / sum(e.count for e in evts)


def time_span(k1_libs: dict, k3_libs: dict, dev) -> dict:
    """K1 precise and K3 with one stage (-L) and two (-q 2 -L) at the CLI's
    taps (-S 96000 -l 12500 -L 12500: 2 audio taps, stages of 2), and
    dma_floor beside the whole kernels."""
    out = {}
    taps = fused_nbfm._taps32([0.5, 0.5])
    taps_c = (ctypes.c_float * len(taps))(*taps.tolist())
    st = np.zeros((fused_nbfm.MAX_STAGES, fused_nbfm.MAX_CPLX_TAPS),
                  np.float32)
    st[:, :2] = [[0.9, -0.9], [0.5, 0.5]]
    st_c = (ctypes.c_float * st.size)(*st.ravel().tolist())
    st_n = (ctypes.c_int * fused_nbfm.MAX_STAGES)(2, 2)
    sc = (ctypes.c_float * 4)(0.0, -2.0, 0.0, -2.0)
    stages = tuple((st[i, :2], (0.0, -2.0)) for i in range(2))
    rng = np.random.default_rng(2)
    for B in (16, 256):
        raw = torch.from_numpy(rng.integers(0, 256, (B, 262144), np.uint8)
                               ).to(dev)
        words = raw.shape[1] // 4
        y = torch.empty((B, words), device=dev)
        # the package's kernels, which the alternatives must equal
        wants = [fused_nbfm.fused_nbfm(raw, taps)] + [
            fused_nbfm.fused_nbfm_cplx(raw, stages[:ns], taps)
            for ns in (1, 2)]
        torch.cuda.synchronize()
        runs = [("K1", label, lib, 0) for label, lib in k1_libs.items()]
        runs += [(f"K3 {ns} stage{'s' * (ns > 1)}", label, lib, ns)
                 for ns in (1, 2) for label, lib in k3_libs.items()]
        for kernel, label, lib, ns in runs:
            if ns == 0:
                fn = lib.fused_nbfm_launch
                fn.argtypes = build._SIGNATURES["fused_nbfm_launch"]
                args = (taps_c, len(taps), 1, 0)
            else:
                fn = lib.fused_nbfm_cplx_launch
                fn.argtypes = build._SIGNATURES["fused_nbfm_cplx_launch"]
                args = (taps_c, len(taps), st_c, st_n, sc, ns, 1, 0)

            def call():
                rc = fn(raw.data_ptr(), y.data_ptr(), B, words, *args,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{kernel} {label}: CUDA error {rc}")
            pattern = "fused_nbfm_kernel" if ns == 0 else "fused_nbfm_cplx"
            key = f"{kernel} B={B}: {label}"
            out[key] = round(device_us(call, pattern), 2)
            print(f"{key}: {out[key]} us", file=sys.stderr, flush=True)
            if "whole kernel" in label:   # the alternatives compute K1/K3
                call()
                out[f"{key}: equal to the package's"] = bool(
                    torch.equal(y, wants[ns]))
        for label, lib in k1_libs.items():
            if label not in ("+ audio FIR (whole kernel)",
                             "whole kernel, 2 chunks per lane"):
                continue
            fn = lib.dma_floor_launch
            fn.argtypes = build._SIGNATURES["dma_floor_launch"]

            def floor():
                rc = fn(raw.data_ptr(), y.data_ptr(), B * words,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"dma_floor {label}: CUDA error {rc}")
            vecs = 2 if label.startswith("whole kernel, 2") else 1
            key = f"K2 B={B}: {vecs} chunk(s) per lane"
            out[key] = round(device_us(floor, "dma_floor_kernel"), 2)
            print(f"{key}: {out[key]} us", file=sys.stderr, flush=True)
        del raw, y, wants
    return out


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


def main(argv=None) -> int:
    kernels = set(sys.argv[1:] if argv is None else argv) or {"span", "pfb",
                                                              "q1"}
    if not kernels <= {"span", "pfb", "q1"}:
        raise SystemExit(f"sections: unknown kernels {sorted(kernels)}")
    if not torch.cuda.is_available():
        raise SystemExit("sections: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if "span" in kernels:
            res.update(time_span(
                _compile(span_variants(False), "fused_nbfm", tmp),
                _compile(span_variants(True), "fused_nbfm_cplx", tmp), dev))
        if "pfb" in kernels:
            res.update(time_pfb(_compile(pfb_variants(), "fused_pfb", tmp),
                                dev))
        if "q1" in kernels:
            res.update(time_q1(_compile(q1_variants(), "fused_nbfm_q1", tmp),
                               dev))
    print("SECTIONS " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
