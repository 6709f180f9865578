"""Where K1's, K3's, K4's and K6's device time goes: each kernel timed on
the card with sections cut out of its source.

    python -m demodulator_tpu_torch.ops.cuda.sections [span] [pfb] [step]
        [q1] [head] [--parent DIR]

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
discriminator, the FFT (the whole kernel); and K6's three-factor
route at C = 512, 1024, 2048 and 4096 on one 0.25 s block of 6.25 kHz
channels (3.2 to 25.6 Msps), cumulatively: the output alone, then the
branch filter (with its input staging), stage 1, stage 2, stage 3 with the
discriminator (the whole kernel), for ``pfb_big_kernel`` (the route of any
plan not compiled in, which a variant makes these C take) and for
``pfb_wide_kernel`` (the compiled-in plans), with every variant's
registers, stack and spills as ``-Xptxas -v`` reports them; with
``--parent DIR`` (a checkout's ``demodulator_tpu_torch/csrc``) also that
tree's K6 at every C of ``WIDE_TIMED``, at the off-plan grids of
``WIDE_OFF_PLAN`` and at bank64's and bank4's C, timed in turns with this
tree's as built (parent, this, this, parent), each held to the plain
version and the two trees' outputs compared bit for bit.  ``step``: K6's
four-step route (C > 4096) at C = 4800, 6144, 8192, 8198 and 16384 on one
0.25 s block of 6.25 kHz channels through the package's wrapper (the
cluster kernel, or at 8198 the two passes), the device µs a call of each
kernel held to the plain version, also after a second of calls back to
back; at 4800 and 8192 the two-pass route's pass 1 cut cumulatively (the
launch and the history alone, + branch filter, + FFT, + the store of Y)
and the cluster kernel cut cumulatively (d from X alone, + branch filter,
+ step A, + the exchange, + step B with the discriminator) with the
diagnostic cuts and the alternatives of ``cluster_variants``, every
variant's ``-Xptxas -v``; with ``--parent DIR`` also that tree's route
and this one's in turns at every C, the outputs held to each other at
the phase-3 bars and the histories bit-equal.  K4 at 16 and 256 blocks of
256 KiB, with tiles of 1024, 2048 and 4096 step pairs, and at Q1_TILE
without its block look-back.  The variants compute wrong outputs; only
their times mean anything.  ``head``: K1 (precise and fast) and K4
(precise) alone and with their float64 head rows (``head=``, the CLI's
audio filter) at 2, 16 and 256 blocks, as built and with the head
variants' registers not held to the spans' occupancy (``__launch_bounds__``
without its CTA count), each held equal to the package's output (K4's
head rows from its own entering offsets); K1 also with the head warp's
work cut, with the spans' store mask cut, and both (wrong rows: what each
part costs); every variant's registers, stack and spills as ``-Xptxas
-v`` reports them.
The arguments pick the kernels (span: K1, K2 and K3; pfb: K6; step: K6's
four-step route; q1: K4; head: K1 and K4 with their heads); none, all.
Needs an NVIDIA GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import build, fused_nbfm, fused_pfb, nbfm_patch
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


# K6's three-factor route: the C timed, and what replaces stage 3 in the
# variants that cut it (each frame's spectrum, or the filter's outputs,
# copied out, so nothing before it is dead)
WIDE_CUT_C = (512, 1024, 2048, 4096)
WIDE_TIMED = (384, 512, 1024, 2048, 4096)
WIDE_OFF_PLAN = (320, 3200)     # pfb_big_kernel: 2 and 20 Msps at 6.25 kHz
_WIDE_OUT = """template <class W>
__device__ __forceinline__ void wide_out(const double2* U, float* rows,
                                         int np) {
  for (int k = threadIdx.x; k < np * W::C; k += W::T) {
    rows[k] = static_cast<float>(U[k].x);
  }
}

"""


def wide_variants() -> dict:
    """{label: fused_pfb.cu text}: ``pfb_big_kernel`` (every three-factor
    plan forced onto it) and ``pfb_wide_kernel`` cut cumulatively."""
    # no two-factor kernel is instantiated: the variants build in a
    # fraction of the file's time
    args = "(src, hi, hp, tb, out, nh, n, C, C1, C2, P, s)"
    src = _sub((build.CSRC / "fused_pfb.cu").read_text(),
               f"  return precise ? launch_plan<true>{args}\n"
               f"                 : launch_plan<false>{args};",
               "  return static_cast<int>(cudaErrorInvalidValue);")
    big = _sub(src, "const int rc = P == kTaps ? wide_plan(",
               "const int rc = false ? wide_plan(")
    # pfb_big_kernel: stage 3 -> the spectra and z copied out; stage 2;
    # stage 1 (both cut out of sub_stages12, which the four-step passes
    # share: only pfb_big_kernel is timed); the branch filter
    b3 = _cut(big, "  sub_stage3_of<false, true>(U, tw, b.s,",
              "\n}\n\nconstexpr int kMaxDevices",
              "  for (int k = threadIdx.x; k < C; k += kThreads) {\n"
              "    row[k] = static_cast<float>(U[k].x) + Z[k].x;\n  }")
    end12 = "}\n\n__device__ __forceinline__ float2 round_f32"
    b2 = _cut(b3, "  if (s.C2 > 1) {", end12)
    b1 = _cut(b2, "  switch (s.C1) {", end12)
    b0 = _cut(b1, "  // branch filter: the odd frame",
              "  float* row = d + static_cast<long long>")
    # pfb_wide_kernel: the same cuts; the output only also without the
    # input's staging
    w3 = _sub(_sub(_sub(src, "// CTA b takes units [b U / grid", _WIDE_OUT
                        + "// CTA b takes units [b U / grid"),
                   "      wide_stage3<W>(U, d + u * W::G * C, np, precise);",
                   "      wide_out<W>(U, d + u * W::G * C, np);"),
              "        wide_stage3_seq<W>(U, row, f, yr, yi, precise);",
              "        if (f) wide_out<W>(U, row, 1);")
    w2 = _sub(w3, "wide_stage2<W>(U, tw);", "")
    w1 = _sub(_sub(w2, "wide_stage1<W>(U, Zo, tw, f != 0);", ""),
              "wide_stage1<W>(U, Zo, tw, false);", "")
    w0 = _cut(w1, "    if (bulk) ring_wait(bar, phase);",
              "    if constexpr (W::kSeq) {")
    w0 = _cut(w0, "  wide_fill<W>(in, ring, bar, max(ua * NF - P, 0LL)",
              "  float yr[W::C3], yi[W::C3];")
    out = {}
    for name, texts in (("pfb_big_kernel", (b0, b1, b2, b3, big)),
                        ("pfb_wide_kernel", (w0, w1, w2, w3, src))):
        for label, text in zip(WIDE_CUTS, texts):
            out[f"{name}: {label}"] = text
    return out


WIDE_CUTS = ("output only", "+ branch filter", "+ stage 1", "+ stage 2",
             "+ stage 3 with the discriminator (whole kernel)")


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
            ("  const int span = blockIdx.x * kWarps + (threadIdx.x >> 5) - kHead;\n"
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


def head_variants(name: str) -> dict:
    """K1's (``name`` "fused_nbfm") or K4's ("fused_nbfm_q1") source as
    built, and with its head variants' ``__launch_bounds__`` CTA count
    taken out (their registers not held).  K1 also: {file: text} with the
    head warp's work cut (it returns at once), with the spans' store mask
    cut (they store the head rows too), and both: what each part of the
    head costs the launch (these compute wrong rows)."""
    src = (build.CSRC / f"{name}.cu").read_text()
    held = {"fused_nbfm": "__launch_bounds__(kThreads, HeadCtas<kT, kPrecise>::value)",
            "fused_nbfm_q1": "__launch_bounds__(kThreads, kQ1Ctas)"}[name]
    out = {"as built": src,
           "registers unheld": _sub(src, held, "__launch_bounds__(kThreads)")}
    if name == "fused_nbfm":
        span = (build.CSRC / "nbfm_span.cuh").read_text()
        no_work = _sub(src, "    fused_head<kPrecise, kNormalize>(a.in + row, a.out + row, "
                       "head, head_smem);\n", "")
        no_mask = _sub(span, "if (__any_sync(kFullMask, w0 < a.head_rows)) {",
                       "if (false) {")
        out["head warp returns at once"] = no_work
        out["spans store the head rows too"] = {f"{name}.cu": src,
                                                "nbfm_span.cuh": no_mask}
        out["both cut"] = {f"{name}.cu": no_work, "nbfm_span.cuh": no_mask}
    return out


def _ptxas_rows(stderr: str) -> dict:
    """{kernel (demangled, without its parameters): "R regs, S B stack,
    spills L/S"} from ``-Xptxas -v``'s report."""
    import re
    rows, cur = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and cur:
            rows[cur] = f"{m.group(1)} B stack, spills " \
                        f"{m.group(3)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            rows[cur] = f"{m.group(1)} regs, {rows.get(cur, '')}"
    names = subprocess.run(["c++filt"], input="\n".join(rows),
                           capture_output=True, text=True).stdout.split("\n")
    return {re.sub(r"\(.*", "", n.replace("(anonymous namespace)::", ""))
            + (" with its head" if re.search(r"PatchAudioFir|Q1Head", n)
               else ""): v
            for n, v in zip(names, rows.values()) if "regs" in v}


def ptxas_regs(variants: dict, name: str, tmp: Path) -> dict:
    """{variant: {kernel: "R regs, S B stack, spills L/S"}} from ``nvcc
    -Xptxas -v`` on each variant's ``name``.cu with the package's flags."""
    out = {}
    for i, (label, text) in enumerate(variants.items()):
        d = tmp / f"regs_{name}{i}"
        d.mkdir()
        files = text if isinstance(text, dict) else {f"{name}.cu": text}
        for f in (f"{name}.cu", *build.HEADERS):
            (d / f).write_text(files.get(f, (build.CSRC / f).read_text()))
        r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-c", "-o", str(d / "k.o"), str(d / f"{name}.cu")],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {label!r}:\n{r.stderr}")
        out[label] = _ptxas_rows(r.stderr)
    return out


def _compile(variants: dict, name: str, tmp: Path, regs=None) -> dict:
    """{variant: ctypes library}, all compiled at once.  A variant is the
    text of ``name``.cu, or {file: text} of the files it replaces.  With a
    dict ``regs``: built with ``-Xptxas -v``, each variant's report into
    regs[variant] as :func:`ptxas_regs` gives it."""
    procs = []
    for i, (label, files) in enumerate(variants.items()):
        # a fresh directory a variant: several sets of one source share tmp
        d = Path(tempfile.mkdtemp(prefix=f"{name}{i}_", dir=tmp))
        if isinstance(files, str):
            files = {f"{name}.cu": files}
        for f in (f"{name}.cu", *build.HEADERS):
            (d / f).write_text(files.get(f, (build.CSRC / f).read_text()))
        cmd = [build.nvcc(), *build.NVCC_FLAGS,
               *(("-Xptxas", "-v") if regs is not None else ()), "-shared",
               "-o", str(d / "lib.so"), str(d / f"{name}.cu")]
        procs.append((label, d, subprocess.Popen(
            cmd, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for label, d, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {label!r}:\n{err}")
        if regs is not None:
            regs[label] = _ptxas_rows(err)
        libs[label] = ctypes.CDLL(str(d / "lib.so"))
    return libs


def device_us(fn, pattern: str, calls: int = 20, tries: int = 3) -> float:
    """Mean device time per launch of the kernel whose name holds pattern
    (each variant launches it once per call); profiled again, up to
    ``tries`` times, while the profiler records no such kernel (it can
    lose a window's device records)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if pattern in e.key]
        if evts:
            break
    else:
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
                args = (taps_c, len(taps), 1, 0, None)
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


def _wide_inputs(C: int, dev, n: int | None = None):
    """n samples (default: one 0.25 s block of C 6.25 kHz channels) of
    seeded random bytes (the kernels' work does not depend on the data) and
    the launch's buffers."""
    pfb = PolyphaseChannelizer(C)
    n = n or int(0.25 * C * 6250.0) // (2 * C) * (2 * C)
    rng = np.random.default_rng(C)
    raw = torch.from_numpy(rng.integers(0, 256, 2 * n, np.uint8)).to(dev)
    hist = torch.from_numpy(rng.standard_normal((2, pfb.hist_len)).astype(
        np.float32)).to(dev)
    h = torch.from_numpy(pfb._h_np.astype(np.float32)).to(dev)
    d = torch.empty((n // (2 * C), C), device=dev)
    return pfb, n, raw, hist, h, d, torch.empty_like(hist)


def _pfb_call(lib, C, n, raw, hist, h, d, nh, P, label):
    fn = lib.fused_pfb_launch
    fn.argtypes = build._SIGNATURES["fused_pfb_launch"]
    C1, C2 = fused_pfb.fft_plan(C)[:2]
    table = fused_pfb._table(C, raw.device)

    def call():
        rc = fn(raw.data_ptr(), hist.data_ptr(), h.data_ptr(),
                table.data_ptr(), d.data_ptr(), nh.data_ptr(), n, C, C1, C2,
                P, 0, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fused_pfb {label} C={C}: CUDA error {rc}")
    return call


def _holds_bars(pfb, C, raw, hist, d, nh, want=None) -> bool:
    """d and the new history against the plain version (``want``: its
    (d, new_hist), computed here when not given): angle-wrapped max|err| <
    0.01 rad, > 80 dB, the history bit-equal."""
    want, want_h = want or fused_pfb.fused_pfb_demod_ref(raw, hist,
                                                         pfb._h_np, C)
    e = torch.remainder(d.double() - want.double() + np.pi, 2 * np.pi) - np.pi
    snr = 10 * np.log10(float((want.double() ** 2).mean())
                        / max(float((e ** 2).mean()), 1e-300))
    return bool(float(e.abs().max()) < 0.01 and snr > 80.0
                and torch.equal(nh, want_h))


def time_wide(libs: dict, dev, parent=None) -> dict:
    """The cumulative cuts at WIDE_CUT_C; with ``parent`` (a library of
    another tree's fused_pfb.cu), that tree's K6 and this one's at every C
    of WIDE_TIMED and WIDE_OFF_PLAN and at bank64's and bank4's in turns,
    parent, this, this, parent, their outputs compared bit for bit."""
    out = {}
    for C in WIDE_CUT_C:
        pfb, n, raw, hist, h, d, nh = _wide_inputs(C, dev)
        for label, lib in libs.items():
            call = _pfb_call(lib, C, n, raw, hist, h, d, nh, pfb.P, label)
            key = f"K6 C={C} {label}"
            out[key] = round(device_us(call, label.split(":")[0]), 2)
            print(f"{key}: {out[key]} us", file=sys.stderr, flush=True)
            if "whole kernel" in label:
                call()
                out[f"{key}: holds the bars"] = _holds_bars(pfb, C, raw, hist,
                                                            d, nh)
        del raw, d
    if parent is None:
        return out
    this = build.load()
    # the three-factor route's C, then the staged route's bank64 block and
    # bank4 chunk (time_pfb's)
    for C, n in ([(C, None) for C in WIDE_TIMED + WIDE_OFF_PLAN]
                 + [(64, 3_072_000), (4, 1_920_000)]):
        pfb, n, raw, hist, h, d, nh = _wide_inputs(C, dev, n)
        times = {"parent": [], "this": []}
        outs = {}
        for who in ("parent", "this", "this", "parent"):
            lib = parent if who == "parent" else this
            call = _pfb_call(lib, C, n, raw, hist, h, d, nh, pfb.P, who)
            # each tree launches one K6 kernel a call
            times[who].append(round(device_us(call, "pfb_"), 2))
            call()
            outs.setdefault(who, (d.clone(), nh.clone()))
            out[f"K6 C={C} {who}: holds the bars"] = _holds_bars(
                pfb, C, raw, hist, d, nh) and out.get(
                f"K6 C={C} {who}: holds the bars", True)
        for who, ts in times.items():
            out[f"K6 C={C} {who} (in turns)"] = ts
        out[f"K6 C={C}: this equal to the parent bit for bit"] = all(
            torch.equal(a, b) for a, b in zip(outs["parent"], outs["this"]))
        print(f"K6 C={C} in turns: {times}", file=sys.stderr, flush=True)
        del raw, d
    return out


# K6's four-step route: the C timed; the C cut into sections (pass 1 of
# the two-pass route and the cluster kernel); what replaces the cut parts'
# output (a value of each part's result compared, so nothing before it is
# dead, and the cluster variants' d written from X)
STEP_C = (4097, 4800, 6144, 8192, 8198, 16384)
STEP_CUT_C = (4800, 8192)
STEP_SUSTAIN_S = 1.0    # back-to-back calls before the "sustained" window
PASS1_CUTS = ("output only", "+ branch filter", "+ FFT",
              "+ store of Y (whole pass 1)")
CLUSTER_CUTS = ("output only", "+ branch filter", "+ step A", "+ exchange",
                "+ step B with the discriminator (whole kernel)")
_CL_OUT = """    for (int t = threadIdx.x; t < C / W::K; t += W::T) {
      d[j * C + rank * (C / W::K) + t] = static_cast<float>(X[t].x);
    }
"""
_CL_XCHG = """    double s = 0.0;
#pragma unroll
    for (int i = 0; i < R; ++i) s += v[i].x + v[i].y;
    row[kb0 / NB * (W::C / W::K) + (f * NB + l) * D + dd] = static_cast<float>(s);
  }
}
"""


def pass1_variants() -> dict:
    """{label: fused_pfb.cu text}: ``pfb_pass1_kernel`` cut cumulatively
    (PASS1_CUTS): the launch and the new history alone, then the branch
    filter, the N2-point FFTs (stage 3's outputs compared, not stored), the
    twiddled store of Y (the whole pass).  Pass 2 runs as built on what Y
    holds."""
    args = "(src, hi, hp, tb, out, nh, n, C, C1, C2, P, s)"
    src = _sub((build.CSRC / "fused_pfb.cu").read_text(),
               f"  return precise ? launch_plan<true>{args}\n"
               f"                 : launch_plan<false>{args};",
               "  return static_cast<int>(cudaErrorInvalidValue);")
    fft = _sub(src, "      Yp[e * C + k2 * N1 + n1] = n1 * k2 ? "
               "cmul(y, __ldg(tw + n1 * k2)) : y;",
               "      if (y.x == 1234.5) Yp[e * C + k2 * N1 + n1] = y;")
    consumer = ("  if (Z[threadIdx.x].x == 1234.5f) Y[blockIdx.x] = "
                "make_double2(0.0, 0.0);\n}")
    bf = _cut(src, "  sub_stages12(\n      [&](int f, int c) {\n"
              "        const float2 z = Z[f * ZS + c];",
              "\n\n// CTA b: pair b / tiles of the group, its tile b % "
              "tiles of k2", consumer)
    out = _cut(bf, "  // branch filter of channel a + tt + N1*n2, tt fastest",
               consumer)
    return dict(zip(PASS1_CUTS, (out, bf, fft, src)))


def cluster_variants() -> dict:
    """{label: fused_pfb_cluster.cu text}: ``pfb_cluster_kernel`` cut
    cumulatively (CLUSTER_CUTS): d written from X alone, then the branch
    filter from the ring (and its asynchronous copies), step A, the
    exchange (the cluster barrier and step B's reads through distributed
    shared memory, the values summed into d), step B's stages with the
    discriminator (the whole kernel); the filter's cut with its taps a
    constant (what reading them costs) and without the next pair's rows
    copied in (what the copies cost); the exchange's cut without its reads
    (what the barrier costs); the whole kernel with each plan's taps the
    other way (kRegTaps: held in registers where the plan reads them, read
    where it holds them)."""
    src = (build.CSRC / "fused_pfb_cluster.cu").read_text()
    xchg = _cut(src, "    cl_dft<R>(v);\n    const double2 w = __ldg(tw + dd * N2);",
                "\n// Rows [ra, rb) of the CTA's ring", _CL_XCHG)
    step_b = ("    cluster_arrive();  // Y of every CTA written\n"
              "    cluster_wait();\n"
              "    step_b<W>(X, XB, tw, d + j * C, kb0, live, precise);\n")
    a = _sub(src, step_b, _CL_OUT)
    bf = _cut(a, "    // step A: the N2-point FFTs of this CTA's n1",
              _CL_OUT)
    out = _sub(_cut(bf, "    if (2 * j < P) {\n      cl_filter<W, true>(",
                    _CL_OUT),
               "  cl_fill<W>(in, ring, max(2 * ja - P, 0LL), 2 * ja + 1, a, "
               "aligned);\n", "")
    barriers = _sub(xchg, "      v[i] = ld_cluster(base + 16u * (n1 % NA), "
                    "n1 / NA);", "      v[i] = make_double2(base + n1, 0.0);")
    held = src
    for C in STEP_CUT_C:
        row = src[src.index(f"  PFB_CLUSTER({C}, "):]
        row = row[:row.index("\n")]
        plan = row[:row.index(">", row.rindex("Stages<")) + 1]
        held = _sub(held, row, plan + (")" if row.endswith(", true)")
                                       else ", true)"))
    taps = _sub(bf, "        return __ldg(h + p * C + c);",
                "        return 0.5f + p;")
    copies = _sub(bf, "    if (j + 1 < jb) cl_fill<W>(in, ring, 2 * j + 1, "
                  "2 * j + 3, a, aligned);\n", "")
    return {**dict(zip(CLUSTER_CUTS, (out, bf, a, xchg, src))),
            "+ branch filter, its taps a constant": taps,
            "+ branch filter, no copies of the next rows": copies,
            "+ step A and the cluster barrier, no reads": barriers,
            "whole kernel, each plan's taps the other way": held}


def _step_window(call, calls: int, C: int) -> dict:
    """The device µs a call of each K6 kernel a call launches (the two-pass
    route's two, or the cluster kernel) over ``calls`` calls under
    torch.profiler, and their sum: a kernel's mean per recorded launch
    times its launches a call, rounded (the profiler can drop records; a
    window that recorded none is profiled again, up to three)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        row = {}
        for e in prof.key_averages():
            for k in ("pfb_pass1_kernel", "pfb_pass2_kernel",
                      "pfb_cluster_kernel"):
                if k in e.key and e.count:
                    row[k] = row.get(k, 0.0) + (
                        e.device_time_total / e.count
                        * max(1, round(e.count / calls)))
        if row and all(row.values()):
            row = {k: round(v, 2) for k, v in row.items()}
            row["sum"] = round(sum(row.values()), 2)
            return row
    raise RuntimeError(f"K6 four-step C={C}: no kernel events in three "
                       f"windows")


def _step_call(lib, C, n, raw, hist, h, d, nh, label):
    """A call of ``lib``'s two-pass route (fused_pfb_step_launch, every pair
    in groups of group_pairs(C), as the wrapper launches it) into d, nh."""
    fn = lib.fused_pfb_step_launch
    fn.argtypes = build._SIGNATURES["fused_pfb_step_launch"]
    N1, N2 = fused_pfb.four_step_plan(C)
    pairs = n // (2 * C)
    g = min(fused_pfb.group_pairs(C), pairs)
    y = torch.empty((g, 2, N2, N1, 2), dtype=torch.float64, device=raw.device)
    plan = (ctypes.c_int * 7)(*fused_pfb.step_plan(C))
    table = fused_pfb._table(C, raw.device)

    def call():
        for p0 in range(0, pairs, g):
            rc = fn(raw.data_ptr(), hist.data_ptr(), h.data_ptr(),
                    table.data_ptr(), y.data_ptr(), d.data_ptr(),
                    nh.data_ptr(), n, C, plan, fused_pfb.WIDE_TAPS, p0,
                    min(g, pairs - p0), 0,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"fused_pfb {label} C={C}: CUDA error "
                                   f"{rc}")
    return call


def _cluster_call(lib, C, n, raw, hist, h, d, nh, label):
    fn = lib.fused_pfb_cluster_launch
    fn.argtypes = build._SIGNATURES["fused_pfb_cluster_launch"]
    table = fused_pfb._table(C, raw.device)

    def call():
        rc = fn(raw.data_ptr(), hist.data_ptr(), h.data_ptr(),
                table.data_ptr(), d.data_ptr(), nh.data_ptr(), n, C,
                fused_pfb.WIDE_TAPS, 0,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fused_pfb {label} C={C}: CUDA error {rc}")
    return call


def time_step(dev, pass1: dict, cluster: dict, parent=None,
              calls: int = 10) -> dict:
    """K6's four-step route through the package's wrapper on one 0.25 s
    block of 6.25 kHz channels at each C of STEP_C: the device µs a call of
    each kernel it launches (torch.profiler, the mean of ``calls`` calls
    after one call), the launches a call, the output held to the plain
    version; also after STEP_SUSTAIN_S of calls back to back (the card
    under sustained load, as chip_smoke.py's phase 5 times it).  At
    STEP_CUT_C the cumulative cuts of ``pass1`` (libraries of
    pass1_variants, through their two-pass entry) and of ``cluster``
    (cluster_variants).  With ``parent`` (a library of another tree's
    fused_pfb.cu): that tree's route (its two passes, as its wrapper
    launched them) and this one's in turns at every C, parent, this, this,
    parent, the two outputs held to each other at the phase-3 bars and the
    histories bit-equal."""
    out = {}
    for C in STEP_C:
        pfb, n, raw, hist, h, d, nh = _wide_inputs(C, dev)
        h64 = pfb._h_np
        want = fused_pfb.fused_pfb_demod_ref(raw, hist, h64, C)

        def call():
            return fused_pfb.fused_pfb_demod(raw, hist, h64, C)
        got = call()
        torch.cuda.synchronize()
        row = _step_window(call, calls, C)
        row["launches"] = fused_pfb.launches_per_call(C, n)
        row["holds the bars"] = _holds_bars(pfb, C, raw, hist, *got,
                                            want=want)
        key = f"K6 four-step C={C}"
        out[key] = row
        print(f"{key}: {row}", file=sys.stderr, flush=True)
        t_end = time.perf_counter() + STEP_SUSTAIN_S
        while time.perf_counter() < t_end:
            call()
            torch.cuda.synchronize()
        out[f"{key}, sustained"] = _step_window(call, calls, C)
        print(f"{key}, sustained: {out[f'{key}, sustained']}",
              file=sys.stderr, flush=True)
        del want, got
        if C in STEP_CUT_C:
            for libs, make, cuts in ((pass1, _step_call, "pass 1"),
                                     (cluster, _cluster_call, "cluster")):
                for label, lib in libs.items():
                    fn = make(lib, C, n, raw, hist, h, d, nh, label)
                    k = f"K6 four-step C={C} {cuts}: {label}"
                    out[k] = _step_window(fn, calls, C)
                    print(f"{k}: {out[k]}", file=sys.stderr, flush=True)
                    if "whole" in label:
                        fn()
                        out[f"{k}: holds the bars"] = _holds_bars(
                            pfb, C, raw, hist, d, nh)
        if parent is not None:
            times, outs = {"parent": [], "this": []}, {}
            this = (lambda: fused_pfb.fused_pfb_demod(raw, hist, h64, C,
                                                      h_dev=h))
            par = _step_call(parent, C, n, raw, hist, h, d, nh, "parent")
            for who in ("parent", "this", "this", "parent"):
                fn = par if who == "parent" else this
                times[who].append(_step_window(fn, calls, C)["sum"])
                res = fn()
                outs.setdefault(who, (d.clone(), nh.clone()) if res is None
                                else res)
            for who, ts in times.items():
                out[f"K6 four-step C={C} {who} (in turns)"] = ts
            out[f"K6 four-step C={C}: this holds the bars against the "
                f"parent"] = _holds_bars(pfb, C, raw, hist, *outs["this"],
                                         want=outs["parent"])
            print(f"K6 four-step C={C} in turns: {times}", file=sys.stderr,
                  flush=True)
        del raw, d
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
                        fused_nbfm._a_words(esr, n), 1, None, None, None,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"fused_nbfm_q1 {label}: CUDA error {rc}")
            out[f"K4 B={B} tile={tile}: {label}"] = round(
                device_us(call, "q1_kernel"), 2)
    return out


def time_head(k1_libs: dict, q1_libs: dict, dev) -> dict:
    """K1 (precise, fast) and K4 (precise) alone and with their head rows
    at 2, 16 and 256 blocks of 256 KiB, the CLI's filters (-S 96000 -l
    12500: 2 audio taps), through each variant's library; a head variant's
    output held to the package's wrapper's (K1 bit-equal; K4 its head rows
    equal to P2's plain version over its own output)."""
    from ...config import config_from_cli_opts
    from ...models.nbfm import BlockPipeline
    outf = BlockPipeline(config_from_cli_opts({"S": "96000", "l": "12500"}),
                         device=dev).out_fir
    fir = nbfm_patch._fir_struct(outf)
    taps = fused_nbfm._taps32(outf.host_taps)
    taps_c = (ctypes.c_float * len(taps))(*taps.tolist())
    esr = float(np.float32(50.0 / 96000.0))
    T, apow = nbfm_patch.q1_head_consts(cond_ops.decay_of(esr),
                                        2 * outf.Wh, dev)
    off_in = torch.tensor([127.3, 126.8], device=dev)
    out = {}
    rng = np.random.default_rng(4)
    for B in (2, 16, 256):
        raw = torch.from_numpy(rng.integers(0, 256, (B, 262144), np.uint8)
                               ).to(dev)
        n = raw.shape[1]
        y = torch.empty((B, n // 4), device=dev)
        ent = torch.empty((B, 2), device=dev)
        fin = torch.empty(2, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for label, lib in k1_libs.items():
            fn = lib.fused_nbfm_launch
            fn.argtypes = build._SIGNATURES["fused_nbfm_launch"]
            for precise in (True, False):
                for head in (False, True):
                    def call():
                        rc = fn(raw.data_ptr(), y.data_ptr(), B, n // 4,
                                taps_c, len(taps), int(precise), 0,
                                ctypes.addressof(fir) if head else None,
                                stream)
                        if rc:
                            raise RuntimeError(f"K1 {label}: CUDA error {rc}")
                    key = (f"K1 {'precise' if precise else 'fast'} B={B}: "
                           f"{'with its head' if head else 'alone'}, {label}")
                    out[key] = round(device_us(call, "fused_nbfm_kernel"), 2)
                    print(f"{key}: {out[key]} us", file=sys.stderr, flush=True)
                    if head and label in ("as built", "registers unheld"):
                        call()
                        out[f"{key}: equal to the package's"] = bool(
                            torch.equal(y, fused_nbfm.fused_nbfm(
                                raw, outf.host_taps, "shift", precise,
                                head=outf)))
        off, table, tiles = fused_nbfm._q1_launch_args(raw, off_in, esr,
                                                       fused_nbfm.Q1_TILE)
        for label, lib in q1_libs.items():
            fn = lib.fused_nbfm_q1_launch
            fn.argtypes = build._SIGNATURES["fused_nbfm_q1_launch"]
            for head in (False, True):
                def call():
                    sync = torch.full((2 + 2 * (tiles + 2 * B),), -1,
                                      dtype=torch.int32, device=dev)
                    rc = fn(raw.data_ptr(), y.data_ptr(), off.data_ptr(),
                            ent.data_ptr(), fin.data_ptr(), sync.data_ptr(),
                            table.data_ptr(), tiles, B, n // 4,
                            fused_nbfm.Q1_TILE, taps_c, len(taps), esr,
                            cond_ops.decay_of(esr),
                            fused_nbfm._a_words(esr, n), 1,
                            ctypes.addressof(fir) if head else None,
                            T.data_ptr() if head else None,
                            apow.data_ptr() if head else None, stream)
                    if rc:
                        raise RuntimeError(f"K4 {label}: CUDA error {rc}")
                key = (f"K4 precise B={B}: "
                       f"{'with its head' if head else 'alone'}, {label}")
                out[key] = round(device_us(call, "q1_kernel"), 2)
                print(f"{key}: {out[key]} us", file=sys.stderr, flush=True)
                if head:
                    call()
                    want = nbfm_patch.patch_q1_ref(raw, y.clone(), ent, outf,
                                                   esr, True)
                    out[f"{key}: head rows equal to P2's plain version"] = \
                        bool(torch.equal(y, want))
        del raw, y
    return out


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = Path(args[i + 1])
        del args[i: i + 2]
    kernels = set(args) or {"span", "pfb", "step", "q1", "head"}
    if not kernels <= {"span", "pfb", "step", "q1", "head"}:
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
            # the three-factor route
            variants, regs = wide_variants(), {}
            if parent is not None:
                variants["parent"] = {
                    f: (parent / f).read_text()
                    for f in ("fused_pfb.cu", *build.HEADERS)
                    if (parent / f).exists()}
            libs = _compile(variants, "fused_pfb", tmp, regs)
            par = libs.pop("parent", None)
            for label, rows in regs.items():
                kern = "pfb_" if label == "parent" else label.split(":")[0]
                for name, v in rows.items():
                    if kern in name:
                        res[f"{label}: {name}"] = v
            res.update(time_wide(libs, dev, par))
        if "step" in kernels:
            regs, libs = {}, {}
            for name, variants in (("fused_pfb", pass1_variants()),
                                   ("fused_pfb_cluster", cluster_variants())):
                libs[name] = _compile(variants, name, tmp, regs)
            for label, rows in regs.items():
                for kern, v in rows.items():
                    if "pfb_pass1_kernel" in kern or "pfb_cluster" in kern:
                        res[f"step {label}: {kern}"] = v
            par = None
            if parent is not None:
                par = _compile({"parent": {
                    f: (parent / f).read_text()
                    for f in ("fused_pfb.cu", *build.HEADERS)
                    if (parent / f).exists()}}, "fused_pfb", tmp)["parent"]
            res.update(time_step(dev, libs["fused_pfb"],
                                 libs["fused_pfb_cluster"], par))
        if "q1" in kernels:
            res.update(time_q1(_compile(q1_variants(), "fused_nbfm_q1", tmp),
                               dev))
        if "head" in kernels:
            k1, q1 = (head_variants(n) for n in ("fused_nbfm",
                                                 "fused_nbfm_q1"))
            for name, variants in (("fused_nbfm", k1),
                                   ("fused_nbfm_q1", q1)):
                for label, rows in ptxas_regs(variants, name, tmp).items():
                    for kern, v in rows.items():
                        if "fused_nbfm_kernel" in kern or "q1_kernel" in kern:
                            res[f"{label}: {kern}"] = v
            res.update(time_head(_compile(k1, "fused_nbfm", tmp),
                                 _compile(q1, "fused_nbfm_q1", tmp), dev))
    print("SECTIONS " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
