"""Build the package's CUDA sources with nvcc and load them with ctypes.

The kernels in ``demodulator_tpu_torch/csrc/*.cu`` expose a plain C
interface, so they compile in seconds with nvcc alone (no PyTorch headers):
one nvcc per source, all started together, then one link into
``demodulator_tpu_torch/_build/lib<hash>.so``, keyed by a hash of the
sources, the shared header and the flags.  Nothing is built or loaded at
import time: the first call of :func:`load` builds (or reuses) the
library.  A failed build raises with nvcc's stderr; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load", "library_path"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_nbfm.cu", "fused_nbfm_cplx.cu", "fused_nbfm_q1.cu",
           "fused_pfb.cu", "fused_pfb_cluster.cu", "nbfm_patch.cu")
HEADERS = ("nbfm_device.cuh", "nbfm_span.cuh", "nbfm_head.cuh",
           "pfb_device.cuh")
# sm_90a (Hopper).  No --use_fast_math and no -prec-div=false: the precise
# discriminator needs IEEE division and must keep denormals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # in, out, blocks, words, taps (host float*), ntaps, precise, normalize,
    # the audio filter for the head rows (a struct's address, or None),
    # stream
    "fused_nbfm_launch": (_P, _P, _I64, _I64, _FP, _I, _I, _I, _P, _P),
    # in, out, total words, stream
    "dma_floor_launch": (_P, _P, _I64, _P),
    # in, out, blocks, words, taps, ntaps, stage taps [2][32], stage ntaps
    # [2], stage constants [2][2], nstages, precise, normalize, stream
    "fused_nbfm_cplx_launch": (_P, _P, _I64, _I64, _FP, _I, _FP,
                               ctypes.POINTER(_I), _FP, _I, _I, _I, _P),
    # in, out, off_in, off_entering, off_final, sync (ticket and published
    # maps), power table, tiles, blocks, words, tile, taps, ntaps, esr, decay
    # (float64), a^words, precise, the audio filter for the head rows (a
    # struct's address, or None), the head's T and apow, stream
    "fused_nbfm_q1_launch": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                             _I, _FP, _I, ctypes.c_float, ctypes.c_double,
                             ctypes.c_float, _I, _P, _P, _P, _P),
    # in, out, off_in, off_entering, off_final, sync flags, tile summaries,
    # power table, tiles, blocks, words, tile, taps, ntaps, esr, decay
    # (float64), a^words, precise, stream
    "fused_nbfm_q1_seq_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                                 _I64, _I, _FP, _I, ctypes.c_float,
                                 ctypes.c_double, ctypes.c_float, _I, _P),
    # in, hist, h, twiddle table, d, new_hist, samples, C, C1, C2, P,
    # precise, stream
    "fused_pfb_launch": (_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
                         _P),
    # C, C1, C2, P, out int[4] (registers, local bytes, shared bytes, CTAs
    # an SM of the kernel a three-factor launch runs)
    "fused_pfb_kernel_attrs": (_I, _I, _I, _I, ctypes.POINTER(_I)),
    # the four-step route (C > 4096): in, hist, h, table, scratch, d,
    # new_hist, samples, C, plan int[7], P, first pair, pairs, precise,
    # stream
    "fused_pfb_step_launch": (_P, _P, _P, _P, _P, _P, _P, _I64, _I,
                              ctypes.POINTER(_I), _I, _I64, _I, _I, _P),
    # C, plan int[7], P, out int[8] (both kernels' attributes)
    "fused_pfb_step_attrs": (_I, ctypes.POINTER(_I), _I, ctypes.POINTER(_I)),
    # a compiled-in cluster plan (C > 4096, fused_pfb_cluster.cu): in, hist,
    # h, table, d, new_hist, samples, C, P, precise, stream
    "fused_pfb_cluster_launch": (_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                                 _P),
    # C, out int[6] (registers, local bytes, shared bytes, CTAs an SM, CTAs
    # a cluster, clusters the card holds)
    "fused_pfb_cluster_attrs": (_I, ctypes.POINTER(_I)),
    # the patches after K3 (nbfm_patch.cu); a struct argument is its
    # address.  raw, audio, blocks, words, stage, audio FIR, n_pairs, w1_words,
    # wt_words, precise, normalize, stream
    "patch_cplx1_launch": (_P, _P, _I64, _I64, _P, _P, _I, _I, _I, _I, _I,
                           _P),
    # raw, audio, blocks, words, dc stage, in stage, audio FIR, geometry,
    # precise, normalize, stream
    "patch_cplx2_launch": (_P, _P, _I64, _I64, _P, _P, _P, _P, _I, _I, _P),
}


def nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, in that order."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of demodulator_tpu_torch cannot be built")


def library_path() -> Path:
    """``_build/lib<hash>.so`` for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def _run(cmd: list) -> None:
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stderr}")


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path.  Each source compiles in its own nvcc process, all at once, into
    a temporary directory; the link writes the library under a temporary
    name that is then renamed, so two processes building at once never
    load a half-written file."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [exe, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / name)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(obj)
        failed = []
        for cmd, p in procs:
            _, err = p.communicate()
            if p.returncode:
                failed.append(f"nvcc failed ({p.returncode}): "
                              f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        _run([exe, *NVCC_FLAGS, "-shared", "-o", so, *objs])
        os.replace(so, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library with every entry's argtypes
    set (a pointer passed without them would be cut to 32 bits).  A
    ``kernel_library`` span in a profiler trace."""
    from torch.profiler import record_function
    with record_function("kernel_library"):
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
