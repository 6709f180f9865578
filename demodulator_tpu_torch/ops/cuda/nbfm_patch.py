"""Wrappers of the NBFM step's float64 patch kernels (P1–P4), beside their
plain versions.

K1, K3 and K4 (:mod:`.fused_nbfm`) compute stationary rows everywhere in
a block; each kernel path then patches the rows the reference's
zero-state filters compute otherwise, in float64.  The JAX package has no
Pallas kernel for these patches (XLA fuses them beside each
``pallas_call``), so they are kernels with no TPU counterpart:

* :func:`patch_fused` (P1) ↔ ``fused_call_u32_3d``'s head patch
  (``demodulator_tpu/models/nbfm.py:159-168``), after K1 (q0, q3);
* :func:`patch_q1` (P2) ↔ ``_q1_head_patch`` (``:215-246``), after K4
  (-q 1), from K4's entering offsets;
* :func:`patch_cplx1` (P3) ↔ ``fused_call_inlpf_u32_3d``'s patches
  (``:288-329``), after K3 with one stage (-L, -q 2);
* :func:`patch_cplx2` (P4) ↔ ``fused_call_q2l_u32_3d``'s patches
  (``:385-486``), after K3 with two stages (-q 2 -L).

Each writes rows of the main kernel's float32 output ``audio`` in place
and returns it (the JAX package sets them with ``.at[].set``).  Given
CUDA tensors a wrapper launches its kernel (``csrc/nbfm_patch.cu``) on the
current stream, after the main kernel there, adds one to its ``launches``
count and returns; a failed build or launch raises, and so does a device,
dtype, shape or contiguity it does not take.  Given CPU tensors it runs
its plain version (``*_ref``): the torch ops the kernel follows operation
for operation.  Nothing falls back.

P1 and P2 read the filters' device buffers (``RealFir``) and
:func:`q1_head_consts` by pointer.  P3 and P4 are launched as
programmatic dependents of K3 (their CTAs start while K3 runs and wait
for it only to store), and read their constants from one buffer a path,
:func:`packed_consts`, packed on the filters' device once (the pipeline
packs them when it is built) and staged into each CTA's shared memory by
one bulk copy.  Either way a launch copies nothing from the host, so a
CUDA graph captures it.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import conditioning as cond_ops
from ..demod import fm_demod
from . import build
from .fused_nbfm import _check_device, _check_raw, _raise_on

__all__ = ["MAX_SMEM", "q1_head_consts", "inlpf_geometry", "q2l_geometry",
           "ConstPack", "pack_bytes", "packed_consts", "smem_bytes",
           "patch_work", "patch_fused", "patch_fused_ref",
           "patch_q1", "patch_q1_ref", "patch_cplx1", "patch_cplx1_ref",
           "patch_cplx2", "patch_cplx2_ref"]

# csrc/nbfm_patch.cu kMaxPatchSmem: a block's opt-in maximum on Hopper
# (P3's and P4's launches raise their kernel's limit above 48 KiB)
MAX_SMEM = 227 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


class _AudioFir(ctypes.Structure):
    """csrc/nbfm_patch.cu ``PatchAudioFir``."""
    _fields_ = [("taps", _P), ("head", _P), ("y_coup", _P), ("ntaps", _I),
                ("H", _I), ("Wh", _I), ("hy", _I), ("ky", _I)]


class _Stage(ctypes.Structure):
    """csrc/nbfm_patch.cu ``PatchStage``."""
    _fields_ = [("taps", _P), ("c_int", _P), ("head", _P), ("c_head", _P),
                ("tail", _P), ("tail_alias", _P), ("c_tail", _P),
                ("yc_head", _P), ("yc_tail", _P), ("ntaps", _I), ("Hc", _I),
                ("Whc", _I), ("Kc", _I), ("Wtc", _I), ("hp", _I), ("tp", _I),
                ("ky", _I)]


_Q2L_KEYS = ("n_pairs", "a_p", "nd", "m1", "w1_words", "hy", "tc2", "at",
             "pt", "m1t", "wt_words", "hp2")


class _Q2lGeometry(ctypes.Structure):
    """csrc/nbfm_patch.cu ``PatchQ2lGeometry``."""
    _fields_ = [(k, _I) for k in _Q2L_KEYS]


# -- geometry -----------------------------------------------------------------

@functools.cache
def q1_head_consts(a: float, steps: int, device: torch.device) -> tuple:
    """(T [steps, steps], apow [steps]) float64 of the -q 1 head patch,
    T[k, j] = a^(k-1-j) for j < k and apow[k] = a^k, once per (a, steps,
    device): a chunk step copies nothing from the host."""
    k = np.arange(steps)
    expo = k[:, None] - 1 - k[None, :]                      # j < k
    T = np.where(expo >= 0, np.power(a, np.maximum(expo, 0)), 0.0)
    return (torch.tensor(T, dtype=torch.float64, device=device),
            torch.tensor(np.power(a, k), dtype=torch.float64, device=device))


def inlpf_geometry(inf, outf) -> tuple:
    """(n_pairs, w1_words, hy, wt_words) of the one-stage patches
    (models/nbfm.py:261-270 of the JAX package): the head pairs to filter,
    the head and tail windows in words, the audio coupling's rows."""
    n_pairs = max(2 * outf.Wh, inf.Hc)
    n_pairs += n_pairs & 1            # the discriminator eats pairs of pairs
    w1_words = -(-max(inf.Whc, n_pairs + inf.Dc) // 2)
    hy = 0 if outf.y_coup is None else outf.y_coup.shape[0]
    return n_pairs, w1_words, hy, -(-inf.Wtc // 2)


def q2l_geometry(dc, inf, outf) -> dict:
    """Patch windows of the two-stage chain (the JAX package's
    ``_q2l_geometry``, models/nbfm.py:332-362): the combined head, the
    tail where the dc overrun's coupling lands, and their inputs."""
    hp2 = 0 if inf.yc_head is None else inf.yc_head.shape[0]
    tc2 = 2 * inf.sos_len
    p_bad = max(inf.Hc, dc.Hc + inf.Dc, hp2)
    p_bad += p_bad & 1
    a_p = max(p_bad // 2, outf.H)       # audio head rows to overwrite
    nd = max(a_p + outf.D, outf.Wh)     # true demod head rows needed
    n_pairs = 2 * nd
    m1 = max(inf.Whc, n_pairs + inf.Dc)     # true dc outputs needed
    w1_words = -(-max(dc.Whc, m1 + dc.Dc) // 2)
    hy = 0 if outf.y_coup is None else outf.y_coup.shape[0]
    at = tc2 // 2 + outf.D              # audio tail rows to overwrite
    pt = 2 * at                         # true tail pairs needed
    m1t = max(pt + inf.Dc, inf.Wtc)     # dc tail outputs needed
    wt_words = -(-max(dc.Wtc, m1t + dc.Dc) // 2)
    return dict(n_pairs=n_pairs, a_p=a_p, nd=nd, m1=m1,
                w1_words=w1_words, hy=hy, tc2=tc2, at=at, pt=pt,
                m1t=m1t, wt_words=wt_words, hp2=hp2)


def _r16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


_FIR = ("taps", "head", "y_coup")
_STAGE = ("taps", "c_int", "head", "c_head", "tail", "tail_alias", "c_tail",
          "yc_head", "yc_tail")


def _pack_pieces(outf, stages) -> list:
    """[(owner, name, tensor)] of a pack in its order (csrc/nbfm_patch.cu
    ``ConstPack``): the audio filter's ``_FIR`` buffers, then each stage's
    ``_STAGE`` buffers; owner "out" or the stage's index; absent ones
    (None) left out."""
    out = [("out", n, getattr(outf, n)) for n in _FIR]
    for i, st in enumerate(stages):
        out += [(i, n, getattr(st, n)) for n in _STAGE]
    return [(o, n, t) for o, n, t in out if t is not None]


def pack_bytes(outf, stages=()) -> int:
    """Bytes of :func:`packed_consts`'s buffer: each piece at the next
    multiple of 16."""
    return sum(_r16(t.numel() * t.element_size())
               for _, _, t in _pack_pieces(outf, stages))


class ConstPack(NamedTuple):
    """P3's or P4's constants in one uint8 buffer on the filters' device:
    ``offsets[(owner, name)]`` is each piece's byte offset (a multiple of
    16).  Made with it, once: ``structs``, the launch's ``PatchAudioFir``
    and ``PatchStage`` structs pointing into ``buf``, and ``smem``, a
    CTA's shared memory (:func:`smem_bytes`).  ``key`` names the filter
    buffers it was packed from (their ids: ``sources`` keeps them alive,
    so no id is reused while the pack is cached)."""
    buf: torch.Tensor
    offsets: dict
    structs: tuple
    smem: int
    key: tuple
    sources: tuple

    def ptr(self, owner, name) -> int | None:
        off = self.offsets.get((owner, name))
        return None if off is None else self.buf.data_ptr() + off


def _buffers_of(outf, stages) -> tuple:
    """Every buffer of the filters (None included), in a fixed order."""
    return tuple(t for m in (outf, *stages) for t in m._buffers.values())


def _launch_structs(pack: ConstPack, outf, stages) -> tuple:
    """(``PatchAudioFir``, ``PatchStage`` of each stage), their pointers
    into ``pack``."""
    return (_fir_struct(outf, pack),
            *(_stage_struct(st, pack, i) for i, st in enumerate(stages)))


# outf -> {id of each stage: ConstPack}; an entry is made anew when a
# buffer of its filters has been replaced
_PACKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def packed_consts(outf, stages=()) -> ConstPack:
    """The constants of the patch after K3 with ``stages`` (P3: one, P4:
    the dc stage and the input lowpass) and the audio filter ``outf``, as
    one buffer laid out as csrc/nbfm_patch.cu ``ConstPack`` walks it,
    built by torch ops on the filters' device (nothing from the host) and
    kept per (filters, device): the pipeline packs them when it is built,
    so a chunk step copies nothing and a CUDA graph captures its launch."""
    stages = tuple(stages)
    sources = _buffers_of(outf, stages)
    key = tuple(map(id, sources))
    cache = _PACKS.setdefault(outf, {})
    hit = cache.get(tuple(map(id, stages)))
    if hit is not None and hit.key == key:
        return hit
    parts, offsets, off = [], {}, 0
    for owner, name, t in _pack_pieces(outf, stages):
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        offsets[(owner, name)] = off
        parts.append(raw)
        pad = _r16(raw.numel()) - raw.numel()
        if pad:
            parts.append(raw.new_zeros(pad))
        off += raw.numel() + pad
    pack = ConstPack(torch.cat(parts), offsets, (), 0, key, sources)
    pack = pack._replace(
        structs=_launch_structs(pack, outf, stages),
        smem=smem_bytes(("cplx1", "cplx2")[len(stages) - 1], outf, stages))
    cache[tuple(map(id, stages))] = pack
    return pack


def smem_bytes(path: str, outf, stages=()) -> int:
    """Shared memory of one CTA of ``path``'s patch ("fused", "q1",
    "cplx1", "cplx2"), as csrc/nbfm_patch.cu lays it out: each window and
    intermediate rounded up to 16 bytes; P3 and P4 first hold their
    mbarrier (16 bytes) and the constants' pack (:func:`pack_bytes`)."""
    if path == "fused":
        return _r16(16 * outf.Wh) + _r16(4 * outf.Wh)
    if path == "q1":
        W = outf.Wh
        return _r16(32 * W) + _r16(16 * W) + _r16(4 * W)
    head = 16 + pack_bytes(outf, stages)
    if path == "cplx1":
        (inf,) = stages
        n_pairs, w1, hy, wt = inlpf_geometry(inf, outf)
        return (head + _r16(16 * w1) + _r16(16 * wt if hy else 0)
                + _r16(8 * n_pairs) + _r16(8 * inf.Kc if hy else 0)
                + _r16(4 * outf.Wh) + _r16(4 * outf.H) + _r16(4 * hy))
    dc, inf = stages
    g = q2l_geometry(dc, inf, outf)
    tp = 0 if inf.yc_tail is None else inf.yc_tail.shape[0]
    return (head + _r16(16 * g["w1_words"]) + _r16(16 * g["wt_words"])
            + _r16(8 * dc.Kc) + _r16(8 * g["m1"]) + _r16(8 * g["m1t"])
            + _r16(8 * tp) + _r16(8 * g["n_pairs"]) + _r16(8 * g["pt"])
            + _r16(8 * inf.Kc if g["hy"] else 0) + _r16(4 * g["nd"])
            + _r16(4 * g["at"]) + _r16(4 * g["a_p"]) + _r16(4 * g["at"])
            + _r16(4 * g["hy"]))


def _numel(t) -> int:
    return 0 if t is None else t.numel()


def _stage_bytes(st) -> int:
    """A complex stage's constants: float32 taps and c_int, float64
    matrices."""
    return 4 * (st.Dc + 1 + 2) + 8 * sum(_numel(getattr(st, n)) for n in (
        "head", "c_head", "tail", "tail_alias", "c_tail", "yc_head",
        "yc_tail"))


def _over_ops(st) -> int:
    """float64 operations of ``CplxFir.over_only`` (both lanes)."""
    return 2 * st.Kc * (2 * st.Wtc + 2 * st.Whc + 2)


def _head_ops(st, n: int) -> tuple[int, int]:
    """(float32, float64) operations of ``CplxFir.pairs_head`` for n pairs:
    the float64 head rows below Hc, the stationary rows above."""
    h = min(st.Hc, n)
    return (n - h) * (4 * (st.Dc + 1) + 2), h * 2 * (2 * st.Whc + 1)


def patch_work(path: str, outf, stages=(), B: int = 1,
               precise: bool = True) -> tuple[int, int, int]:
    """(bytes, float32 operations, float64 operations) of one call of
    ``path``'s patch on B blocks, counted from the geometry: each window
    byte read once, each constant once, each audio row written once (and
    read once where a coupling adds to a row the patch does not write);
    conditioning 2 a byte, the discriminator 33 (precise) or 27 (fast) a
    word (tools/roofline.py), a dot of length L 2·L."""
    dem = 6 + (26 if precise else 20) + 1
    H, Wh, D = outf.H, outf.Wh, outf.D
    hy, ky = (0, 0) if outf.y_coup is None else outf.y_coup.shape
    const = 4 * (D + 1) + 8 * (_numel(outf.head) + _numel(outf.y_coup))
    f64 = 2 * H * Wh + 2 * hy * ky          # the head dot, the coupling
    fir = 2 * (D + 1) - 1                   # a stationary audio row
    if path == "fused":
        per_b, f32 = 4 * Wh + 4 * H, 8 * Wh + dem * Wh
    elif path == "q1":
        S = 2 * Wh
        per_b = 8 * Wh + 8 + 4 * H          # front, back, offset, rows
        const += 8 * (S * S + S)
        f32 = dem * Wh
        f64 += 4 * S + 2 * S * (S - 1) + 6 * S
    elif path == "cplx1":
        (st,) = stages
        n_pairs, w1, _, wt = inlpf_geometry(st, outf)
        per_b = 4 * w1 + 4 * max(H, hy) + (4 * wt + 4 * max(0, hy - H)
                                           if hy else 0)
        const += _stage_bytes(st)
        h32, h64 = _head_ops(st, n_pairs)
        f32 = 8 * w1 + h32 + dem * Wh + hy + (8 * wt if hy else 0)
        f64 += h64 + (_over_ops(st) if hy else 0)
    else:
        dc, st = stages
        g = q2l_geometry(dc, st, outf)
        extra = max(0, hy - g["a_p"])
        per_b = (4 * (g["w1_words"] + g["wt_words"] + g["a_p"] + g["at"])
                 + 8 * extra)
        const += _stage_bytes(dc) + _stage_bytes(st)
        d32, d64 = _head_ops(dc, g["m1"])
        i32, i64 = _head_ops(st, g["n_pairs"])
        tp = _numel(st.yc_tail) // (2 * max(1, 2 * dc.Kc))
        stat_dc, stat_in = 4 * (dc.Dc + 1) + 2, 4 * (st.Dc + 1) + 2
        f32 = (8 * (g["w1_words"] + g["wt_words"]) + d32 + i32
               + g["m1t"] * stat_dc + g["pt"] * stat_in + 2 * g["hp2"]
               + 2 * g["tc2"] + (2 * st.Kc if hy else 0)
               + dem * (g["nd"] + g["at"])
               + fir * (g["a_p"] - H + g["at"]) + hy)
        f64 += (_over_ops(dc) + d64 + i64 + 2 * (tp + g["hp2"]) * 2 * 2
                * dc.Kc + (_over_ops(st) if hy else 0))
    return B * per_b + const, B * f32, B * f64


# -- checks -------------------------------------------------------------------

def _check_audio(audio: torch.Tensor, raw: torch.Tensor) -> None:
    B, n = raw.shape
    if (audio.dtype != torch.float32 or tuple(audio.shape) != (B, n // 4)
            or audio.device != raw.device):
        raise ValueError(f"audio must be float32 [{B}, {n // 4}] on "
                         f"{raw.device}, got {audio.dtype} "
                         f"{tuple(audio.shape)} on {audio.device}")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")


def _check_buffers(mod, names, device, label: str) -> None:
    """Each named buffer of ``mod`` (None allowed) on ``device`` and
    contiguous, the taps and constants float32, the matrices float64."""
    for name in names:
        t = getattr(mod, name)
        if t is None:
            continue
        want = torch.float32 if name in ("taps", "c_int") else torch.float64
        if t.dtype != want or t.device != device or not t.is_contiguous():
            raise ValueError(f"{label}.{name} must be contiguous {want} on "
                             f"{device}, got {t.dtype} on {t.device}")


def _check_common(raw, audio, conditioning, outf, stages=()) -> tuple:
    B, n = _check_raw(raw)
    _check_audio(audio, raw)
    if conditioning not in ("shift", "normalize"):
        raise ValueError(f"unknown conditioning {conditioning!r}")
    _check_buffers(outf, _FIR, raw.device, "out_fir")
    for i, st in enumerate(stages):
        _check_buffers(st, _STAGE, raw.device, f"stage {i}")
    return B, n


def _launch_args(raw: torch.Tensor, path: str, outf, stages=(),
                 need: int | None = None) -> int:
    """Checks for a launch (block count, alignment, shared memory: ``need``
    bytes, or :func:`smem_bytes`'s count); returns the block count."""
    B = _check_device(raw)
    if need is None:
        need = smem_bytes(path, outf, stages)
    if need > MAX_SMEM:
        raise ValueError(f"the {path} patch needs {need} bytes of shared "
                         f"memory per block, above the kernel's {MAX_SMEM}")
    return B


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _fir_struct(outf, pack: ConstPack | None = None) -> _AudioFir:
    """The audio filter's ``PatchAudioFir``: its buffers' pointers, or
    their pieces' in ``pack``."""
    hy, ky = (0, 0) if outf.y_coup is None else outf.y_coup.shape
    ptrs = ((_ptr(getattr(outf, n)) for n in _FIR) if pack is None
            else (pack.ptr("out", n) for n in _FIR))
    return _AudioFir(*ptrs, outf.D + 1, outf.H, outf.Wh, hy, ky)


def _stage_struct(st, pack: ConstPack, i: int) -> _Stage:
    """Stage ``i``'s ``PatchStage``, its pointers into ``pack``."""
    hp = 0 if st.yc_head is None else st.yc_head.shape[0]
    tp = 0 if st.yc_tail is None else st.yc_tail.shape[0]
    ky = 0 if st.yc_head is None else st.yc_head.shape[2]
    return _Stage(*(pack.ptr(i, n) for n in _STAGE), st.Dc + 1, st.Hc,
                  st.Whc, st.Kc, st.Wtc, hp, tp, ky)


def _stream(raw: torch.Tensor) -> int:
    return torch.cuda.current_stream(raw.device).cuda_stream


# -- P1: after K1 -------------------------------------------------------------

def patch_fused_ref(raw: torch.Tensor, audio: torch.Tensor, outf,
                    conditioning: str = "shift",
                    precise: bool = True) -> torch.Tensor:
    """Plain version of P1: condition the first Wh words, ``fm_demod``,
    ``RealFir.head_only`` into ``audio[:, :H]`` (in place)."""
    dh = fm_demod(cond_ops.condition(raw[:, : 4 * outf.Wh], conditioning),
                  fast=not precise)
    audio[:, : outf.H] = outf.head_only(dh)
    return audio


def patch_fused(raw: torch.Tensor, audio: torch.Tensor, outf,
                conditioning: str = "shift",
                precise: bool = True) -> torch.Tensor:
    """P1: uint8 [B, n] raw bytes, K1's float32 [B, n/4] output and the
    audio filter (``RealFir``) → ``audio`` with its first H rows of each
    block replaced by the float64 head rows, in place."""
    B, n = _check_common(raw, audio, conditioning, outf)
    if outf.Wh > n // 4:
        raise ValueError(f"block of {n // 4} words is shorter than the head "
                         f"window ({outf.Wh})")
    if raw.device.type == "cpu":
        return patch_fused_ref(raw, audio, outf, conditioning, precise)
    B = _launch_args(raw, "fused", outf)
    lib = build.load()
    fir = _fir_struct(outf)
    with torch.cuda.device(raw.device):
        rc = lib.patch_fused_launch(
            raw.data_ptr(), audio.data_ptr(), B, n // 4,
            ctypes.addressof(fir), int(bool(precise)),
            int(conditioning == "normalize"), _stream(raw))
    _raise_on(rc, "patch_fused")
    patch_fused.launches += 1
    return audio


patch_fused.launches = 0


# -- P2: after K4 -------------------------------------------------------------

def patch_q1_ref(raw: torch.Tensor, audio: torch.Tensor,
                 offs_in: torch.Tensor, outf, esr: float,
                 precise: bool = True) -> torch.Tensor:
    """Plain version of P2: the float64 head recompute of each block from
    its entering offset ``offs_in`` [B, 2] (K4's), into ``audio[:, :H]``."""
    W, H = outf.Wh, outf.H
    B, n = raw.shape
    f64 = torch.float64
    front = raw[:, : 4 * W].reshape(B, W, 4).to(f64)
    back = raw[:, n - 4 * W:].reshape(B, W, 4).flip(-2).to(f64)
    # back word n/4-1-v holds (I, Q of step 2v+1, I, Q of step 2v)
    a = cond_ops.decay_of(esr)
    s0 = (front[..., 0:2] + back[..., 2:4]) * esr           # step 2v
    s1 = (front[..., 2:4] + back[..., 0:2]) * esr           # step 2v+1
    s = torch.stack([s0, s1], dim=-2).reshape(B, 2 * W, 2)
    T, apow = q1_head_consts(a, 2 * W, raw.device)
    pref = torch.einsum("kj,bjl->bkl", T, s)
    off_steps = apow[None, :, None] * offs_in.to(f64)[:, None, :] + pref
    cond = (front.reshape(B, W, 2, 2)
            - off_steps.reshape(B, W, 2, 2)).to(torch.float32)
    dh = fm_demod(cond.reshape(B, 4 * W), fast=not precise)
    audio[:, :H] = outf.head_only(dh)
    return audio


def patch_q1(raw: torch.Tensor, audio: torch.Tensor, offs_in: torch.Tensor,
             outf, esr: float, precise: bool = True) -> torch.Tensor:
    """P2: uint8 [B, n] raw bytes of consecutive blocks, K4's float32
    [B, n/4] output and entering offsets [B, 2], the audio filter and
    correctIq's esr (float32, as a float) → ``audio`` with its first H
    rows of each block recomputed in float64 from the block's entering
    offset, in place.  Runs after K4 on the same stream."""
    B, n = _check_common(raw, audio, "shift", outf)
    if (offs_in.dtype != torch.float32 or tuple(offs_in.shape) != (B, 2)
            or offs_in.device != raw.device or not offs_in.is_contiguous()):
        raise ValueError(f"offs_in must be contiguous float32 [{B}, 2] on "
                         f"{raw.device}, got {offs_in.dtype} "
                         f"{tuple(offs_in.shape)} on {offs_in.device}")
    if n % 8 or 2 * outf.Wh > n // 4:
        raise ValueError(f"block of {n} bytes cannot hold the -q 1 head "
                         f"windows (2 x {outf.Wh} words, n % 8 == 0)")
    if raw.device.type == "cpu":
        return patch_q1_ref(raw, audio, offs_in, outf, esr, precise)
    B = _launch_args(raw, "q1", outf)
    T, apow = q1_head_consts(cond_ops.decay_of(esr), 2 * outf.Wh, raw.device)
    lib = build.load()
    fir = _fir_struct(outf)
    with torch.cuda.device(raw.device):
        rc = lib.patch_q1_launch(
            raw.data_ptr(), audio.data_ptr(), offs_in.data_ptr(),
            T.data_ptr(), apow.data_ptr(), float(esr), B, n // 4,
            ctypes.addressof(fir), int(bool(precise)), _stream(raw))
    _raise_on(rc, "patch_q1")
    patch_q1.launches += 1
    return audio


patch_q1.launches = 0


# -- P3: after K3 with one stage ----------------------------------------------

def patch_cplx1_ref(raw: torch.Tensor, audio: torch.Tensor, inf, outf,
                    conditioning: str = "shift",
                    precise: bool = True) -> torch.Tensor:
    """Plain version of P3: the stage's float64 head rows
    (``CplxFir.pairs_head``), the discriminator and the audio head rows;
    with an audio coupling, the stage's overrun (``over_only``) coupled
    into the first hy rows.  In place."""
    B = raw.shape[0]
    n_pairs, w1_words, hy, wt_words = inlpf_geometry(inf, outf)
    head_pairs = cond_ops.condition(raw[:, : 4 * w1_words],
                                    conditioning).reshape(B, -1, 2)
    filt = inf.pairs_head(head_pairs, n_pairs)
    d_head = fm_demod(filt.reshape(B, -1), fast=not precise)
    audio[:, : outf.H] = outf.head_only(d_head[:, : outf.Wh])
    if hy:
        tail_pairs = cond_ops.condition(
            raw[:, raw.shape[1] - 4 * wt_words:],
            conditioning).reshape(B, -1, 2)
        over = inf.over_only(head_pairs, tail_pairs)
        audio[:, :hy] += torch.einsum(
            "hk,bk->bh", outf.y_coup,
            over.reshape(B, -1).to(torch.float64)).to(torch.float32)
    return audio


def patch_cplx1(raw: torch.Tensor, audio: torch.Tensor, inf, outf,
                conditioning: str = "shift",
                precise: bool = True) -> torch.Tensor:
    """P3: uint8 [B, n] raw bytes, K3's float32 [B, n/4] output (one
    stage), the stage (``CplxFir``) and the audio filter → ``audio`` with
    its head rows and, where the audio filter reads the stage's overrun,
    the coupling of its first hy rows patched in float64, in place.  On
    the card it is launched as a programmatic dependent of the kernel
    before it on the stream (K3, which triggers it at entry)."""
    B, n = _check_common(raw, audio, conditioning, outf, (inf,))
    n_pairs, w1, hy, wt = inlpf_geometry(inf, outf)
    if max(w1, wt, outf.H, hy) > n // 4:
        raise ValueError(f"block of {n // 4} words is shorter than the "
                         f"patch windows ({max(w1, wt, outf.H, hy)} words)")
    if raw.device.type == "cpu":
        return patch_cplx1_ref(raw, audio, inf, outf, conditioning, precise)
    pack = packed_consts(outf, (inf,))
    B = _launch_args(raw, "cplx1", outf, (inf,), pack.smem)
    lib = build.load()
    fir, st = pack.structs
    with torch.cuda.device(raw.device):
        rc = lib.patch_cplx1_launch(
            raw.data_ptr(), audio.data_ptr(), B, n // 4,
            ctypes.addressof(st), ctypes.addressof(fir), n_pairs, w1, wt,
            int(bool(precise)), int(conditioning == "normalize"),
            _stream(raw))
    _raise_on(rc, "patch_cplx1")
    patch_cplx1.launches += 1
    return audio


patch_cplx1.launches = 0


# -- P4: after K3 with two stages ---------------------------------------------

def _stationary_audio(outf, d: torch.Tensor, start: int,
                      span: int) -> torch.Tensor:
    """Σ_d taps[d]·d[:, start+q+d] for q < span (zero past the end)."""
    dp = torch.nn.functional.pad(d[:, start:], (0, outf.D))
    return outf._stationary_rows(dp, span)


def patch_cplx2_ref(raw: torch.Tensor, audio: torch.Tensor, dc, inf, outf,
                    conditioning: str = "shift",
                    precise: bool = True) -> torch.Tensor:
    """Plain version of P4: the float64 head through both stages, the
    stationary tail recompute with the dc overrun's coupling, and the
    audio y-coupling (``fused_call_q2l_u32_3d``).  In place."""
    g = q2l_geometry(dc, inf, outf)
    B = raw.shape[0]
    f32, f64 = torch.float32, torch.float64
    fast = not precise
    head_pairs = cond_ops.condition(raw[:, : 4 * g["w1_words"]],
                                    conditioning).reshape(B, -1, 2)
    tail_pairs = cond_ops.condition(raw[:, raw.shape[1] - 4 * g["wt_words"]:],
                                    conditioning).reshape(B, -1, 2)
    # the dc overrun: y_init of the in-stage's arena, source of both
    # coupling adds below
    dc_over = dc.over_only(head_pairs, tail_pairs).reshape(B, -1).to(f64)

    # head: the true chain through both stages
    y1_head = dc.pairs_head(head_pairs, g["m1"])
    y2_head = inf.pairs_head(y1_head, g["n_pairs"])
    if g["hp2"]:
        y2_head[:, : g["hp2"]] += torch.einsum(
            "plk,bk->bpl", inf.yc_head, dc_over).to(f32)
    d_head = fm_demod(y2_head.reshape(B, -1), fast=fast)
    audio[:, : outf.H] = outf.head_only(d_head[:, : outf.Wh])
    if g["a_p"] > outf.H:
        span = g["a_p"] - outf.H
        audio[:, outf.H: g["a_p"]] = _stationary_audio(
            outf, d_head[:, : outf.H + span + outf.D], outf.H, span)

    # tail: stationary recompute, zero past the block's end
    m1t, pt, tc2, at = g["m1t"], g["pt"], g["tc2"], g["at"]
    xt = tail_pairs[:, max(0, tail_pairs.shape[1] - (m1t + dc.Dc)):]
    y1t = dc.stationary(xt)[:, -m1t:]
    y2t = inf.stationary(y1t)[:, -pt:]
    add_t = torch.einsum("plk,bk->bpl", inf.yc_tail, dc_over).to(f32)
    y2t[:, pt - tc2:] += add_t[:, :tc2]
    d_tail = fm_demod(y2t.reshape(B, -1), fast=fast)
    audio[:, audio.shape[1] - at:] = _stationary_audio(outf, d_tail, 0, at)

    # audio y-coupling from the in-stage overrun
    if g["hy"]:
        in_over = inf.over_only(y1_head, y1t) + add_t[:, tc2:]
        audio[:, : g["hy"]] += torch.einsum(
            "hk,bk->bh", outf.y_coup,
            in_over.reshape(B, -1).to(f64)).to(f32)
    return audio


def patch_cplx2(raw: torch.Tensor, audio: torch.Tensor, dc, inf, outf,
                conditioning: str = "shift",
                precise: bool = True) -> torch.Tensor:
    """P4: uint8 [B, n] raw bytes, K3's float32 [B, n/4] output (two
    stages), the DC-block and input-lowpass stages and the audio filter →
    ``audio`` with its head rows, the tail rows and the audio coupling
    patched in float64, in place.  On the card it is launched as a
    programmatic dependent of the kernel before it on the stream (K3)."""
    B, n = _check_common(raw, audio, conditioning, outf, (dc, inf))
    g = q2l_geometry(dc, inf, outf)
    need = max(g["w1_words"], g["wt_words"], g["a_p"] + g["at"], g["hy"],
               g["nd"])
    if need > n // 4:
        raise ValueError(f"block of {n // 4} words is shorter than the "
                         f"patch windows ({need} words)")
    if inf.yc_tail is None:
        raise ValueError("the input lowpass has no coupling to the dc "
                         "stage's overrun")
    if raw.device.type == "cpu":
        return patch_cplx2_ref(raw, audio, dc, inf, outf, conditioning,
                               precise)
    pack = packed_consts(outf, (dc, inf))
    B = _launch_args(raw, "cplx2", outf, (dc, inf), pack.smem)
    lib = build.load()
    fir, s_dc, s_in = pack.structs
    geom = _Q2lGeometry(*(g[k] for k in _Q2L_KEYS))
    with torch.cuda.device(raw.device):
        rc = lib.patch_cplx2_launch(
            raw.data_ptr(), audio.data_ptr(), B, n // 4,
            ctypes.addressof(s_dc), ctypes.addressof(s_in),
            ctypes.addressof(fir), ctypes.addressof(geom),
            int(bool(precise)), int(conditioning == "normalize"),
            _stream(raw))
    _raise_on(rc, "patch_cplx2")
    patch_cplx2.launches += 1
    return audio


patch_cplx2.launches = 0
