"""The NBFM step's float64 patch kernels (P1-P4, ``ops/cuda/nbfm_patch.py``)
on the CPU: their wrappers' CPU branch, the kernel paths through them, and
the windows they read.

On the CPU a wrapper runs its plain version (``*_ref``), the patch code
the kernel paths ran as torch ops before the patch kernels existed.  Held
here, at 16 KiB blocks of the ``iq_data`` tone (tiled) and noise, for
each kernel path, precise and fast, shift and normalize, over the
default, ``-d 10``, Chebyshev ``-m 1 -e 3``, ``-L -D 8`` and ``-S 192000
-l 6500`` configs:

* the wrapper equals its ``*_ref``;
* ``fused_call`` equals the kernel's plain version followed by that patch
  code as it stood in ``models/nbfm.py`` (kept below, verbatim, as the
  oracle of the move);
* a numpy model of each entry point's windows, from the path's geometry,
  is exactly the bytes the plain version reads (recorded op by op), and
  bytes outside it change nothing;
* the wrappers refuse a dtype, shape or contiguity their kernels do not
  take;
* P3's and P4's constants pack (``packed_consts``): each piece read back
  at its 16-byte-aligned offset, in the launcher's order; their shared
  memory; ``patch_work`` as before their redesign; their CPU wrappers
  reach no library.

The JAX package's fused paths: tests/test_torch_patch_jax.py.  The
kernels themselves run on the card: tests/test_torch_cuda.py ``-k patch``.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from demodulator_tpu_torch.config import config_from_cli_opts
from demodulator_tpu_torch.models.nbfm import BlockPipeline, PipelineState
from demodulator_tpu_torch.ops import conditioning as cond_ops
from demodulator_tpu_torch.ops.cuda import fused_nbfm as k
from demodulator_tpu_torch.ops.cuda import nbfm_patch as kq
from demodulator_tpu_torch.ops.demod import fm_demod

torch.set_num_threads(1)

BUF = 16384
BLOCKS = 3
BASE = {"S": "96000", "l": "12500"}
CONFIGS = {"default": {}, "-d 10": {"d": "10"},
           "chebyshev -m 1 -e 3": {"m": "1", "e": "3"},
           "-L -D 8": {"L": "12500", "D": "8"},
           "-S 192000 -l 6500": {"S": "192000", "l": "6500"}}
# kernel-path modes: q0 and q3 (P1), -q 1 (P2), -L, -L q3 and -q 2 (P3),
# -q 2 -L (P4); under "-L -D 8" every mode but -q 1 has the input lowpass
MODES = {"q0": {}, "q3": {"q": "3"}, "q1": {"q": "1"}, "L": {"L": "12500"},
         "L q3": {"L": "12500", "q": "3"}, "q2": {"q": "2"},
         "q2 L": {"q": "2", "L": "12500"}}
PATHS = {"fused": "patch_fused", "q1": "patch_q1", "cplx1": "patch_cplx1",
         "cplx2": "patch_cplx2"}


def _pipe(config, mode, fast):
    """The config's pipeline on the CPU, or None where its mode has no
    kernel path (-q 1 with -L)."""
    opts = {**BASE, **CONFIGS[config], **MODES[mode]}
    cfg = config_from_cli_opts(opts)
    cfg.buf_size = BUF
    pipe = BlockPipeline(cfg, fast_atan2=fast, device="cpu")
    return pipe if pipe.kernel_path() != "plain" else None


def _cases():
    out = []
    for config in CONFIGS:
        for mode in MODES:
            if _pipe(config, mode, False) is not None:
                out += [(config, mode, fast) for fast in (False, True)]
    return out


CASES = _cases()


def _tone(iq_data, blocks=BLOCKS):
    reps = -(-blocks * BUF // iq_data.size)
    return np.tile(iq_data, reps)[: blocks * BUF].reshape(blocks, BUF)


def _noise(blocks=BLOCKS, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (blocks, BUF),
                                                np.uint8)


def _offs(blocks, seed=9):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        120.0, 135.0, (blocks, 2)).astype(np.float32))


def _main(pipe, raw):
    """The kernel's plain version → (audio, entering offsets or None)."""
    outf, cond = pipe.out_fir, pipe.conditioning
    precise = not pipe.fast_atan2
    path = pipe.kernel_path()
    if path == "fused":
        return k.fused_nbfm_ref(raw, outf.host_taps, cond, precise), None
    if path == "q1":
        off = torch.tensor([127.25, 126.75])
        audio, ent, _ = k.fused_nbfm_q1_ref(raw, off, outf.host_taps,
                                            float(pipe.esr), precise)
        return audio, ent
    return k.fused_nbfm_cplx_ref(raw, pipe.stage_consts(), outf.host_taps,
                                 cond, precise), None


def _patch(pipe, name, raw, audio, offs):
    """The pipeline's patch wrapper (``name`` "" ) or its plain version
    (``name`` "_ref") on (raw, audio)."""
    outf, cond = pipe.out_fir, pipe.conditioning
    precise = not pipe.fast_atan2
    path = pipe.kernel_path()
    fn = getattr(kq, PATHS[path] + name)
    if path == "fused":
        return fn(raw, audio, outf, cond, precise)
    if path == "q1":
        return fn(raw, audio, offs, outf, float(pipe.esr), precise)
    if path == "cplx1":
        return fn(raw, audio, pipe._cplx_stages()[0], outf, cond, precise)
    return fn(raw, audio, pipe.dc_fir, pipe.in_fir, outf, cond, precise)


# -- the patch code as it stood in models/nbfm.py, the oracle of the move ----
def _legacy_plain(pipe, raw2, audio):
    outf = pipe.out_fir
    dh = fm_demod(pipe._cond(raw2[:, : 4 * outf.Wh]), fast=pipe.fast_atan2)
    audio[:, : outf.H] = outf.head_only(dh)
    return audio


def _legacy_inlpf(pipe, raw2, audio):
    (inf,), outf = pipe._cplx_stages(), pipe.out_fir
    B = raw2.shape[0]
    n_pairs, w1_words, hy, wt_words = kq.inlpf_geometry(inf, outf)
    head_pairs = pipe._cond(raw2[:, : 4 * w1_words]).reshape(B, -1, 2)
    filt = inf.pairs_head(head_pairs, n_pairs)
    d_head = fm_demod(filt.reshape(B, -1), fast=pipe.fast_atan2)
    audio[:, : outf.H] = outf.head_only(d_head[:, : outf.Wh])
    if hy:
        tail_pairs = pipe._cond(
            raw2[:, raw2.shape[1] - 4 * wt_words:]).reshape(B, -1, 2)
        over = inf.over_only(head_pairs, tail_pairs)
        audio[:, :hy] += torch.einsum(
            "hk,bk->bh", outf.y_coup,
            over.reshape(B, -1).to(torch.float64)).to(torch.float32)
    return audio


def _legacy_stationary_audio(pipe, d, start, span):
    dp = torch.nn.functional.pad(d[:, start:], (0, pipe.out_fir.D))
    return pipe.out_fir._stationary_rows(dp, span)


def _legacy_q2l(pipe, raw2, audio):
    dc, inf, outf = pipe.dc_fir, pipe.in_fir, pipe.out_fir
    g = kq.q2l_geometry(dc, inf, outf)
    B = raw2.shape[0]
    f32, f64 = torch.float32, torch.float64
    head_pairs = pipe._cond(
        raw2[:, : 4 * g["w1_words"]]).reshape(B, -1, 2)
    tail_pairs = pipe._cond(
        raw2[:, raw2.shape[1] - 4 * g["wt_words"]:]).reshape(B, -1, 2)
    dc_over = dc.over_only(head_pairs, tail_pairs).reshape(B, -1).to(f64)
    y1_head = dc.pairs_head(head_pairs, g["m1"])
    y2_head = inf.pairs_head(y1_head, g["n_pairs"])
    if g["hp2"]:
        y2_head[:, : g["hp2"]] += torch.einsum(
            "plk,bk->bpl", inf.yc_head, dc_over).to(f32)
    d_head = fm_demod(y2_head.reshape(B, -1), fast=pipe.fast_atan2)
    audio[:, : outf.H] = outf.head_only(d_head[:, : outf.Wh])
    if g["a_p"] > outf.H:
        span = g["a_p"] - outf.H
        audio[:, outf.H: g["a_p"]] = _legacy_stationary_audio(
            pipe, d_head[:, : outf.H + span + outf.D], outf.H, span)
    m1t, pt, tc2, at = g["m1t"], g["pt"], g["tc2"], g["at"]
    xt = tail_pairs[:, max(0, tail_pairs.shape[1] - (m1t + dc.Dc)):]
    y1t = dc.stationary(xt)[:, -m1t:]
    y2t = inf.stationary(y1t)[:, -pt:]
    add_t = torch.einsum("plk,bk->bpl", inf.yc_tail, dc_over).to(f32)
    y2t[:, pt - tc2:] += add_t[:, :tc2]
    d_tail = fm_demod(y2t.reshape(B, -1), fast=pipe.fast_atan2)
    audio[:, audio.shape[1] - at:] = _legacy_stationary_audio(pipe, d_tail,
                                                              0, at)
    if g["hy"]:
        in_over = inf.over_only(y1_head, y1t) + add_t[:, tc2:]
        audio[:, : g["hy"]] += torch.einsum(
            "hk,bk->bh", outf.y_coup,
            in_over.reshape(B, -1).to(f64)).to(f32)
    return audio


def _legacy_q1(pipe, raw2, audio, offs_in):
    outf = pipe.out_fir
    W, H = outf.Wh, outf.H
    B, n = raw2.shape
    f64 = torch.float64
    front = raw2[:, : 4 * W].reshape(B, W, 4).to(f64)
    back = raw2[:, n - 4 * W:].reshape(B, W, 4).flip(-2).to(f64)
    esr = float(pipe.esr)
    a = cond_ops.decay_of(pipe.esr)
    s0 = (front[..., 0:2] + back[..., 2:4]) * esr
    s1 = (front[..., 2:4] + back[..., 0:2]) * esr
    s = torch.stack([s0, s1], dim=-2).reshape(B, 2 * W, 2)
    T, apow = kq.q1_head_consts(a, 2 * W, raw2.device)
    pref = torch.einsum("kj,bjl->bkl", T, s)
    off_steps = apow[None, :, None] * offs_in.to(f64)[:, None, :] + pref
    cond = (front.reshape(B, W, 2, 2)
            - off_steps.reshape(B, W, 2, 2)).to(torch.float32)
    dh = fm_demod(cond.reshape(B, 4 * W), fast=pipe.fast_atan2)
    audio[:, :H] = outf.head_only(dh)
    return audio


def _legacy_fused_call(pipe, state, raw):
    """The kernel's plain version, then the patch code it replaced."""
    path = pipe.kernel_path()
    if path == "q1":
        off_in = state.iq_off.reshape(-1)[:2]
        audio, offs, _ = k.fused_nbfm_q1_ref(
            raw, off_in, pipe.out_fir.host_taps, float(pipe.esr),
            not pipe.fast_atan2)
        return _legacy_q1(pipe, raw, audio, offs)
    audio, _ = _main(pipe, raw)
    return {"fused": _legacy_plain, "cplx1": _legacy_inlpf,
            "cplx2": _legacy_q2l}[path](pipe, raw, audio)


# -- the tests --------------------------------------------------------------
@pytest.mark.parametrize("config, mode, fast", CASES)
def test_wrapper_on_cpu_is_its_ref(iq_data, config, mode, fast):
    """On CPU tensors each wrapper is its plain version: the same rows
    written, bit for bit, in place, and no launch counted."""
    pipe = _pipe(config, mode, fast)
    name = PATHS[pipe.kernel_path()]
    counter = getattr(kq, name)
    for raw in (_tone(iq_data), _noise()):
        raw = torch.from_numpy(raw)
        base, _ = _main(pipe, raw)
        offs = _offs(BLOCKS)
        n0 = counter.launches
        audio = base.clone()
        got = _patch(pipe, "", raw, audio, offs)
        want = _patch(pipe, "_ref", raw, base.clone(), offs)
        assert got is audio                     # in place
        assert torch.equal(got, want)
        assert not torch.equal(got, base)       # it patched rows
        assert counter.launches == n0


@pytest.mark.parametrize("config, mode, fast", CASES)
def test_fused_call_equals_the_patch_code_it_replaced(iq_data, config, mode,
                                                      fast):
    """``fused_call`` through the patch wrappers equals the kernel's plain
    version plus the patch code as ``models/nbfm.py`` ran it, bit for
    bit (the ``*_ref`` is that code, moved)."""
    pipe = _pipe(config, mode, fast)
    for raw in (_tone(iq_data), _noise()):
        raw = torch.from_numpy(raw)
        state = PipelineState(iq_off=torch.tensor([127.25, 126.75]))
        s_got, got = pipe.fused_call(state, raw)
        want = _legacy_fused_call(pipe, state, raw)
        assert torch.equal(got, want), (config, mode, fast)


def _windows(pipe, n: int) -> np.ndarray:
    """The numpy model: a mask of the bytes of an n-byte block that the
    path's patch reads, from its geometry: the first words (P1: Wh; P2:
    Wh front and Wh mirrored back; P3: the stage's head window w1 and,
    with an audio coupling, its tail window wt; P4: both stages' head
    window w1 and tail window wt)."""
    mask = np.zeros(n, bool)
    outf = pipe.out_fir
    path = pipe.kernel_path()
    if path == "fused":
        head, tail = outf.Wh, 0
    elif path == "q1":
        head = tail = outf.Wh
    elif path == "cplx1":
        (inf,) = pipe._cplx_stages()
        n_pairs = max(2 * outf.Wh, inf.Hc)
        n_pairs += n_pairs % 2
        head = -(-max(inf.Whc, n_pairs + inf.Dc) // 2)
        tail = -(-inf.Wtc // 2) if outf.y_coup is not None else 0
    else:
        g = kq.q2l_geometry(pipe.dc_fir, pipe.in_fir, outf)
        head, tail = g["w1_words"], g["wt_words"]
    mask[: 4 * head] = True
    if tail:
        mask[n - 4 * tail:] = True
    return mask


class _Reads(TorchDispatchMode):
    """Records the bytes of ``raw`` that any operation reads: for each
    operation that is not a view and takes a tensor on ``raw``'s storage,
    the offsets of that tensor's elements in ``raw``."""

    def __init__(self, raw):
        super().__init__()
        self.ptr = raw.untyped_storage().data_ptr()
        self.base = raw.storage_offset()
        self.pos = torch.arange(raw.untyped_storage().nbytes())
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            for a in torch.utils._pytree.tree_leaves((args, kwargs)):
                if (isinstance(a, torch.Tensor) and a.device.type == "cpu"
                        and a.untyped_storage().data_ptr() == self.ptr):
                    at = torch.as_strided(self.pos, a.shape, a.stride(),
                                          a.storage_offset())
                    self.read.update((at - self.base).flatten().tolist())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("config, mode, fast", CASES)
def test_windows_are_what_the_ref_reads(iq_data, config, mode, fast):
    """The numpy model of the windows is exactly the bytes of each block
    the plain version reads (recorded op by op), and poisoning every byte
    outside it leaves the plain version's output as it was."""
    pipe = _pipe(config, mode, fast)
    raw = torch.from_numpy(_tone(iq_data, 2).copy())
    base, _ = _main(pipe, raw)
    offs = _offs(2)
    with _Reads(raw) as reads:
        want = _patch(pipe, "_ref", raw, base.clone(), offs)
    read = np.zeros(raw.numel(), bool)
    read[sorted(reads.read)] = True
    mask = _windows(pipe, BUF)
    assert 0 < mask.sum() < BUF // 4
    np.testing.assert_array_equal(read.reshape(2, BUF), [mask, mask])
    rng = np.random.default_rng(17)
    poisoned = raw.clone()
    outside = torch.from_numpy(np.tile(~mask, (2, 1)))
    poisoned[outside] = torch.from_numpy(
        rng.integers(0, 256, int(outside.sum()), np.uint8))
    got = _patch(pipe, "_ref", poisoned, base.clone(), offs)
    assert torch.equal(got, want)


def test_windows_fit_the_kernels_shared_memory():
    """Every config here, 32 audio taps included, fits a CTA's shared
    memory (csrc/nbfm_patch.cu kMaxPatchSmem); each patch's work is
    counted for the roofline."""
    for config, mode, fast in CASES:
        pipe = _pipe(config, mode, fast)
        path = pipe.kernel_path()
        stages = tuple(pipe._cplx_stages())
        assert 0 < kq.smem_bytes(path, pipe.out_fir, stages) <= kq.MAX_SMEM
        nbytes, ops32, ops64 = kq.patch_work(path, pipe.out_fir, stages, 16,
                                             not fast)
        assert nbytes > 16 * 4 * pipe.out_fir.H and ops32 > 0 and ops64 > 0


def _bad_calls(pipe, raw, audio, offs):
    """(label, call) pairs a wrapper must refuse."""
    outf, cond = pipe.out_fir, pipe.conditioning
    wrong = {
        "raw dtype": (raw.to(torch.int16), audio),
        "raw rank": (raw[0], audio),
        "raw contiguity": (raw[:, ::2], audio[:, : BUF // 8]),
        "audio dtype": (raw, audio.double()),
        "audio shape": (raw, audio[:, :-4]),
        "audio contiguity": (raw, audio.t().contiguous().t()),
        "blocks": (raw, audio[:2]),
    }
    out = []
    for label, (r, a) in wrong.items():
        out.append((label, lambda r=r, a=a: _patch(pipe, "", r, a, offs)))
    if pipe.kernel_path() != "q1":
        out.append(("conditioning", lambda: getattr(
            kq, PATHS[pipe.kernel_path()])(raw, audio, *(
                (outf,) if pipe.kernel_path() == "fused" else
                (*pipe._cplx_stages(), outf)), "invert")))
    else:
        out.append(("offsets shape", lambda: _patch(pipe, "", raw, audio,
                                                    offs[:, :1])))
        out.append(("offsets dtype", lambda: _patch(pipe, "", raw, audio,
                                                    offs.double())))
    return out


@pytest.mark.parametrize("mode", ["q0", "q1", "L", "q2 L"])
def test_wrappers_reject_what_their_kernels_do_not_take(iq_data, mode):
    """A dtype, rank, shape or contiguity a patch kernel does not take
    raises ValueError, on the CPU as on the card, before anything runs;
    so does a block shorter than the patch windows."""
    pipe = _pipe("default", mode, False)
    raw = torch.from_numpy(_tone(iq_data))
    audio, _ = _main(pipe, raw)
    offs = _offs(BLOCKS)
    for label, call in _bad_calls(pipe, raw, audio.clone(), offs):
        with pytest.raises(ValueError):
            call()
            pytest.fail(label)
    short = raw[:, :16].contiguous()
    with pytest.raises(ValueError, match="shorter|cannot hold"):
        _patch(pipe, "", short, torch.zeros((BLOCKS, 4)), offs)


# -- P3 and P4: the constants' pack, the shared memory, the work ------------
K3_CASES = sorted({(config, mode) for config, mode, _ in CASES
                   if _pipe(config, mode, False).kernel_path()
                   in ("cplx1", "cplx2")})


def _k3_pipe(config, mode):
    pipe = _pipe(config, mode, False)
    return pipe, tuple(pipe._cplx_stages())


@pytest.mark.parametrize("config, mode", K3_CASES)
def test_pack_reads_back_each_filter_tensor(config, mode):
    """``packed_consts``: each constant of the audio filter and the stages,
    read back at its offset, is the filter's tensor; the offsets are
    multiples of 16, in csrc/nbfm_patch.cu ``ConstPack``'s order, each
    piece right after the one before (rounded up to 16); the buffer's size
    is ``pack_bytes``; a second call returns the same pack, and a replaced
    buffer packs anew."""
    pipe, stages = _k3_pipe(config, mode)
    outf = pipe.out_fir
    pack = kq.packed_consts(outf, stages)
    assert pack.buf.dtype == torch.uint8 and pack.buf.dim() == 1
    assert pack.buf.numel() == kq.pack_bytes(outf, stages)
    assert pack.buf.numel() % 16 == 0
    order = [("out", n) for n in ("taps", "head", "y_coup")] + [
        (i, n) for i in range(len(stages))
        for n in ("taps", "c_int", "head", "c_head", "tail", "tail_alias",
                  "c_tail", "yc_head", "yc_tail")]
    mods = {"out": outf, **dict(enumerate(stages))}
    want_off = 0
    for owner, name in order:
        t = getattr(mods[owner], name)
        if t is None:
            assert (owner, name) not in pack.offsets
            continue
        off = pack.offsets[(owner, name)]
        assert off % 16 == 0 and off == want_off, (owner, name)
        nbytes = t.numel() * t.element_size()
        got = pack.buf[off: off + nbytes].view(t.dtype).reshape(t.shape)
        assert torch.equal(got, t), (owner, name)
        want_off += -(-nbytes // 16) * 16
    assert want_off == pack.buf.numel()
    # the launch's structs point at the pieces; the CTA's shared memory
    fir, *sts = pack.structs
    base = pack.buf.data_ptr()
    for struct, owner, names in ((fir, "out", ("taps", "head", "y_coup")),
                                 *((st, i, ("taps", "c_int", "head",
                                            "yc_tail"))
                                   for i, st in enumerate(sts))):
        for name in names:
            off = pack.offsets.get((owner, name))
            assert getattr(struct, name) == (None if off is None
                                             else base + off), (owner, name)
    assert pack.smem == kq.smem_bytes(pipe.kernel_path(), outf, stages)
    assert kq.packed_consts(outf, stages) is pack
    stages[0].c_int = stages[0].c_int.clone()
    again = kq.packed_consts(outf, stages)
    assert again is not pack and torch.equal(again.buf, pack.buf)


def test_pack_sizes_of_the_cli_filters():
    """The CLI's filters (-S 96000 -l 12500 -L 12500): 5968 bytes of
    constants for P4 (-q 2 -L), 2320 for P3 (-L, and -q 2)."""
    for mode, want in (("q2 L", 5968), ("L", 2320), ("q2", 2320)):
        pipe, stages = _k3_pipe("default", mode)
        assert kq.pack_bytes(pipe.out_fir, stages) == want, mode


@pytest.mark.parametrize("config, mode", K3_CASES)
def test_shared_memory_holds_the_pack_and_fits(config, mode):
    """P3's and P4's shared memory is the mbarrier (16 bytes), the pack
    and the windows and chain values (each rounded to 16), under
    ``MAX_SMEM``, and above 48 KiB nowhere here (no launch raises its
    kernel's limit)."""
    pipe, stages = _k3_pipe(config, mode)
    outf, path = pipe.out_fir, pipe.kernel_path()
    need = kq.smem_bytes(path, outf, stages)
    pack = kq.pack_bytes(outf, stages)
    assert need % 16 == 0 and 16 + pack < need <= 48 * 1024 < kq.MAX_SMEM
    if path == "cplx1":
        n_pairs, w1, hy, wt = kq.inlpf_geometry(stages[0], outf)
        windows = 16 * w1 + (16 * wt if hy else 0)
    else:
        g = kq.q2l_geometry(*stages, outf)
        windows = 16 * (g["w1_words"] + g["wt_words"])
    assert need - 16 - pack > windows


def test_shared_memory_above_48k_fits_max_smem():
    """``-d 20 -q 2 -L`` (a config the CLI takes, on the kernel path): P4
    needs more than the default 48 KiB of shared memory, its pack most of
    it, and fits ``MAX_SMEM`` (the launch raises the kernel's limit)."""
    cfg = config_from_cli_opts({**BASE, "d": "20", "q": "2", "L": "12500"})
    cfg.buf_size = BUF
    pipe = BlockPipeline(cfg, device="cpu")
    stages = tuple(pipe._cplx_stages())
    assert pipe.fused_ineligible_reason() is None
    need = kq.smem_bytes("cplx2", pipe.out_fir, stages)
    assert 48 * 1024 < need <= kq.MAX_SMEM
    assert kq.pack_bytes(pipe.out_fir, stages) > need // 2


def test_patch_work_is_unchanged():
    """The bound counts the same work as before the redesign (bytes,
    float32 and float64 operations at B = 16, the CLI's filters)."""
    for mode, fast, want in (("q2 L", False, (7528, 12912, 35584)),
                             ("q2 L", True, (7528, 11952, 35584)),
                             ("L", False, (3704, 5376, 15104)),
                             ("q2", False, (3704, 5376, 15104))):
        pipe, stages = _k3_pipe("default", mode)
        got = kq.patch_work(pipe.kernel_path(), pipe.out_fir, stages, 16,
                            not fast)
        assert got == want, (mode, fast, got)


@pytest.mark.parametrize("mode", ["L", "q2", "q2 L"])
def test_cpu_wrappers_run_their_refs_without_the_library(iq_data,
                                                          monkeypatch, mode):
    """On CPU tensors P3 and P4 run their plain versions: no library is
    built or loaded, no pack is made, no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel's launch")
    monkeypatch.setattr(kq.build, "load", refuse)
    monkeypatch.setattr(kq, "packed_consts", refuse)
    pipe, _ = _k3_pipe("default", mode)
    raw = torch.from_numpy(_tone(iq_data))
    audio, _ = _main(pipe, raw)
    counter = getattr(kq, PATHS[pipe.kernel_path()])
    n0 = counter.launches
    got = _patch(pipe, "", raw, audio.clone(), None)
    assert torch.equal(got, _patch(pipe, "_ref", raw, audio.clone(), None))
    assert counter.launches == n0
