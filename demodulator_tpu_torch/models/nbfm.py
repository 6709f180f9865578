"""NBFM block pipeline (torch): the reference consumer chain
(src/matrix.c:178-280),

    uint8 IQ block → conditioning (shiftOrigin | correctIq | highpassDc |
                   normalizeInput) → [complex FIR (input lowpass, -L)]
                   → quadrature discriminator → real FIR (audio lowpass)

per block with zero filter state (the compat profile); correctIq's DC
offset chains across blocks.  In float32 or, under ``--precision
float64``, float64 (the reference's -DSET_PRECISION build).  Counterpart
of ``demodulator_tpu/models/nbfm.py`` (``:38-690``).

As the JAX package takes its Pallas kernels on the TPU, this one takes the
CUDA kernels for a float32 CUDA tensor: K1 (q0/q3), K3 with one complex
stage (-L, -q 2) or two (-q 2 -L), K4 (-q 1), each followed by its path's
float64 patch kernel (P1-P4, ``ops/cuda/nbfm_patch.py``): two launches a
step, where JAX runs its Pallas call and XLA's fusions of the patch.  A
CPU tensor takes the plain PyTorch chain, the counterpart of
the JAX ``backend="xla"`` path; so do the configs no kernel in either
package computes (``kernel_path`` "plain": float64, demod mode 0), as torch
ops on whatever device holds the data.  A float32 config whose kernel
cannot take it (``fused_ineligible_reason``: too many taps, blocks shorter
than the patch windows) raises on a CUDA tensor.

The continuous profile (``halo_pairs``, ``condition_block(s)``,
``continuous_post``, ``continuous_halo``) keeps conditioning per block and
runs the filters stationary across block boundaries; it has no kernel in
either package and runs as torch ops on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DemodConfig
from ..design.biquad import BUTTER_HP, design_sos
from ..ops import conditioning as cond_ops
from ..ops.cuda.fused_nbfm import (MAX_CPLX_TAPS, MAX_TAPS, fused_nbfm,
                                   fused_nbfm_cplx, fused_nbfm_q1)
from ..ops.cuda.nbfm_patch import (inlpf_geometry, packed_consts,
                                   patch_cplx1, patch_cplx2, patch_fused,
                                   patch_q1, q2l_geometry)
from ..ops.demod import fm_demod
from ..ops.fir import extract_cplx_fir, extract_real_fir
from ..ops.fir_apply import CplxFir, RealFir

__all__ = ["PipelineState", "BlockPipeline", "unported_reason",
           "set_filters_from_jax", "require_device"]


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (the pipelines never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device not available (pass device=\"cpu\" "
                           "for the plain PyTorch path)")
    return device


class PipelineState(NamedTuple):
    """Carry state across blocks.  The reference's only cross-block state
    is correctIq's DC offset (src/matrix.c:125); every other mode passes
    it through unchanged."""
    iq_off: torch.Tensor  # [..., 2] in the pipeline's dtype


def unported_reason(cfg: DemodConfig) -> str | None:
    """The option that selects a path this package does not run yet, or
    None when ``cfg`` is on a ported path."""
    if cfg.demod_mode() == 0 and not cfg.lowpass_in:
        return ("demod mode 0 (filter-IQ only, set through "
                "DemodConfig(mode=...)) without -L")
    return None


def set_filters_from_jax(pipe: "BlockPipeline", jpipe) -> None:
    """Give ``pipe`` the JAX pipeline ``jpipe``'s filter constants
    (``dc_fir``, ``in_fir``, ``out_fir``), through the ``from_numpy``
    builders and in ``pipe``'s dtype, so both packages compute with the
    same numbers."""
    f = jpipe.out_fir
    pipe.out_fir = RealFir.from_numpy(f.host_taps, f.head, f.H, f.Wh, f.D,
                                      f.y_coup, device=pipe.device,
                                      dtype=pipe.dtype)
    for name in ("dc_fir", "in_fir"):
        c = getattr(jpipe, name)
        setattr(pipe, name, None if c is None else CplxFir.from_numpy(
            c.host_taps, c.head, c.tail, c.tail_alias, c.c_head,
            c.host_c_int, c.c_tail, c.sos_len, c.yc_head, c.yc_tail,
            device=pipe.device, dtype=pipe.dtype))


class BlockPipeline:
    """Holds the filters for a config and runs blocks through them."""

    def __init__(self, cfg: DemodConfig, fast_atan2: bool = False,
                 device="cuda"):
        """``device``: where the filters live, "cuda" (the default; raises
        without a card) or "cpu"."""
        self.device = require_device(device)
        cfg.validate()
        reason = unported_reason(cfg)
        if reason is not None:
            raise NotImplementedError(f"{reason} is not ported yet")
        self.cfg = cfg
        self.fast_atan2 = fast_atan2
        self.kind = cfg.conditioning_kind()
        self.dtype = (torch.float64 if cfg.precision == "float64"
                      else torch.float32)
        np_dtype = cfg.np_dtype()
        # K1/K3 conditioning: -q 2 filters shiftOrigin's output
        # (src/matrix.c:151); -q 1 has its own kernel
        self.conditioning = "normalize" if self.kind == 3 else "shift"
        self.esr = np_dtype(50.0 / cfg.sample_rate)
        fir_kw = dict(device=self.device, dtype=self.dtype)

        # DC-block highpass (src/matrix.c:142-157)
        self.dc_fir = None
        dc_overrun = 0
        if self.kind == 2:
            sos_dc = design_sos(BUTTER_HP, 3, 1.0, cfg.sample_rate, 0.0,
                                dtype=np_dtype)
            op, _ = extract_cplx_fir(sos_dc, alias=False)
            self.dc_fir = CplxFir.from_op(op, **fir_kw)
            dc_overrun = 2 * op.Kc  # interleaved reals scribbled past region
        # input lowpass (-L)
        self.in_fir = None
        in_overrun = 0
        if cfg.lowpass_in:
            sos_in = design_sos(cfg.in_filter_family(),
                                cfg.effective_in_filter_degree(),
                                cfg.lowpass_in, cfg.sample_rate, cfg.epsilon,
                                dtype=np_dtype)
            op, y_coup = extract_cplx_fir(sos_in, alias=True,
                                          y_init_len=dc_overrun)
            self.in_fir = CplxFir.from_op(op, y_coup, **fir_kw)
            in_overrun = 2 * op.Kc
        # audio lowpass, coupled to the last complex stage's overrun
        sos_out = design_sos(cfg.out_filter_family(), cfg.out_filter_degree,
                             cfg.lowpass_out, cfg.sample_rate, cfg.epsilon,
                             dtype=np_dtype)
        op = extract_real_fir(sos_out, y_init_len=in_overrun
                              if self.in_fir is not None else dc_overrun)
        self.out_fir = RealFir.from_numpy(op.taps, op.head, op.H, op.Wh,
                                          op.D, op.y_coup, **fir_kw)
        if (self.device.type == "cuda" and self.fused_eligible
                and self.kernel_path() in ("cplx1", "cplx2")):
            # P3's or P4's constants in one buffer on the card, packed once
            # here (a chunk step, and its capture, copies nothing)
            packed_consts(self.out_fir, self._cplx_stages())

    # -- kernel-path geometry ----------------------------------------------
    def _cplx_stages(self) -> list:
        """The complex stages in application order: highpassDc, then the
        input lowpass."""
        return [f for f in (self.dc_fir, self.in_fir) if f is not None]

    def kernel_path(self) -> str:
        """The kernel a CUDA block takes: "fused" (K1), "cplx1" or "cplx2"
        (K3 with one or two stages), "q1" (K4), or "plain" where no kernel
        computes the config (float64, demod mode 0, -q 1 with -L: K4 has no
        complex stage, as JAX's ``_use_fused_q1`` requires no input
        lowpass): the plain chain as torch ops on the card."""
        if self.dtype != torch.float32 or self.cfg.demod_mode() == 0:
            return "plain"
        if self.kind == 1:
            return "plain" if self.in_fir is not None else "q1"
        return ("fused", "cplx1", "cplx2")[len(self._cplx_stages())]

    def fused_ineligible_reason(self) -> str | None:
        """Why the kernel path cannot take this config, or None.  The JAX
        gates (models/nbfm.py:93-99, 177-190, 272-286, 364-380) less their
        TPU layout terms (the ≤ 128-word patch windows and even row
        counts): float32 data in a demodulating mode, the kernels' tap
        bounds, and blocks long enough for every head and tail window the
        patches read."""
        path = self.kernel_path()
        if path == "plain":
            if self.cfg.demod_mode() == 0:
                return "demod mode 0 (filter-IQ only) has no kernel"
            if self.dtype != torch.float32:
                return ("the kernels compute float32 (float64 runs the "
                        "plain chain)")
            return "-q 1 with -L has no kernel (it runs the plain chain)"
        words = self.cfg.buf_size // 4
        outf = self.out_fir
        if outf.D + 1 > MAX_TAPS:
            return f"{outf.D + 1} audio taps exceed the kernel's {MAX_TAPS}"
        need = outf.Wh
        if path == "q1":
            if words % 2:
                return "correctIq kernel needs an even number of words"
            need = 2 * outf.Wh              # Wh front words + Wh mirror words
        elif path != "fused":
            for st in self._cplx_stages():
                if st.Dc + 1 > MAX_CPLX_TAPS:
                    return (f"{st.Dc + 1} complex taps exceed the kernel's "
                            f"{MAX_CPLX_TAPS}")
            if path == "cplx1":
                (st,) = self._cplx_stages()
                n_pairs, w1, hy, wt = inlpf_geometry(st, outf)
                need = max(need, w1, wt, outf.H, hy)
            else:
                g = q2l_geometry(self.dc_fir, self.in_fir, outf)
                need = max(need, g["w1_words"], g["wt_words"],
                           g["a_p"] + g["at"], g["hy"], g["nd"])
        if words < need:
            return (f"block of {self.cfg.buf_size} bytes is shorter than "
                    f"the patch windows ({need} words)")
        return None

    @property
    def fused_eligible(self) -> bool:
        return self.fused_ineligible_reason() is None

    def init_state(self, batch_shape=()) -> PipelineState:
        return PipelineState(iq_off=torch.zeros(
            (*batch_shape, 2), dtype=self.dtype, device=self.device))

    # -- kernel paths ---------------------------------------------------------
    def _cond(self, raw: torch.Tensor) -> torch.Tensor:
        return cond_ops.condition(raw, self.conditioning, self.dtype)

    def fused_call(self, state: PipelineState, raw: torch.Tensor):
        """Kernel path: uint8 [..., n] → (state, audio [..., n/4]).  Each
        kernel computes stationary rows everywhere; its path's patch kernel
        then rewrites the block's head (and tail) rows in float64, in
        place: one launch each on the card, their plain versions on the
        CPU."""
        reason = self.fused_ineligible_reason()
        if reason is not None:
            raise ValueError(reason)
        n = self.cfg.buf_size
        lead = raw.shape[:-1]
        raw2 = raw.reshape(-1, n)
        path = self.kernel_path()
        if path == "q1":
            state, audio = self._fused_q1(state, raw2)
        else:
            audio = {"fused": self._fused_plain, "cplx1": self._fused_inlpf,
                     "cplx2": self._fused_q2l}[path](raw2)
        return state, audio.reshape(*lead, n // 4)

    def _fused_plain(self, raw2: torch.Tensor) -> torch.Tensor:
        """K1 plus its head patch P1 (models/nbfm.py:139-169 of the JAX
        package)."""
        precise = not self.fast_atan2
        audio = fused_nbfm(raw2, self.out_fir.host_taps, self.conditioning,
                           precise=precise)
        return patch_fused(raw2, audio, self.out_fir, self.conditioning,
                           precise=precise)

    def stage_consts(self) -> tuple:
        """K3's ``stages`` argument: ((taps, (c_i, c_q)), ...) of the
        complex stages in application order."""
        return tuple((s.host_taps, tuple(s.host_c_int))
                     for s in self._cplx_stages())

    def _fused_inlpf(self, raw2: torch.Tensor) -> torch.Tensor:
        """K3 with one complex stage (-L or -q 2) plus P3: the float64
        complex head rows and the audio filter's coupling to the stage's
        overrun (``fused_call_inlpf_u32_3d``, models/nbfm.py:288-329)."""
        (inf,), outf = self._cplx_stages(), self.out_fir
        precise = not self.fast_atan2
        audio = fused_nbfm_cplx(raw2, self.stage_consts(), outf.host_taps,
                                self.conditioning, precise=precise)
        return patch_cplx1(raw2, audio, inf, outf, self.conditioning,
                           precise=precise)

    def _fused_q2l(self, raw2: torch.Tensor) -> torch.Tensor:
        """K3 with two stages (-q 2 -L) plus P4: the float64 head, the
        stationary tail recompute with the dc overrun's coupling, and the
        audio y-coupling (``fused_call_q2l_u32_3d``,
        models/nbfm.py:385-486)."""
        precise = not self.fast_atan2
        audio = fused_nbfm_cplx(raw2, self.stage_consts(),
                                self.out_fir.host_taps, self.conditioning,
                                precise=precise)
        return patch_cplx2(raw2, audio, self.dc_fir, self.in_fir,
                           self.out_fir, self.conditioning, precise=precise)

    def _fused_q1(self, state: PipelineState, raw2: torch.Tensor):
        """K4 (-q 1) plus P2, the float64 head recompute from each block's
        entering offset (``fused_call_q1_u32_3d`` and ``_q1_head_patch``,
        models/nbfm.py:195-246).  The batch axis is the block sequence:
        the offset chains through it."""
        outf = self.out_fir
        precise = not self.fast_atan2
        off_in = state.iq_off.reshape(-1)[:2]
        audio, offs_in, off_fin = fused_nbfm_q1(
            raw2, off_in, outf.host_taps, float(self.esr), precise=precise)
        audio = patch_q1(raw2, audio, offs_in, outf, float(self.esr),
                         precise=precise)
        return (PipelineState(iq_off=off_fin.reshape(state.iq_off.shape)),
                audio)

    # -- plain chain ------------------------------------------------------
    def _condition(self, raw: torch.Tensor):
        """→ (conditioned [..., n], dc overrun | None) for the stateless
        kinds 0, 2 and 3."""
        if self.kind == 2:
            pairs = cond_ops.shift_origin(raw, self.dtype).reshape(
                *raw.shape[:-1], raw.shape[-1] // 2, 2)
            y, over = self.dc_fir(pairs)
            return (y.reshape(*raw.shape),
                    over.reshape(*over.shape[:-2], -1))
        return self._cond(raw), None

    def post_condition(self, x: torch.Tensor, dc_over: torch.Tensor | None):
        """Filters and discriminator on conditioned data [..., n] → audio
        [..., n/4]."""
        n = self.cfg.buf_size
        if self.in_fir is not None:
            y, in_over = self.in_fir(
                x.reshape(*x.shape[:-1], n // 2, 2), dc_over)
            x = y.reshape(*x.shape[:-1], n)
            dc_over = in_over.reshape(*in_over.shape[:-2], -1)
        d = fm_demod(x, fast=self.fast_atan2)
        return self.out_fir(d, dc_over)

    def process_blocks(self, state: PipelineState, raw: torch.Tensor):
        """raw: uint8 [B, n] → (state, audio [B, n/4]) with the correctIq
        tracker chained through the blocks in order (models/nbfm.py:658-690
        of the JAX package): per-block summaries at zero offset, a scan
        over the block axis, then each block's entering offset applied.
        A float32 CUDA tensor takes K4 (:meth:`fused_call`)."""
        if self.kind != 1:
            return self(state, raw)
        if raw.is_cuda and self.kernel_path() != "plain":
            return self.fused_call(state, raw)
        return self.plain_call(state, raw)

    def _correct_iq_blocks(self, state: PipelineState, raw: torch.Tensor):
        """correctIq over blocks [B, n] in stream order → (state after the
        last block, conditioned [B, n], offset entering each block [B, 2])."""
        n = self.cfg.buf_size
        decay = cond_ops.correct_iq_decay(n, self.esr, raw.device, self.dtype)
        a_tot = decay[-1] * decay[1]
        out0, b_tot = cond_ops.correct_iq_zero(raw, self.esr, self.dtype)
        off_before, (A, b) = cond_ops.correct_iq_block_prefix(
            a_tot, b_tot, state.iq_off)
        final = A * state.iq_off + b
        cond = cond_ops.correct_iq_apply_offset(out0, off_before, decay)
        return PipelineState(iq_off=final), cond, off_before

    def __call__(self, state: PipelineState, raw: torch.Tensor):
        """raw: uint8 [..., buf_size] → (state, audio [..., buf_size/4]),
        or filtered IQ [..., buf_size] in demod mode 0, in the pipeline's
        dtype.  A CUDA tensor goes through its mode's kernel, which raises
        where it cannot take the config (:meth:`fused_ineligible_reason`);
        a config no kernel computes (:meth:`kernel_path` "plain") and a CPU
        tensor go through the plain chain on the tensor's device.  With
        -q 1 the blocks are [B, n] in stream order and the returned state
        carries the tracker's offset."""
        n = self.cfg.buf_size
        if raw.shape[-1] != n:
            raise ValueError(f"expected blocks of {n} bytes, "
                             f"got {tuple(raw.shape)}")
        if self.cfg.demod_mode() == 0:
            x = cond_ops.normalize_input(raw, self.dtype)
            y, _ = self.in_fir(x.reshape(*x.shape[:-1], n // 2, 2))
            return state, y.reshape(*x.shape[:-1], n)
        if self.kind == 1:
            return self.process_blocks(state, raw)
        if raw.is_cuda and self.kernel_path() != "plain":
            return self.fused_call(state, raw)
        return self.plain_call(state, raw)

    def plain_call(self, state: PipelineState, raw: torch.Tensor):
        """The plain chain as torch ops on ``raw``'s device, whatever the
        device: uint8 [..., n] → (state, audio [..., n/4]) of a
        demodulating mode (-q 1: blocks [B, n] in stream order, the
        offset carried), the counterpart a kernel path is held to."""
        if self.kind == 1:
            state, cond, _ = self._correct_iq_blocks(state, raw)
            return state, self.post_condition(cond, None)
        x, dc_over = self._condition(raw)
        return state, self.post_condition(x, dc_over)

    # -- continuous profile -------------------------------------------------
    @property
    def halo_pairs(self) -> int:
        """Complex samples of the next block's conditioned head that the
        stationary filter chain needs to continue across a block boundary:
        2 input pairs per audio tap reach plus each complex stage's reach,
        rounded up to even so the discriminator's pairing never straddles
        the halo's edge (the JAX ``halo_pairs``)."""
        hp = 2 * self.out_fir.D
        for f in self._cplx_stages():
            hp += f.Dc
        return hp + (hp & 1)

    def condition_block(self, state: PipelineState, raw: torch.Tensor):
        """Conditioning alone, one block: uint8 [..., n] → (state, cond
        [..., n]).  correctIq runs its two-ended tracker per block; -q 2
        conditions with shiftOrigin only, its DC-block highpass running as
        a stationary stage of :meth:`continuous_post` (the JAX
        ``condition_block``)."""
        if self.kind == 1:
            out, off = cond_ops.correct_iq(raw, state.iq_off, self.esr,
                                           self.dtype)
            return PipelineState(iq_off=off), out
        if self.kind == 3:
            return state, cond_ops.normalize_input(raw, self.dtype)
        return state, cond_ops.shift_origin(raw, self.dtype)

    def condition_blocks(self, state: PipelineState, raw: torch.Tensor):
        """:meth:`condition_block` over blocks [B, n] in stream order, in
        one pass: correctIq chains through the blocks by the block prefix of
        :meth:`process_blocks`.  → (state after the last block, cond
        [B, n], the state entering each block as a PipelineState of [B, 2])
        — what a checkpoint between blocks holds."""
        if self.kind == 1:
            state, cond, off_before = self._correct_iq_blocks(state, raw)
            return state, cond, PipelineState(iq_off=off_before)
        _, cond = self.condition_block(state, raw)
        entering = PipelineState(iq_off=state.iq_off.expand(
            raw.shape[0], *state.iq_off.shape[-1:]))
        return state, cond, entering

    def continuous_post(self, cond: torch.Tensor,
                        halo_cond: torch.Tensor) -> torch.Tensor:
        """Stationary filters and discriminator across the block boundary:
        cond [..., n] and the next block's conditioned first 2·halo_pairs
        reals (zeros at the end of the stream) → audio [..., n/4] (filtered
        IQ [..., n] in demod mode 0), with no per-block transients (the JAX
        ``continuous_post``)."""
        n = self.cfg.buf_size
        if halo_cond.shape[-1] != 2 * self.halo_pairs:
            raise ValueError(f"halo of {halo_cond.shape[-1]} reals, want "
                             f"{2 * self.halo_pairs}")
        ext = torch.cat([cond, halo_cond], dim=-1)
        pairs = ext.reshape(*ext.shape[:-1], ext.shape[-1] // 2, 2)
        for f in self._cplx_stages():
            pairs = f.stationary(pairs)
        flat = pairs.reshape(ext.shape)
        if self.cfg.demod_mode() == 0:
            return flat[..., :n]
        audio = self.out_fir.stationary(fm_demod(flat, fast=self.fast_atan2))
        return audio[..., : n >> 2]

    def continuous_halo(self, cond_next: torch.Tensor) -> torch.Tensor:
        """The halo :meth:`continuous_post` takes, from the next block's
        conditioned output: [..., n] → [..., 2·halo_pairs]."""
        return cond_next[..., : 2 * self.halo_pairs]
