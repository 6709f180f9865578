"""The host plans of the redesigned K6, K4, K1 and K3 kernels, on the CPU.

K6 (csrc/fused_pfb.cu) runs its C-point DFT as a float64 FFT in two factors
C = C1·C2 that the wrapper plans (``fft_plan``), with every factor read from
one float64 table (``fft_table``); it compiles in the plans of the powers of
two, and conditions the input a 32-bit word at a time with byte permutes.  K4 and K5 (csrc/fused_nbfm_q1.cu) read
every power of the tracker's decay from a float32 table that the host builds
(``q1_pow_table``), and K4 composes its tiles' affine summaries into
blocks' and the blocks' in a decoupled look-back.  The kernels run only on the card
(tests/test_torch_cuda.py); here numpy emulations of their index order and
composition order are held to numpy's FFT and to K4's plain version.
K1 and K3 (csrc/nbfm_span.cuh) cut each row into overlapping warp spans
(``span_plan``, ``lane_words``): their plan is checked for every tap count
the kernels take, and a numpy emulation of the lanes, shuffles and
block-end zeros is held equal to the plain versions.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from demodulator_tpu_torch.config import config_from_cli_opts
from demodulator_tpu_torch.models.nbfm import BlockPipeline
from demodulator_tpu_torch.ops.channelizer import pfb_twiddles
from demodulator_tpu_torch.ops.conditioning import NORM_SCALE, split_iq
from demodulator_tpu_torch.ops.demod import (_ATAN_COEFFS, _ATAN_COEFFS_FAST,
                                             atan2_poly)
from demodulator_tpu_torch.ops.cuda import fused_nbfm as k
from demodulator_tpu_torch.ops.cuda.fused_pfb import (MAX_CHANNELS, MAX_FACTOR,
                                                      fft_plan, fft_table)

CHANNELS = range(1, MAX_CHANNELS + 1)


def _row_stride(C2):
    return C2 + 1 if C2 > 1 else 1


def test_fft_plan_factorises_every_c():
    for C in CHANNELS:
        C1, C2 = fft_plan(C)
        assert C1 * C2 == C, C
        assert (C1 <= MAX_FACTOR and C2 <= MAX_FACTOR) or C2 == 1, C
        if C2 == 1 and C > 1:
            # no split into factors of at most 16 exists
            assert not any(C % a == 0 and C // a <= MAX_FACTOR
                           for a in range(1, MAX_FACTOR + 1)), C
    # the closest factors at the bank's channel counts, and two others
    assert [fft_plan(C) for C in (64, 256, 12, 4)] == [(8, 8), (16, 16),
                                                       (3, 4), (2, 2)]
    assert fft_plan(48) == (6, 8) and fft_plan(17) == (17, 1)


def test_fft_table_is_exact_cos_sin():
    """The table's first C rows are e^{+j2πi/C}; the stage factors the
    kernel reads at strides C2 and C1 are e^{+j2πm/C1} and e^{+j2πm/C2}
    to float64 precision; the twiddles between the stages, at C + k1·RS +
    c2, are e^{+j2πk1·c2/C} exactly as numpy evaluates them."""
    for C in CHANNELS:
        C1, C2 = fft_plan(C)
        tab = fft_table(C)
        rs = _row_stride(C2)
        assert tab.dtype == np.float64 and tab.shape == (C + C1 * rs, 2), C
        cos, sin = pfb_twiddles(C)
        np.testing.assert_array_equal(tab[:C, 0], cos)
        np.testing.assert_array_equal(tab[:C, 1], sin)
        for n, stride in ((C1, C2), (C2, C1)):
            m = np.arange(n)
            theta = 2.0 * np.pi * m / n
            np.testing.assert_allclose(tab[m * stride, 0], np.cos(theta),
                                       rtol=0, atol=2e-15, err_msg=str(C))
            np.testing.assert_allclose(tab[m * stride, 1], np.sin(theta),
                                       rtol=0, atol=2e-15, err_msg=str(C))
        k1c2 = np.arange(C1)[:, None] * np.arange(C2)[None, :]
        tw = tab[C:].reshape(C1, rs, 2)[:, :C2]
        np.testing.assert_array_equal(tw[..., 0], np.cos(2.0 * np.pi * k1c2 / C))
        np.testing.assert_array_equal(tw[..., 1], np.sin(2.0 * np.pi * k1c2 / C))


def _two_stage(z, C):
    """The kernel's DFT of z [M, C] in its index order, every factor from
    its table: u[k1, c2] = Σ_c1 w_C1^(k1 c1) z[C2 c1 + c2], times w_C^(k1
    c2), then y[k1 + C1 k2] = Σ_c2 w_C2^(k2 c2) u[k1, c2]."""
    C1, C2 = fft_plan(C)
    tab = fft_table(C)
    w = tab[:, 0] + 1j * tab[:, 1]
    zz = z.reshape(-1, C1, C2)                                # [m, c1, c2]
    a1 = np.arange(C1)
    u = np.einsum("kc,mcd->mkd", w[(a1[:, None] * a1[None, :]) % C1 * C2], zz)
    u = u * w[C:].reshape(C1, _row_stride(C2))[:, :C2]        # [m, k1, c2]
    a2 = np.arange(C2)
    y = np.einsum("jd,mkd->mjk", w[(a2[:, None] * a2[None, :]) % C2 * C1], u)
    return y.reshape(-1, C)                                   # k = k1 + C1·k2


def test_two_stage_order_matches_inverse_fft():
    rng = np.random.default_rng(0)
    for C in CHANNELS:
        z = rng.standard_normal((3, C)) + 1j * rng.standard_normal((3, C))
        want = C * np.fft.ifft(z, axis=-1)                    # the +j sign
        err = np.max(np.abs(_two_stage(z, C) - want))
        assert err <= 1e-12 * np.max(np.abs(want)), (C, err)


def test_compiled_plans_are_the_wrappers_plans():
    """The kernel compiles in the plan of every power of two C from 2 to
    256 (Fixed); its dispatch keys must be the wrapper's factorisations, or
    those C would run on the runtime plan."""
    src = (Path(__file__).resolve().parents[1] / "demodulator_tpu_torch"
           / "csrc" / "fused_pfb.cu").read_text()
    body = src[src.index("    switch (key) {"):]
    body = body[:body.index("default:")]
    fixed = {(int(a), int(b))
             for a, b in re.findall(r"PFB_FIXED\((\d+), (\d+)\)", body)}
    assert fixed == {fft_plan(1 << k) for k in range(1, 9)}


def _byte_perm(x, y, sel):
    """CUDA __byte_perm on uint32 arrays: result byte k is byte (sel >>
    4k) & 7 of the 8 bytes y:x (x the low four)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for k in range(4):
        b = (sel >> (4 * k)) & 7
        out |= ((both >> np.uint64(8 * b)) & np.uint64(255)) << np.uint64(8 * k)
    return out.astype(np.uint32)


def test_word_conditioning_is_the_plain_conditioning():
    """K6's staging (cond_word): every byte of a word incremented mod 256
    at once, placed under the bits of 2^23 by a byte permute, less 2^23 +
    128, is the plain shiftOrigin conditioning of that byte, bit for bit:
    every byte value in every position, and random words."""
    rng = np.random.default_rng(5)
    b = np.arange(256, dtype=np.uint32)
    w = np.concatenate([b * 0x01010101, (b << 8) | (255 - b),
                        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
                        .astype(np.uint32)])
    v = ((w & 0x7F7F7F7F) + 0x01010101) ^ (w & 0x80808080)
    high = np.full_like(w, 0x4B000000)
    got = np.stack([_byte_perm(v, high, 0x7540 + k).view(np.float32)
                    - np.float32(8388736.0) for k in range(4)], -1)
    xi, xq = split_iq(torch.from_numpy(w.view(np.uint8).copy()))
    want = torch.stack([xi, xq], -1).reshape(len(w), 4).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- K4 / K5: the power table and the look-back -------------------------------
def _esr(rate):
    return np.float32(50.0 / rate)        # models/nbfm.py BlockPipeline.esr


@pytest.mark.parametrize("rate", [96000.0, 192000.0])
def test_q1_pow_table_is_float64_power_rounded_once(rate):
    esr = _esr(rate)
    d = 1.0 - 2.0 * float(esr)
    q = d * d
    T = k.q1_pow_table(esr)
    assert T.dtype == np.float32
    assert len(T) == k.Q1_TILE + k.MAX_TAPS   # every m <= tile + kMaxTaps - 1
    for m in range(len(T)):
        assert T[m] == np.float32(q ** m), m
    assert T[0] == 1.0


def _lookback_offsets(raw, off_in, esr, tile):
    """K4's composition order in float32: each tile's map from zero (step
    pairs j of a block: front word j and mirror word n/4-1-j); a block's
    map folds its tiles' maps in order, x -> T[len]·x + agg; the blocks
    compose from off_in as x -> a^(n/4)·x + tot, as the plain version
    composes them; a tile's entering offset folds its block's earlier
    tiles onto the block's.  → (off_entering [B, 2], off_final [2], every
    tile's entering offset [tiles, 2])."""
    f32 = np.float32
    B, n = raw.shape
    half = n // 8
    words = raw.reshape(B, n // 4, 4).astype(f32)
    front, mirror = words[:, :half], words[:, ::-1][:, :half]
    es, a = f32(esr), f32(1.0 - 2.0 * float(esr))
    s0 = np.stack([(front[..., 0] + mirror[..., 2]) * es,
                   (front[..., 1] + mirror[..., 3]) * es], -1)
    s1 = np.stack([(front[..., 2] + mirror[..., 0]) * es,
                   (front[..., 3] + mirror[..., 1]) * es], -1)
    T = k.q1_pow_table(esr, tile)
    a_blk = f32((1.0 - 2.0 * float(esr)) ** (n // 4))
    e = np.asarray(off_in, f32)
    entering, tile_in = [], []
    for b in range(B):
        entering.append(e)
        tot, e_tile = np.zeros(2, f32), e
        for j0 in range(0, half, tile):
            tile_in.append(e_tile)
            agg = np.zeros(2, f32)
            for j in range(j0, min(j0 + tile, half)):
                agg = a * (a * agg + s0[b, j]) + s1[b, j]
            ln = min(j0 + tile, half) - j0
            tot = T[ln] * tot + agg
            e_tile = T[ln] * e_tile + agg
        e = a_blk * e + tot
    return np.stack(entering), e, np.stack(tile_in)


def _tracker64(raw, off_in, esr):
    """The tracker in float64, step pair by step pair through the blocks:
    the offset entering step pair j of block b, [B, n/8, 2]."""
    B, n = raw.shape
    half = n // 8
    words = raw.reshape(B, n // 4, 4).astype(np.float64)
    front, mirror = words[:, :half], words[:, ::-1][:, :half]
    es = float(np.float32(esr))
    a = 1.0 - 2.0 * es
    off = np.asarray(off_in, np.float64)
    out = np.empty((B, half, 2))
    for b in range(B):
        for j in range(half):
            out[b, j] = off
            off = a * (a * off + (front[b, j, 0:2] + mirror[b, j, 2:4]) * es) \
                + (front[b, j, 2:4] + mirror[b, j, 0:2]) * es
    return out


@pytest.mark.parametrize("tile", [k.Q1_TILE, 100, 37])
def test_lookback_order_offsets_match_plain_version(iq_data, tile):
    """On the iq_data tone (3 blocks of 4096 bytes, 512 step pairs each:
    one tile per block at Q1_TILE, several with a remainder tile at 100 and
    37), the look-back's offsets are within 1e-3 of K4's plain version,
    and every tile's within 1e-3 of a float64 tracker."""
    raw = iq_data.reshape(3, -1)
    off_in = np.array([127.3, 126.8], np.float32)
    esr = _esr(192000.0)
    ent, fin, tile_in = _lookback_offsets(raw, off_in, esr, tile)
    _, want_ent, want_fin = k.fused_nbfm_q1_ref(
        torch.from_numpy(raw), torch.from_numpy(off_in), [1.0], float(esr))
    np.testing.assert_allclose(ent, want_ent.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(fin, want_fin.numpy(), rtol=0, atol=1e-3)
    # every tile's entering offset, against the float64 tracker
    want_tiles = _tracker64(raw, off_in, esr)[:, ::tile].reshape(-1, 2)
    np.testing.assert_allclose(tile_in, want_tiles, rtol=0, atol=1e-3)
    assert k.q1_tiles(3, raw.shape[1], tile) == len(tile_in)


def test_normalize_byte_trick_is_the_plain_conditioning():
    """K1's and K3's normalize conditioning (condition_word<true>): byte k
    of a word placed under the bits of 2^23 by a byte permute, less 2^23,
    is float(b) exactly; times f32(2/255), less 1, it is the plain
    normalize conditioning of that byte, bit for bit: every byte value in
    every position, and random words."""
    rng = np.random.default_rng(6)
    b = np.arange(256, dtype=np.uint32)
    w = np.concatenate([b * 0x01010101, (b << 8) | (255 - b),
                        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
                        .astype(np.uint32)])
    got = np.stack([_span_condition(w, "normalize", k) for k in range(4)],
                   -1)
    xi, xq = split_iq(torch.from_numpy(w.view(np.uint8).copy()), "normalize")
    want = torch.stack([xi, xq], -1).reshape(len(w), 4).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- K1 / K3: the warp spans --------------------------------------------------
def _span_condition(w, cond, k):
    """Byte k of the uint32 words w conditioned as csrc/nbfm_device.cuh
    condition_byte does it: float32 arithmetic on the permuted bits."""
    f32 = np.float32
    if cond == "shift":
        w = ((w & 0x7F7F7F7F) + 0x01010101) ^ (w & 0x80808080)
    f = _byte_perm(w, np.full_like(w, 0x4B000000), 0x7540 + k).view(f32)
    if cond == "shift":
        return f - f32(8388736.0)
    return (f - f32(8388608.0)) * f32(NORM_SCALE) - f32(1.0)


def _span_gather(v, M):
    """The kernel's gather: e[lane, c, m] = element P + m of lane's chunk c,
    i.e. element m % P of lane + 1 + m // P, of chunk c + 1 past lane 31;
    past the span's last lane the shuffle wraps (garbage, as on the card).
    v [32, vecs, P, ...] → [32, vecs, M, ...]."""
    lanes, vecs, P = v.shape[:3]
    e = np.empty((lanes, vecs, M) + v.shape[3:], v.dtype)
    for m in range(M):
        src = np.arange(lanes) + 1 + m // P
        s = v[src & 31, :, m % P]                      # one shuffle per chunk
        nxt = (src >= 32).reshape((-1,) + (1,) * (s.ndim - 2))
        for c in range(vecs):
            e[:, c, m] = np.where(nxt & (c + 1 < vecs), s[:, min(c + 1,
                                                              vecs - 1)],
                                  s[:, c])
    return e


def _span_kernel(row, taps, stages, cond, precise, vecs):
    """K1's or K3's span body on one row of uint8 bytes, in the kernel's
    order: per warp span, its 32 lanes' words (lane_words), conditioning
    by the byte trick, each stage on a lane's samples plus the gathered
    look-ahead, zero past the row's end after every step, the
    discriminator, the audio FIR on a lane's words plus the gathered ones;
    each lane writes its words below step.  float32 throughout."""
    f32 = np.float32
    words = len(row) // 4
    w_row = row.view(np.uint32)
    taps = np.asarray(taps, np.float64).astype(f32)
    step, spans = k.span_plan(words, len(taps), [len(t) for t, _ in stages],
                              vecs)
    lw = np.stack([k.lane_words(lane, vecs) for lane in range(32)])
    lw = lw.reshape(32, vecs, 4)
    out = np.zeros(words, f32)
    written = np.zeros(words, int)
    coeffs = _ATAN_COEFFS if precise else _ATAN_COEFFS_FAST
    for j in range(spans):
        idx = j * step + lw                                   # [32, vecs, 4]
        live = idx < words
        w = np.where(live, w_row[np.minimum(idx, words - 1)], 0).astype(
            np.uint32)
        z = np.stack([_span_condition(w, cond, b) for b in range(4)], -1)
        z = z.reshape(32, vecs, 8, 2)                 # samples (I, Q)
        live_s = np.repeat(live, 2, axis=2)[..., None]
        z = np.where(live_s, z, f32(0))
        for st, c in stages:
            st = np.asarray(st, np.float64).astype(f32)
            c = np.asarray(c, np.float64).astype(f32)
            ext = np.concatenate([z, _span_gather(z, max(len(st) - 1, 0))],
                                 axis=2)
            y = np.broadcast_to(c, z.shape).astype(f32)
            for t in range(len(st)):
                y = y + st[t] * ext[:, :, t: t + 8]
            z = np.where(live_s, y, f32(0))
        zr = z[:, :, 0::2, 0] * z[:, :, 1::2, 0] + z[:, :, 0::2, 1] * z[:, :, 1::2, 1]
        zj = z[:, :, 0::2, 1] * z[:, :, 1::2, 0] - z[:, :, 0::2, 0] * z[:, :, 1::2, 1]
        x = atan2_poly(torch.from_numpy(zj), torch.from_numpy(zr), coeffs,
                       newton_recip=not precise).numpy()
        x = np.where(np.isnan(x) | ~live, f32(0), x)
        xe = np.concatenate([x, _span_gather(x, len(taps) - 1)], axis=2)
        y = taps[0] * x
        for d in range(1, len(taps)):
            y = y + taps[d] * xe[:, :, d: d + 4]
        keep = live & (idx - j * step < step)
        out[idx[keep]] = y[keep]
        written[idx[keep]] += 1
    assert np.all(written == 1)
    return out


# K1 at D = 1 and 2, K3 with one stage of Dc = 1 and 2 and with two stages
SPAN_CHAINS = {
    "K1 D=1": {"S": "192000", "l": "12500"},
    "K1 D=2": {"S": "96000", "l": "12500", "m": "1", "d": "8"},
    "K3 -L": {"S": "96000", "l": "12500", "L": "12500"},
    "K3 -L Dc=2": {"S": "192000", "l": "12500", "L": "12500", "D": "8",
                   "m": "2"},
    "K3 -q 2 -L": {"S": "96000", "l": "12500", "q": "2", "L": "12500"},
}


@pytest.mark.parametrize("row_words", [1024, 4 * 77 + 3])
@pytest.mark.parametrize("vecs", [1, 2])
@pytest.mark.parametrize("cond", ["shift", "normalize"])
@pytest.mark.parametrize("chain", sorted(SPAN_CHAINS))
def test_span_order_equals_plain_version(iq_data, chain, cond, vecs,
                                         row_words):
    """The numpy emulation of the span kernel's order (lanes, shuffles,
    the zero past the row's end, the spans' overlap) equals the plain
    version bit for bit on the iq_data tone: 3 rows of 1024 words, and
    rows of 311 words (not a multiple of 4 or of a span)."""
    pipe = BlockPipeline(config_from_cli_opts({**SPAN_CHAINS[chain],
                                               "b": "-6"}), device="cpu")
    taps = pipe.out_fir.host_taps
    stages = pipe.stage_consts() if chain.startswith("K3") else ()
    raw = iq_data[: 3 * 4 * row_words].reshape(3, -1)
    t = torch.from_numpy(raw)
    want = (k.fused_nbfm_cplx_ref(t, stages, taps, cond) if stages
            else k.fused_nbfm_ref(t, taps, cond)).numpy()
    got = np.stack([_span_kernel(r.copy(), taps, stages, cond, True, vecs)
                    for r in raw])
    np.testing.assert_array_equal(got, want)


def test_span_constants_match_the_kernel():
    src = (Path(__file__).resolve().parents[1] / "demodulator_tpu_torch"
           / "csrc" / "nbfm_span.cuh").read_text()
    m = re.search(r"constexpr int kVecs = (\d+);", src)
    assert int(m.group(1)) == k.SPAN_VECS


def _reach_splits(stages):
    """(stage taps) for every reach R a count of stages can have: none;
    one stage of 1..32 taps; two stages, up to 32 taps each."""
    if stages == 0:
        return [()]
    if stages == 1:
        return [(r + 1,) for r in range(32)]
    return [(min(r, 31) + 1, r - min(r, 31) + 1) for r in range(63)]


@pytest.mark.parametrize("vecs", [1, 2])
@pytest.mark.parametrize("stages", [0, 1, 2])
def test_span_plan_writes_every_word_once(vecs, stages):
    """For every D <= 31 and stage reach (<= 62 samples), on rows of word
    counts that are and are not multiples of 4 or of a span: every output
    word is written by exactly one lane; every 16-byte load starts on a
    16-byte boundary of a 16-byte aligned row of a multiple of 4 words and
    lies wholly in the row or wholly past it; the span reads at least the
    FIR's D and the stages' reach (halved up to words) past its last
    written word."""
    lw = np.stack([k.lane_words(lane, vecs) for lane in range(32)])
    assert sorted(lw.ravel()) == list(range(128 * vecs))
    firsts = lw[:, ::4].ravel()                     # each chunk's first word
    for ntaps in range(1, 33):
        for st in _reach_splits(stages):
            reach = sum(n - 1 for n in st)
            halo = k.span_halo(ntaps, st)
            assert halo == (reach + 1) // 2 + ntaps - 1
            for words in (1, 3, 4, 5, 127, 128, 129, 311, 1201, 1203, 4096,
                          65539):
                step, spans = k.span_plan(words, ntaps, st, vecs)
                assert 0 < step and step % 4 == 0
                assert step + halo <= 128 * vecs
                assert (spans - 1) * step < words <= spans * step
                base = np.arange(spans)[:, None] * step
                wr = (base + lw.ravel()[lw.ravel() < step]).ravel()
                wr = wr[wr < words]
                assert np.array_equal(np.bincount(wr, minlength=words),
                                      np.ones(words, int))
                if words % 4 == 0:
                    starts = (base + firsts).ravel()
                    assert np.all(starts % 4 == 0)
                    assert np.all((starts + 4 <= words) | (starts >= words))
