"""The host plans of the redesigned K6, K4, K1 and K3 kernels, on the CPU.

K6 (csrc/fused_pfb.cu) runs its C-point DFT as a float64 FFT in two factors
C = C1·C2 up to 256 channels and in three, C = C1·C2·C3, above, up to 4096,
as the wrapper plans it (``fft_plan``), and above 4096 as a four-step FFT
C = N1·N2 in two passes through a scratch buffer (``four_step_plan``),
with every factor read from one
float64 table (``fft_table``); it compiles in the plans of the powers of
two up to 256, and conditions the input a 32-bit word at a time with byte
permutes.  K4 and K5 (csrc/fused_nbfm_q1.cu) read
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
import math
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
from demodulator_tpu_torch.ops.channelizer import PolyphaseChannelizer
from demodulator_tpu_torch.ops.cuda.fused_pfb import (
    CLUSTER_PLANS, MAX_CTA_CHANNELS, MAX_FACTOR, MAX_STAGED, SCRATCH_BYTES, SMEM_LIMIT,
    STEP_SMEM,
    WIDE_PLANS, WIDE_TAPS, fft_plan, fft_table, four_step_plan,
    four_step_smem, four_step_tiles, fused_pfb_demod_ref, group_pairs,
    launches_per_call, on_cluster, pair_smem_bytes,
    sub_plan)

# the two-factor route's channel counts; above, the three-factor route's
CHANNELS = range(1, MAX_STAGED + 1)
WIDE = range(MAX_STAGED + 1, MAX_CTA_CHANNELS + 1)
# the three-factor plans of the card's tests, one of each stage kind: a
# large direct last stage (257, 278, 771), a large direct first one (323),
# small direct stages (384, 1000, 3003), radix stages (512, 1024, 4096)
WIDE_CASES = (257, 278, 323, 384, 512, 771, 1000, 1024, 3003, 4063, 4094,
              4096)


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


def _old_two_factor_plan(C):
    """fft_plan as it was before the three-factor route (C <= 256)."""
    for c1 in range(int(np.sqrt(C)), 0, -1):
        if C % c1 == 0 and C // c1 <= MAX_FACTOR:
            return c1, C // c1
    return C, 1


def _splits(C):
    """Every ordered (C1, C2, C3) with C1·C2·C3 = C and C2 <= 16."""
    return [(a, b, C // (a * b)) for a in range(1, C + 1) if C % a == 0
            for b in range(1, MAX_FACTOR + 1) if (C // a) % b == 0]


def _prime_factors(C):
    out, p = [], 2
    while p * p <= C:
        while C % p == 0:
            out.append(p)
            C //= p
        p += 1
    return out + ([C] if C > 1 else [])


def test_fft_plan_up_to_256_is_unchanged():
    for C in CHANNELS:
        assert fft_plan(C) == _old_two_factor_plan(C), C


def test_fft_plan_three_factors_up_to_max_channels():
    """Every C from 257 to 4096: three factors, C2 at most 16; every factor
    at most 16 where such a split exists, and a factor above 16 only where
    none does, which is so wherever C has a prime factor above 16; the
    shared memory of a CTA within the card's."""
    for C in WIDE:
        plan = fft_plan(C)
        assert len(plan) == 3 and int(np.prod(plan)) == C, C
        assert plan[1] <= MAX_FACTOR, C
        small = any(max(p) <= MAX_FACTOR for p in _splits(C))
        assert (max(plan) <= MAX_FACTOR) == small, C
        if max(_prime_factors(C)) > MAX_FACTOR:
            assert not small and max(plan) > MAX_FACTOR, C
        assert pair_smem_bytes(C) <= SMEM_LIMIT, C
    assert [fft_plan(C) for C in WIDE_CASES] == [
        (1, 1, 257), (1, 2, 139), (17, 1, 19), (3, 8, 16), (8, 8, 8),
        (1, 3, 257), (10, 10, 10), (8, 8, 16), (11, 13, 21), (17, 1, 239),
        (23, 2, 89), (16, 16, 16)]
    # the compiled-in plan (one frame's spectra, Zo, 14 staged rows); any
    # other P runs pfb_big_kernel (a pair's spectra and branch outputs)
    assert pair_smem_bytes(4096) == 213264
    assert pair_smem_bytes(4096, 7) == 197120
    # a C above is the four-step route's
    with pytest.raises(ValueError):
        pair_smem_bytes(MAX_CTA_CHANNELS + 1)


def test_fft_table_three_factors_is_exact_cos_sin():
    """Above 256 the table is e^{+j2πi/C} for i < C alone; the stage
    factors the kernel reads at strides D, C1·C3 and C1·C2 are e^{+j2πm/n}
    to float64 precision, and the twiddles between the stages, entries
    k1·d and C1·k2·c3, are e^{+j2π(k1·d)/C} and e^{+j2π(C1·k2·c3)/C}
    exactly as numpy evaluates them."""
    for C in WIDE:
        C1, C2, C3 = fft_plan(C)
        D = C2 * C3
        tab = fft_table(C)
        assert tab.dtype == np.float64 and tab.shape == (C, 2), C
        cos, sin = pfb_twiddles(C)
        np.testing.assert_array_equal(tab[:, 0], cos)
        np.testing.assert_array_equal(tab[:, 1], sin)
        for n, stride in ((C1, D), (C2, C1 * C3), (C3, C1 * C2)):
            m = np.arange(n)
            theta = 2.0 * np.pi * m / n
            np.testing.assert_allclose(tab[m * stride, 0], np.cos(theta),
                                       rtol=0, atol=2e-15, err_msg=str(C))
            np.testing.assert_allclose(tab[m * stride, 1], np.sin(theta),
                                       rtol=0, atol=2e-15, err_msg=str(C))
        for e in (np.arange(C1)[:, None] * np.arange(D)[None, :],
                  C1 * np.arange(C2)[:, None] * np.arange(C3)[None, :]):
            assert e.max() < C, C
            np.testing.assert_array_equal(tab[e, 0], np.cos(2.0 * np.pi * e / C))
            np.testing.assert_array_equal(tab[e, 1], np.sin(2.0 * np.pi * e / C))


def _stages(z, plan, w, ts=1):
    """The three-factor DFT of z [M, N] in the kernels' index order, N =
    C1·C2·C3 (plan), every factor w_N^e the table entry e·ts of w:
    c = D·c1 + C3·c2 + c3, u1[k1, d] = w_N^(k1 d) Σ_c1 w_C1^(k1 c1) z[D c1
    + d]; u2[k1, k2, c3] = w_N^(C1 k2 c3) Σ_c2 w_C2^(k2 c2) u1[k1, C3 c2 +
    c3]; y[k1 + C1 k2 + C1 C2 k3] = Σ_c3 w_C3^(k3 c3) u2[k1, k2, c3]."""
    C1, C2, C3 = plan
    D = C2 * C3

    def wn(e):
        return w[e * ts]
    a1, a2, a3 = np.arange(C1), np.arange(C2), np.arange(C3)
    zz = z.reshape(-1, C1, D)                                  # [m, c1, d]
    u1 = np.einsum("kc,mcd->mkd", wn((a1[:, None] * a1) % C1 * D), zz)
    u1 = u1 * wn(a1[:, None] * np.arange(D)[None, :])          # [m, k1, d]
    u1 = u1.reshape(-1, C1, C2, C3)                            # [m, k1, c2, c3]
    u2 = np.einsum("jc,mkcd->mkjd", wn((a2[:, None] * a2) % C2 * C1 * C3), u1)
    u2 = u2 * wn(C1 * a2[:, None] * a3[None, :])               # [m, k1, k2, c3]
    y = np.einsum("ld,mkjd->mljk", wn((a3[:, None] * a3) % C3 * C1 * C2), u2)
    return y.reshape(-1, C1 * C2 * C3)         # k = k1 + C1·k2 + C1·C2·k3


def _three_stage(z, C):
    """The three-factor route's DFT of z [M, C] in its index order
    (:func:`_stages` on fft_plan(C) and its table)."""
    return _stages(z, fft_plan(C), fft_table(C) @ np.array([1.0, 1j]))


@pytest.mark.parametrize("C", WIDE_CASES)
def test_three_stage_order_matches_inverse_fft(C):
    rng = np.random.default_rng(C)
    z = rng.standard_normal((3, C)) + 1j * rng.standard_normal((3, C))
    want = C * np.fft.ifft(z, axis=-1)                         # the +j sign
    err = np.max(np.abs(_three_stage(z, C) - want))
    assert err <= 1e-12 * np.max(np.abs(want)), (C, err)


_PFB_SRC = (Path(__file__).resolve().parents[1] / "demodulator_tpu_torch"
            / "csrc" / "fused_pfb.cu")


def test_compiled_wide_plans_are_the_wrappers_plans():
    """The three-factor plans compiled in (PFB_WIDE) are the wrapper's
    factorisations of the 6.25 kHz grids, with the unit, threads and CTAs
    an SM of WIDE_PLANS; each needs the shared memory pair_smem_bytes
    says, within the card's; stages 1 and 2 have a column a thread or more,
    stage 3 at least half as many columns as threads (a column a thread
    where one frame is held)."""
    src = _PFB_SRC.read_text()
    body = src[src.index("#define PFB_WIDE"):src.index("#undef PFB_WIDE")]
    rows = re.findall(r"PFB_WIDE\((\d+), (\d+), (\d+), (\d+), (true|false), "
                      r"(\d+), (\d+)\)", body)
    got = {int(a) * int(b) * int(c): ((int(a), int(b), int(c)),
                                      (int(g), seq == "true", int(t),
                                       int(k)))
           for a, b, c, g, seq, t, k in rows}
    assert set(got) == set(WIDE_PLANS) == {384, 512, 1024, 2048, 4096}
    for C, (plan, consts) in got.items():
        assert plan == fft_plan(C) and consts == WIDE_PLANS[C], C
        G, seq, T, ctas = consts
        C1, C2, C3 = plan
        assert pair_smem_bytes(C) <= SMEM_LIMIT // ctas, C
        frames = 1 if seq else 2 * G
        assert frames * C2 * C3 >= T and frames * C1 * C3 >= T, C
        assert (C1 * C2 == T) if seq else (2 * G * C1 * C2 >= T), C
    # a plan compiled in runs only with the prototype's taps
    assert re.search(r"const int rc = P == kTaps \? wide_plan\(", src)


def test_wide_stage_factors_are_the_tables():
    """kW16, kW3 and kW5 (csrc/pfb_device.cuh), the compiled-in plans'
    stage factors, are the table's entries w_C^(m·C/n) that pfb_big_kernel
    reads, at the three-factor plans and the cluster plans: bit for bit
    where C / n is a power of two (numpy's 2π·i/C is then 2π·m/n exactly)
    and at C = 4800 for n = 5, else within 2e-15 (kW16 at C = 384)."""
    src = (_PFB_SRC.parent / "pfb_device.cuh").read_text()
    plans = {**{C: fft_plan(C) for C in WIDE_PLANS},
             **{C: (*sa, *sb) for C, (_, _, _, _, sa, sb, _)
                in CLUSTER_PLANS.items()}}
    for name, n in (("kW16", 16), ("kW3", 3), ("kW5", 5)):
        body = src[src.index(f"__constant__ double2 {name}["):]
        body = body[:body.index(";")]
        vals = [float.fromhex(v) for v in
                re.findall(r"(-?0x[0-9a-f.]+p[-+]\d+)", body)]
        got = np.array(vals).reshape(n, 2)
        for C, plan in plans.items():
            if n in plan or (n == 16 and C % 16 == 0):
                want = fft_table(C)[np.arange(n) * (C // n)]
                if (C // n) & (C // n - 1) == 0 or (n, C) == (5, 4800):
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{name} {C}")
                else:
                    np.testing.assert_allclose(got, want, rtol=0, atol=2e-15,
                                               err_msg=f"{name} {C}")


def _cond16(w):
    """16-bit words' shiftOrigin conditioning (I the low byte, Q the high)."""
    f32 = np.float32
    return ((((w & 255) + 1) % 256).astype(f32) - f32(128),
            ((((w >> 8) & 255) + 1) % 256).astype(f32) - f32(128))


def _stage_dft(w, n, stride):
    """A stage's factors w_n^(k·c) = table entry (k·c mod n)·stride."""
    k = np.arange(n)
    return w[(k[:, None] * k[None, :]) % n * stride]


def _powers(w, n):
    """wide_powers: w^k for k < n [..., n] by the kernel's squarings and
    products, from w [...]."""
    p = [np.ones_like(w), w]
    for k in range(2, n):
        p.append(p[k - 1] * w if k % 2 else p[k // 2] * p[k // 2])
    return np.stack(p[:n], -1)


def _wide_walk(raw, hist, h, C, grid, precise=False):
    """pfb_wide_kernel's walk in numpy: CTA b's run of units; the ring of
    P + 2G rows filled as the bulk copies fill it, each slot's row checked
    at every read, rows before sample 0 from the history; the branch
    filter's sliding window in float32, tap by tap; each stage's columns as
    the threads split them (every column exactly once), in float64 in U's
    layout; kSeq's Zo and the even frame's held y; stage 3 rounded to
    float32, the plain discriminator.  → (d, z [M, C] complex64 of the
    filter, y [M, C] complex128 of the FFT, natural k)."""
    f32 = np.float32
    G, seq, T, _ = WIDE_PLANS[C]
    C1, C2, C3 = fft_plan(C)
    P = h.shape[0]
    D, ST = C2 * C3, C1 * C2
    S1 = D if D % 2 else D + 1
    NF = 2 * G
    RING, UF = P + NF, 1 if seq else NF
    words = raw.view(np.uint16)
    M = len(words) // C
    pairs = M // 2
    units = -(-pairs // G)
    w = fft_table(C) @ np.array([1.0, 1j])
    d = np.full((pairs, C), np.nan, f32)
    z_all = np.full((M, C), np.nan, np.complex64)
    y_all = np.full((M, C), np.nan, complex)
    c = np.arange(C)
    e = (c > 0).astype(int)
    pos = np.where(e == 1, C - c, 0)
    k3s = ST * np.arange(C3)[None, :]

    def tasks(n):
        """thread t's tasks t, t + T, ...: every task below n once"""
        got = np.concatenate([np.arange(t, n, T) for t in range(T)])
        assert np.array_equal(np.sort(got), np.arange(n))
        return got

    grid = min(grid, units)          # launch_wide: at most a CTA a unit
    for b in range(grid):
        ua, ub = units * b // grid, units * (b + 1) // grid
        assert ub > ua
        ring = np.zeros((RING, C), np.uint16)
        slot_row = np.full(RING, -1)

        def fill(ra, rb):
            for r in range(max(ra, 0), min(rb, M)):
                ring[r % RING] = words[r * C:(r + 1) * C]
                slot_row[r % RING] = r

        fill(ua * NF - P, ua * NF + NF)
        for u in range(ua, ub):
            m0 = u * NF

            def x(q):            # sample (m0 + q)C - c, every c
                s_ = (m0 + q) * C - c
                row = m0 + q - e
                xi, xq = np.full(C, np.nan, f32), np.full(C, np.nan, f32)
                old = s_ < 0
                xi[old] = hist[0, P * C + s_[old]]
                xq[old] = hist[1, P * C + s_[old]]
                # rows from M on: a short unit's frames past the block,
                # read from stale slots, never stored
                new = ~old & (row < M)
                sl = row[new] % RING
                assert np.array_equal(slot_row[sl], row[new])
                xi[new], xq[new] = _cond16(ring[sl, pos[new]])
                return xi, xq

            win = {q: x(q) for q in range(-(P - 1), NF)}
            z = np.empty((NF, C), np.complex64)
            for r in range(NF):
                ar, ai = h[0] * win[r][0], h[0] * win[r][1]
                for p in range(1, P):
                    ar = ar + h[p] * win[r - p][0]
                    ai = ai + h[p] * win[r - p][1]
                assert ar.dtype == ai.dtype == f32
                z[r] = ar + 1j * ai
            live = [f for f in range(NF) if m0 + f < M]
            z_all[m0 + np.array(live)] = z[live]
            fill(m0 + NF, m0 + 2 * NF)                 # the next unit's rows
            held = None
            for fs in ([0], [1]) if seq else (list(range(NF)),):
                U = np.full((UF, C1, S1), np.nan, complex)
                U[:, :, :D] = z[fs].reshape(UF, C1, D)  # kSeq frame 1: Zo
                t = tasks(UF * D)                       # stage 1
                f, dd = t // D, t % D
                y = U[f, :, dd] @ _stage_dft(w, C1, D).T
                U[f, :, dd] = y * _powers(w[dd], C1)      # w_C^(k1 d)
                t = tasks(UF * C1 * C3)                 # stage 2
                f, r = t // (C1 * C3), t % (C1 * C3)
                k1, c3 = (r // C3)[:, None], (r % C3)[:, None]
                idx = c3 + C3 * np.arange(C2)[None, :]
                y = U[f[:, None], k1, idx] @ _stage_dft(w, C2, C1 * C3).T
                U[f[:, None], k1, idx] = y * _powers(w[C1 * c3[:, 0]], C2)
                # stage 3: a column (j, k1, k2) of both frames of pair j,
                # or (k1, k2) of the frame held
                t = tasks(ST if seq else G * ST)
                j, r = t // ST, t % ST
                k1 = (r % C1)[:, None]
                idx = (r // C1)[:, None] * C3 + np.arange(C3)[None, :]
                ys = []
                for fr in ((0,) if seq else (0, 1)):
                    uf = np.zeros_like(j) if seq else 2 * j + fr
                    ys.append(U[uf[:, None], k1, idx] @ _stage_dft(
                        w, C3, C1 * C2).T)
                    frame = m0 + (np.full_like(j, fs[0]) if seq
                                  else 2 * j + fr)
                    ok = frame < M
                    y_all[frame[ok][:, None], r[ok][:, None] + k3s] = \
                        ys[-1][ok]
                if seq and fs == [0]:
                    held = ys[0]
                    continue
                ye = (held if seq else ys[0]).astype(np.complex64)
                yo = ys[-1].astype(np.complex64)
                zr = ye.real * yo.real + ye.imag * yo.imag
                zj = ye.imag * yo.real - ye.real * yo.imag
                a = atan2_poly(torch.from_numpy(zj), torch.from_numpy(zr),
                               _ATAN_COEFFS if precise else _ATAN_COEFFS_FAST,
                               newton_recip=not precise).numpy()
                a = np.where(np.isnan(a), f32(0), a)
                pair = u * G + j
                ok = pair < pairs
                at = (pair[ok][:, None], r[ok][:, None] + k3s)
                assert np.all(np.isnan(d[at]))       # each output once
                d[at] = a[ok]
    return d, z_all, y_all


@pytest.mark.parametrize("C", sorted(WIDE_PLANS))
@pytest.mark.parametrize("pairs, grid", [(11, 3), (5, 1)])
def test_wide_walk_matches_fft_and_plain_version(C, pairs, grid):
    """The compiled-in plans' walk (_wide_walk) on two streamed blocks of
    random bytes, `pairs` pairs a block over `grid` CTAs (runs of one to
    several units; where G = 2 a block's last unit is short; the first
    units' rows before sample 0 come from a random history): the branch
    outputs bit-equal to the plain version's, the FFT within 1e-12 of
    C·ifft of them, and the output within 1e-5 rad (> 100 dB) of
    fused_pfb_demod_ref."""
    rng = np.random.default_rng(C + pairs)
    pfb = PolyphaseChannelizer(C)
    assert pfb.P == WIDE_TAPS
    h = pfb._h_np.astype(np.float32)
    hist = rng.standard_normal((2, pfb.hist_len)).astype(np.float32)
    for blk in range(2):
        raw = rng.integers(0, 256, 4 * C * pairs, np.uint8)
        d, z, y = _wide_walk(raw, hist, h, C, grid)
        assert not np.isnan(d).any() and not np.isnan(y).any()
        t_raw, t_hist = torch.from_numpy(raw), torch.from_numpy(hist)
        zp, _ = pfb.branch_filter(torch.stack(split_iq(t_raw)), t_hist)
        zp = zp.numpy()
        np.testing.assert_array_equal(z.real, zp[0])
        np.testing.assert_array_equal(z.imag, zp[1])
        ref = C * np.fft.ifft(z.astype(np.complex128), axis=-1)
        assert np.max(np.abs(y - ref)) <= 1e-12 * np.max(np.abs(ref))
        want, new_hist = fused_pfb_demod_ref(t_raw, t_hist, pfb._h_np, C)
        want = want.numpy().astype(np.float64)
        err = np.remainder(d - want + np.pi, 2 * np.pi) - np.pi
        snr = 10 * np.log10(np.mean(want ** 2)
                            / max(np.mean(err ** 2), 1e-300))
        assert np.abs(err).max() < 1e-5 and snr > 100.0, (C, blk, snr)
        hist = new_hist.numpy()


# -- K6's four-step route (C > 4096) ------------------------------------------
FOUR_STEP = sorted({*range(MAX_CTA_CHANNELS + 1, 20001),
                    *(1 << k for k in range(13, 21)), 4099, 8191, 8198})


def test_four_step_plan_takes_every_c():
    """Every C from 4097 to 20 000, the powers of two to 2^20, 4099, 8191
    and 8198: N1·N2 = C, N1 the largest divisor up to √C unless that
    leaves N2 above 4096; a factor above 4096 only as N1 (pass 2's direct
    sum, T2 = 0), and every factor up to 4096 on fft_plan's plan (a
    two-factor plan as (a, 1, b)); each tile within a CTA's shared memory,
    at most STEP_SMEM (two CTAs an SM) wherever one column pair fits; the
    launches a call two a group of pairs whose scratch stays within
    SCRATCH_BYTES (one group of a 0.25 s block's 781 pairs up to 16 384
    channels), or one on a compiled-in cluster plan: 4800, 6144, 8192 and
    16384 with the 12-tap prototype, and no other C or P."""
    for C in FOUR_STEP:
        N1, N2 = four_step_plan(C)
        assert N1 * N2 == C, C
        assert N2 <= MAX_CTA_CHANNELS, C
        small = max(d for d in range(1, math.isqrt(C) + 1) if C % d == 0)
        assert (N1, N2) in ((small, C // small), (C // small, small)), C
        assert (N1 == small) == (C // small <= MAX_CTA_CHANNELS), C
        T1, T2 = four_step_tiles(C)
        assert 1 <= T1 <= N1, C
        assert (T2 == 0) == (N1 > MAX_CTA_CHANNELS), C
        assert T2 == 0 or 1 <= T2 <= N2, C
        for N in (N2, N1) if T2 else (N2,):
            plan = fft_plan(N)
            assert sub_plan(N) == (plan if len(plan) == 3
                                   else (plan[0], 1, plan[1])), (C, N)
            assert int(np.prod(sub_plan(N))) == N and sub_plan(N)[1] <= 16
        for sm, T in zip(four_step_smem(C), (T1, T2)):
            assert sm <= SMEM_LIMIT, C
            assert T <= 1 or sm <= STEP_SMEM, C
        g = group_pairs(C)
        assert g == max(1, SCRATCH_BYTES // (32 * C)), C
        assert on_cluster(C) == (C in (4800, 6144, 8192, 16384)), C
        assert not on_cluster(C, WIDE_TAPS - 5), C
        assert launches_per_call(C, 2 * C * 781) == (
            1 if on_cluster(C) else 2 * -(-781 // g)), C
        assert launches_per_call(C, 2 * C * 781, WIDE_TAPS - 5) == \
            2 * -(-781 // g), C
        assert C > 16384 or g >= 781, C
    assert [four_step_plan(C) for C in (4800, 6144, 8192, 8198, 8191,
                                        16384, 1 << 20)] == [
        (64, 75), (64, 96), (64, 128), (4099, 2), (8191, 1), (128, 128),
        (1024, 1024)]
    assert launches_per_call(8192, 8192 * 1562) == 1       # the cluster plan
    assert launches_per_call(8198, 8198 * 1562) == 2
    assert launches_per_call(1 << 20, (1 << 20) * 1562) == 2 * 49  # 16 a group
    assert launches_per_call(4096, 4096 * 1562) == 1


def _pair_filter(x, h, C, top, c):
    """pair_filter in float32: both frames' z of channels c (any shape) of
    the pair whose odd frame starts at sample top, x(s) the conditioned
    sample s; the even frame at tap p reads what the odd one read at tap p
    + 1, each z summed tap by tap from p = 0."""
    P = h.shape[0]
    s = x(top - c)
    hp = h[0, c]
    orr, oi = hp * s[0], hp * s[1]
    er = ei = None
    for p in range(1, P + 1):
        s = x(top - c - p * C)
        er = hp * s[0] if p == 1 else er + hp * s[0]
        ei = hp * s[1] if p == 1 else ei + hp * s[1]
        if p < P:
            hp = h[p, c]
            orr, oi = orr + hp * s[0], oi + hp * s[1]
    assert er.dtype == orr.dtype == np.float32
    return er + 1j * ei, orr + 1j * oi


def _four_step_walk(raw, hist, h, C, group, precise=False):
    """pfb_pass1_kernel and pfb_pass2_kernel in numpy, a group of `group`
    pairs a launch: pass 1 a CTA a (pair, tile of T1 n1), the filter of
    channels n1 + N1·n2 (_pair_filter), the N2-point FFT of each column on
    sub_plan(N2) with w_N2^m = w_C^(m·N1), times w_C^(n1·k2), into the
    scratch Y [pair][frame][k2][n1] (each entry written once); pass 2 a CTA
    a (pair, tile of T2 k2), the N1-point FFT of each row on sub_plan(N1)
    with w_N1^m = w_C^(m·N2), or the direct sum where T2 = 0, y rounded
    once to float32, the discriminator into d[m2, k2 + N2·k1].  → (d, z
    [M, C] complex64, y [M, C] complex128, natural k)."""
    f32 = np.float32
    N1, N2 = four_step_plan(C)
    T1, T2 = four_step_tiles(C)
    P = h.shape[0]
    w = fft_table(C) @ np.array([1.0, 1j])
    words = raw.view(np.uint16)
    pairs = len(words) // (2 * C)
    xi, xq = _cond16(words)

    def x(s):                       # conditioned samples s (any shape)
        old = s < 0
        si = np.where(old, 0, s)
        hi = np.where(old, P * C + s, 0)
        return (np.where(old, hist[0, hi], xi[si]).astype(f32),
                np.where(old, hist[1, hi], xq[si]).astype(f32))

    d = np.full((pairs, C), np.nan, f32)
    z_all = np.full((2 * pairs, C), np.nan, np.complex64)
    y_all = np.full((2 * pairs, C), np.nan, complex)
    k2s, k1s = np.arange(N2), np.arange(N1)
    for p0 in range(0, pairs, group):
        g = min(group, pairs - p0)
        Y = np.full((g, 2, N2, N1), np.nan, complex)
        for jp in range(g):
            top = (2 * (p0 + jp) + 1) * C
            for a in range(0, N1, T1):
                n1 = np.arange(a, min(a + T1, N1))
                c = n1[:, None] + N1 * k2s[None, :]        # [live, n2]
                ze, zo = _pair_filter(x, h, C, top, c)
                for e, z in enumerate((ze, zo)):
                    z_all[2 * (p0 + jp) + e, c] = z
                    yk = _stages(z.astype(complex), sub_plan(N2), w, N1)
                    got = Y[jp, e][:, n1]
                    assert np.all(np.isnan(got))           # written once
                    Y[jp, e][:, n1] = (yk * w[n1[:, None] * k2s[None, :]]).T
        assert not np.isnan(Y).any()
        for jp in range(g):
            j = p0 + jp
            for b in range(0, N2, T2 or N2):
                k2 = np.arange(b, min(b + (T2 or N2), N2))
                ys = []
                for e in (0, 1):
                    rows = Y[jp, e][k2]                    # [live, n1]
                    if T2:
                        yk = _stages(rows, sub_plan(N1), w, N2)
                    else:                  # the direct sum, w_C^(n1 k1 N2)
                        yk = rows @ w[(k1s[:, None] * k1s[None, :]) % N1
                                      * N2]
                    k = k2[:, None] + N2 * k1s[None, :]
                    y_all[2 * j + e, k] = yk
                    ys.append(yk.astype(np.complex64))
                ye, yo = ys
                zr = ye.real * yo.real + ye.imag * yo.imag
                zj = ye.imag * yo.real - ye.real * yo.imag
                a_ = atan2_poly(torch.from_numpy(zj), torch.from_numpy(zr),
                                _ATAN_COEFFS if precise else _ATAN_COEFFS_FAST,
                                newton_recip=not precise).numpy()
                k = k2[:, None] + N2 * k1s[None, :]
                assert np.all(np.isnan(d[j, k]))
                d[j, k] = np.where(np.isnan(a_), f32(0), a_)
    return d, z_all, y_all


@pytest.mark.parametrize("C", [4800, 6144, 8192, 8198])
def test_four_step_order_matches_inverse_fft(C):
    """Both passes in the scratch layout and index order (_four_step_walk)
    on 3 frame pairs of random bytes after a random history, a pair a
    group (the first group's filter reads the history): y within 1e-9
    relative of C·ifft of the filter's z, the output within 1e-5 rad and
    > 100 dB of the plain discriminator on that y rounded to float32."""
    rng = np.random.default_rng(C)
    pfb = PolyphaseChannelizer(C)
    h = pfb._h_np.astype(np.float32)
    hist = rng.standard_normal((2, pfb.hist_len)).astype(np.float32)
    raw = rng.integers(0, 256, 4 * C * 3, np.uint8)
    d, z, y = _four_step_walk(raw, hist, h, C, group=1)
    assert not np.isnan(y).any() and not np.isnan(d).any()
    ref = C * np.fft.ifft(z.astype(np.complex128), axis=-1)     # the +j sign
    assert np.max(np.abs(y - ref)) <= 1e-9 * np.max(np.abs(ref)), C
    r = ref.astype(np.complex64)
    ye, yo = r[0::2], r[1::2]
    zr = ye.real * yo.real + ye.imag * yo.imag
    zj = ye.imag * yo.real - ye.real * yo.imag
    want = atan2_poly(torch.from_numpy(zj), torch.from_numpy(zr),
                      _ATAN_COEFFS_FAST, newton_recip=True).numpy()
    want = np.where(np.isnan(want), 0, want).astype(np.float64)
    err = np.remainder(d - want + np.pi, 2 * np.pi) - np.pi
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean(err ** 2), 1e-300))
    assert np.abs(err).max() < 1e-5 and snr > 100.0, (C, snr)


@pytest.mark.parametrize("C", [4097, 8192, 8198])
def test_four_step_filter_is_the_plain_filter(C):
    """Pass 1's branch filter over its tiles, z of 2 frame pairs after a
    random history, bit-equal to the plain version's (the channelizer's
    float32 filter in p order); two pairs a group and one."""
    rng = np.random.default_rng(C + 1)
    pfb = PolyphaseChannelizer(C)
    h = pfb._h_np.astype(np.float32)
    hist = rng.standard_normal((2, pfb.hist_len)).astype(np.float32)
    raw = rng.integers(0, 256, 4 * C * 2, np.uint8)
    zp, _ = pfb.branch_filter(torch.stack(split_iq(torch.from_numpy(raw))),
                              torch.from_numpy(hist))
    zp = zp.numpy()
    N1, N2 = four_step_plan(C)
    T1, _ = four_step_tiles(C)
    words = raw.view(np.uint16)
    xi, xq = _cond16(words)
    P = h.shape[0]

    def x(s):
        old = s < 0
        return (np.where(old, hist[0, np.where(old, P * C + s, 0)],
                         xi[np.where(old, 0, s)]).astype(np.float32),
                np.where(old, hist[1, np.where(old, P * C + s, 0)],
                         xq[np.where(old, 0, s)]).astype(np.float32))
    for j in range(2):
        got = np.full((2, C), np.nan, np.complex64)
        for a in range(0, N1, T1):
            n1 = np.arange(a, min(a + T1, N1))
            c = n1[:, None] + N1 * np.arange(N2)[None, :]
            got[0, c], got[1, c] = _pair_filter(x, h, C, (2 * j + 1) * C, c)
        np.testing.assert_array_equal(got.real, zp[0, 2 * j: 2 * j + 2])
        np.testing.assert_array_equal(got.imag, zp[1, 2 * j: 2 * j + 2])


# -- K6's cluster route (the compiled-in four-step plans) ---------------------
def _stage_geometry(plan, s):
    """Stages' stage s of an N-point plan: (R, B, D)."""
    B = int(np.prod(plan)) // int(np.prod(plan[:s]))
    return plan[s], B, B // plan[s]


def _stage_pos(plan, k):
    """Stages::pos: natural index k -> its position after the stages."""
    p = 0
    for s in range(len(plan)):
        p += (k % plan[s]) * _stage_geometry(plan, s)[2]
        k //= plan[s]
    return p


def _stage_kbase(plan, row):
    """Stages::kbase: the last stage's block row -> its output 0's natural
    index."""
    kb, m = 0, 1
    for s in range(len(plan) - 1):
        kb += (row // (_stage_geometry(plan, s)[2] // plan[-1]) % plan[s]) * m
        m *= plan[s]
    return kb


def _by_products(w0, w1, n):
    """[n, ...]: w0·w1^k, each power the one before times w1 (the kernel's
    running product)."""
    p = [w0 * np.ones_like(w1)]
    for _ in range(1, n):
        p.append(p[-1] * w1)
    return np.stack(p)


def _cl_stage(X, plan, s, w, C):
    """cl_stage: stage s (not the last) of X [2, N, L]'s N-point FFTs in
    place, outputs times w_B^(k·d) as powers of table entry d·C/B."""
    R, B, D = _stage_geometry(plan, s)
    N, L = X.shape[1], X.shape[2]
    v = X.reshape(2, N // B, R, D, L)          # point blk·B + D·i + d
    k = np.arange(R)
    y = np.einsum("ki,fbidl->fbkdl", w[(k[:, None] * k[None, :]) % R
                                        * (C // R)], v)
    y *= _by_products(1.0 + 0j, w[np.arange(D) * (C // B)], R)[
        None, None, :, :, None]
    return y.reshape(2, N, L)


def _cl_last(X, plan, w, C):
    """The last stage's R-point DFTs of X [2, N, L] in place (no twiddle):
    (y [2, N/R, R, L], block row -> kbase)."""
    R = plan[-1]
    N, L = X.shape[1], X.shape[2]
    k = np.arange(R)
    y = np.einsum("ki,fril->frkl", w[(k[:, None] * k[None, :]) % R
                                      * (C // R)], X.reshape(2, N // R, R, L))
    return y, np.array([_stage_kbase(plan, r) for r in range(N // R)])


def _cluster_walk(raw, hist, h, C, grid, precise=False):
    """pfb_cluster_kernel's walk in numpy: cluster i of `grid` takes pairs
    [i·pairs/grid, (i + 1)·pairs/grid); its CTA r keeps a ring of P + 1
    rows of N2 runs of NA + 8 raw words (the run of n2 from sample (R +
    1)C − N1·n2 − a − NA, 16-byte aligned; each slot's row checked at
    every read), filled as the copies fill it, samples before 0 from the
    history and channel 0's row −1 from the input; the filter of channels
    a + l + N1·n2 (the odd frame's tap p from ring row 2j − p, the even
    frame's from 2j − 1 − p, float32 tap by tap) into X [frame, n2, l];
    step A's stages in place, the last times w_C^(n1·k2); the exchange:
    CTA r's k2 slice gathers Y[n1, k2] from the CTA owning n1 at
    Stages::pos(k2); step B's stages, the last
    pairing the frames (y rounded once to float32, the plain
    discriminator) into d[j, k2 + N2·k1].  → (d, z [M, C] complex64, y [M,
    C] complex128 in natural k)."""
    f32 = np.float32
    N1, N2, K, _, SA, SB, _ = CLUSTER_PLANS[C]
    P = h.shape[0]
    NA, NB, RW, RING = N1 // K, -(-N2 // K), N1 // K + 8, P + 1
    words = raw.view(np.uint16)
    xi, xq = _cond16(words)
    M = len(words) // C
    pairs = M // 2
    w = fft_table(C) @ np.array([1.0, 1j])
    d = np.full((pairs, C), np.nan, f32)
    z_all = np.full((M, C), np.nan, np.complex64)
    y_all = np.full((M, C), np.nan, complex)
    n2s, ls = np.arange(N2)[:, None], np.arange(NA)[None, :]
    grid = min(grid, pairs)
    for cl in range(grid):
        ja, jb = pairs * cl // grid, pairs * (cl + 1) // grid
        assert jb > ja
        ring = np.zeros((K, RING, N2, RW), np.uint16)
        slot_row = np.full((K, RING), -1)

        def fill(ra, rb):
            for r in range(K):
                for R in range(ra, rb):
                    src = ((R + 1) * C - N1 * n2s - r * NA - NA
                           + np.arange(RW)[None, :])
                    assert src.min() >= 0 and src.max() < len(words)
                    assert src.min() % 8 == 0            # 16-byte aligned
                    ring[r, R % RING] = words[src]
                    slot_row[r, R % RING] = R

        fill(max(2 * ja - P, 0), 2 * ja + 1)
        for j in range(ja, jb):
            X = []
            for r in range(K):
                c = r * NA + ls + N1 * n2s                  # [N2, NA]

                def x(q):
                    R = 2 * j - q
                    s_ = (R + 1) * C - c
                    vi = np.full(c.shape, np.nan, f32)
                    vq = np.full(c.shape, np.nan, f32)
                    old = s_ < 0
                    vi[old] = hist[0, P * C + s_[old]]
                    vq[old] = hist[1, P * C + s_[old]]
                    if R < 0:                   # sample 0 of channel 0
                        new = ~old
                        assert np.array_equal(s_[new], np.zeros(new.sum()))
                        vi[new], vq[new] = xi[s_[new]], xq[s_[new]]
                    else:
                        assert not old.any()
                        assert slot_row[r, R % RING] == R
                        vi, vq = _cond16(ring[r, R % RING, n2s, NA - ls])
                    return vi, vq
                ze, zo = _ring_pair_filter(x, h, c)
                z_all[2 * j, c], z_all[2 * j + 1, c] = ze, zo
                X.append(np.stack([ze, zo]).astype(complex))  # [2, N2, NA]
            if j + 1 < jb:
                fill(2 * j + 1, 2 * j + 3)
            for r in range(K):                               # step A
                for s_ in range(len(SA) - 1):
                    X[r] = _cl_stage(X[r], SA, s_, w, C)
                y, kb = _cl_last(X[r], SA, w, C)
                n1 = r * NA + np.arange(NA)
                tw = _by_products(w[kb[:, None] * n1[None, :]],
                                  w[n1 * (N2 // SA[-1])][None, :], SA[-1])
                X[r] = (y * tw.transpose(1, 0, 2)[None]).reshape(2, N2, NA)
            for r in range(K):                               # step B
                k2 = r * NB + np.arange(min(NB, N2 - r * NB))
                pos = np.array([_stage_pos(SA, k) for k in k2])
                n1 = np.arange(N1)
                Xb = np.stack([X[q][:, pos] for q in range(K)], 1)
                # Xb [2, K, live, NA] -> rows [2, N1, live], n1 = q·NA + col
                Xb = Xb.transpose(0, 1, 3, 2).reshape(2, N1, len(k2))
                for s_ in range(len(SB) - 1):
                    Xb = _cl_stage(Xb, SB, s_, w, C)
                y, kb = _cl_last(Xb, SB, w, C)               # [2, rows, R, L]
                k1 = kb[:, None] + (N1 // SB[-1]) * np.arange(SB[-1])[None, :]
                k = k2[None, None, :] + N2 * k1[:, :, None]  # [rows, R, L]
                for f in (0, 1):
                    y_all[2 * j + f, k] = y[f]
                ye, yo = y.astype(np.complex64)
                zr = ye.real * yo.real + ye.imag * yo.imag
                zj = ye.imag * yo.real - ye.real * yo.imag
                a_ = atan2_poly(torch.from_numpy(zj), torch.from_numpy(zr),
                                _ATAN_COEFFS if precise else _ATAN_COEFFS_FAST,
                                newton_recip=not precise).numpy()
                assert np.all(np.isnan(d[j, k]))             # each output once
                d[j, k] = np.where(np.isnan(a_), f32(0), a_)
    return d, z_all, y_all


def _ring_pair_filter(x, h, c):
    """The filter of both frames of a pair from x(q), ring row 2j − q: the
    odd frame's tap p at q = p, the even frame's at q = p + 1, each z summed
    tap by tap from p = 0 in float32 (pair_filter's order)."""
    P = h.shape[0]
    s = x(0)
    hp = h[0, c]
    orr, oi = hp * s[0], hp * s[1]
    er = ei = None
    for p in range(1, P + 1):
        s = x(p)
        er = hp * s[0] if p == 1 else er + hp * s[0]
        ei = hp * s[1] if p == 1 else ei + hp * s[1]
        if p < P:
            hp = h[p, c]
            orr, oi = orr + hp * s[0], oi + hp * s[1]
    assert er.dtype == orr.dtype == np.float32
    return er + 1j * ei, orr + 1j * oi


@pytest.mark.parametrize("C", sorted(CLUSTER_PLANS))
def test_cluster_walk_matches_fft_and_plain_version(C):
    """The cluster plans' walk (_cluster_walk) on two streamed blocks of 8
    random frame pairs over two clusters (the first cluster's pairs and the
    second's first two read rows before sample 0 from a random history,
    the later ones only the ring): the branch outputs bit-equal to the plain
    version's, y within 1e-9 of C·ifft of them, the output within 1e-5 rad
    and > 100 dB of the plain discriminator on that y rounded to float32,
    and at 4800 of fused_pfb_demod_ref; the history bit-equal to it."""
    rng = np.random.default_rng(C + 3)
    pfb = PolyphaseChannelizer(C)
    assert pfb.P == WIDE_TAPS
    h = pfb._h_np.astype(np.float32)
    hist = rng.standard_normal((2, pfb.hist_len)).astype(np.float32)
    for blk in range(2):
        raw = rng.integers(0, 256, 4 * C * 8, np.uint8)
        d, z, y = _cluster_walk(raw, hist, h, C, grid=2, precise=blk == 1)
        assert not np.isnan(d).any() and not np.isnan(y).any()
        t_raw, t_hist = torch.from_numpy(raw), torch.from_numpy(hist)
        zp, new_hist = pfb.branch_filter(torch.stack(split_iq(t_raw)), t_hist)
        zp = zp.numpy()
        np.testing.assert_array_equal(z.real, zp[0])
        np.testing.assert_array_equal(z.imag, zp[1])
        ref = C * np.fft.ifft(z.astype(np.complex128), axis=-1)
        assert np.max(np.abs(y - ref)) <= 1e-9 * np.max(np.abs(ref)), C
        r = ref.astype(np.complex64)
        ye, yo = r[0::2], r[1::2]
        zr = ye.real * yo.real + ye.imag * yo.imag
        zj = ye.imag * yo.real - ye.real * yo.imag
        want = atan2_poly(torch.from_numpy(zj), torch.from_numpy(zr),
                          _ATAN_COEFFS if blk else _ATAN_COEFFS_FAST,
                          newton_recip=not blk).numpy()
        wants = [np.where(np.isnan(want), 0, want)]
        if C == 4800:
            ref_d, ref_h = fused_pfb_demod_ref(t_raw, t_hist, pfb._h_np, C,
                                               precise=blk == 1)
            wants.append(ref_d.numpy())
            assert torch.equal(new_hist, ref_h)
        for want in wants:
            want = want.astype(np.float64)
            err = np.remainder(d - want + np.pi, 2 * np.pi) - np.pi
            snr = 10 * np.log10(np.mean(want ** 2)
                                / max(np.mean(err ** 2), 1e-300))
            assert np.abs(err).max() < 1e-5 and snr > 100.0, (C, blk, snr)
        hist = new_hist.numpy()


def test_compiled_cluster_plans_are_the_wrappers_plans():
    """The cluster plans compiled in (PFB_CLUSTER in
    csrc/fused_pfb_cluster.cu, the taps held in registers where the row
    says so) are CLUSTER_PLANS: four_step_plan's N1 × N2,
    K CTAs a cluster dividing N1 in 16-byte runs (N1/K a multiple of 8), at
    most 8 (no non-portable size), step A's and step B's stages products to
    N2 and N1 of 2, 3, 4, 5, 8 and 16 points; step B's first stage a task a
    thread."""
    src = (_PFB_SRC.parent / "fused_pfb_cluster.cu").read_text()
    body = src[src.index("#define PFB_CLUSTER"):src.index("#undef PFB_CLUSTER")]
    rows = re.findall(r"PFB_CLUSTER\((\d+), (\d+), (\d+), (\d+), (\d+), "
                      r"Stages<([\d, ]+)>, Stages<([\d, ]+)>"
                      r"(?:, (true))?\)", body)
    got = {int(c): (int(n1), int(n2), int(k), int(t),
                    tuple(int(v) for v in sa.split(", ")),
                    tuple(int(v) for v in sb.split(", ")), held == "true")
           for c, n1, n2, k, t, sa, sb, held in rows}
    assert got == CLUSTER_PLANS
    assert set(CLUSTER_PLANS) == {4800, 6144, 8192, 16384}
    for C, (N1, N2, K, T, SA, SB, _) in CLUSTER_PLANS.items():
        assert (N1, N2) == four_step_plan(C) and N1 * N2 == C
        assert N1 % K == 0 and (N1 // K) % 8 == 0 and K <= 8, C
        assert int(np.prod(SA)) == N2 and int(np.prod(SB)) == N1, C
        assert set(SA) | set(SB) <= {2, 3, 4, 5, 8, 16}, C
        assert 2 * -(-N2 // K) * (N1 // SB[0]) <= T, C
        assert on_cluster(C) and launches_per_call(C, 2 * C * 781) == 1


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


@pytest.mark.parametrize("H", [0, 1, 3, 4, 5, 20, 123, 130])
@pytest.mark.parametrize("vecs", [1, 2])
def test_span_plan_with_head_writes_every_word_once(vecs, H):
    """K1 with its head rows (csrc/fused_nbfm.cu, nbfm_span.cuh): the
    head warp writes words [0, H), and a span that starts before H stores
    its words one by one from H on (the other spans store as K1 alone), as
    the kernel masks them: every word of the row is written exactly once,
    for head rows within the first span and past it."""
    lw = np.stack([k.lane_words(lane, vecs) for lane in range(32)])
    for ntaps in (2, 3, 32):
        for words in (H + 1, 127, 128, 1201, 4096, 65539):
            if words <= H:
                continue
            step, spans = k.span_plan(words, ntaps, (), vecs)
            count = np.zeros(words, int)
            count[:H] += 1                              # the head warp
            for span in range(spans):
                w0 = span * step
                masked = w0 < H                         # warp-uniform
                for lane in range(32):
                    for c in range(vecs):
                        if 128 * c + 4 * lane >= step:
                            continue
                        wd = w0 + 128 * c + 4 * lane    # the chunk's first
                        in_head = H - wd if masked else 0
                        for i in range(4):
                            if wd + i < words and i >= in_head:
                                count[wd + i] += 1
            assert np.array_equal(count, np.ones(words, int)), (ntaps, words)
            assert sorted(lw.ravel()) == list(range(128 * vecs))


@pytest.mark.parametrize("name", ["span", "span K3", "pfb", "wide", "q1",
                                  "head fused_nbfm", "head fused_nbfm_q1",
                                  "step", "cluster"])
def test_section_variants_find_their_markers(name):
    """``ops/cuda/sections.py`` cuts its variants out of the kernels'
    sources by markers; every marker is still in the source (a missing
    one raises), and each variant differs from the source as built."""
    from demodulator_tpu_torch.ops.cuda import sections
    if name.startswith("head"):
        variants = sections.head_variants(name.split()[1])
        assert variants["as built"] != variants["registers unheld"]
        return
    variants = {"span": lambda: sections.span_variants(False),
                "span K3": lambda: sections.span_variants(True),
                "pfb": sections.pfb_variants,
                "wide": sections.wide_variants,
                "q1": sections.q1_variants,
                "step": sections.pass1_variants,
                "cluster": sections.cluster_variants}[name]()
    texts = [v if isinstance(v, str) else "".join(v.values())
             for v in variants.values()]
    assert len(set(texts)) == len(texts) > 1
    if name == "wide":
        # cumulative cuts: each adds its section's call back
        for kern, calls in (
                ("pfb_big_kernel", ("  // branch filter: the odd frame",
                                    "  switch (s.C1) {",
                                    "  if (s.C2 > 1) {",
                                    "  sub_stage3_of<false, true>(U, tw, b.s,")),
                ("pfb_wide_kernel", ("wide_filter<W, false>(ring,",
                                     "wide_stage1<W>(U, Zo, tw, false);",
                                     "wide_stage2<W>(U, tw);",
                                     "wide_stage3<W>(U, d + u"))):
            cuts = [variants[f"{kern}: {c}"] for c in sections.WIDE_CUTS]
            for k, call in enumerate(calls):
                assert [call in t for t in cuts] == [i > k for i in range(5)]
    # cumulative cuts: each adds its section back
    for kind, cut_names, calls in (
            ("step", sections.PASS1_CUTS,
             ("      pair_filter(in, hist, h, C, P, top, a + tt + N1 * n2,",
              "        const float2 z = Z[f * ZS + c];",
              "      Yp[e * C + k2 * N1 + n1] = n1 * k2 ? cmul(")),
            ("cluster", sections.CLUSTER_CUTS,
             ("      cl_filter<W, false>(ring, in, hist, h, hr, X, j, a);",
              "    cl_last_a<W>(X, tw, a);",
              "    step_b<W>(X, XB, tw, d + j * C, kb0, live, precise);",
              ("    step_b<W>(X, XB, tw, d + j * C, kb0, live, precise);",
               "  cl_last_b<W>(X, row, kb0, live, precise);")))):
        if name != kind:
            continue
        cuts = [variants[c] for c in cut_names]
        for k, call in enumerate(calls):
            call = (call,) if isinstance(call, str) else call
            assert [all(c in t for c in call) for t in cuts] == [
                i > k for i in range(len(cuts))], call
