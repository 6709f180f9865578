"""The CUDA kernels against their plain PyTorch versions, on an NVIDIA GPU.

Every test here needs the card and skips without one: a CUDA kernel has no
CPU mode.  The file imports neither jax nor tests/conftest.py, so it also
runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import io
import math

import numpy as np
import pytest
import torch

from demodulator_tpu_torch.config import config_from_cli_opts
from demodulator_tpu_torch.models.nbfm import BlockPipeline
from demodulator_tpu_torch.ops.cuda import fused_nbfm as k
from demodulator_tpu_torch.runtime.stream import StreamProcessor

pytestmark = pytest.mark.cuda

BUF = 4096
FILTERS = {
    "butterworth": {"S": "192000", "l": "12500"},              # D = 1
    "chebyshev": {"S": "96000", "l": "12500", "m": "1", "d": "8"},  # D = 2
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tone(blocks, seed=42, fs=192000.0, buf=BUF):
    """FM tone + noise uint8 IQ [blocks, buf], like tests/conftest.py."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * buf // 2) / fs
    iq = np.exp(2.5j * (1 - np.cos(2 * np.pi * 1000.0 * t))) * 80
    iq += (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t))) * 4
    out = np.empty(blocks * buf, dtype=np.uint8)
    out[0::2] = np.clip(np.round(iq.real + 127.4), 0, 255)
    out[1::2] = np.clip(np.round(iq.imag + 127.4), 0, 255)
    return torch.from_numpy(out.reshape(blocks, buf))


def _snr_db(want, got):
    want = want.double().cpu().ravel()
    err = float(((want - got.double().cpu().ravel()) ** 2).mean())
    return math.inf if err == 0 else 10 * math.log10(
        float((want ** 2).mean()) / err)


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("cond", ["shift", "normalize"])
@pytest.mark.parametrize("precise", [True, False])
def test_kernel_matches_ref(cuda_device, precise, cond, filt):
    taps = BlockPipeline(config_from_cli_opts(FILTERS[filt]),
                         device="cpu").out_fir.host_taps
    raw = _tone(3).to(cuda_device)
    n0 = k.fused_nbfm.launches
    got = k.fused_nbfm(raw, taps, cond, precise)
    assert k.fused_nbfm.launches == n0 + 1
    want = k.fused_nbfm_ref(raw, taps, cond, precise)
    if precise:
        # the same float32 operations in the same order, each rounded to
        # nearest
        assert torch.equal(got, want)
    else:
        # rcp.approx + Newton against an exact reciprocal + Newton
        assert _snr_db(want, got) > 110.0


def test_dma_floor_matches_ref(cuda_device):
    raw = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (5, BUF), np.uint8)).to(cuda_device)
    n0 = k.dma_floor.launches
    assert torch.equal(k.dma_floor(raw), k.dma_floor_ref(raw))
    assert k.dma_floor.launches == n0 + 1


def test_misaligned_bytes_raise(cuda_device):
    buf = torch.zeros(BUF + 1, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        k.fused_nbfm(buf[1:].view(1, BUF), [1.0])


@pytest.mark.parametrize("q, fast", [(0, False), (0, True), (3, False)])
def test_pipeline_takes_kernel(cuda_device, q, fast):
    """A CUDA tensor goes through the kernel plus the float64 head patch and
    agrees with the plain chain on the CPU."""
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6",
                                "q": str(q)})
    raw = _tone(3)
    cpu = BlockPipeline(cfg, fast_atan2=fast, device="cpu")
    gpu = BlockPipeline(cfg, fast_atan2=fast, device=cuda_device)
    n0 = k.fused_nbfm.launches
    _, got = gpu(gpu.init_state(), raw.to(cuda_device))
    assert k.fused_nbfm.launches == n0 + 1
    _, want = cpu(cpu.init_state(), raw)
    assert _snr_db(want, got) > 110.0


@pytest.mark.parametrize("chunk_blocks", [1, 3, 16])
def test_stream_processor_on_card(cuda_device, chunk_blocks):
    """The pinned-buffer ring and the inflight window give the plain
    chain's output, every block once and in order."""
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6"})
    raw = _tone(7)
    data = raw.numpy().tobytes() + b"\x7f" * 100
    outs = {}
    for dev in ("cpu", cuda_device):
        out = io.BytesIO()
        proc = StreamProcessor(cfg, chunk_blocks=chunk_blocks, device=dev)
        assert proc.run(io.BytesIO(data), out) == 7
        outs[str(dev)] = torch.from_numpy(
            np.frombuffer(out.getvalue(), np.float32).copy())
    assert _snr_db(outs["cpu"], outs[str(cuda_device)]) > 110.0


# -L, -q 2 and -q 2 -L: K3 with one or two complex stages
CHAINS = {
    "L": {"S": "96000", "l": "12500", "L": "12500"},
    "q2": {"S": "96000", "l": "12500", "q": "2"},
    "q2 L": {"S": "96000", "l": "12500", "q": "2", "L": "12500"},
    "L D8 m2": {"S": "192000", "l": "12500", "L": "12500", "D": "8",
                "m": "2"},                                    # Dc = 2
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("cond", ["shift", "normalize"])
@pytest.mark.parametrize("precise", [True, False])
def test_cplx_kernel_matches_ref(cuda_device, precise, cond, chain):
    pipe = BlockPipeline(config_from_cli_opts({**CHAINS[chain], "b": "-6"}),
                         device="cpu")
    stages, taps = pipe.stage_consts(), pipe.out_fir.host_taps
    raw = _tone(3).to(cuda_device)
    n0 = k.fused_nbfm_cplx.launches
    got = k.fused_nbfm_cplx(raw, stages, taps, cond, precise)
    assert k.fused_nbfm_cplx.launches == n0 + 1
    want = k.fused_nbfm_cplx_ref(raw, stages, taps, cond, precise)
    if precise:
        # the same float32 operations in the same order, each rounded
        assert torch.equal(got, want)
    else:
        assert _snr_db(want, got) > 110.0


# -- K1 and K3's warp spans: odd rows, misaligned rows, runtime counts -------
SPAN_CHAINS = {"K1 butterworth": FILTERS["butterworth"],
               "K1 chebyshev": FILTERS["chebyshev"],
               **{f"K3 {c}": o for c, o in CHAINS.items()}}


def _span_kernel(raw, chain, cond, precise):
    """(kernel output, plain output) of K1 or K3 for the chain's taps; the
    kernel's launch count goes up by one."""
    pipe = BlockPipeline(config_from_cli_opts({**SPAN_CHAINS[chain],
                                               "b": "-6"}), device="cpu")
    taps = pipe.out_fir.host_taps
    if chain.startswith("K1"):
        kernel, args = k.fused_nbfm, (taps,)
        plain = k.fused_nbfm_ref
    else:
        kernel, args = k.fused_nbfm_cplx, (pipe.stage_consts(), taps)
        plain = k.fused_nbfm_cplx_ref
    n0 = kernel.launches
    got = kernel(raw, *args, cond, precise)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    return got, plain(raw, *args, cond, precise)


# (bytes per row, rows, byte offset of the first row from a 16-byte
# boundary): rows of 4·(4k + 1) and 4·(4k + 3) bytes (scalar loads and
# stores, a span boundary inside a lane's words), one of 5 words (a single
# span), a 256 KiB + 12 byte row; a row start 4 bytes past a 16-byte
# boundary; one row; 300 rows.
SPAN_SHAPES = [(4 * (4 * 300 + 1), 3, 0), (4 * (4 * 300 + 3), 3, 0),
               (4 * (4 * 1 + 1), 4, 0), (4 * (4 * 65536 + 3), 2, 0),
               (BUF, 3, 4), (BUF, 1, 0), (BUF, 300, 0)]


@pytest.mark.parametrize("n, B, offset", SPAN_SHAPES)
@pytest.mark.parametrize("chain", sorted(SPAN_CHAINS))
@pytest.mark.parametrize("cond", ["shift", "normalize"])
def test_span_kernels_bit_equal_on_any_row(cuda_device, cond, chain, n, B,
                                           offset):
    raw = _tone(B, buf=n).reshape(-1)
    buf = torch.zeros(B * n + 16, dtype=torch.uint8, device=cuda_device)
    base = (16 - buf.data_ptr() % 16) % 16 + offset
    buf[base: base + B * n] = raw.to(cuda_device)
    raw = buf[base: base + B * n].view(B, n)
    assert raw.data_ptr() % 16 == offset
    got, want = _span_kernel(raw, chain, cond, True)
    assert torch.equal(got, want)


# counts that are not compiled in: 32 audio taps (D = 31) and 32 taps per
# stage (a reach of 62 samples), 1 and 5 audio taps, 4 and 17 stage taps;
# the kernel reads them at run time
@pytest.mark.parametrize("ntaps, stage_taps", [
    (32, ()), (1, ()), (5, ()), (32, (32,)), (32, (32, 32)), (2, (4,)),
    (3, (17, 2)), (1, (1, 1))])
@pytest.mark.parametrize("precise", [True, False])
def test_span_kernels_runtime_counts(cuda_device, precise, ntaps, stage_taps):
    rng = np.random.default_rng(ntaps + 7 * len(stage_taps))
    taps = rng.uniform(-0.5, 0.5, ntaps)
    stages = tuple((rng.uniform(-0.3, 0.3, m), tuple(rng.uniform(-1, 1, 2)))
                   for m in stage_taps)
    raw = _tone(3, buf=4 * (4 * 300 + 3)).to(cuda_device)
    for cond in ("shift", "normalize"):
        if stages:
            got = k.fused_nbfm_cplx(raw, stages, taps, cond, precise)
            want = k.fused_nbfm_cplx_ref(raw, stages, taps, cond, precise)
        else:
            got = k.fused_nbfm(raw, taps, cond, precise)
            want = k.fused_nbfm_ref(raw, taps, cond, precise)
        if precise:
            assert torch.equal(got, want), cond
        else:
            assert _snr_db(want, got) > 110.0, cond


def test_dma_floor_on_odd_and_misaligned_rows(cuda_device):
    rng = np.random.default_rng(4)
    for n, B, offset in SPAN_SHAPES:
        buf = torch.zeros(B * n + 16, dtype=torch.uint8, device=cuda_device)
        base = (16 - buf.data_ptr() % 16) % 16 + offset
        buf[base: base + B * n] = torch.from_numpy(
            rng.integers(0, 256, B * n, np.uint8)).to(cuda_device)
        raw = buf[base: base + B * n].view(B, n)
        assert torch.equal(k.dma_floor(raw), k.dma_floor_ref(raw)), (n, B)


# one tile; several tiles; several and a remainder tile of 64 step pairs
# (n/4 stays a multiple of 128: on other lengths the plain version's flat
# affine scan is itself below the 110 dB bar against a float64 tracker)
@pytest.mark.parametrize("buf", [BUF, 16 * BUF, 16 * BUF + 8 * 64])
# 64 blocks: the look-back crosses blocks
@pytest.mark.parametrize("blocks", [1, 5, 64])
@pytest.mark.parametrize("precise", [True, False])
def test_q1_kernel_matches_ref(cuda_device, precise, blocks, buf):
    pipe = BlockPipeline(config_from_cli_opts(
        {"S": "96000", "l": "12500", "q": "1"}), device="cpu")
    taps, esr = pipe.out_fir.host_taps, float(pipe.esr)
    raw = _tone(blocks, buf=buf).to(cuda_device)
    off = torch.tensor([127.3, 126.8], device=cuda_device)
    n0 = k.fused_nbfm_q1.launches
    audio, offs, fin = k.fused_nbfm_q1(raw, off, taps, esr, precise)
    assert k.fused_nbfm_q1.launches == n0 + 1
    wa, wo, wf = k.fused_nbfm_q1_ref(raw, off, taps, esr, precise)
    assert _snr_db(wa, audio) > 110.0
    assert float((offs - wo).abs().max()) < 1e-3
    assert float((fin - wf).abs().max()) < 1e-3


@pytest.mark.parametrize("chain", sorted(CHAINS) + ["q1"])
@pytest.mark.parametrize("fast", [False, True])
def test_pipeline_takes_mode_kernel(cuda_device, chain, fast):
    """Each mode's CUDA path (its kernel plus the float64 patches) against
    the plain chain on the CPU."""
    opts = CHAINS.get(chain, {"S": "96000", "l": "12500", "q": "1"})
    cfg = config_from_cli_opts({**opts, "b": "-6"})
    raw = _tone(5)
    cpu = BlockPipeline(cfg, fast_atan2=fast, device="cpu")
    gpu = BlockPipeline(cfg, fast_atan2=fast, device=cuda_device)
    kernel = {"cplx1": k.fused_nbfm_cplx, "cplx2": k.fused_nbfm_cplx,
              "q1": k.fused_nbfm_q1}[gpu.kernel_path()]
    n0 = kernel.launches
    st, got = gpu(gpu.init_state(), raw.to(cuda_device))
    assert kernel.launches == n0 + 1
    wst, want = cpu(cpu.init_state(), raw)
    assert _snr_db(want, got) > 110.0
    assert float((st.iq_off.cpu() - wst.iq_off).abs().max()) < 1e-3


def test_q1_blocks_one_at_a_time_equal_batched(cuda_device):
    cfg = config_from_cli_opts({"S": "96000", "l": "12500", "q": "1",
                                "b": "-6"})
    pipe = BlockPipeline(cfg, device=cuda_device)
    raw = _tone(6).to(cuda_device)
    st, batched = pipe(pipe.init_state(), raw)
    st1, outs = pipe.init_state(), []
    for b in range(6):
        st1, a = pipe(st1, raw[b:b + 1])
        outs.append(a)
    assert _snr_db(batched, torch.cat(outs)) > 125.0
    assert float((st1.iq_off - st.iq_off).abs().max()) < 1e-3


@pytest.mark.parametrize("chunk_blocks", [1, 3])
def test_stream_processor_q1_on_card(cuda_device, chunk_blocks):
    """-q 1's offset crosses the chunks on the card as on the CPU."""
    cfg = config_from_cli_opts({"S": "96000", "l": "12500", "q": "1",
                                "b": "-6"})
    data = _tone(7).numpy().tobytes()
    outs = {}
    for dev in ("cpu", cuda_device):
        out = io.BytesIO()
        proc = StreamProcessor(cfg, chunk_blocks=chunk_blocks, device=dev)
        assert proc.run(io.BytesIO(data), out) == 7
        outs[str(dev)] = torch.from_numpy(
            np.frombuffer(out.getvalue(), np.float32).copy())
    assert _snr_db(outs["cpu"], outs[str(cuda_device)]) > 110.0


def test_cplx_and_q1_misaligned_bytes_raise(cuda_device):
    buf = torch.zeros(BUF + 1, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        k.fused_nbfm_cplx(buf[1:].view(1, BUF), (([1.0], (0.0, 0.0)),),
                          [1.0])
    with pytest.raises(ValueError):
        k.fused_nbfm_q1(buf[1:].view(1, BUF),
                        torch.zeros(2, device=cuda_device), [1.0], 0.001)


# -- K5: the sequential correctIq kernel -------------------------------------
@pytest.mark.parametrize("buf", [BUF, 16 * BUF])
@pytest.mark.parametrize("blocks", [1, 5, 40])
@pytest.mark.parametrize("precise", [True, False])
def test_q1_seq_kernel_matches_ref_and_k4(cuda_device, precise, blocks, buf):
    pipe = BlockPipeline(config_from_cli_opts(
        {"S": "96000", "l": "12500", "q": "1"}), device="cpu")
    taps, esr = pipe.out_fir.host_taps, float(pipe.esr)
    raw = _tone(blocks, buf=buf).to(cuda_device)
    off = torch.tensor([127.3, 126.8], device=cuda_device)
    n0 = k.fused_nbfm_q1_seq.launches
    audio, offs, fin = k.fused_nbfm_q1_seq(raw, off, taps, esr, precise)
    torch.cuda.synchronize()
    assert k.fused_nbfm_q1_seq.launches == n0 + 1
    for want in (k.fused_nbfm_q1_seq_ref(raw, off, taps, esr, precise),
                 k.fused_nbfm_q1(raw, off, taps, esr, precise)):
        wa, wo, wf = want
        assert _snr_db(wa, audio) > 110.0
        assert float((offs - wo).abs().max()) < 1e-3
        assert float((fin - wf).abs().max()) < 1e-3


# -- K6: the PFB front of the channel bank ----------------------------------
from demodulator_tpu_torch.models.channel_bank import (  # noqa: E402
    ChannelBankConfig, ChannelBankPipeline)
from demodulator_tpu_torch.ops.channelizer import (  # noqa: E402
    PolyphaseChannelizer)
from demodulator_tpu_torch.ops.cuda import fused_pfb as k6  # noqa: E402
from demodulator_tpu_torch.runtime.stream import (  # noqa: E402
    BankStreamProcessor)

CR = 192000.0


def _bank_iq(fs, offsets, n, seed=0, tone=1000.0, dev=5000.0):
    """Wideband uint8 IQ with one FM carrier per offset (the fixture of
    tests/test_channel_bank.py), n complex samples."""
    t = np.arange(n) / fs
    z = np.zeros(n, np.complex128)
    for i, off in enumerate(offsets):
        msg = np.sin(2 * np.pi * tone * (i + 1) * t)
        z += 0.3 * np.exp(1j * (2 * np.pi * off * t
                                + 2 * np.pi * dev * np.cumsum(msg) / fs))
    rng = np.random.default_rng(seed)
    z += rng.normal(0, .01, n) + 1j * rng.normal(0, .01, n)
    iq = np.empty(2 * n)
    iq[0::2], iq[1::2] = z.real, z.imag
    return np.clip(np.round(iq * 127 + 127), 0, 255).astype(np.uint8)


def _wrapped_ok(want, got):
    """tests/test_fused_pfb.py:46-55: angle-wrapped error < 0.01 rad and
    > 80 dB."""
    w, g = want.double().cpu(), got.double().cpu()
    e = torch.remainder(g - w + math.pi, 2 * math.pi) - math.pi
    snr = 10 * math.log10(float((w ** 2).mean())
                          / max(float((e ** 2).mean()), 1e-300))
    return float(e.abs().max()) < 0.01 and snr > 80.0, (float(e.abs().max()),
                                                        snr)


# every FFT plan: radix and direct factors, up to 256 channels, and 17 and
# 251 (primes above 16: the direct DFT, C2 = 1)
@pytest.mark.parametrize("C", [2, 3, 4, 5, 8, 12, 16, 17, 32, 48, 64, 128,
                               251, 256])
@pytest.mark.parametrize("data", ["bank", "noise"])
def test_pfb_kernel_matches_ref(cuda_device, data, C):
    pfb = PolyphaseChannelizer(C)
    n = 2 * C * 96
    rng = np.random.default_rng(C)
    hist_k = torch.zeros((2, pfb.hist_len), device=cuda_device)
    hist_r = hist_k.clone()
    for blk in range(2):
        raw = (_bank_iq(C * CR, (0.0, 2 * CR, -CR), n, seed=blk)
               if data == "bank" else rng.integers(0, 256, 2 * n, np.uint8))
        raw = torch.from_numpy(raw).to(cuda_device)
        n0 = k6.fused_pfb_demod.launches
        d, hist_k = k6.fused_pfb_demod(raw, hist_k, pfb._h_np, C)
        torch.cuda.synchronize()
        assert k6.fused_pfb_demod.launches == n0 + 1
        want, hist_r = k6.fused_pfb_demod_ref(raw, hist_r, pfb._h_np, C)
        ok, detail = _wrapped_ok(want, d)
        assert ok, detail
        assert torch.equal(hist_k, hist_r)


# a prototype of 7 taps per branch: the kernel's plan read at run time, also
# where C is a power of two (compiled in for 12 taps)
@pytest.mark.parametrize("C", [4, 12, 64])
def test_pfb_kernel_runtime_plan_matches_ref(cuda_device, C):
    pfb = PolyphaseChannelizer(C, taps_per_phase=7)
    n = 2 * C * 96
    hist_k = torch.zeros((2, pfb.hist_len), device=cuda_device)
    hist_r = hist_k.clone()
    for blk in range(2):
        raw = torch.from_numpy(_bank_iq(C * CR, (0.0, 2 * CR), n, seed=blk)
                               ).to(cuda_device)
        d, hist_k = k6.fused_pfb_demod(raw, hist_k, pfb._h_np, C)
        want, hist_r = k6.fused_pfb_demod_ref(raw, hist_r, pfb._h_np, C)
        ok, detail = _wrapped_ok(want, d)
        assert ok, detail
        assert torch.equal(hist_k, hist_r)


# raw bytes that start 2 bytes into a 4-byte word: every tile's words are
# shifted by a sample, with one loose sample at either end
@pytest.mark.parametrize("C", [3, 64])
def test_pfb_kernel_on_bytes_two_into_a_word(cuda_device, C):
    pfb = PolyphaseChannelizer(C)
    n = 2 * C * 96
    buf = torch.zeros(2 * n + 2, dtype=torch.uint8, device=cuda_device)
    buf[2:] = torch.from_numpy(_bank_iq(C * CR, (CR,), n, seed=9)).to(
        cuda_device)
    raw = buf[2:]
    assert raw.data_ptr() % 4 == 2
    hist = torch.zeros((2, pfb.hist_len), device=cuda_device)
    d, h = k6.fused_pfb_demod(raw, hist, pfb._h_np, C)
    want, hw = k6.fused_pfb_demod_ref(raw, hist, pfb._h_np, C)
    ok, detail = _wrapped_ok(want, d)
    assert ok, detail
    assert torch.equal(h, hw)


def test_pfb_kernel_refuses_other_small_factors(cuda_device):
    """C = 4 is compiled in as 2 x 2 (the wrapper's plan): the entry point
    refuses 4 x 1, whose twiddle table the 2 x 2 FFT would read past."""
    from demodulator_tpu_torch.ops.cuda import build
    pfb = PolyphaseChannelizer(4)
    n = 2 * 4 * 16
    raw = torch.zeros(2 * n, dtype=torch.uint8, device=cuda_device)
    hist = torch.zeros((2, pfb.hist_len), device=cuda_device)
    h = torch.from_numpy(pfb._h_np.astype(np.float32)).to(cuda_device)
    table = torch.from_numpy(k6.fft_table(4)).to(cuda_device)
    d = torch.empty((n // 8, 4), device=cuda_device)
    nh = torch.empty_like(hist)
    for C1, C2, ok in ((4, 1, False), (2, 2, True)):
        rc = build.load().fused_pfb_launch(
            raw.data_ptr(), hist.data_ptr(), h.data_ptr(), table.data_ptr(),
            d.data_ptr(), nh.data_ptr(), n, 4, C1, C2, pfb.P, 0,
            torch.cuda.current_stream().cuda_stream)
        assert (rc == 0) == ok, (C1, C2, rc)
    torch.cuda.synchronize()


def test_pfb_kernel_on_block_tpu_kernel_could_not_tile(cuda_device):
    """C = 4, 1500 rows of 128 samples (the bank4 block)."""
    pfb = PolyphaseChannelizer(4)
    raw = torch.from_numpy(_bank_iq(4 * CR, (0.0, CR), 1500 * 128)).to(
        cuda_device)
    hist = torch.zeros((2, pfb.hist_len), device=cuda_device)
    d, h = k6.fused_pfb_demod(raw, hist, pfb._h_np, 4)
    want, hw = k6.fused_pfb_demod_ref(raw, hist, pfb._h_np, 4)
    ok, detail = _wrapped_ok(want, d)
    assert ok, detail
    assert torch.equal(h, hw)


@pytest.mark.parametrize("C", [4, 12, 17, 64])
def test_pfb_kernel_chunked_equals_per_block(cuda_device, C):
    """Each output's arithmetic does not depend on where the blocks are
    cut: one launch over 5 blocks is bit-equal to 5 launches."""
    pfb = PolyphaseChannelizer(C)
    n = 2 * C * 40
    raw = torch.from_numpy(_bank_iq(C * CR, (CR,), 5 * n, seed=3)).to(
        cuda_device)
    hist0 = torch.zeros((2, pfb.hist_len), device=cuda_device)
    whole, hw = k6.fused_pfb_demod(raw, hist0, pfb._h_np, C)
    h, parts = hist0, []
    for b in range(5):
        d, h = k6.fused_pfb_demod(raw[2 * n * b: 2 * n * (b + 1)], h,
                                  pfb._h_np, C)
        parts.append(d)
    assert torch.equal(whole, torch.cat(parts))
    assert torch.equal(hw, h)


def test_pfb_kernel_refuses_too_many_channels(cuda_device):
    C = k6.MAX_CHANNELS + 2
    pfb = PolyphaseChannelizer(C)
    raw = torch.zeros(4 * C, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        k6.fused_pfb_demod(raw, torch.zeros((2, pfb.hist_len),
                                            device=cuda_device), pfb._h_np, C)
    with pytest.raises(ValueError):
        ChannelBankPipeline(ChannelBankConfig(
            sample_rate=C * CR, offsets_hz=(0.0,)), device=cuda_device)


@pytest.mark.parametrize("nch", [8, 64])
def test_bank_pipeline_on_card_matches_cpu(cuda_device, nch):
    offs = tuple((c - nch // 2) * CR for c in range(nch // 2 - 2,
                                                      nch // 2 + 2))
    cfg = ChannelBankConfig(sample_rate=nch * CR, offsets_hz=offs,
                            block_seconds=0.064 / nch)
    gpu = ChannelBankPipeline(cfg, device=cuda_device)
    cpu = ChannelBankPipeline(cfg, device="cpu")
    raw = torch.from_numpy(_bank_iq(cfg.sample_rate, offs,
                                    3 * gpu.block_complex).reshape(
        3, gpu.block_bytes))
    n0 = k6.fused_pfb_demod.launches
    sg, got = gpu.call_u16(gpu.init_state(), raw.to(cuda_device))
    assert k6.fused_pfb_demod.launches == n0 + 1
    sc, want = cpu.call_u16(cpu.init_state(), raw)
    assert got.shape == want.shape == (4, 3 * gpu.audio_per_block)
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for c in range(4):
        assert _snr_db(want[c], got[c]) > 80.0
    assert torch.equal(sg.chan_hist.cpu(), sc.chan_hist)


def test_audio_fir_on_card_is_float32_not_tf32(cuda_device):
    """The bank's audio FIR against float64 numpy within 1e-5: a TF32
    convolution (cuDNN's default on Hopper) would miss by ~1e-3."""
    cfg = ChannelBankConfig(sample_rate=8 * CR, offsets_hz=(0.0,))
    pipe = ChannelBankPipeline(cfg, device=cuda_device)
    taps = np.asarray(pipe.audio.taps, np.float64)
    rng = np.random.default_rng(0)
    x = rng.uniform(-np.pi, np.pi, (3, 5000)).astype(np.float32)
    y, _ = pipe.audio(torch.from_numpy(x).to(cuda_device),
                      pipe.audio.init_hist((3,)))
    want = np.stack([np.convolve(r.astype(np.float64), taps)[:5000]
                     for r in x])
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk_blocks", [1, 3])
def test_bank_stream_processor_on_card(cuda_device, chunk_blocks):
    import io
    offs = (-CR, 0.0, 2 * CR)
    cfg = ChannelBankConfig(sample_rate=8 * CR, offsets_hz=offs,
                            block_seconds=0.005)
    raw = _bank_iq(cfg.sample_rate, offs, 7 * 7680, seed=5).tobytes()
    outs = {}
    for dev in ("cpu", cuda_device):
        files = [io.BytesIO() for _ in offs]
        proc = BankStreamProcessor(cfg, chunk_blocks=chunk_blocks, device=dev)
        assert proc.run(io.BytesIO(raw), files) == 7
        outs[str(dev)] = [np.frombuffer(f.getvalue(), np.float32)
                          for f in files]
    for want, got in zip(outs["cpu"], outs[str(cuda_device)]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
