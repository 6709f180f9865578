"""The CUDA kernels against their plain PyTorch versions, on an NVIDIA GPU.

Every test here needs the card and skips without one: a CUDA kernel has no
CPU mode.  The file imports neither jax nor tests/conftest.py, so it also
runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import functools
import io
import math

import numpy as np
import pytest
import torch

from demodulator_tpu_torch.config import config_from_cli_opts
from demodulator_tpu_torch.models.nbfm import BlockPipeline, PipelineState
from demodulator_tpu_torch.ops.cuda import fused_nbfm as k
from demodulator_tpu_torch.ops.cuda import nbfm_patch as kq
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
# 251 (primes above 16: the direct DFT, C2 = 1); above 256 the three-factor
# route: a large direct last stage (257, 278, 771), a large direct first one
# (323 = 17·1·19), small direct stages (384, 768, 1000), radix stages (512,
# 1024, 2048, 4096); 384, 512, 1024, 2048 and 4096 on the compiled-in plans
@pytest.mark.parametrize("C", [2, 3, 4, 5, 8, 12, 16, 17, 32, 48, 64, 128,
                               251, 256, 257, 278, 323, 384, 512, 768, 771,
                               1000, 1024, 2048, 4096])
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
# where C is a power of two (compiled in for 12 taps), and on the
# three-factor route (512)
@pytest.mark.parametrize("C", [4, 12, 64, 512])
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


@pytest.mark.parametrize("C", [4, 12, 17, 64, 384, 4096])
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


# the compiled-in three-factor plans over pair counts that are and are not
# a multiple of a unit (G = 4 pairs at 384, 2 at 512, 1 at 4096), with one
# CTA, a few and every CTA the card holds; the precise discriminator too
@pytest.mark.parametrize("pairs", [1, 97, 781])
@pytest.mark.parametrize("C", [384, 512, 4096])
def test_pfb_wide_kernel_pair_counts(cuda_device, C, pairs):
    """Two streamed blocks of `pairs` frame pairs of a bank capture: one
    launch a call, the output at the bars against the plain version, the
    history bit-equal."""
    pfb = PolyphaseChannelizer(C)
    n = 2 * C * pairs
    hist_k = torch.zeros((2, pfb.hist_len), device=cuda_device)
    hist_r = hist_k.clone()
    for blk in range(2):
        raw = torch.from_numpy(_bank_iq(C * 6250.0, (0.0, 2 * 6250.0,
                                                     -6250.0), n, seed=blk,
                                        dev=1000.0)).to(cuda_device)
        for precise in ((False, True) if pairs == 97 else (False,)):
            n0 = k6.fused_pfb_demod.launches
            d, h = k6.fused_pfb_demod(raw, hist_k, pfb._h_np, C, precise)
            torch.cuda.synchronize()
            assert k6.fused_pfb_demod.launches == n0 + 1
            want, hw = k6.fused_pfb_demod_ref(raw, hist_r, pfb._h_np, C,
                                              precise)
            ok, detail = _wrapped_ok(want, d)
            assert ok, (precise, detail)
            assert torch.equal(h, hw)
        hist_k, hist_r = h, hw


# input bytes 2 and 8 bytes past a 16-byte boundary: the compiled-in plans'
# threads copy the rows the bulk copies would (8192: the cluster plan's
# runs)
@pytest.mark.parametrize("offset", [2, 8])
@pytest.mark.parametrize("C", [384, 4096, 8192])
def test_pfb_wide_kernel_unaligned_input(cuda_device, C, offset):
    pfb = PolyphaseChannelizer(C)
    n = 2 * C * 37
    buf = torch.zeros(2 * n + 16, dtype=torch.uint8, device=cuda_device)
    buf[offset: offset + 2 * n] = torch.from_numpy(
        _bank_iq(C * 6250.0, (6250.0,), n, seed=offset, dev=1000.0)).to(
        cuda_device)
    raw = buf[offset: offset + 2 * n]
    assert raw.data_ptr() % 16 == offset
    hist = torch.from_numpy(np.random.default_rng(C).standard_normal(
        (2, pfb.hist_len)).astype(np.float32)).to(cuda_device)
    d, h = k6.fused_pfb_demod(raw, hist, pfb._h_np, C)
    want, hw = k6.fused_pfb_demod_ref(raw, hist, pfb._h_np, C)
    ok, detail = _wrapped_ok(want, d)
    assert ok, detail
    assert torch.equal(h, hw)
    aligned, _ = k6.fused_pfb_demod(raw.clone(), hist, pfb._h_np, C)
    assert torch.equal(aligned, d)


# K6's four-step route (C > 4096): 4097 = 17·241 (direct stages in both
# passes), 4800 = 64·75, 8192 = 64·128, 8198 = 4099·2 (pass 2 a direct sum
# from global memory), 16384 = 128·128; 130 frame pairs a block in one
# group (4800, 8192, 16384: the cluster plans, one launch), and in three
# on the two-pass route (the cluster plans emptied, the scratch held to 50
# pairs)
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("C", [4097, 4800, 8192, 8198, 16384])
@pytest.mark.parametrize("data", ["bank", "noise"])
def test_pfb_four_step_matches_ref(cuda_device, monkeypatch, data, C,
                                   groups):
    """Two chained blocks of an on-grid FM bank of 6.25 kHz channels or of
    noise: one launch a call counted on a cluster plan, else two a group,
    the output at the bars against the plain version, the history
    bit-equal."""
    if groups > 1:
        monkeypatch.setattr(k6, "CLUSTER_PLANS", {})
        monkeypatch.setattr(k6, "SCRATCH_BYTES", 32 * C * 50)
    pfb = PolyphaseChannelizer(C)
    n = 2 * C * 130
    rng = np.random.default_rng(C)
    hist_k = torch.zeros((2, pfb.hist_len), device=cuda_device)
    hist_r = hist_k.clone()
    per_call = k6.launches_per_call(C, n)
    assert per_call == (1 if k6.on_cluster(C) else 2 * groups)
    assert k6.on_cluster(C) == (groups == 1 and C in (4800, 8192, 16384))
    for blk in range(2):
        raw = (_bank_iq(C * 6250.0, (0.0, 2 * 6250.0, -6250.0), n, seed=blk,
                        dev=1000.0)
               if data == "bank" else rng.integers(0, 256, 2 * n, np.uint8))
        raw = torch.from_numpy(raw).to(cuda_device)
        n0 = k6.fused_pfb_demod.launches
        d, hist_k = k6.fused_pfb_demod(raw, hist_k, pfb._h_np, C,
                                       precise=blk == 1)
        torch.cuda.synchronize()
        assert k6.fused_pfb_demod.launches == n0 + per_call
        want, hist_r = k6.fused_pfb_demod_ref(raw, hist_r, pfb._h_np, C,
                                              precise=blk == 1)
        ok, detail = _wrapped_ok(want, d)
        assert ok, (blk, detail)
        assert torch.equal(hist_k, hist_r)


def _into_trace(prof):
    """Step a torch.profiler warmed up one step into its recording window,
    then let the window's first device work pass: one small kernel, a
    synchronize and 50 ms.  The trace can lose the device records of its
    first milliseconds of device work (the runtime records of those
    launches kept, the outputs equal to an eager run's: the kernels ran),
    however long after ``prof.step()`` that work starts; on the H100 it
    did, on every trace, late in a long process."""
    import time
    torch.cuda.synchronize()
    time.sleep(0.05)
    prof.step()
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    time.sleep(0.05)


@pytest.mark.parametrize("route", ["two-pass", "cluster"])
@pytest.mark.parametrize("C", [4800, 8192])
def test_pfb_four_step_launches_are_the_kernel_events(cuda_device,
                                                      monkeypatch, C, route):
    """The four-step route's counted launches equal the kernel events
    torch.profiler records, in an eager call and in a CUDA graph's replay
    of it (the cluster launch captured as the eager call launches it); the
    replay's output equal to the eager call's: the cluster kernel, one
    launch a call, and the two-pass route (the cluster plans emptied),
    pfb_pass1_kernel and pfb_pass2_kernel, one each a group, here 3 groups
    (the scratch held to 60 pairs)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    if route == "two-pass":
        monkeypatch.setattr(k6, "CLUSTER_PLANS", {})
        monkeypatch.setattr(k6, "SCRATCH_BYTES", 32 * C * 60)
    pfb = PolyphaseChannelizer(C)
    n = 2 * C * 150
    raw = torch.from_numpy(_bank_iq(C * 6250.0, (6250.0,), n, seed=5,
                                    dev=1000.0)).to(cuda_device)
    hist = torch.zeros((2, pfb.hist_len), device=cuda_device)
    h_dev = torch.from_numpy(pfb._h_np.astype(np.float32)).to(cuda_device)

    def call():
        return k6.fused_pfb_demod(raw, hist, pfb._h_np, C, h_dev=h_dev)
    want, want_h = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = k6.fused_pfb_demod.launches
    with torch.cuda.graph(graph):
        got, got_h = call()
    captured = k6.fused_pfb_demod.launches - n0
    assert captured == k6.launches_per_call(C, n) == (
        1 if route == "cluster" else 6)
    for run in ("eager", "replay"):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            _into_trace(prof)
            n0 = k6.fused_pfb_demod.launches
            if run == "eager":
                call()
                counted = k6.fused_pfb_demod.launches - n0
            else:
                graph.replay()
                counted = captured
            torch.cuda.synchronize()
        events = {name: sum(e.count for e in prof.key_averages()
                            if name in e.key)
                  for name in ("pfb_pass1_kernel", "pfb_pass2_kernel",
                               "pfb_cluster_kernel")}
        assert events["pfb_pass1_kernel"] == events["pfb_pass2_kernel"]
        assert (events["pfb_cluster_kernel"] == 0) == (route == "two-pass")
        assert sum(events.values()) == counted, (run, events, counted)
    assert torch.equal(got, want) and torch.equal(got_h, want_h)


# the cluster plans over pair counts that are and are not a multiple of the
# clusters the card holds (one cluster, a few, every one), a block's last
# pairs in a run of their own
@pytest.mark.parametrize("pairs", [1, 97, 781])
@pytest.mark.parametrize("C", [4800, 8192, 16384])
def test_pfb_cluster_kernel_pair_counts(cuda_device, C, pairs):
    """Two streamed blocks of `pairs` frame pairs of a bank capture: one
    launch a call, the output at the bars against the plain version (< 0.01
    rad, > 80 dB), the history bit-equal."""
    assert k6.on_cluster(C)
    pfb = PolyphaseChannelizer(C)
    n = 2 * C * pairs
    hist_k = torch.zeros((2, pfb.hist_len), device=cuda_device)
    hist_r = hist_k.clone()
    for blk in range(2):
        raw = torch.from_numpy(_bank_iq(C * 6250.0, (0.0, 2 * 6250.0,
                                                     -6250.0), n, seed=blk,
                                        dev=1000.0)).to(cuda_device)
        n0 = k6.fused_pfb_demod.launches
        d, hist_k = k6.fused_pfb_demod(raw, hist_k, pfb._h_np, C)
        torch.cuda.synchronize()
        assert k6.fused_pfb_demod.launches == n0 + 1
        want, hist_r = k6.fused_pfb_demod_ref(raw, hist_r, pfb._h_np, C)
        ok, detail = _wrapped_ok(want, d)
        assert ok, (blk, detail)
        assert torch.equal(hist_k, hist_r)
        del raw, want, d


def test_pfb_kernel_refuses_too_many_channels(cuda_device):
    """No C is refused any more: C = 4098 (the four-step route) runs, at the
    bars, also as a bank on the card; a prototype of more than MAX_PHASES
    taps a branch is refused, naming the limit."""
    C = k6.MAX_CTA_CHANNELS + 2
    pfb = PolyphaseChannelizer(C)
    raw = torch.from_numpy(_bank_iq(C * 6250.0, (6250.0,), 2 * C * 8,
                                    dev=1000.0)).to(cuda_device)
    hist = torch.zeros((2, pfb.hist_len), device=cuda_device)
    d, h = k6.fused_pfb_demod(raw, hist, pfb._h_np, C)
    want, hw = k6.fused_pfb_demod_ref(raw, hist, pfb._h_np, C)
    ok, detail = _wrapped_ok(want, d)
    assert ok, detail
    assert torch.equal(h, hw)
    ChannelBankPipeline(ChannelBankConfig(sample_rate=C * CR,
                                          offsets_hz=(0.0,)),
                        device=cuda_device)
    deep = PolyphaseChannelizer(64, taps_per_phase=k6.MAX_PHASES + 1)
    raw = torch.zeros(4 * 64, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match=f"1..{k6.MAX_PHASES} taps"):
        k6.fused_pfb_demod(raw, torch.zeros((2, deep.hist_len),
                                            device=cuda_device),
                           deep._h_np, 64)


@pytest.mark.parametrize("nch", [8, 64, 384, 512, 1024, 4096, 8192])
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
    assert k6.fused_pfb_demod.launches == n0 + k6.launches_per_call(
        nch, 3 * gpu.block_complex)
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


# -- float64, the continuous profile, checkpoint/resume -----------------------
MODES = {"q0": {}, "q1": {"q": "1"}, "q2": {"q": "2"}, "q3": {"q": "3"},
         "L": {"L": "12500"}, "q2 L": {"q": "2", "L": "12500"}}


def _launch_counts():
    return (k.fused_nbfm.launches, k.fused_nbfm_cplx.launches,
            k.fused_nbfm_q1.launches, kq.patch_cplx1.launches,
            kq.patch_cplx2.launches)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_float64_on_card_matches_cpu(cuda_device, mode, fast):
    """float64 runs the plain chain as torch ops on the card, no kernel:
    > 200 dB against --device cpu (tests/test_precision.py:50)."""
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6",
                                **MODES[mode]})
    cfg.precision = "float64"
    raw = _tone(6)
    cpu = BlockPipeline(cfg, fast_atan2=fast, device="cpu")
    gpu = BlockPipeline(cfg, fast_atan2=fast, device=cuda_device)
    n0 = _launch_counts()
    sg, got = gpu(gpu.init_state(), raw.to(cuda_device))
    assert _launch_counts() == n0
    sc, want = cpu(cpu.init_state(), raw)
    assert got.dtype == want.dtype == torch.float64
    assert _snr_db(want, got) > 200.0
    assert torch.allclose(sg.iq_off.cpu(), sc.iq_off, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("opts, words", [
    ({"b": "-14"}, "shorter than the patch windows"),               # K1
    ({"b": "-14", "q": "1"}, "shorter than the patch windows"),     # K4
    ({"b": "-13", "q": "2", "L": "12500"}, "shorter than the patch"),  # K3
    ({"b": "-6", "d": "130"}, "audio taps exceed"),                 # K1
])
def test_float32_config_kernel_cannot_take_raises_on_card(cuda_device, opts,
                                                          words):
    """Only the configs no kernel computes (float64, demod mode 0) run torch
    ops on the card; a float32 config its kernel cannot take raises on a
    CUDA tensor and launches nothing."""
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", **opts})
    pipe = BlockPipeline(cfg, device=cuda_device)
    assert pipe.kernel_path() != "plain"
    assert words in pipe.fused_ineligible_reason()
    raw = torch.zeros((2, cfg.buf_size), dtype=torch.uint8,
                      device=cuda_device)
    n0 = _launch_counts()
    with pytest.raises(ValueError, match=words):
        pipe(pipe.init_state(), raw)
    with pytest.raises(ValueError, match=words):
        pipe.process_blocks(pipe.init_state(), raw)
    assert _launch_counts() == n0


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_continuous_stream_on_card_matches_cpu(cuda_device, mode, precision):
    """The continuous profile on the card (torch ops, no kernel) against
    --device cpu: > 110 dB in float32, > 200 dB in float64; 7 blocks in
    chunks of 3 and a padded tail."""
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6",
                                **MODES[mode]})
    cfg.profile, cfg.precision = "continuous", precision
    data = _tone(7).numpy().tobytes() + b"\x7f" * 100
    outs = {}
    n0 = _launch_counts()
    for dev in ("cpu", cuda_device):
        out = io.BytesIO()
        proc = StreamProcessor(cfg, chunk_blocks=3, device=dev)
        assert proc.run(io.BytesIO(data), out) == 8
        outs[str(dev)] = torch.from_numpy(
            np.frombuffer(out.getvalue(), cfg.np_dtype()).copy())
    assert _launch_counts() == n0
    bar = 200.0 if precision == "float64" else 110.0
    assert _snr_db(outs["cpu"], outs[str(cuda_device)]) > bar


def _run_stream(cfg, data, dev, **kw) -> bytes:
    out = io.BytesIO()
    StreamProcessor(cfg, chunk_blocks=4, device=dev).run(io.BytesIO(data),
                                                         out, **kw)
    return out.getvalue()


def test_resume_on_card_q0_byte_equal(cuda_device, tmp_path):
    """8 blocks with a checkpoint, then the rest of 11: byte for byte."""
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6"})
    data = _tone(11).numpy().tobytes()
    ck = str(tmp_path / "ck.npz")
    n0 = k.fused_nbfm.launches
    full = _run_stream(cfg, data, cuda_device)
    first = _run_stream(cfg, data[: 8 * BUF], cuda_device,
                        checkpoint_path=ck, checkpoint_every=4)
    rest = _run_stream(cfg, data, cuda_device, checkpoint_path=ck,
                       resume=True)
    assert k.fused_nbfm.launches > n0
    assert first + rest == full and len(full) == 11 * BUF


def test_resume_on_card_q1(cuda_device, tmp_path):
    """K4's look-back composes the block maps in an order that depends on
    timing, so its bytes may differ from run to run: > 110 dB, and the
    saved offset within 1e-3 of the one the uninterrupted run carried."""
    from demodulator_tpu_torch.runtime.checkpoint import load_checkpoint
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6",
                                "q": "1"})
    raw = _tone(11)
    data = raw.numpy().tobytes()
    ck = str(tmp_path / "ck.npz")
    n0 = k.fused_nbfm_q1.launches
    full = _run_stream(cfg, data, cuda_device)
    first = _run_stream(cfg, data[: 8 * BUF], cuda_device,
                        checkpoint_path=ck, checkpoint_every=4)
    pipe = BlockPipeline(cfg, device=cuda_device)
    saved, off, blocks = load_checkpoint(ck, pipe.init_state(), cfg=cfg)
    assert (off, blocks) == (8 * BUF, 8)
    carried, _ = pipe.process_blocks(pipe.init_state(),
                                     raw[:8].to(cuda_device))
    assert float((saved.iq_off - carried.iq_off).abs().max()) < 1e-3
    rest = _run_stream(cfg, data, cuda_device, checkpoint_path=ck,
                       resume=True)
    assert k.fused_nbfm_q1.launches > n0
    f32 = lambda b: torch.from_numpy(np.frombuffer(b, np.float32).copy())  # noqa: E731
    assert len(first + rest) == len(full)
    assert _snr_db(f32(full), f32(first + rest)) > 110.0


@pytest.mark.parametrize("chunk_blocks", [2, 10])
def test_resume_on_card_bank4_byte_equal(cuda_device, tmp_path, chunk_blocks):
    """bank4 (4 channels of 192 kHz at 768 ksps): K6 and the audio FIR
    carry their histories through the checkpoint bit for bit."""
    offs = (-2 * CR, -CR, 0.0, CR)
    cfg = ChannelBankConfig(sample_rate=4 * CR, offsets_hz=offs,
                            block_seconds=0.005)
    probe = ChannelBankPipeline(cfg, device="cpu")
    nblk, first = 3 * chunk_blocks, 2 * chunk_blocks
    raw = _bank_iq(cfg.sample_rate, offs, nblk * probe.block_complex,
                   seed=7).tobytes()
    ck = str(tmp_path / "ck.npz")

    def run(d, **kw):
        files = [io.BytesIO() for _ in offs]
        BankStreamProcessor(cfg, chunk_blocks=chunk_blocks,
                            device=cuda_device).run(io.BytesIO(d), files, **kw)
        return [f.getvalue() for f in files]
    n0 = k6.fused_pfb_demod.launches
    full = run(raw)
    a = run(raw[: first * probe.block_bytes], checkpoint_path=ck)
    b = run(raw, checkpoint_path=ck, resume=True)
    assert k6.fused_pfb_demod.launches > n0
    for c in range(len(offs)):
        assert a[c] + b[c] == full[c]


# -- WBFM, the mixer bank and the general PolyResampler: torch ops and
# torch.matmul on the card (no kernel in either package), held to the CPU
from demodulator_tpu_torch.models.wbfm import (  # noqa: E402
    WbfmConfig, WbfmPipeline)
from demodulator_tpu_torch.ops.resample import (  # noqa: E402
    PolyResampler, design_resampler_taps)
from demodulator_tpu_torch.runtime.stream import (  # noqa: E402
    WbfmStreamProcessor)

WBFM_RATES = {2.4e6: 0.02, 240000.0: 0.1, 2.048e6: 0.05}


def _wbfm_iq(fs, n, seed=0, dev=75000.0):
    """uint8 IQ of a broadcast FM carrier (two tones, 75 µs pre-emphasis
    as its continuous-time 1 + s·τ, phase in closed form), n complex
    samples."""
    t = np.arange(n) / fs
    tau, phase = 75e-6, np.zeros(n)
    for f, a in ((1000.0, 0.6), (3000.0, 0.3)):
        w = 2 * np.pi * f
        phase += a * ((1 - np.cos(w * t)) / w + tau * np.sin(w * t))
    z = 0.9 * np.exp(1j * 2 * np.pi * dev * phase)
    rng = np.random.default_rng(seed)
    z += (rng.normal(0, .01, n) + 1j * rng.normal(0, .01, n))
    iq = np.empty(2 * n)
    iq[0::2], iq[1::2] = z.real, z.imag
    return np.clip(np.round(iq * 127 + 127), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("L, M", [(1, 5), (1, 7), (2, 5), (21, 64)])
def test_poly_resampler_on_card(cuda_device, L, M):
    """The banded product through torch.matmul (full float32, no TF32)
    against the CPU over three blocks of a [2, 2] batch; the history
    equal."""
    taps = design_resampler_taps(L, M, 240000.0, atten_db=80.0)
    cpu, card = PolyResampler(L, M, taps), PolyResampler(L, M, taps,
                                                         device=cuda_device)
    hc, hg = cpu.init_hist((2, 2)), card.init_hist((2, 2))
    rng = np.random.default_rng(M)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((2, 2, M * 77)).astype(
            np.float32))
        yc, hc = cpu(x, hc)
        yg, hg = card(x.to(cuda_device), hg)
        np.testing.assert_allclose(yg.cpu().numpy(), yc.numpy(), rtol=1e-5,
                                   atol=2e-6)
        assert torch.equal(hg.cpu(), hc)


@pytest.mark.parametrize("fs", sorted(WBFM_RATES))
def test_wbfm_on_card_matches_cpu(cuda_device, fs):
    cfg = WbfmConfig(sample_rate=fs, block_seconds=WBFM_RATES[fs])
    cpu = WbfmPipeline(cfg, device="cpu")
    card = WbfmPipeline(cfg, device=cuda_device)
    raw = _wbfm_iq(fs, 3 * cpu.block_complex).reshape(3, -1)
    sc, sg, want, got = cpu.init_state((1,)), card.init_state((1,)), [], []
    for b in range(3):
        u16 = torch.from_numpy(raw[b:b + 1].view(np.uint16).copy())
        sc, a = cpu.call_u16(sc, u16)
        sg, g = card.call_u16(sg, u16.to(cuda_device))
        want.append(a)
        got.append(g)
    assert _snr_db(torch.cat(want, -1), torch.cat(got, -1)) > 110.0


def test_wbfm_stream_on_card_resume_byte_equal(cuda_device, tmp_path):
    cfg = WbfmConfig(block_seconds=0.02)
    bb = WbfmPipeline(cfg, device="cpu").block_bytes
    data = _wbfm_iq(cfg.sample_rate, 6 * bb // 2, seed=3).tobytes()
    ck = str(tmp_path / "ck.npz")

    def run(d, **kw):
        out = io.BytesIO()
        WbfmStreamProcessor(cfg, device=cuda_device).run(
            [io.BytesIO(d)], [out], **kw)
        return out.getvalue()
    full = run(data)
    first = run(data[: 3 * bb], checkpoint_path=ck)
    assert first + run(data, checkpoint_path=ck, resume=True) == full


def test_mixer_on_card_matches_cpu(cuda_device):
    """Off-grid offsets at the bank bars (> 80 dB, 1e-4), the phasor
    within 1e-5, and chunks of 1 and 3 equal byte for byte on the card."""
    offs = (-250000.0, 13000.0, 200000.0)
    cfg = ChannelBankConfig(sample_rate=4 * CR, offsets_hz=offs,
                            block_seconds=0.01)
    cpu = ChannelBankPipeline(cfg, device="cpu")
    card = ChannelBankPipeline(cfg, device=cuda_device)
    assert card.method == "mixer"
    raw = torch.from_numpy(_bank_iq(cfg.sample_rate, offs,
                                    3 * cpu.block_complex).reshape(3, -1))
    sc, want = cpu.call_u16(cpu.init_state(), raw)
    outs, sg = [], card.init_state()
    for b in range(3):
        sg, g = card.call_u16(sg, raw[b:b + 1].to(cuda_device))
        outs.append(g)
    got = torch.cat(outs, -1)
    for c in range(len(offs)):
        assert _snr_db(want[c], got[c]) > 80.0
    assert float((got.cpu() - want).abs().max()) < 1e-4
    assert float((sg.phasor.cpu() - sc.phasor).abs().max()) < 1e-5
    _, batched = card.call_u16(card.init_state(), raw.to(cuda_device))
    assert torch.equal(batched, got)


# -- the parallel layer on the card --------------------------------------
SHARD_MODES = {"q0": ({}, "fused_nbfm"), "q3": ({"q": "3"}, "fused_nbfm"),
               "L": ({"L": "12500"}, "fused_nbfm_cplx"),
               "q2 L": ({"q": "2", "L": "12500"}, "fused_nbfm_cplx"),
               "q1": ({"q": "1"}, "fused_nbfm_q1")}


@pytest.mark.parametrize("mode", sorted(SHARD_MODES))
def test_sharded_step_takes_mode_kernel(cuda_device, mode):
    """ShardedPipeline on a (4, 2) mesh of the one card: each position runs
    its mode's kernel (K4 once per channel of a position); per-block kernels
    give the unsharded card pipeline's bytes, -q 1 > 110 dB and its
    offsets within 1e-3."""
    from demodulator_tpu_torch.parallel.mesh import make_demod_mesh
    from demodulator_tpu_torch.parallel.sharding import ShardedPipeline
    extra, kernel = SHARD_MODES[mode]
    cfg = config_from_cli_opts({"S": "96000", "l": "12500", "b": "-6",
                                **extra})
    raw = _tone(16).reshape(2, 8, BUF).to(cuda_device)
    sp = ShardedPipeline(cfg, make_demod_mesh(4, 2,
                                              devices=[cuda_device] * 8))
    fn = getattr(k, kernel)
    n0 = fn.launches
    off, got = sp(torch.zeros(2, 2), raw)
    assert fn.launches - n0 == 8
    pipe = BlockPipeline(cfg, device=cuda_device)
    if mode != "q1":
        _, want = pipe(pipe.init_state(), raw)
        assert torch.equal(got, want)
        return
    for c in range(2):
        st, want = pipe(pipe.init_state(), raw[c])
        assert _snr_db(want, got[c]) > 110.0
        assert float((off[c] - st.iq_off).abs().max()) < 1e-3


@pytest.mark.parametrize("profile", ["compat", "continuous"])
def test_sharded_stream_on_card_matches_cpu(cuda_device, profile):
    """ShardedStreamProcessor (-q 1) on a (4, 1) mesh of the card against
    the same stream on the CPU: 19 blocks, two chunks and the tail."""
    from demodulator_tpu_torch.parallel.mesh import make_demod_mesh
    from demodulator_tpu_torch.runtime.stream import ShardedStreamProcessor
    cfg = config_from_cli_opts({"S": "96000", "l": "12500", "b": "-6",
                                "q": "1"})
    cfg.profile = profile
    data = _tone(19).numpy().tobytes()
    outs = {}
    for dev in ("cpu", cuda_device):
        out = io.BytesIO()
        ShardedStreamProcessor(cfg, mesh=make_demod_mesh(
            4, 1, devices=[dev] * 4), device=dev).run(io.BytesIO(data), out)
        outs[str(dev)] = torch.from_numpy(np.frombuffer(out.getvalue(),
                                                        np.float32).copy())
    want, got = outs["cpu"], outs[str(cuda_device)]
    assert got.shape == want.shape == (19 * BUF // 4,)
    assert _snr_db(want, got) > 110.0


def test_blocks_per_shard_on_card(cuda_device):
    """ShardedStreamProcessor (q0, K1) on a (2, 1) mesh of the card at 4
    blocks a shard gives the bytes of the default 2 and of the unsharded
    card stream: 19 blocks, two chunks and the tail (one K1 launch a
    position and chunk, one for the tail)."""
    from demodulator_tpu_torch.parallel.mesh import make_demod_mesh
    from demodulator_tpu_torch.runtime.stream import ShardedStreamProcessor
    cfg = config_from_cli_opts({"S": "96000", "l": "12500", "b": "-6"})
    data = _tone(19).numpy().tobytes()
    outs = {}
    for bps, launches in ((2, 4 * 2 + 1), (4, 2 * 2 + 1)):
        out = io.BytesIO()
        n0 = k.fused_nbfm.launches
        ShardedStreamProcessor(cfg, mesh=make_demod_mesh(
            2, 1, devices=[cuda_device] * 2), blocks_per_shard=bps).run(
                io.BytesIO(data), out)
        assert k.fused_nbfm.launches - n0 == launches
        outs[bps] = out.getvalue()
    out = io.BytesIO()
    StreamProcessor(cfg, chunk_blocks=5, device=cuda_device).run(
        io.BytesIO(data), out)
    assert len(outs[4]) == 19 * BUF
    assert outs[4] == outs[2] == out.getvalue()


def test_chan_sharded_pfb_bank_on_card(cuda_device):
    """The PFB bank over a (1, 2) mesh of the card: K6 whole at each
    position, each keeping its channels; equal to the unsharded card
    bank."""
    from demodulator_tpu_torch.parallel.mesh import make_demod_mesh
    offs = (-384000.0, -192000.0, 0.0, 192000.0)
    cfg = ChannelBankConfig(sample_rate=4 * CR, offsets_hz=offs,
                            block_seconds=0.01)
    card = ChannelBankPipeline(cfg, device=cuda_device)
    sharded = card.shard_over(make_demod_mesh(1, 2,
                                              devices=[cuda_device] * 2))
    raw = torch.from_numpy(_bank_iq(cfg.sample_rate, offs,
                                    3 * card.block_complex).reshape(3, -1))
    n0 = k6.fused_pfb_demod.launches
    _, got = sharded.call_u16(card.init_state(), raw.to(cuda_device))
    assert k6.fused_pfb_demod.launches == n0 + 2
    _, want = card.call_u16(card.init_state(), raw.to(cuda_device))
    assert torch.equal(got, want)


def test_dryrun_multichip_on_card(cuda_device):
    from demodulator_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, cuda_device)


@pytest.mark.parametrize("sharded", [False, True], ids=["unsharded", "4x1"])
def test_q1_with_input_lowpass_on_card_matches_cpu(cuda_device, sharded):
    """-q 1 -L has no kernel (K4 has no complex stage; kernel_path "plain",
    as JAX's gates): on the card it runs the plain chain as torch ops, no
    launch, > 110 dB against the CPU and its offsets within 1e-3;
    unsharded and on a (4, 1) mesh of the card."""
    from demodulator_tpu_torch.parallel.mesh import make_demod_mesh
    from demodulator_tpu_torch.parallel.sharding import ShardedPipeline
    cfg = config_from_cli_opts({"S": "96000", "l": "12500", "b": "-6",
                                "q": "1", "L": "12500"})
    raw = _tone(8)
    off0 = torch.tensor([[120.5, 126.25]])
    outs = {}
    for dev in ("cpu", cuda_device):
        n0 = _launch_counts()
        if sharded:
            sp = ShardedPipeline(cfg, make_demod_mesh(
                4, 1, devices=[torch.device(dev)] * 4))
            off, audio = sp(off0, raw[None].to(dev))
        else:
            pipe = BlockPipeline(cfg, device=dev)
            assert pipe.kernel_path() == "plain"
            st, audio = pipe(PipelineState(iq_off=off0[0].to(dev)),
                             raw.to(dev))
            off = st.iq_off
        assert _launch_counts() == n0
        outs[str(dev)] = (off.cpu().reshape(-1), audio.cpu().reshape(-1))
    (off_c, want), (off_g, got) = outs["cpu"], outs[str(cuda_device)]
    assert got.shape == want.shape == (8 * BUF // 4,)
    assert _snr_db(want, got) > 110.0
    assert float((off_g - off_c).abs().max()) < 1e-3


def _cli_env(**extra):
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return {**os.environ, "PYTHONPATH": repo,
            "DEMODULATOR_TPU_TORCH_PHASES": "1", **extra}


def _phases_of(err: str) -> dict:
    import json
    lines = [ln for ln in err.splitlines() if ln.startswith("PHASES ")]
    assert len(lines) == 1, err[-3000:]
    return json.loads(lines[0][len("PHASES "):])


@pytest.mark.parametrize("q", ["0", "1"])
def test_nccl_ranks_on_four_cards(cuda_device, tmp_path, q):
    """Four cards: --shard-time 4 --distributed as 4 ranks with a card each
    (the exchange on NCCL), and --shard-time 4 in one process over the 4
    cards, captured (a graph a position) and eager, against --shard-time
    1 on one card: q0 byte-equal, -q 1 > 110 dB.  Every rank is killed
    when one outlives 300 s."""
    _four_cards(tmp_path, q, [], "fused_nbfm_q1" if q == "1"
                else "fused_nbfm")


@pytest.mark.parametrize("q", ["0", "1"])
def test_nccl_ranks_on_four_cards_continuous(cuda_device, tmp_path, q):
    """As test_nccl_ranks_on_four_cards in the continuous profile: each
    position's segments captured on its card, the halos (and -q 1's
    summaries) exchanged between them, across cards in one process and
    on NCCL between 4 ranks; no kernel launched."""
    _four_cards(tmp_path, q, ["--profile", "continuous"], None)


def _four_cards(tmp_path, q, extra, kernel):
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    (tmp_path / "in.iq").write_bytes(_tone(19).numpy().tobytes())
    args = [sys.executable, "-m", "demodulator_tpu_torch", "-i", "in.iq",
            "-S", "192000", "-l", "12500", "-b", "-6", "-q", q, *extra]

    def launched(ph):
        counts = [v for key, v in ph.items() if key.endswith("_launches")]
        return (ph[kernel + "_launches"] > 0 if kernel
                else not any(counts))

    def run(extra, **env):
        r = subprocess.run(args + extra, cwd=tmp_path, env=_cli_env(**env),
                           capture_output=True, text=True, timeout=300,
                           stdin=subprocess.DEVNULL)
        assert r.returncode == 0, r.stderr[-3000:]
        return _phases_of(r.stderr)

    ph = run(["-o", "one.raw", "--shard-time", "1"], CUDA_VISIBLE_DEVICES="0")
    assert launched(ph)
    ph = run(["-o", "four.raw", "--shard-time", "4"])
    assert (ph["shards"], ph["backend"], ph["graph"]) == (4, None, True)
    assert launched(ph)
    ph = run(["-o", "four_eager.raw", "--shard-time", "4"],
             DEMODULATOR_TPU_TORCH_GRAPHS="0")
    assert (ph["shards"], ph["graph"]) == (4, False)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        args + ["-o", "ranks.raw", "--shard-time", "4", "--distributed"],
        cwd=tmp_path, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_cli_env(
            CUDA_VISIBLE_DEVICES=str(r),
            DEMODULATOR_TPU_COORDINATOR=f"localhost:{port}",
            DEMODULATOR_TPU_NUM_PROCESSES="4",
            DEMODULATOR_TPU_PROCESS_ID=str(r))) for r in range(4)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            errs.append(err)
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    ph = _phases_of(errs[0])
    assert (ph["shards"], ph["backend"], ph["graph"]) == (4, "nccl", True)
    assert all(launched(_phases_of(e)) for e in errs)
    one = (tmp_path / "one.raw").read_bytes()
    assert len(one) == 19 * BUF
    for name in ("four.raw", "four_eager.raw", "ranks.raw"):
        got = (tmp_path / name).read_bytes()
        if q == "0":
            assert got == one, name
        else:
            assert _snr_db(torch.frombuffer(bytearray(one), dtype=torch.float32),
                           torch.frombuffer(bytearray(got),
                                            dtype=torch.float32)) > 110.0


# -- the warm start: chunk steps replayed as CUDA graphs (runtime/graphs.py)
from demodulator_tpu_torch import cli  # noqa: E402
from demodulator_tpu_torch.runtime.graphs import CapturedStep  # noqa: E402

NBFM_ARGS = ["-S", "192000", "-l", "12500", "-b", "-6", "--chunk-blocks",
             "4"]
# every mode whose full chunks replay a graph: name -> (CLI options,
# the kernel whose launches it counts, or None)
GRAPH_MODES = {
    "q0": (NBFM_ARGS, "fused_nbfm"),
    "fast": (NBFM_ARGS + ["--fast-atan2"], "fused_nbfm"),
    "-L": (NBFM_ARGS + ["-L", "12500"], "fused_nbfm_cplx"),
    "-q 2": (NBFM_ARGS + ["-q", "2"], "fused_nbfm_cplx"),
    "-q 2 -L": (NBFM_ARGS + ["-q", "2", "-L", "12500"], "fused_nbfm_cplx"),
    "-q 1": (NBFM_ARGS + ["-q", "1"], "fused_nbfm_q1"),
    "-q 1 -L": (NBFM_ARGS + ["-q", "1", "-L", "12500"], None),
    "float64": (NBFM_ARGS + ["--precision", "float64"], None),
    "continuous": (NBFM_ARGS + ["--profile", "continuous"], None),
    "continuous -q 1": (NBFM_ARGS + ["--profile", "continuous", "-q", "1"],
                        None),
    "bank64": (["--bank", ",".join(str((c - 32) * 192000) for c in range(64)),
                "--iq-rate", "12288000", "--block-seconds", "0.005",
                "--chunk-blocks", "2"], "fused_pfb"),
    "bank4": (["--bank", "-384000,-192000,0,192000", "--iq-rate", "768000",
               "--block-seconds", "0.01", "--chunk-blocks", "2"],
              "fused_pfb"),
    "mixer8": (["--bank", ",".join(str((c - 3.5) * 192000) for c in range(8)),
                "--iq-rate", "1536000", "--block-seconds", "0.01",
                "--chunk-blocks", "2"], None),
    "wbfm": (["--wbfm", "--block-seconds", "0.02"], None),
    "--inputs": (["--wbfm", "--inputs", "a.iq,b.iq", "--block-seconds",
                  "0.02"], None),
}


def _graph_inputs(tmp_path, mode):
    """Write the mode's input files (whole chunks, a tail chunk and a
    partial block where the mode has them) → (its -i/-o options, the names
    of its outputs)."""
    if mode in ("wbfm", "--inputs"):
        for i, name in enumerate(("a.iq", "b.iq")):
            (tmp_path / name).write_bytes(_wbfm_iq(
                2.4e6, 5 * 48000 + 77, seed=i).tobytes())
        if mode == "wbfm":
            return ["-i", "a.iq", "-o", "a.raw"], ["a.raw"]
        return ["-o", "a"], ["a.st0.raw", "a.st1.raw"]
    if mode.startswith(("bank", "mixer")):
        args = GRAPH_MODES[mode][0]
        offs = [float(v) for v in args[1].split(",")]
        fs = float(args[3])
        n = 5 * int(fs * float(args[5])) + 333
        (tmp_path / "a.iq").write_bytes(_bank_iq(fs, offs, n,
                                                 seed=3).tobytes())
        return (["-i", "a.iq", "-o", "a"],
                [f"a.ch{c}.raw" for c in range(len(offs))])
    (tmp_path / "a.iq").write_bytes(_tone(11).numpy().tobytes() + b"\x7f"
                                    * 100)
    return ["-i", "a.iq", "-o", "a.raw"], ["a.raw"]


def _cli_phases(capsys, argv) -> dict:
    """cli.main in this process with every launch count at 0 → PHASES."""
    import json
    from demodulator_tpu_torch.runtime.graphs import _counters
    for fn in _counters():
        fn.launches = 0
    capsys.readouterr()
    assert cli.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("PHASES ")]
    assert len(lines) == 1
    return json.loads(lines[0][len("PHASES "):])


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_cli_graph_replays_equal_eager(cuda_device, tmp_path, monkeypatch,
                                       capsys, mode):
    """The CLI with its full chunks replayed as a CUDA graph against the
    same run under DEMODULATOR_TPU_TORCH_GRAPHS=0: byte for byte, with the
    same launch counts (a replay adds what its capture launched; the
    warm-up and the capture count none).  -q 1: K4's look-back composes
    the block maps in an order that depends on timing, so its bytes may
    differ from run to run: > 110 dB there."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DEMODULATOR_TPU_TORCH_PHASES", "1")
    io_args, outs = _graph_inputs(tmp_path, mode)
    args, kernel = GRAPH_MODES[mode]
    got = {}
    for graphs in ("1", "0"):
        monkeypatch.setenv("DEMODULATOR_TPU_TORCH_GRAPHS", graphs)
        ph = _cli_phases(capsys, [*io_args, *args])
        assert ph["graph"] is (graphs == "1"), ph
        assert (ph["graph_s"] is None) == (graphs == "0"), ph
        counts = {key: v for key, v in ph.items()
                  if key.endswith("_launches")}
        if kernel is None:
            assert not any(counts.values()), counts
        else:
            assert counts[kernel + "_launches"] > 0, counts
        got[graphs] = (counts, [(tmp_path / o).read_bytes() for o in outs])
    assert got["1"][0] == got["0"][0]
    for a, b in zip(got["1"][1], got["0"][1]):
        assert len(a) == len(b) > 0
        if mode == "-q 1":
            f32 = lambda v: torch.frombuffer(bytearray(v),  # noqa: E731
                                             dtype=torch.float32)
            assert _snr_db(f32(b), f32(a)) > 110.0
        else:
            assert a == b


# grids above 256 channels through the CLI on the card (K6's three-factor
# route): 6.25 kHz channels of 2.4, 3.2, 6.4 and 25.6 Msps
@pytest.mark.parametrize("C", [384, 512, 1024, 4096])
def test_cli_bank_wide_grid_on_card_matches_cpu(cuda_device, tmp_path,
                                                monkeypatch, capsys, C):
    """--bank on C grid channels of 6.25 kHz, 3 blocks of 0.004 s, one a
    call: one fused_pfb launch a block, and every channel file within 1e-4
    and > 80 dB of the same run with --device cpu."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DEMODULATOR_TPU_TORCH_PHASES", "1")
    cr = 6250.0
    offs = (-cr, 0.0, 3 * cr)
    fs = C * cr
    block = int(0.004 * fs) // (2 * C) * (2 * C)
    (tmp_path / "w.iq").write_bytes(_bank_iq(fs, offs, 3 * block, seed=C,
                                             tone=300.0, dev=1000.0).tobytes())
    args = ["-i", "w.iq", "-l", "2500", "--bank",
            ",".join(f"{o:.0f}" for o in offs), "--iq-rate", f"{fs:.0f}",
            "--channel-rate", "6250", "--block-seconds", "0.004",
            "--chunk-blocks", "1"]
    ph = _cli_phases(capsys, [*args, "-o", "card"])
    assert ph["fused_pfb_launches"] == ph["blocks"] == 3, ph
    _cli_phases(capsys, [*args, "-o", "cpu", "--device", "cpu"])
    for c in range(len(offs)):
        got = np.fromfile(tmp_path / f"card.ch{c}.raw", np.float32)
        want = np.fromfile(tmp_path / f"cpu.ch{c}.raw", np.float32)
        assert len(got) == len(want) == 3 * block // (2 * C)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert _snr_db(torch.from_numpy(want), torch.from_numpy(got)) > 80.0


def test_graph_tail_chunk_runs_eagerly(cuda_device):
    """11 blocks at 4 a chunk: two replays, then the 3-block tail through
    the plain step; the output equal to the eager processor's."""
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6"})
    data = _tone(11).numpy().tobytes()
    proc = StreamProcessor(cfg, chunk_blocks=4, device=cuda_device)
    assert proc.graph is True and proc.graph_s > 0
    replays = []
    graph = proc.step.graph
    orig = graph.replay
    graph.replay = lambda: (replays.append(1), orig())
    n0 = k.fused_nbfm.launches
    out = io.BytesIO()
    assert proc.run(io.BytesIO(data), out) == 11
    assert len(replays) == 2 and k.fused_nbfm.launches - n0 == 3
    eager = io.BytesIO()
    step = proc.step
    step.graph = None
    proc.run(io.BytesIO(data), eager)
    step.graph = graph
    assert out.getvalue() == eager.getvalue()


@pytest.mark.parametrize("mode", ["q0", "-q 1", "bank4"])
def test_graph_launch_counts_are_the_kernel_events(cuda_device, mode):
    """Under a graph a launch count is what each replay adds in Python
    (the capture's count): over a run, with its eager tail chunk, the
    counts equal the kernel events torch.profiler records on the card."""
    import re
    from torch.profiler import ProfilerActivity, profile, schedule
    make, data, _ = _stream_modes()[mode]
    proc = make(cuda_device)
    assert proc.graph is True
    wrappers = {"fused_nbfm_kernel": k.fused_nbfm,
                "q1_kernel": k.fused_nbfm_q1, "pfb_kernel": k6.fused_pfb_demod}
    n0 = {sym: fn.launches for sym, fn in wrappers.items()}
    # the window opened past the device records a trace can lose
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        _into_trace(prof)
        _run_proc(proc, io.BytesIO(data))
        torch.cuda.synchronize()
    events = {sym: sum(e.count for e in prof.key_averages() if re.search(
        rf"(?<![A-Za-z_]){sym}(?![A-Za-z_])", e.key)) for sym in wrappers}
    counted = {sym: fn.launches - n0[sym] for sym, fn in wrappers.items()}
    assert events == counted and sum(counted.values()) > 0, (events,
                                                             counted)


def test_q1_two_replays_equal_eager_twice(cuda_device):
    """K4's sync words are filled inside the graph, so every replay re-arms
    them: two replays on one chunk, the second from the first's state,
    against two eager calls (> 110 dB, offsets within 1e-3; K4's look-back
    order depends on timing)."""
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6",
                                "q": "1"})
    pipe = BlockPipeline(cfg, device=cuda_device)
    raw = _tone(4).to(cuda_device)
    step = CapturedStep(pipe, pipe.init_state(), tuple(raw.shape),
                        cuda_device, "q1")
    assert step.graph is not None
    n0 = k.fused_nbfm_q1.launches
    s1, a1 = step(pipe.init_state(), raw)
    a1 = a1.clone()
    s2, a2 = step(s1, raw)
    assert k.fused_nbfm_q1.launches - n0 == 2
    e1s, e1 = pipe(pipe.init_state(), raw)
    e2s, e2 = pipe(e1s, raw)
    assert _snr_db(e1, a1) > 110.0 and _snr_db(e2, a2) > 110.0
    assert float((s2.iq_off - e2s.iq_off).abs().max()) < 1e-3


def _stream_modes():
    """name -> (processor factory on the card, input bytes, blocks)."""
    q0 = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6"})
    q1 = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6",
                               "q": "1"})
    offs = (-2 * CR, -CR, 0.0, CR)
    bcfg = ChannelBankConfig(sample_rate=4 * CR, offsets_hz=offs,
                             block_seconds=0.005)
    wcfg = WbfmConfig(block_seconds=0.02)
    return {
        "q0": (lambda d: StreamProcessor(q0, chunk_blocks=2, device=d),
               _tone(11).numpy().tobytes(), 11),
        "-q 1": (lambda d: StreamProcessor(q1, chunk_blocks=2, device=d),
                 _tone(11).numpy().tobytes(), 11),
        "bank4": (lambda d: BankStreamProcessor(bcfg, chunk_blocks=2,
                                                device=d),
                  _bank_iq(bcfg.sample_rate, offs, 9 * 3840,
                           seed=7).tobytes(), 9),
        "wbfm": (lambda d: WbfmStreamProcessor(wcfg, device=d),
                 _wbfm_iq(wcfg.sample_rate, 6 * 48000, seed=3).tobytes(), 6),
    }


def _run_proc(proc, fin, **kw) -> bytes:
    """``proc.run`` on one input → its output bytes, a bank's channels one
    after another."""
    if isinstance(proc, StreamProcessor):
        out = io.BytesIO()
        proc.run(fin, out, **kw)
        return out.getvalue()
    if isinstance(proc, BankStreamProcessor):
        outs = [io.BytesIO() for _ in proc.pipe.cfg.offsets_hz]
        proc.run(fin, outs, **kw)
    else:
        outs = [io.BytesIO()]
        proc.run([fin], outs, **kw)
    return b"".join(o.getvalue() for o in outs)


@pytest.mark.parametrize("mode", ["q0", "-q 1", "bank4", "wbfm"])
def test_graph_mid_stream_checkpoint_resumes(cuda_device, tmp_path,
                                             monkeypatch, mode):
    """A checkpoint saved between replays holds the state after its
    blocks (the snapshot is stream-ordered before the next replay): the
    run resumed from it, its state copied into the graph's static state
    before the first replay, joined to the uninterrupted run's output up
    to there, is that output, byte for byte (-q 1: > 110 dB)."""
    import shutil
    from demodulator_tpu_torch.runtime import stream as stream_mod
    make, data, nblk = _stream_modes()[mode]
    ck = str(tmp_path / "ck.npz")
    saved = []
    orig = stream_mod.save_checkpoint

    def keep(path, state, **kw):
        orig(path, state, **kw)
        shutil.copy(path, f"{path}.at{kw['blocks']}")
        saved.append(kw["blocks"])
    monkeypatch.setattr(stream_mod, "save_checkpoint", keep)
    proc = make(cuda_device)
    assert proc.graph is True
    full = _run_proc(proc, io.BytesIO(data), checkpoint_path=ck,
                     checkpoint_every=2)
    at = [b for b in saved if 0 < b < nblk][len(saved) // 2 - 1]
    shutil.copy(f"{ck}.at{at}", ck)
    monkeypatch.setattr(stream_mod, "save_checkpoint", orig)
    resumed = make(cuda_device)
    rest = _run_proc(resumed, io.BytesIO(data), checkpoint_path=ck,
                     resume=True)
    per_block = len(full) // nblk
    if isinstance(proc, BankStreamProcessor):
        n = len(proc.pipe.cfg.offsets_hz)
        fa = np.frombuffer(full, np.float32).reshape(n, nblk, -1)
        ra = np.frombuffer(rest, np.float32).reshape(n, nblk - at, -1)
        assert np.array_equal(fa[:, at:], ra)
        return
    assert len(rest) == (nblk - at) * per_block
    if mode == "-q 1":
        f32 = lambda v: torch.frombuffer(bytearray(v),  # noqa: E731
                                         dtype=torch.float32)
        assert _snr_db(f32(full[at * per_block:]), f32(rest)) > 110.0
    else:
        assert full[at * per_block:] == rest


@pytest.mark.parametrize("C", [4, 8])
def test_validate_pfb_hw_on_card(cuda_device, C):
    """The port's validate_pfb_hw on K6 at its block shape: chip_smoke.py
    phase 3's bars (< 0.01 rad angle-wrapped, > 80 dB, the history bit
    for bit), and both times measured."""
    from demodulator_tpu_torch.tools import validate_pfb_hw
    n0 = k6.fused_pfb_demod.launches
    line = validate_pfb_hw.validate(C, cuda_device)
    assert k6.fused_pfb_demod.launches > n0
    assert line["check"] == "kernel against the plain version"
    assert line["max_dphi_rad"] < 0.01 and line["history_equal"]
    assert line["snr_db"] is None or line["snr_db"] > 80.0
    assert line["within_bars"]
    assert line["kernel_us_per_block"] > 0 and line["plain_us_per_block"] > 0


def test_bench_scaling_on_card(cuda_device, capsys):
    """The port's bench_scaling on the visible cards: one line per device
    count (1, 2, 4, ... and the count itself), labelled with the card,
    every --e2e --diagnose field measured."""
    import json
    from demodulator_tpu_torch.tools import bench_scaling
    assert bench_scaling.main(["--blocks-per-device", "2", "--repeats", "1",
                               "--e2e", "--diagnose", "--e2e-chunks",
                               "2"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln]
    n = torch.cuda.device_count()
    want = [1 << i for i in range(n.bit_length())]
    want += [n] if want[-1] != n else []
    assert [ln["devices"] for ln in lines] == want
    assert lines[0]["efficiency"] == 1.0
    for ln in lines:
        assert ln["backend"] == "cuda"
        assert ln["device_name"] == torch.cuda.get_device_name(0)
        assert all(ln[key] > 0 for key in (
            "msps", "msps_same_work_1dev", "step_fixed_ms", "msps_e2e"))


@pytest.mark.parametrize("name, B, kernels", [
    ("nbfm_q0_fused_fast", 16, ("fused_nbfm",)),
    ("hbm_memcpy_floor", 256, ("dma_floor",))])
def test_bench_row_on_card(cuda_device, name, B, kernels):
    """A row of the port's bench (python -m demodulator_tpu_torch.bench) at
    its loop lengths: its kernel held to its plain version, one launch a
    step of its kernel (with its head rows), a replayed CUDA graph, and
    a time no shorter than the card's bound allows (achieved_frac <=
    1.05)."""
    from demodulator_tpu_torch import bench
    sz = bench.FULL._replace(B=B, reps=2)
    info = {"device": torch.cuda.get_device_name(0), "device_count": 1,
            "power_limit": None}
    row = bench.measure(name, dict(bench.MATRIX)[name], cuda_device, sz,
                        info, sz.lengths)
    assert row["correct"] and row["value"] > 0
    assert row["timing"] == "cuda graph"
    assert row["launches"] == {kn: row["steps"] for kn in kernels}
    assert 0 < row["roofline"]["achieved_frac"] <= bench.BAR_FRAC


# -- the captured sharded steps (ShardedPipeline.capture, ChanSharded.capture)
from demodulator_tpu_torch.parallel.mesh import make_demod_mesh  # noqa: E402

SHARD_GRAPH_MODES = {"q0": {}, "q3": {"q": "3"}, "L": {"L": "12500"},
                     "q2": {"q": "2"}, "q2 L": {"q": "2", "L": "12500"},
                     "q1": {"q": "1"}, "q1 L": {"q": "1", "L": "12500"},
                     "float64": {}}


def _graphs_and_eager(monkeypatch, make, run):
    """{"graph": ..., "eager": ...}: ``run(make())`` with the processor
    built under DEMODULATOR_TPU_TORCH_GRAPHS 1 and 0, each with its
    processor's ``graph`` and the launches its run added."""
    got = {}
    for name, flag in (("graph", "1"), ("eager", "0")):
        monkeypatch.setenv("DEMODULATOR_TPU_TORCH_GRAPHS", flag)
        proc = make()
        assert proc.graph is (flag == "1")
        assert (proc.graph_s is not None) == (flag == "1")
        n0 = _launch_counts() + (k6.fused_pfb_demod.launches,)
        out = run(proc)
        n1 = _launch_counts() + (k6.fused_pfb_demod.launches,)
        got[name] = (out, tuple(b - a for a, b in zip(n0, n1)))
    assert got["graph"][1] == got["eager"][1]
    return got


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)], ids=["1x1", "2x1"])
@pytest.mark.parametrize("mode", sorted(SHARD_GRAPH_MODES))
def test_captured_sharded_stream_equals_eager_on_card(cuda_device,
                                                      monkeypatch, mode,
                                                      shape):
    """ShardedStreamProcessor on one position of the card and on two
    positions of it (each its own capture), 2 blocks a shard, 19 blocks
    (the tail through the single-device pipeline): the replayed stream
    against the eager one (the same launches), byte-equal (-q 1 on K4
    > 110 dB: its look-back order depends on timing), and byte-equal to
    the unsharded card stream where blocks are independent."""
    from demodulator_tpu_torch.runtime.stream import ShardedStreamProcessor
    cfg = config_from_cli_opts({"S": "96000", "l": "12500", "b": "-6",
                                **SHARD_GRAPH_MODES[mode]})
    if mode == "float64":
        cfg.precision = "float64"
    data = _tone(19).numpy().tobytes()
    mesh = make_demod_mesh(*shape, devices=[cuda_device] * shape[0])

    def run(proc):
        out = io.BytesIO()
        assert proc.run(io.BytesIO(data), out) == 19
        return out.getvalue()
    got = _graphs_and_eager(monkeypatch, lambda: ShardedStreamProcessor(
        cfg, mesh=mesh, device=cuda_device), run)
    graph, eager = got["graph"][0], got["eager"][0]
    assert len(graph) == len(eager) == 19 * BUF * (
        2 if mode == "float64" else 1)
    if mode == "q1":
        assert _snr_db(torch.frombuffer(bytearray(eager), dtype=torch.float32),
                       torch.frombuffer(bytearray(graph),
                                        dtype=torch.float32)) > 110.0
        return
    assert graph == eager
    if mode != "q1 L":
        out = io.BytesIO()
        StreamProcessor(cfg, chunk_blocks=5, device=cuda_device).run(
            io.BytesIO(data), out)
        assert graph == out.getvalue()


@pytest.mark.parametrize("kind", ["bank4", "wbfm2st"])
def test_captured_chan_sharded_equals_eager_on_card(cuda_device,
                                                    monkeypatch, tmp_path,
                                                    kind):
    """The chan-sharded bank4 (K6) and a 2-station WBFM bank on a (1, 2)
    mesh of the card, each position its own capture: the replayed stream
    byte-equal to the eager one with the same launches; bank4 byte-equal
    to the unsharded card bank, the stations > 110 dB against it (the
    decimator's torch.matmul takes other shapes)."""
    mesh = make_demod_mesh(1, 2, devices=[cuda_device] * 2)
    if kind == "bank4":
        offs = (-384000.0, -192000.0, 0.0, 192000.0)
        cfg = ChannelBankConfig(sample_rate=4 * CR, offsets_hz=offs,
                                block_seconds=0.01)
        data = _bank_iq(cfg.sample_rate, offs, 7 * int(0.01 * 4 * CR)
                        ).tobytes()

        def make(m):
            return BankStreamProcessor(cfg, chunk_blocks=2,
                                       device=cuda_device, mesh=m)

        def run(proc):
            outs = [io.BytesIO() for _ in offs]
            proc.run(io.BytesIO(data), outs)
            return [o.getvalue() for o in outs]
    else:
        wcfg = WbfmConfig(sample_rate=240000.0, audio_rate=48000.0,
                          block_seconds=0.05)
        rng = np.random.default_rng(2)
        caps = [rng.integers(0, 256, 5 * 24000 + 7, np.uint8).tobytes()
                for _ in range(2)]

        def make(m):
            return WbfmStreamProcessor(wcfg, stations=2, device=cuda_device,
                                       mesh=m)

        def run(proc):
            outs = [io.BytesIO() for _ in caps]
            proc.run([io.BytesIO(c) for c in caps], outs)
            return [o.getvalue() for o in outs]
    got = _graphs_and_eager(monkeypatch, lambda: make(mesh), run)
    graph = got["graph"][0]
    assert all(len(g) > 0 for g in graph) and graph == got["eager"][0]
    if kind == "bank4":
        assert got["graph"][1][-1] > 0      # K6, the last count
    monkeypatch.setenv("DEMODULATOR_TPU_TORCH_GRAPHS", "1")
    alone = run(make(None))
    if kind == "bank4":
        assert graph == alone
        return
    for a, g in zip(alone, graph):
        assert _snr_db(torch.frombuffer(bytearray(a), dtype=torch.float32),
                       torch.frombuffer(bytearray(g),
                                        dtype=torch.float32)) > 110.0


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)], ids=["1x1", "2x1"])
def test_captured_q1_offset_on_card(cuda_device, monkeypatch, shape):
    """-q 1 on K4: the captured sharded step (two halves a position, the
    offset carried in their static state) over three chunks against the
    eager sharded step: audio > 110 dB and the offset after each chunk
    within 1e-3."""
    from demodulator_tpu_torch.parallel.sharding import ShardedPipeline
    cfg = config_from_cli_opts({"S": "96000", "l": "12500", "b": "-6",
                                "q": "1"})
    raw = _tone(24).reshape(3, 1, 8, BUF).to(cuda_device)
    mesh = make_demod_mesh(*shape, devices=[cuda_device] * shape[0])
    monkeypatch.setenv("DEMODULATOR_TPU_TORCH_GRAPHS", "1")
    sp = ShardedPipeline(cfg, mesh)
    step = sp.capture(8 // shape[0])
    assert step.graph is True
    off_g = off_e = torch.tensor([[120.5, 126.25]], device=cuda_device)
    for chunk in raw:
        off_g, a_g = step.step(off_g, step.place(chunk))
        g = sp.gather(a_g).cpu()
        off_e, a_e = sp.step(off_e, sp.place(chunk))
        assert _snr_db(sp.gather(a_e), g) > 110.0
        assert float((off_g - off_e).abs().max()) < 1e-3


# -- the continuous profile's captured steps (StreamProcessor's steady
# chunk, ShardedStep's segments)
CONT_MODES = {"q0": {}, "q3": {"q": "3"}, "L": {"L": "12500"},
              "q2": {"q": "2"}, "q2 L": {"q": "2", "L": "12500"},
              "q1": {"q": "1"}, "q1 L": {"q": "1", "L": "12500"},
              "float64": {}, "float64 q1": {"q": "1"},
              "iq": {"L": "12500"}}


def _cont_cfg(mode):
    cfg = config_from_cli_opts({"S": "96000", "l": "12500", "b": "-6",
                                **CONT_MODES[mode]})
    cfg.profile = "continuous"
    if mode.startswith("float64"):
        cfg.precision = "float64"
    if mode == "iq":
        cfg.mode &= ~0x30               # demod mode 0: the filtered IQ
    return cfg


def _replays(step) -> list:
    """Count the replays of a CapturedStep's graph: the list grows one a
    replay."""
    got, orig = [], step.graph.replay
    step.graph.replay = lambda: (got.append(1), orig())
    return got


@pytest.mark.parametrize("mode", sorted(CONT_MODES))
def test_captured_continuous_stream_equals_eager_on_card(cuda_device,
                                                         monkeypatch, mode):
    """The continuous stream at 4 blocks a chunk over 11 blocks and 100
    bytes (the tail padded to a 12th block): the first chunk eager, the
    two full chunks after it one replay each; byte-equal to the same
    stream under DEMODULATOR_TPU_TORCH_GRAPHS=0, no kernel launched."""
    cfg = _cont_cfg(mode)
    data = _tone(11).numpy().tobytes() + b"\x7f" * 100

    def run(proc):
        out = io.BytesIO()
        assert proc.run(io.BytesIO(data), out) == 12
        return out.getvalue()
    replays = {}

    def make():
        proc = StreamProcessor(cfg, chunk_blocks=4, device=cuda_device)
        if proc.graph:
            replays["n"] = _replays(proc.step)
        return proc
    got = _graphs_and_eager(monkeypatch, make, run)
    assert len(replays["n"]) == 2
    assert not any(got["graph"][1])
    n = BUF if mode == "iq" else BUF // 4
    assert len(got["graph"][0]) == 12 * n * (8 if mode.startswith(
        "float64") else 4)
    assert got["graph"][0] == got["eager"][0]


@pytest.mark.parametrize("nblk", [16, 19])
@pytest.mark.parametrize("shape", [(1, 1), (4, 1)], ids=["1x1", "4x1"])
@pytest.mark.parametrize("mode", ["q0", "L", "q2", "q2 L", "q1", "q1 L",
                                  "float64 q1"])
def test_captured_continuous_sharded_equals_eager_on_card(
        cuda_device, monkeypatch, mode, shape, nblk):
    """ShardedStreamProcessor in the continuous profile on one position
    of the card and on four (each its own captures), 2 blocks a shard:
    16 blocks (the last full chunk held to the end, replayed with
    has_next 0) and 19 (a tail through the single-device pipeline); a
    full chunk one replay per segment per position; the replayed stream
    byte-equal to the eager one."""
    from demodulator_tpu_torch.runtime.stream import ShardedStreamProcessor
    cfg = _cont_cfg(mode)
    data = _tone(nblk).numpy().tobytes()
    mesh = make_demod_mesh(*shape, devices=[cuda_device] * shape[0])
    NB = 2 * shape[0]
    replays = {}

    def make():
        proc = ShardedStreamProcessor(cfg, mesh=mesh, device=cuda_device)
        if proc.graph:
            step = proc.step
            replays["n"] = [_replays(step.calls[p][i])
                            for p, i in step.order()]
        return proc

    def run(proc):
        out = io.BytesIO()
        assert proc.run(io.BytesIO(data), out) == nblk
        return out.getvalue()
    got = _graphs_and_eager(monkeypatch, make, run)
    full = nblk // NB
    assert [len(r) for r in replays["n"]] == [full] * len(replays["n"])
    assert got["graph"][0] == got["eager"][0]


@pytest.mark.parametrize("where", ["single", "1x1", "4x1"])
@pytest.mark.parametrize("mode", ["q0", "q1"])
def test_captured_continuous_checkpoint_resumes_on_card(
        cuda_device, tmp_path, monkeypatch, mode, where):
    """A checkpoint a replayed continuous chunk reported (the state
    entering the block it held back, cloned before the next replay),
    resumed: the run and the resumed run byte-equal to the same two runs
    under DEMODULATOR_TPU_TORCH_GRAPHS=0, and the resumed output joined
    to the run's up to there equal to the whole run's byte for byte; the
    single-device -q 1 stream > 110 dB there (the resumed run folds the
    tracker's offset from the held block on, where the run folded it over
    whole chunks: the same sums in another order)."""
    import shutil
    from demodulator_tpu_torch.runtime import stream as stream_mod
    from demodulator_tpu_torch.runtime.stream import ShardedStreamProcessor
    cfg = _cont_cfg(mode)
    nblk = 19
    data = _tone(nblk).numpy().tobytes()

    def make():
        if where == "single":
            return StreamProcessor(cfg, chunk_blocks=4, device=cuda_device)
        shape = (1, 1) if where == "1x1" else (4, 1)
        return ShardedStreamProcessor(cfg, mesh=make_demod_mesh(
            *shape, devices=[cuda_device] * shape[0]), device=cuda_device)
    # a checkpoint of a replayed chunk: single, 7 (3 + 4); sharded, the
    # first chunk's replay (the resumed run replays the second)
    at = {"single": 7, "1x1": 2, "4x1": 8}[where]
    orig = stream_mod.save_checkpoint
    got = {}
    for flag in ("1", "0"):
        ck = str(tmp_path / f"ck{flag}.npz")
        saved = []

        def keep(path, state, **kw):
            orig(path, state, **kw)
            shutil.copy(path, f"{path}.at{kw['blocks']}")
            saved.append(kw["blocks"])
        monkeypatch.setattr(stream_mod, "save_checkpoint", keep)
        monkeypatch.setenv("DEMODULATOR_TPU_TORCH_GRAPHS", flag)
        proc = make()
        assert proc.graph is (flag == "1")
        full = io.BytesIO()
        proc.run(io.BytesIO(data), full, checkpoint_path=ck,
                 checkpoint_every=2)
        assert at in saved, saved
        shutil.copy(f"{ck}.at{at}", ck)
        monkeypatch.setattr(stream_mod, "save_checkpoint", orig)
        rest = io.BytesIO()
        make().run(io.BytesIO(data), rest, checkpoint_path=ck, resume=True)
        got[flag] = (full.getvalue(), rest.getvalue())
    assert got["1"] == got["0"]
    full, rest = got["1"]
    joined = full[: at * BUF] + rest          # float32 audio: BUF bytes a block
    if mode == "q1" and where == "single":
        f32 = lambda v: torch.frombuffer(bytearray(v),  # noqa: E731
                                         dtype=torch.float32)
        assert len(joined) == len(full)
        assert _snr_db(f32(full), f32(joined)) > 110.0
    else:
        assert joined == full


# -- the NBFM step's float64 patches (P1, P2 in K1's and K4's launch; P3, P4
# after K3, csrc/nbfm_patch.cu) ----------------------------------------------
# config -> CLI options; each runs its kernel path's patch
PATCH_CONFIGS = {
    "default": {}, "-d 10": {"d": "10"}, "chebyshev": {"m": "1", "e": "3"},
    "-L -D 8": {"L": "12500", "D": "8"},
    "-S 192000 -l 6500": {"S": "192000", "l": "6500"},
    # P4 under -q 2 -L needs 50 848 bytes of shared memory: its launch
    # raises the kernel's limit above the default 48 KiB
    "-d 20": {"d": "20"}}
PATCH_MODES = {"q0": {}, "q3": {"q": "3"}, "q1": {"q": "1"},
               "L": {"L": "12500"}, "q2": {"q": "2"},
               "q2 L": {"q": "2", "L": "12500"}}
HEAD_PATHS = ("fused", "q1")     # K1 and K4 compute their head rows
OFF_IN = (127.3, 126.8)          # the -q 1 tracker entering block 0


def _patch_pipe(config, mode, fast, device, buf=16384):
    opts = {"S": "96000", "l": "12500", **PATCH_CONFIGS[config],
            **PATCH_MODES[mode]}
    cfg = config_from_cli_opts(opts)
    cfg.buf_size = buf
    pipe = BlockPipeline(cfg, fast_atan2=fast, device=device)
    return pipe if pipe.kernel_path() != "plain" else None


@functools.cache
def _off_in(device):
    """OFF_IN on ``device``, made once (a graph capture copies nothing)."""
    return torch.tensor(OFF_IN, device=device)


def _with_head(pipe, raw):
    """K1's or K4's wrapper with its head rows (``head=``), as the model
    calls it → (audio, K4's entering offsets or None)."""
    outf, precise = pipe.out_fir, not pipe.fast_atan2
    if pipe.kernel_path() == "fused":
        return k.fused_nbfm(raw, outf.host_taps, pipe.conditioning, precise,
                            head=outf), None
    off = _off_in(raw.device)
    audio, ent, _ = k.fused_nbfm_q1(raw, off, outf.host_taps,
                                    float(pipe.esr), precise, head=outf)
    return audio, ent


def _head_want(pipe, raw, got, ent):
    """What K1's or K4's output with its head rows must equal: the kernel
    alone (K1: a second launch; K4, whose look-back order varies: ``got``
    itself) with P1's or P2's plain version (from ``ent``) over it, and
    K1 alone (None for K4)."""
    outf, cond, precise = pipe.out_fir, pipe.conditioning, not pipe.fast_atan2
    if pipe.kernel_path() == "fused":
        base = k.fused_nbfm(raw, outf.host_taps, cond, precise)
        return kq.patch_fused_ref(raw, base.clone(), outf, cond,
                                  precise), base
    return kq.patch_q1_ref(raw, got.clone(), ent, outf, float(pipe.esr),
                           precise), None


def _patch_call(pipe, raw, audio, offs):
    """P3's or P4's wrapper on (raw, audio)."""
    outf, cond, precise = pipe.out_fir, pipe.conditioning, not pipe.fast_atan2
    if pipe.kernel_path() == "cplx1":
        return kq.patch_cplx1(raw, audio, pipe._cplx_stages()[0], outf,
                              cond, precise)
    return kq.patch_cplx2(raw, audio, pipe.dc_fir, pipe.in_fir, outf, cond,
                          precise)


def _patch_ref(pipe, raw, audio, offs):
    outf, cond, precise = pipe.out_fir, pipe.conditioning, not pipe.fast_atan2
    path = pipe.kernel_path()
    if path == "fused":
        return kq.patch_fused_ref(raw, audio, outf, cond, precise)
    if path == "q1":
        return kq.patch_q1_ref(raw, audio, offs, outf, float(pipe.esr),
                               precise)
    if path == "cplx1":
        return kq.patch_cplx1_ref(raw, audio, pipe._cplx_stages()[0], outf,
                                  cond, precise)
    return kq.patch_cplx2_ref(raw, audio, pipe.dc_fir, pipe.in_fir, outf,
                              cond, precise)


def _ulps(a, b) -> int:
    """The largest distance of two float32 tensors in units in the last
    place (as ordered integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("mode", sorted(PATCH_MODES))
@pytest.mark.parametrize("config", sorted(PATCH_CONFIGS))
def test_patch_kernel_matches_ref(cuda_device, config, mode, fast):
    """Each patch against its plain version on the card, on the tone and on
    noise, at 16 and 2 blocks: equal, or within 2 float32 ULP and > 140 dB
    (a float64 dot summed in cuBLAS's order against the kernel's), writing
    only the rows its plain version writes; one launch a call.  P1 and P2
    as K1 and K4 compute them (``head=``): K1's output equals K1 alone
    with P1's plain version over it; K4's equals its own output with P2's
    plain version over it from its entering offsets (its other rows are
    K4's, > 110 dB from its plain version: its look-back order varies);
    P3 and P4 on a random K3 output."""
    pipe = _patch_pipe(config, mode, fast, cuda_device)
    if pipe is None:
        pytest.skip("no kernel path (-q 1 -L runs the plain chain)")
    n, path = pipe.cfg.buf_size, pipe.kernel_path()
    rng = np.random.default_rng(7)
    counter = {"fused": k.fused_nbfm, "q1": k.fused_nbfm_q1,
               "cplx1": kq.patch_cplx1, "cplx2": kq.patch_cplx2}[path]
    for B in (16, 2):
        for data in ("tone", "noise"):
            raw = (_tone(B, buf=n) if data == "tone" else torch.from_numpy(
                rng.integers(0, 256, (B, n), np.uint8))).to(cuda_device)
            n0 = counter.launches
            if path in HEAD_PATHS:
                got, ent = _with_head(pipe, raw)
                torch.cuda.synchronize()
                assert counter.launches == n0 + 1
                want, base = _head_want(pipe, raw, got, ent)
                if path == "q1":
                    outf = pipe.out_fir
                    plain, _, _ = k.fused_nbfm_q1_ref(
                        raw, _off_in(raw.device),
                        outf.host_taps, float(pipe.esr), not fast)
                    plain = kq.patch_q1_ref(raw, plain, ent, outf,
                                            float(pipe.esr), not fast)
                    assert _snr_db(plain, got) > 110.0, (B, data)
            else:
                base = torch.from_numpy(rng.standard_normal(
                    (B, n // 4)).astype(np.float32)).to(cuda_device)
                got = _patch_call(pipe, raw, base.clone(), None)
                torch.cuda.synchronize()
                assert counter.launches == n0 + 1
                want = _patch_ref(pipe, raw, base.clone(), None)
            if base is not None:
                assert torch.equal(got != base, want != base)
            if not torch.equal(got, want):
                assert _ulps(got, want) <= 2, (B, data)
                assert _snr_db(want, got) > 140.0, (B, data)


@pytest.mark.parametrize("mode", sorted(PATCH_MODES))
def test_fused_call_is_kernel_and_patch(cuda_device, mode):
    """On the card a kernel path's step is one launch of K1 or K4 (its head
    rows in it), or K3 and its patch kernel, one launch each, and no other
    torch op but allocations (K4's flag fill too)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    pipe = _patch_pipe("default", mode, True, cuda_device)
    raw = _tone(16, buf=pipe.cfg.buf_size).to(cuda_device)
    state = pipe.init_state()
    pipe.fused_call(state, raw)     # the per-device constants, once
    n0 = _launch_counts()
    with Ops() as ops:
        pipe.fused_call(state, raw)
    added = [b - a for a, b in zip(n0, _launch_counts())]
    want = 1 if pipe.kernel_path() in HEAD_PATHS else 2
    assert sum(added) == want and max(added) == 1, added
    views = ("view", "reshape", "_reshape_alias", "select", "slice",
             "_unsafe_view", "alias", "detach")
    work = [op for op in ops.ops
            if not op.startswith(("aten.empty", "aten.full"))
            and op.split(".")[-1] not in views]
    assert work == [], work


@pytest.mark.parametrize("mode", ["q0", "q1"])
def test_patch_rejects_what_it_does_not_take(cuda_device, mode):
    """K1's and K4's wrappers with ``head=`` raise on a dtype, contiguity,
    device or block length they do not take, or a head whose buffers are
    not contiguous float64 (float32 taps) on the card, and launch
    nothing."""
    from types import SimpleNamespace
    pipe = _patch_pipe("default", mode, False, cuda_device)
    n, outf = pipe.cfg.buf_size, pipe.out_fir
    raw = _tone(4, buf=n).to(cuda_device)
    counter = k.fused_nbfm if mode == "q0" else k.fused_nbfm_q1
    keys = ("taps", "head", "y_coup", "H", "Wh", "D")

    def head_with(**kw):
        return SimpleNamespace(**{**{a: getattr(outf, a) for a in keys},
                                  **kw})

    def call(r, head):
        if mode == "q0":
            return k.fused_nbfm(r, outf.host_taps, head=head)
        off = torch.tensor(OFF_IN, device=r.device)
        return k.fused_nbfm_q1(r, off, outf.host_taps, float(pipe.esr),
                               head=head)
    n0 = counter.launches
    for bad_raw, head in (
            (raw.float(), outf), (raw[:, ::2], outf),
            (raw.cpu(), outf), (raw[:, :16].contiguous(), outf),
            (raw, head_with(head=outf.head.float())),
            (raw, head_with(head=outf.head.cpu())),
            (raw, head_with(taps=outf.taps.double()))):
        with pytest.raises(ValueError):
            call(bad_raw, head)
    assert counter.launches == n0


@pytest.mark.parametrize("mode", ["q0", "q1"])
def test_head_refused_launch_raises(cuda_device, monkeypatch, mode):
    """A K1 or K4 launch with a head the library refuses (here a window of
    0 words) raises RuntimeError and counts no launch: there is no
    fallback to a launch without the head."""
    pipe = _patch_pipe("default", mode, False, cuda_device)
    real = kq._fir_struct

    def zero_window(outf, pack=None):
        fir = real(outf, pack)
        fir.Wh = 0
        return fir
    monkeypatch.setattr(kq, "_fir_struct", zero_window)
    raw = _tone(4, buf=pipe.cfg.buf_size).to(cuda_device)
    counter = k.fused_nbfm if mode == "q0" else k.fused_nbfm_q1
    n0 = counter.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _with_head(pipe, raw)
    torch.cuda.synchronize()
    assert counter.launches == n0


# -- P3 and P4 as the model launches them: programmatic dependents of K3 ----
def _graph_of(fn):
    """``fn()`` captured as a CUDA graph after one warm-up on a side
    stream → (graph, the captured call's output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("mode", ["L", "q2", "q2 L"])
def test_k3_patch_as_the_model_launches_it(cuda_device, mode, fast):
    """P3 (-L, -q 2) and P4 (-q 2 -L) as the model launches them: K3, then
    the patch with nothing between (``fused_call``; the patch starts as a
    programmatic dependent of K3 and stores only after K3 completes), on
    256 KiB blocks, B = 2, 16 and 256, tone and noise.  Eagerly: equal to
    the plain version on the same K3 output (a second K3 run), or within 2
    float32 ULP and > 140 dB (test_patch_kernel_matches_ref's bar),
    writing only its rows.  Captured as a CUDA graph and replayed 50
    times: every replay equal to the eager step (a store before K3's
    completion would leave K3's row in a patched one, now and then)."""
    pipe = _patch_pipe("default", mode, fast, cuda_device, buf=262144)
    n, outf = pipe.cfg.buf_size, pipe.out_fir
    stages, cond, precise = pipe.stage_consts(), pipe.conditioning, not fast
    ref = (kq.patch_cplx1_ref if pipe.kernel_path() == "cplx1"
           else kq.patch_cplx2_ref)
    state = pipe.init_state()
    tone16 = _tone(16, buf=n).to(cuda_device)
    rng = np.random.default_rng(11)
    for B in (2, 16, 256):
        for data in ("tone", "noise"):
            raw = (tone16.repeat(-(-B // 16), 1)[:B].contiguous()
                   if data == "tone" else torch.from_numpy(rng.integers(
                       0, 256, (B, n), np.uint8)).to(cuda_device))
            got = pipe.fused_call(state, raw)[1]
            base = k.fused_nbfm_cplx(raw, stages, outf.host_taps, cond,
                                     precise)
            want = ref(raw, base.clone(), *pipe._cplx_stages(), outf, cond,
                       precise)
            assert torch.equal(got != base, want != base), (B, data)
            if not torch.equal(got, want):
                assert _ulps(got, want) <= 2, (B, data)
                assert _snr_db(want, got) > 140.0, (B, data)
            graph, out = _graph_of(lambda: pipe.fused_call(state, raw)[1])
            for rep in range(50):
                out.fill_(float("nan"))
                graph.replay()
                assert torch.equal(out, got), (B, data, rep)
            del graph, out


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("mode", ["q0", "q3", "q1"])
def test_head_as_the_model_launches_it(cuda_device, mode, fast):
    """K1 and K4 with their head rows as the model launches them (one
    launch a step) on 256 KiB blocks, B = 2, 16 and 256, tone and noise.
    Eagerly: K1's equal to K1 alone with P1's plain version over it, K4's
    to its own output with P2's plain version over it from its entering
    offsets, or within 2 float32 ULP and > 140 dB
    (test_patch_kernel_matches_ref's bar).  Captured as a CUDA graph and
    replayed 50 times: every replay of K1 equal to the eager step (a head
    row left unwritten, or written by a span too, would show now and
    then); every replay of K4 at that bar against P2's plain version over
    it, and > 110 dB from the eager step (its look-back order varies)."""
    pipe = _patch_pipe("default", mode, fast, cuda_device, buf=262144)
    n = pipe.cfg.buf_size
    tone16 = _tone(16, buf=n).to(cuda_device)
    rng = np.random.default_rng(11)
    for B in (2, 16, 256):
        for data in ("tone", "noise"):
            raw = (tone16.repeat(-(-B // 16), 1)[:B].contiguous()
                   if data == "tone" else torch.from_numpy(rng.integers(
                       0, 256, (B, n), np.uint8)).to(cuda_device))
            got, ent = _with_head(pipe, raw)
            want, base = _head_want(pipe, raw, got, ent)
            if base is not None:
                assert torch.equal(got != base, want != base), (B, data)
            if not torch.equal(got, want):
                assert _ulps(got, want) <= 2, (B, data)
                assert _snr_db(want, got) > 140.0, (B, data)
            graph, (out, out_ent) = _graph_of(lambda: _with_head(pipe, raw))
            for rep in range(50):
                out.fill_(float("nan"))
                graph.replay()
                if ent is None:
                    assert torch.equal(out, got), (B, data, rep)
                    continue
                w, _ = _head_want(pipe, raw, out, out_ent)
                assert torch.equal(out, w) or (
                    _ulps(out, w) <= 2 and _snr_db(w, out) > 140.0), rep
                assert _snr_db(got, out) > 110.0, (B, data, rep)
            del graph, out


def test_k3_patch_refused_launch_raises(cuda_device, monkeypatch):
    """A P3 or P4 launch the library refuses (here constants not laid out
    as one 16-byte-aligned pack) raises RuntimeError and counts no launch:
    there is no fallback to another launch."""
    for mode in ("L", "q2 L"):
        pipe = _patch_pipe("default", mode, False, cuda_device)
        stages, outf = tuple(pipe._cplx_stages()), pipe.out_fir
        good = kq.packed_consts(outf, stages)
        bad = good._replace(offsets={key: off + 8 for key, off
                                     in good.offsets.items()})
        bad = bad._replace(structs=kq._launch_structs(bad, outf, stages))
        monkeypatch.setattr(kq, "packed_consts", lambda *a, **kw: bad)
        n = pipe.cfg.buf_size
        raw = _tone(4, buf=n).to(cuda_device)
        audio = torch.zeros((4, n // 4), device=cuda_device)
        counter = kq.patch_cplx1 if len(stages) == 1 else kq.patch_cplx2
        n0 = counter.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            _patch_call(pipe, raw, audio, None)
        torch.cuda.synchronize()
        assert counter.launches == n0
        monkeypatch.undo()
