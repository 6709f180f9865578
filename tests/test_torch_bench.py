"""The port's benchmark (``python -m demodulator_tpu_torch.bench``) on the
CPU.

Its builders against the root ``bench.py``'s (the JAX package's benchmark)
at 2 blocks: the same complex samples a step, and the same least traffic
but where the JAX bench does not count each input byte read once and
each output byte written once, as the port does; the
flagship step against one iteration of the JAX flagship's body on the
``iq_data`` tone.  The roofline's bounds of K1 and K6 (``tools/roofline.py``)
at the shapes ``PERF.md`` gives them.  A row's checks against a wrong head
patch, a wrong carried offset and a wrong replay.  Then the command at its
rehearsal size (``--device cpu``): the headline line, the matrix file,
``--rows``, failing rows, the exit without a card, and that the module
imports no jax.  Its numbers here are the host's; the card runs it in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodulator_tpu_torch import bench
from demodulator_tpu_torch.models.nbfm import BlockPipeline
from demodulator_tpu_torch.models.wbfm import WbfmConfig, WbfmPipeline
from demodulator_tpu_torch.ops.channelizer import PolyphaseChannelizer
from demodulator_tpu_torch.runtime.graphs import CapturedStep
from demodulator_tpu_torch.tools.roofline import bound, demod_ops, pfb_ops
from tests.conftest import snr_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
B = 2
N = bench.BLOCK
E2E = ["e2e_stream_q0", "e2e_stream_wbfm", "e2e_bank4_pfb"]
ROW_KEYS = ("metric", "value", "unit", "vs_baseline", "correct", "check",
            "lengths", "reps", "seconds", "roofline", "device",
            "device_count", "power_limit")
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "correct",
                 "device", "device_count", "power_limit")


def _jax_bench():
    """The root bench.py as a module (its builders import jax when
    called)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# row -> (the port's builder, the JAX bench's) at the same small size; the
# sharded step at 64 blocks a position on one device (JAX's smallest is
# 1 x 64)
PAIRS = {
    "hbm_memcpy_floor": (lambda: bench.memcpy_floor(CPU, B),
                         lambda jb: jb._memcpy_floor(B=B)),
    "nbfm_q0_fused_precise": (lambda: bench.flagship(CPU, False, 0, B),
                              lambda jb: jb._flagship(False, q=0, B=B)),
    "nbfm_q0_fused_fast": (lambda: bench.flagship(CPU, True, 0, B),
                           lambda jb: jb._flagship(True, q=0, B=B)),
    "nbfm_q3_fused_fast": (lambda: bench.flagship(CPU, True, 3, B),
                           lambda jb: jb._flagship(True, q=3, B=B)),
    "nbfm_q1_correctiq": (lambda: bench.q1(CPU, B),
                          lambda jb: jb._q1(B=B)),
    "nbfm_q2_dcblock_fused": (lambda: bench.inlpf(CPU, 2, False, B),
                              lambda jb: jb._inlpf(q=2, lowpass_in=False,
                                                   B=B)),
    "nbfm_inlpf_fused": (lambda: bench.inlpf(CPU, 0, True, B),
                         lambda jb: jb._inlpf(q=0, lowpass_in=True, B=B)),
    "nbfm_q2_inlpf_fused": (lambda: bench.inlpf(CPU, 2, True, B),
                            lambda jb: jb._inlpf(q=2, lowpass_in=True, B=B)),
    "nbfm_f64": (lambda: bench.f64(CPU, B), lambda jb: jb._f64(B=B)),
    "wbfm_2p4msps": (lambda: bench.wbfm(CPU), lambda jb: jb._wbfm()),
    "channel_bank_8ch": (lambda: bench.bank(CPU, 8, False),
                         lambda jb: jb._bank()),
    "channel_bank_8ch_pfb": (lambda: bench.bank(CPU, 8, True),
                             lambda jb: jb._bank(on_grid=True)),
    "channel_bank_64ch_pfb": (lambda: bench.bank(CPU, 64, True),
                              lambda jb: jb._bank(n_chan=64, on_grid=True)),
    "sharded_step": (lambda: bench.sharded(CPU, 64),
                     lambda jb: jb._sharded(B_per=1)),
}


@pytest.fixture
def jax_bench(monkeypatch):
    """The JAX bench, its mesh one CPU device (the conftest gives JAX
    8)."""
    import demodulator_tpu.parallel.mesh as jmesh
    real = jmesh.make_demod_mesh
    monkeypatch.setattr(jmesh, "make_demod_mesh",
                        lambda: real(devices=jax.devices()[:1]))
    return _jax_bench()


def test_pairs_cover_the_matrix():
    assert sorted(PAIRS) == sorted(n for n, _ in bench.MATRIX)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_builder_counts_match_jax(jax_bench, name):
    port, jax_builder = PAIRS[name]
    row = port()
    _, _, iq, traffic = jax_builder(jax_bench)
    assert row.iq_per_step == iq
    if name == "wbfm_2p4msps":
        # JAX counts the channel filter's quad-rate output (T·L/M float32)
        # as the output; the port the audio it writes
        T = row.iq_per_step
        pipe = WbfmPipeline(WbfmConfig(), device=CPU)
        assert traffic == 2 * T + 4 * (T * pipe.chan.L // pipe.chan.M)
        assert row.traffic == 2 * T + 4 * pipe.audio_per_block
    elif name == "nbfm_q1_correctiq":
        # the input read once (JAX's TPU path counts it twice, 3·B·n; off
        # the TPU it counts 2·B·n)
        assert row.traffic == 2 * B * N
        assert traffic in (2 * B * N, 3 * B * N)
    else:
        assert row.traffic == int(traffic)


def test_flagship_step_matches_jax_body(jax_bench):
    # tests/conftest.py's iq_data tone (its seed), one block of it a row
    tone = bench.tone_blocks(B, N, 42)
    body, raw, _, _ = jax_bench._flagship(True, q=0, B=B)
    x = jnp.asarray(tone.view(np.uint32).reshape(raw.shape)
                    if raw.dtype == jnp.uint32 else tone)
    want = np.asarray(body(0, x)).view(np.float32).reshape(B, N // 4)
    row = bench.flagship(CPU, True, 0, B)
    _, got = row.step(row.state, torch.from_numpy(tone), 0)
    assert snr_db(want, got.numpy()) > 110.0


@pytest.mark.parametrize("blocks, us", [(16, 2.50), (256, 40.06)])
def test_k1_bound(blocks, us):
    """K1 (precise, the flagship's audio taps) on ``blocks`` blocks: bytes
    bound, at PERF.md's 2.50 / 40.06 us."""
    pipe = BlockPipeline(bench._nbfm_cfg(), device=CPU)
    ntaps = len(pipe.out_fir.host_taps)
    ms, by = bound(2 * blocks * N, demod_ops(True, ntaps) * blocks * N / 4)
    assert by == "bytes" and round(ms * 1e3, 2) == us


def test_k6_bound():
    """K6 at C = 64 on one 0.25 s block (3 072 000 complex samples): bytes
    in, the discriminator's n/2 float32 out, the history read and written;
    operation-bound at PERF.md's 4.20 us."""
    C = 64
    P = PolyphaseChannelizer(C).P
    n = int(0.25 * C * 192000.0)
    ms, by = bound(2 * n + 4 * (n // 2) + 2 * 4 * (2 * P * C),
                   pfb_ops(n, C, P))
    assert by == "operations" and round(ms * 1e3, 2) == 4.20


class _WrongReplay(CapturedStep):
    """A capture whose replay's output is off by one."""

    def __call__(self, state, raw):
        state, out = super().__call__(state, raw)
        return state, out + 1


@pytest.mark.parametrize("fault", ["head patch", "carried offset", "replay"])
def test_row_checks_catch_a_wrong_step(monkeypatch, fault):
    """The kernel held to its plain version is right in each case; the
    row's other checks catch what is wrong around it."""
    real = BlockPipeline.fused_call
    if fault == "head patch":
        def wrong(self, state, raw):
            state, audio = real(self, state, raw)
            audio[..., :8] += 1.0
            return state, audio
        monkeypatch.setattr(BlockPipeline, "fused_call", wrong)
    elif fault == "carried offset":
        def wrong(self, state, raw):
            state, audio = real(self, state, raw)
            return state._replace(iq_off=state.iq_off + 0.01), audio
        monkeypatch.setattr(BlockPipeline, "fused_call", wrong)
    else:
        monkeypatch.setattr(bench, "CapturedStep", _WrongReplay)
    name = "nbfm_q1_correctiq" if fault == "carried offset" \
        else "nbfm_q0_fused_fast"
    row = bench.measure(name, dict(bench.MATRIX)[name], CPU,
                        bench.REHEARSAL, {}, (1, 2))
    check = row["check"]
    assert check["kernel"]["correct"] and row["correct"] is False
    assert check["replay" if fault == "replay" else "step"]["correct"] \
        is False


def _main(argv, capsys):
    rc = bench.main(argv)
    out = capsys.readouterr().out
    return rc, [json.loads(ln) for ln in out.splitlines() if ln]


def _rows(path) -> dict:
    return {r["metric"]: r for r in json.loads(path.read_text())}


def test_headline_is_one_line(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, lines = _main(["--device", "cpu"], capsys)
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    assert tuple(line) == HEADLINE_KEYS
    assert line["metric"] == bench.HEADLINE_CPU and line["device"] == "cpu"
    assert line["value"] > 0 and line["correct"]
    assert not list(tmp_path.iterdir())        # the CPU writes no file


def test_matrix_writes_every_row(capsys, tmp_path):
    out = tmp_path / "m.json"
    rc, lines = _main(["--matrix", "--device", "cpu", "--out", str(out)],
                      capsys)
    assert rc == 0
    names = [n for n, _ in bench.MATRIX] + E2E
    rows = json.loads(out.read_text())
    assert [r["metric"] for r in rows] == [f"iq_throughput_{n}"
                                           for n in names]
    for r in rows:
        assert all(k in r for k in ROW_KEYS), r["metric"]
        assert r["correct"] and r["value"] > 0 and r["device"] == "cpu"
        assert sorted(r["seconds"]) == sorted(map(str, r["lengths"]))
        assert all(len(s) == r["reps"] for s in r["seconds"].values())
        roof = r["roofline"]
        assert roof["achieved_frac"] is None        # not timed on a card
        if r["metric"][len("iq_throughput_"):] in E2E:
            # timed by the host clock: no device bound
            assert roof["bound_ms"] is None and roof["bound_by"] is None
            continue
        assert roof["bound_by"] in ("bytes", "operations")
        assert roof["bound_ms"] > 0
        check = r["check"]
        assert check["replay"]["correct"] and check["first_step_finite"]
        assert check["replay"]["steps"] == r["lengths"][0]
        name = r["metric"][len("iq_throughput_"):]
        if name.startswith("nbfm_") and name != "nbfm_f64" \
                or name == "sharded_step":
            assert check["step"]["correct"], name     # the whole step
    assert lines[:-1] == rows
    assert tuple(lines[-1]) == HEADLINE_KEYS
    assert lines[-1]["metric"] == bench.HEADLINE_CPU


def test_rows_keep_prior_and_mark_the_rest(capsys, tmp_path):
    out = tmp_path / "m.json"
    prior = {"metric": "iq_throughput_nbfm_f64", "value": 1.5}
    out.write_text(json.dumps([prior]))
    rc, _ = _main(["--matrix", "--rows", "hbm_memcpy_floor", "--device",
                   "cpu", "--out", str(out)], capsys)
    assert rc == 0
    rows = _rows(out)
    assert len(rows) == len(bench.MATRIX) + len(E2E)
    assert rows["iq_throughput_nbfm_f64"] == prior
    assert rows["iq_throughput_hbm_memcpy_floor"]["correct"]
    assert rows["iq_throughput_nbfm_q0_fused_fast"]["correct"]  # headline
    assert rows["iq_throughput_e2e_bank4_pfb"] == {
        "metric": "iq_throughput_e2e_bank4_pfb",
        "skipped": "not in --rows and no prior value"}


def _raise(dev, sz):
    raise RuntimeError("builder fails")


@pytest.mark.parametrize("fault", ["raises", "incorrect"])
def test_failing_row_leaves_the_others(capsys, tmp_path, monkeypatch, fault):
    if fault == "raises":
        monkeypatch.setattr(bench, "MATRIX", tuple(
            (n, _raise if n == "nbfm_f64" else b) for n, b in bench.MATRIX))
    else:       # the memory floor's plain version disagrees with K2
        monkeypatch.setattr(bench, "dma_floor_ref",
                            lambda x: bench.dma_floor(x) + 1)
    out = tmp_path / "m.json"
    rc, lines = _main(["--matrix", "--rows", "hbm_memcpy_floor,nbfm_f64",
                       "--device", "cpu", "--out", str(out)], capsys)
    assert rc == 1
    rows = _rows(out)
    assert len(rows) == len(bench.MATRIX) + len(E2E)
    f64, floor = rows["iq_throughput_nbfm_f64"], \
        rows["iq_throughput_hbm_memcpy_floor"]
    if fault == "raises":
        assert "builder fails" in f64["error"] and floor["correct"]
    else:
        assert floor["correct"] is False and f64["correct"]
    assert rows["iq_throughput_nbfm_q0_fused_fast"]["correct"]
    assert lines[-1]["metric"] == bench.HEADLINE_CPU


def test_cpu_never_writes_the_card_file(tmp_path):
    with pytest.raises(SystemExit) as e:
        bench.main(["--matrix", "--device", "cpu", "--out",
                    str(tmp_path / bench.DEFAULT_OUT)])
    assert e.value.code == 2
    assert not (tmp_path / bench.DEFAULT_OUT).exists()


def _python(code: str, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO, **env})


def test_no_card_exits_nonzero():
    # no visible card (the card's machine hides its own)
    r = _python("import sys; from demodulator_tpu_torch.bench import main; "
                "sys.exit(main(['--matrix']))", CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA device not available" in r.stderr


def test_module_imports_no_jax():
    r = _python("import sys, demodulator_tpu_torch.bench; "
                "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'demodulator_tpu', 'bench')))")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
