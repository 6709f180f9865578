"""The fused NBFM kernel's plain version against the JAX Pallas kernel.
(The CUDA kernel against its plain version: tests/test_torch_cuda.py.)

On the CPU the JAX kernel runs in interpret mode, as tests/test_fused.py
runs it.  There its --fast-atan2 reciprocal estimate is emulated in
bfloat16 before the Newton step, while the CUDA kernel's rcp.approx is
within an ULP of 1/x: the fast variants agree to ~110.3-111 dB on the tone
fixture and ~122 dB on noise (measured), the precise ones to > 125 dB.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodulator_tpu.ops.demod import _ATAN_COEFFS as J_COEFFS
from demodulator_tpu.ops.demod import _ATAN_COEFFS_FAST as J_COEFFS_FAST
from demodulator_tpu.ops.pallas.fused_nbfm import (dma_floor_u32_3d,
                                                   fused_nbfm_u32_3d)
from demodulator_tpu_torch.config import config_from_cli_opts
from demodulator_tpu_torch.models.nbfm import BlockPipeline
from demodulator_tpu_torch.ops import demod as t_demod
from demodulator_tpu_torch.ops.cuda import fused_nbfm as k
from tests.conftest import snr_db

torch.set_num_threads(1)

BUF = 4096
CSRC = Path(__file__).resolve().parents[1] / "demodulator_tpu_torch" / "csrc"
CU = CSRC / "nbfm_device.cuh"  # the kernels' shared constants
FILTERS = {
    "butterworth": {"S": "192000", "l": "12500"},              # D = 1
    "chebyshev": {"S": "96000", "l": "12500", "m": "1", "d": "8"},  # D = 2
}


def _taps(name):
    taps = BlockPipeline(config_from_cli_opts(FILTERS[name]),
                         device="cpu").out_fir.host_taps
    assert len(taps) == {"butterworth": 2, "chebyshev": 3}[name]
    return taps


def _jax_kernel(raw, taps, cond, precise):
    u32 = jnp.asarray(raw.view(np.uint32).reshape(raw.shape[0], -1, 128))
    out = fused_nbfm_u32_3d(u32, tuple(float(t) for t in taps), cond,
                            interpret=True, precise=precise)
    return np.asarray(out).reshape(raw.shape[0], -1)


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("cond", ["shift", "normalize"])
@pytest.mark.parametrize("precise", [True, False])
def test_ref_matches_jax_kernel(iq_data, precise, cond, filt):
    taps = _taps(filt)
    tone = iq_data.reshape(3, BUF)
    noise = np.random.default_rng(0).integers(0, 256, (3, BUF), np.uint8)
    for name, raw in (("tone", tone), ("noise", noise)):
        got = k.fused_nbfm_ref(torch.from_numpy(raw), taps, cond,
                               precise).numpy()
        want = _jax_kernel(raw, taps, cond, precise)
        s = snr_db(want.ravel(), got.ravel())
        print(f"{name} precise={precise} {cond} {filt}: {s:.1f} dB, "
              f"max|err| {np.max(np.abs(want - got)):.3g}")
        assert s > 110.0, f"{name}: {s:.1f} dB"  # bar of tests/test_fused.py


def test_dma_floor_ref_equals_jax():
    raw = np.random.default_rng(1).integers(0, 256, (3, BUF), np.uint8)
    want = np.asarray(dma_floor_u32_3d(
        jnp.asarray(raw.view(np.uint32).reshape(3, -1, 128)),
        interpret=True)).reshape(3, -1)
    got = k.dma_floor_ref(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensor_takes_plain_version():
    raw = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (2, BUF), np.uint8))
    taps = _taps("butterworth")
    before = (k.fused_nbfm.launches, k.dma_floor.launches)
    for precise in (True, False):
        assert torch.equal(k.fused_nbfm(raw, taps, "shift", precise),
                           k.fused_nbfm_ref(raw, taps, "shift", precise))
    assert torch.equal(k.dma_floor(raw), k.dma_floor_ref(raw))
    assert (k.fused_nbfm.launches, k.dma_floor.launches) == before


@pytest.mark.parametrize("raw, taps", [
    (torch.zeros(2, BUF, dtype=torch.int8), [1.0]),            # dtype
    (torch.zeros(BUF, dtype=torch.uint8), [1.0]),              # rank
    (torch.zeros(2, BUF + 2, dtype=torch.uint8), [1.0]),       # n % 4
    (torch.zeros(BUF, 2, dtype=torch.uint8).t(), [1.0]),       # strides
    (torch.zeros(2, BUF, dtype=torch.uint8), [0.5] * 33),      # MAX_TAPS
    (torch.zeros(2, BUF, dtype=torch.uint8), []),
])
def test_wrapper_rejects(raw, taps):
    with pytest.raises(ValueError):
        k.fused_nbfm(raw, taps)


def test_kernel_constants_match_python():
    """The .cu file's float32 hex literals are the float32 roundings of the
    Python coefficient tuples (which are the JAX package's)."""
    assert t_demod._ATAN_COEFFS == J_COEFFS
    assert t_demod._ATAN_COEFFS_FAST == J_COEFFS_FAST
    src = CU.read_text()

    def floats(name, count):
        m = re.search(name + r"\[" + str(count) + r"\] = \{([^}]*)\}", src)
        assert m, name
        return [float.fromhex(v.strip().rstrip("f"))
                for v in m.group(1).split(",")]

    for name, coeffs in (("kAtanPrecise", J_COEFFS),
                         ("kAtanFast", J_COEFFS_FAST)):
        assert floats(name, len(coeffs)) == [float(np.float32(c))
                                             for c in coeffs]
    for name, value in (("kHalfPi", np.pi / 2), ("kPi", np.pi),
                        ("kNormScale", 2.0 / 255.0)):
        m = re.search(r"constexpr float " + name + r" = ([^;]*)f;", src)
        assert float.fromhex(m.group(1)) == float(np.float32(value))
    m = re.search(r"kMaxTaps = (\d+);", src)
    assert int(m.group(1)) == k.MAX_TAPS
    m = re.search(r"kMaxCplxTaps = (\d+);", src)
    assert int(m.group(1)) == k.MAX_CPLX_TAPS
    # K4 and K5 take their tile at launch (Q1_TILE), up to kMaxTile
    m = re.search(r"kMaxTile = (\d+);", (CSRC / "fused_nbfm_q1.cu").read_text())
    assert int(m.group(1)) == k.Q1_MAX_TILE
    assert 1 <= k.Q1_TILE <= k.Q1_MAX_TILE

