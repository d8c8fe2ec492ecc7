"""Card-only checks: what the CPU suite cannot see (reduced-precision
matmuls, backend-specific rounding and fusion).

Run on the card with ``RESPMON_TEST_GPU=1 python -m pytest -m gpu -n 0
tests/``; everywhere else every test here skips.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found {dev.platform}")
    return dev


def test_u8_widen_bit_exact(gpu):
    from respmon_tpu.utils.parity import u8_widen_mismatches

    assert u8_widen_mismatches().size == 0


def test_gaussfit_decisions_within_float32_envelope(gpu):
    from respmon_tpu.utils.parity import gaussfit_agreement

    ar, _, nr, _ = gaussfit_agreement()
    assert round(ar * nr) >= 74   # tests/test_gaussfit.py pins 75/80 on the CPU


def test_band_levels_match_the_host(gpu):
    from respmon_tpu.config import CalibrationConfig
    from respmon_tpu.pipeline import evm

    cfg = CalibrationConfig()
    x = np.random.default_rng(0).random((4, 270, 480)).astype(np.float32)
    fn = jax.jit(lambda v: evm._band_laplacian_levels(v, cfg))
    got = fn(jnp.asarray(x))
    want = fn(jax.device_put(x, jax.devices("cpu")[0]))
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)


def test_locate_matches_host_float64(gpu):
    import chip_smoke as cs
    from respmon_tpu.config import CalibrationConfig
    from respmon_tpu.io.synthetic import breathing_clip
    from respmon_tpu.pipeline import evm

    cfg = CalibrationConfig()
    clip = cs._u8(breathing_clip(num_frames=128, height=240, width=320,
                                 fps=10.0, patch_size=(40, 50),
                                 amplitude=0.12, motion_px=2.0,
                                 texture_motion=True))
    r = evm.locate(jnp.asarray(clip), 10.0, cfg)
    box, heat = cs.locate_reference(clip, cfg)
    assert (int(r.x), int(r.y), int(r.w), int(r.h)) == box
    assert cs.heatmap_diff(r.heatmap_u8, heat) <= 1


def test_fleet_matches_single_stream(gpu):
    import chip_smoke as cs

    sz = cs.Sizes(fleet_hw=(240, 320), cal_len=64, pyramid_levels=6,
                  skip_levels=2)
    from respmon_tpu.parallel import streams as fleet

    clip, _ = cs._fleet_clip(sz, sz.cal_len + 6)
    mon = fleet.MultiStreamMonitor(cs._monitor_cfg(sz), None,
                                   sz.fleet_hw, cs.FPS)
    loc = mon.calibrate(cs._stream_buffers(clip, sz, range(4)))
    boxes = np.asarray(loc.boxes)
    got = np.stack([np.asarray(mon.step(cs._stream_frames(
        clip, sz, range(4), sz.cal_len + k)).samples) for k in range(6)])
    for s in range(4):
        want = cs._reference_samples(
            mon.spec, boxes[s],
            lambda k: np.roll(clip[sz.cal_len + k], cs._fleet_shift(sz, s),
                              axis=1), 6)
        _, _, ok = cs.compare_samples(got[:, s], want, cs.FLEET_SAMPLE_TOL)
        assert ok
