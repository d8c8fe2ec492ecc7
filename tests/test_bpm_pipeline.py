"""End-to-end BPM-stage parity (reference base.py:340-352) incl. float32."""

import numpy as np
import pytest

import jax.numpy as jnp

from respmon_tpu.config import MeasureConfig
from respmon_tpu.io.synthetic import motion_trace
from respmon_tpu.ops import filters
from respmon_tpu.pipeline import bpm as bpm_mod
from tests.golden import reference_numpy as golden

FPS = 10.0
CFG = MeasureConfig()
COEFFS = filters.design_butter_lowpass(1.0 * 0.5, FPS, CFG.filter_order)
MIN_DIST = 10  # floor(fps / freq_max)


def _run(y, t, count=None, dtype=np.float64):
    n = 128
    count = len(y) if count is None else count
    yp = np.zeros(n, dtype)
    tp = np.zeros(n, dtype)
    yp[n - count:] = y[:count]
    tp[n - count:] = t[:count]
    return bpm_mod.estimate_bpm_jit(jnp.asarray(yp), jnp.asarray(tp),
                                    jnp.asarray(count), COEFFS, MIN_DIST, CFG)


@pytest.mark.parametrize("bpm_true", [12.0, 18.0, 30.0])
def test_bpm_matches_oracle(bpm_true):
    t, y = motion_trace(num_samples=128, fps=FPS, bpm=bpm_true, noise=0.02,
                        seed=int(bpm_true))
    res = _run(y, t)
    want, _, want_peaks, _ = golden.measure_bpm(y, t, FPS)
    assert bool(res.has_bpm) == (want is not None)
    if want is not None:
        np.testing.assert_allclose(float(res.bpm), want, atol=1e-6)
        assert int(res.peak_count) == len(want_peaks)


def test_bpm_float32_within_half_bpm():
    # The float32 production dtype must stay within the ±0.5 BPM parity bar
    # (BASELINE.md) vs the float64 oracle.
    t, y = motion_trace(num_samples=128, fps=FPS, bpm=18.0, noise=0.02)
    res = _run(y.astype(np.float32), t.astype(np.float32), dtype=np.float32)
    want, _, _, _ = golden.measure_bpm(y, t, FPS)
    assert bool(res.has_bpm)
    assert abs(float(res.bpm) - want) <= 0.5


@pytest.mark.parametrize("count", [13, 20, 40])
def test_growing_buffer_matches_oracle(count):
    t, y = motion_trace(num_samples=128, fps=FPS, bpm=18.0, noise=0.02)
    res = _run(y, t, count=count)
    want, _, _, _ = golden.measure_bpm(y[:count], t[:count], FPS)
    assert bool(res.has_bpm) == (want is not None)
    if want is not None:
        np.testing.assert_allclose(float(res.bpm), want, atol=1e-6)


def test_flat_signal_yields_no_bpm():
    t = np.arange(128) / FPS
    res = _run(np.zeros(128), t)
    assert not bool(res.has_bpm)
    assert int(res.peak_count) == 0


def test_fit_disagreement_bpm_error_bounded():
    """Quantify the BPM error induced by LM-vs-curve_fit accept/reject
    disagreements (the ~1% of pure-noise windows where the fitters differ):
    across a noise sweep, whenever both pipelines produce a BPM the gap
    must stay within the ±0.5 BPM parity bar, and has_bpm decisions must
    agree on all but a small fraction of traces."""
    cases = 0
    decision_flips = 0
    max_gap = 0.0
    for bpm_true in (12.0, 18.0):
        for noise in (0.05, 0.1, 0.2, 0.3):
            for seed in range(5):
                t, y = motion_trace(num_samples=128, fps=FPS, bpm=bpm_true,
                                    noise=noise, seed=seed + int(10 * noise)
                                    + int(bpm_true))
                res = _run(y, t)
                want, _, _, _ = golden.measure_bpm(y, t, FPS)
                cases += 1
                if bool(res.has_bpm) != (want is not None):
                    decision_flips += 1
                    continue
                if want is not None:
                    max_gap = max(max_gap, abs(float(res.bpm) - want))
    assert cases == 40
    # Accept/reject flips on noisy windows may change *whether* a BPM is
    # reported this frame (the reference's own retry path smooths these),
    # but never push a reported BPM outside the parity bar.
    assert decision_flips <= 2, \
        f"{decision_flips}/{cases} has_bpm decisions flipped"
    assert max_gap <= 0.5, f"max BPM gap {max_gap:.3f} > 0.5"
