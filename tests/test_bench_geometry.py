"""End-to-end BPM credibility at the flagship bench geometry.

The headline bench's BPM readout must be proven against
the golden reference chain at bench scale (640x480, flow, texture motion),
not just at the small parity-test geometries.  These tests run the exact
bench fixture through ``measure_clip`` and assert (a) the device BPM tail
matches the golden oracle (scipy filtfilt + peakutils + curve_fit,
reference base.py:312-352) window for window, and (b) both land near the
clip's ground-truth rate.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from respmon_tpu.config import MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.ops import filters
from respmon_tpu.pipeline import motion, scan

from tests.golden import reference_numpy as golden

FPS = 10.0


def test_bench_clip_bpm_matches_oracle_and_truth():
    """The flagship bench protocol (bench.py main_headline), CPU-run:
    device tail median within 0.5 BPM of the oracle AND of truth."""
    cfg = MonitorConfig(motion_extraction_method="flow")
    cal_len = cfg.calibration.buffer_length
    measure_len = 128
    clip = breathing_clip(num_frames=cal_len + 1 + measure_len, height=480,
                          width=640, fps=FPS, bpm=18.0,
                          patch_center=(240, 320), patch_size=(80, 100),
                          amplitude=0.12, motion_px=2.0, texture_motion=True)
    # ROI pinned to what EVM locate reports on this clip (bench.py computes
    # it on-device; full-frame locate on the CPU mesh is minutes of conv
    # work and is covered by its own parity tests).
    x, y, w, h = 256, 189, 128, 105
    spec = motion.MeasureSpec.for_roi(cfg, 480, 640, w, h, FPS)
    coeffs = filters.design_butter_lowpass(0.5, FPS,
                                           cfg.measure.filter_order)
    res = scan.measure_clip(jnp.asarray(clip[cal_len + 1:], jnp.float32),
                            jnp.asarray([x, y, w, h]), spec, coeffs, 10,
                            cfg.measure)
    samples = np.asarray(res.samples)
    tt = np.asarray(res.t)
    has = np.asarray(res.has_bpm)
    assert has.any()
    tail = np.asarray(res.bpm)[has][-10:]

    n = cfg.measure.buffer_length
    total = len(samples)
    oracle = []
    for i in range(total - 10, total):
        lo = max(0, i + 1 - n)
        ob, _, _, _ = golden.measure_bpm(samples[lo:i + 1], tt[lo:i + 1],
                                         FPS)
        oracle.append(ob if ob is not None else np.nan)
    oracle = np.asarray(oracle, float)

    # Window-for-window agreement with the reference chain...
    assert np.all(np.isfinite(oracle))
    np.testing.assert_allclose(tail, oracle, atol=5e-3)
    # ...and the headline number is near ground truth.
    assert abs(float(np.median(tail)) - 18.0) <= 0.5
    # The flow signal must not decay (the round-2 envelope fixture lost
    # ~50% rms over 256 frames as LK points drifted off apparent motion).
    rms_a = float(np.sqrt(np.mean(samples[:64] ** 2)))
    rms_b = float(np.sqrt(np.mean(samples[-64:] ** 2)))
    assert rms_b > 0.6 * rms_a


class TestTextureMotionFixture:
    def test_outside_patch_static_inside_moves(self):
        clip = breathing_clip(num_frames=30, height=80, width=100, fps=FPS,
                              bpm=18.0, patch_center=(40, 50),
                              patch_size=(24, 30), amplitude=0.1,
                              motion_px=2.0, noise=0.0,
                              texture_motion=True)
        # Far from the patch the envelope is ~0: frames identical.
        corner0 = clip[:, :8, :8]
        assert np.ptp(corner0, axis=0).max() <= 1.5 / 255.0
        # Inside the patch the texture moves: frames differ.
        assert np.ptp(clip[:, 36:44, 46:54], axis=0).max() > 5.0 / 255.0

    def test_texture_translates_by_motion_px(self):
        """phase=-1 at frame 25 (sin(1.5*pi)): the patch core equals the
        phase-0 texture shifted by motion_px rows (up), modulo the
        brightness term."""
        mp = 2.0
        clip = breathing_clip(num_frames=30, height=80, width=100, fps=FPS,
                              bpm=18.0, patch_center=(40, 50),
                              patch_size=(40, 50), amplitude=0.0,
                              motion_px=mp, noise=0.0, texture_motion=True)
        base = clip[0]          # phase 0: no shift
        shifted = clip[25]      # phase -1: texture at y + mp
        core = np.s_[36:45, 46:55]
        ref = base[36 + int(mp):45 + int(mp), 46:55]
        np.testing.assert_allclose(shifted[core], ref, atol=3.5 / 255.0)


@pytest.mark.parametrize("texture", [False, True])
def test_breathing_clip_modes_share_background(texture):
    """texture_motion only changes behavior when motion_px > 0."""
    a = breathing_clip(num_frames=4, height=40, width=50, fps=FPS,
                       motion_px=0.0, texture_motion=texture)
    b = breathing_clip(num_frames=4, height=40, width=50, fps=FPS,
                       motion_px=0.0, texture_motion=False)
    np.testing.assert_array_equal(a, b)
