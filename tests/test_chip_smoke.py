"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
comparison helpers decide as documented (checked at tiny sizes)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from respmon_tpu.config import CalibrationConfig
from respmon_tpu.io.synthetic import breathing_clip, motion_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu(where, tmp_path):
    # In the checkout it stops at the platform check; copied alone it has
    # none of the package either.  Either way: non-zero, no result line.
    if where == "checkout":
        cwd = REPO
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run_smoke(cwd)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    if where == "checkout":
        assert "needs a GPU" in r.stderr


@pytest.mark.parametrize("got,want,atol,bitwise,ok", [
    ([1.0, 2.0, np.nan], [1.0, 2.0, np.nan], 0.0, True, True),
    ([1.0, 2.005, np.nan], [1.0, 2.0, np.nan], 0.01, False, True),
    ([1.0, 2.05, np.nan], [1.0, 2.0, np.nan], 0.01, False, False),
    ([1.0, 2.0, 3.0], [1.0, 2.0, np.nan], 0.01, False, False),
])
def test_compare_samples(got, want, atol, bitwise, ok):
    b, _, o = cs.compare_samples(got, want, atol)
    assert (b, o) == (bitwise, ok)


def test_compare_samples_rejects_shape_mismatch():
    with pytest.raises(cs.SmokeFailure):
        cs.compare_samples([1.0, 2.0], [1.0], 0.1)


def _windows(fps=10.0, n=60):
    from tests.golden import reference_numpy as golden

    t, y = motion_trace(num_samples=n, fps=fps, bpm=18.0, noise=0.02)
    out = []
    for c in range(20, n + 1, 10):
        bpm, _, _, _ = golden.measure_bpm(y[:c], t[:c], fps)
        out.append([y[:c], t[:c], bpm is not None,
                    np.nan if bpm is None else bpm])
    return out


def test_bpm_agreement_counts_mismatches_and_deltas():
    w = _windows()
    n, mism, both, worst = cs.bpm_agreement(w, 10.0)
    assert (n, mism, worst) == (len(w), 0, 0.0) and both > 0
    w[-1][3] += 0.3          # a BPM off by 0.3
    w[0][2] = not w[0][2]    # a flipped has-BPM decision
    n, mism, _, worst = cs.bpm_agreement(w, 10.0)
    assert mism == 1 and abs(worst - 0.3) < 1e-9


@pytest.mark.parametrize("roi,iou,inside", [
    ((10, 10, 20, 20), 1.0, True),
    ((20, 10, 20, 20), 1.0 / 3.0, True),
    ((40, 40, 5, 5), 0.0, False),
])
def test_roi_geometry(roi, iou, inside):
    assert cs.roi_iou(roi, (10, 10, 20, 20)) == pytest.approx(iou)
    assert cs.covers(roi, (20, 20)) == inside


def test_heatmap_diff_is_per_pixel_max():
    a = np.array([[0, 255], [10, 20]], np.uint8)
    b = np.array([[1, 254], [10, 23]], np.uint8)
    assert cs.heatmap_diff(a, b) == 3


def test_locate_reference_matches_golden_chain():
    # The host float64 locate that phase d compares the card against is
    # the cv2 golden chain's box on a small clip.
    from tests.golden import reference_numpy as golden

    cfg = CalibrationConfig(buffer_length=48, pyramid_levels=4,
                            skip_levels_at_top=2)
    clip = cs._u8(breathing_clip(num_frames=48, height=60, width=80,
                                 fps=10.0, bpm=18.0, patch_center=(30, 40),
                                 patch_size=(16, 20), amplitude=0.2))
    box, heat = cs.locate_reference(clip, cfg)
    want = golden.locate(clip.astype(np.float64) / 255.0, 10.0,
                         pyramid_levels=4, skip_levels_at_top=2)
    assert box == tuple(want)
    assert heat.shape == (60, 80) and heat.dtype == np.uint8


def test_fleet_streams_are_shifted_copies():
    sz = cs.Sizes(fleet_hw=(24, 160), cal_len=4)
    clip = np.arange(6 * 24 * 160, dtype=np.uint8).reshape(6, 24, 160)
    frames = cs._stream_frames(clip, sz, [0, 3], 5)
    bufs = cs._stream_buffers(clip, sz, [0, 3])
    assert frames.shape == (2, 24, 160) and bufs.shape == (2, 4, 24, 160)
    np.testing.assert_array_equal(frames[1], np.roll(clip[5], 6, axis=1))
    np.testing.assert_array_equal(bufs[1, 2], np.roll(clip[2], 6, axis=1))
