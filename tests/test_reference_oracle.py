"""Parity of the pyramid, EVM bandpass and locate chain against the
cv2/scipy golden chain (``tests/golden/reference_numpy.py``, a float64
model of reference pyramid.py, transforms.py:82-102, 144-198 and
base.py:547-601):

  - pyrDown/pyrUp video pyramids (pyramid.py:8-48) vs ops.pyramid,
  - the full EVM bandpass incl. the packed-rfft bin-zeroing quirk and the
    suppress-top mask vs pipeline.evm,
  - the complete locate chain vs pipeline.evm.locate,
  - the IIR temporal filter variant (transforms.py:72-79), which the golden
    chain does not model, against the upstream reference modules when they
    are importable (``tests/golden/reference_import.py``).

The ±0.5 BPM bar (BASELINE.md) and peak/fit stages are covered by the
golden chain's BPM tests.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.ops.pyramid import laplacian_pyramid, pyr_up, pyramid_shapes
from respmon_tpu.pipeline import evm
from tests.golden import reference_numpy as golden
from tests.golden.reference_import import load_reference

cv2 = pytest.importorskip("cv2")

FPS = 10.0


def _clip(t=48, h=60, w=80):
    return breathing_clip(num_frames=t, height=h, width=w, fps=FPS,
                          bpm=18.0, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.2,
                          noise=0.01).astype(np.float64)


def test_laplacian_video_pyramid_matches_reference():
    vid = _clip(t=6)
    want = golden.laplacian_video_pyramid(vid.copy(), 4)
    got = laplacian_pyramid(jnp.asarray(vid), 4)
    assert len(want) == len(got)
    for lvl, (w_lvl, g_lvl) in enumerate(zip(want, got)):
        np.testing.assert_allclose(np.asarray(g_lvl), w_lvl,
                                   rtol=1e-10, atol=1e-10,
                                   err_msg=f"level {lvl}")


def test_collapse_matches_reference():
    vid = _clip(t=4)
    levels = 4
    pyr = golden.laplacian_video_pyramid(vid.copy(), levels)
    wanted = golden.collapse_laplacian_video_pyramid(
        [p.copy() for p in pyr])
    # Ours collapses zero-skipped levels implicitly; with no zeroing the
    # collapse is level-(L-1) pyrUp-added through level 0.
    shapes = pyramid_shapes(vid.shape[1], vid.shape[2], levels)
    img = jnp.asarray(pyr[levels - 1])
    for lvl in range(levels - 2, -1, -1):
        img = pyr_up(img, shapes[lvl]) + jnp.asarray(pyr[lvl])
    np.testing.assert_allclose(np.asarray(img), wanted,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("t", [48, 50])  # even + odd-ish buffer lengths
def test_evm_bandpass_matches_reference(t):
    vid = _clip(t=t)
    cfg = CalibrationConfig(buffer_length=t, pyramid_levels=4,
                            skip_levels_at_top=2, freq_min=0.1, freq_max=1.0,
                            amplification=500.0, temporal_threshold=0.7)
    want_masked, want_raw = golden.eulerian_magnification_bandpass(
        vid.copy(), FPS, cfg.freq_min, cfg.freq_max, cfg.amplification,
        pyramid_levels=cfg.pyramid_levels,
        skip_levels_at_top=cfg.skip_levels_at_top,
        threshold=cfg.temporal_threshold)
    got = evm.eulerian_magnification_bandpass(jnp.asarray(vid), FPS, cfg)
    scale = max(abs(want_raw.min()), abs(want_raw.max()))
    np.testing.assert_allclose(np.asarray(got.raw), want_raw,
                               atol=1e-8 * scale)
    np.testing.assert_allclose(np.asarray(got.masked), want_masked,
                               atol=1e-8 * scale)


def test_evm_bandpass_iir_matches_reference():
    try:
        _, ref_transforms = load_reference()
    except ImportError as e:
        pytest.skip(f"upstream reference modules not importable: {e}")
    vid = _clip(t=48)
    cfg = CalibrationConfig(buffer_length=48, pyramid_levels=4,
                            skip_levels_at_top=2, temporal_filter="iir")
    want_masked, want_raw = ref_transforms.eulerian_magnification_bandpass(
        vid.copy(), FPS, cfg.freq_min, cfg.freq_max, cfg.amplification,
        pyramid_levels=cfg.pyramid_levels,
        skip_levels_at_top=cfg.skip_levels_at_top,
        threshold=cfg.temporal_threshold,
        temporal_filter_function=ref_transforms.temporal_bandpass_filter)
    got = evm.eulerian_magnification_bandpass(jnp.asarray(vid), FPS, cfg)
    scale = max(abs(want_raw.min()), abs(want_raw.max()))
    np.testing.assert_allclose(np.asarray(got.raw), want_raw,
                               atol=1e-7 * scale)
    np.testing.assert_allclose(np.asarray(got.masked), want_masked,
                               atol=1e-7 * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_locate_matches_reference(seed):
    vid = breathing_clip(num_frames=48, height=60, width=80, fps=FPS,
                         bpm=18.0, patch_center=(30, 40),
                         patch_size=(16, 20), amplitude=0.2, noise=0.01,
                         seed=seed).astype(np.float64)
    cfg = CalibrationConfig(buffer_length=48, pyramid_levels=4,
                            skip_levels_at_top=2)
    want = golden.locate(vid.copy(), FPS, cfg.freq_min, cfg.freq_max,
                         cfg.amplification,
                         pyramid_levels=cfg.pyramid_levels,
                         skip_levels_at_top=cfg.skip_levels_at_top,
                         temporal_threshold=cfg.temporal_threshold,
                         threshold=int(round(cfg.threshold * 255.0)))
    got = evm.locate(jnp.asarray(vid), FPS, cfg)
    if want is None:
        assert not bool(got.found)
        return
    assert bool(got.found)
    assert (int(got.x), int(got.y), int(got.w), int(got.h)) == tuple(want)
