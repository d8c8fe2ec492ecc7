"""The EVM's kept Laplacian levels and the Gaussian chain they come from
(pipeline/evm._band_laplacian_levels, ops/pyramid.gaussian_pyramid) against
the cv2 golden chain, at the geometries the locate and absorb paths use."""

import numpy as np
import pytest

import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig
from respmon_tpu.ops import pyramid
from respmon_tpu.pipeline import evm
from tests.golden import reference_numpy as golden

pytest.importorskip("cv2")


def _video(shape, seed):
    return np.random.default_rng(seed).random(shape)


@pytest.mark.parametrize("shape,levels,skip", [
    ((3, 120, 160), 6, 2),
    ((2, 480, 640), 9, 4),   # production geometry (odd tiny levels)
    ((2, 60, 80), 4, 1),
])
def test_band_levels_match_golden(shape, levels, skip):
    vid = _video(shape, 0)
    cfg = CalibrationConfig(pyramid_levels=levels, skip_levels_at_top=skip)
    got = evm._band_laplacian_levels(jnp.asarray(vid), cfg)
    want = golden.laplacian_video_pyramid(vid, levels)
    assert sorted(got) == list(range(skip, levels - 1))
    for lvl, g in got.items():
        np.testing.assert_allclose(np.asarray(g), want[lvl], rtol=0,
                                   atol=1e-12, err_msg=f"level {lvl}")


@pytest.mark.parametrize("shape,depth", [
    ((2, 135, 192), 1),      # odd H (mid-pyramid odd sizes)
    ((2, 135, 192), 2),
    ((2, 135, 192), 3),
    ((3, 67, 256), 1),
    ((2, 68, 240), 2),       # width not a power of two
])
def test_gaussian_level_matches_golden(shape, depth):
    vid = _video(shape, 2)
    got = pyramid.gaussian_pyramid(jnp.asarray(vid), depth + 1)[depth]
    want = np.stack([golden.gaussian_pyramid(f, depth + 1)[depth]
                     for f in vid])
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-12)


def test_band_levels_compose_from_a_gaussian_level():
    # Kept levels built from gauss[s1] with the pyramid shortened by s1
    # equal the whole video's kept levels: the chain is one stencil per
    # level, so it can start from any level.
    vid = _video((2, 135, 192), 3)
    levels, skip, s1 = 7, 3, 2
    g = pyramid.gaussian_pyramid(jnp.asarray(vid), s1 + 1)[s1]
    got = evm._band_laplacian_levels(g, CalibrationConfig(
        pyramid_levels=levels - s1, skip_levels_at_top=skip - s1))
    want = golden.laplacian_video_pyramid(vid, levels)
    assert len(got) == levels - 1 - skip
    for lvl, g_lvl in got.items():
        np.testing.assert_allclose(np.asarray(g_lvl), want[lvl + s1],
                                   rtol=0, atol=1e-12)
