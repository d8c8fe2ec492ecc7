"""Eulerian video magnification calibration — one fused device program.

Replaces the reference's calibration stack (transforms.py:144-198 +
base.py:547-601), which is its compute bottleneck (SURVEY.md §3.3): 128
frames x 9-level OpenCV pyramid + per-pixel scipy FFTs + per-frame collapse.
Here the whole chain — Laplacian video pyramid, per-level packed-rfft
temporal bandpass (as matmuls), bandpassed-pyramid collapse, suppress-top
windowing, heatmap reduction, threshold, and largest-component bbox — traces
into a single ``jax.jit`` program over the on-device (T, H, W) buffer.

The bandpassed pyramid skips the top ``skip_levels_at_top`` levels and the
bottom (Gaussian) level (transforms.py:156-160); skipped levels contribute
zeros to the collapse, so the collapse starts from the deepest *filtered*
level and pyr-ups through the zero levels — mathematically identical to the
reference's zero-filled collapse but without touching full-res zero arrays.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig
from respmon_tpu.ops import ccl
from respmon_tpu.ops.dtype import float_to_uint8, uint8_to_float
from respmon_tpu.ops.fft_bandpass import temporal_bandpass_fft
from respmon_tpu.ops.pyramid import gaussian_pyramid, pyr_up, pyramid_shapes


class EVMResult(NamedTuple):
    masked: jnp.ndarray   # (T, H, W) suppress-top-masked bandpassed video
    raw: jnp.ndarray      # (T, H, W) raw collapsed bandpassed video


class LocateResult(NamedTuple):
    found: jnp.ndarray      # bool — False mirrors locate() returning None
    x: jnp.ndarray          # int32 bbox (cv2 convention)
    y: jnp.ndarray
    w: jnp.ndarray
    h: jnp.ndarray
    heatmap_u8: jnp.ndarray  # (H, W) uint8 normalized average frame
    thresh: jnp.ndarray      # (H, W) uint8 binary threshold image
    raw_heat_u8: jnp.ndarray  # (H, W) uint8 of the unmasked heatmap


def _band_laplacian_levels(vid: jnp.ndarray, cfg: CalibrationConfig):
    """Laplacian levels [skip_top, levels-2] of the video.

    Builds the Gaussian chain once, then only the KEPT Laplacian
    differences — the full-resolution Laplacians below ``skip_top`` (which
    nothing consumes) never pay their pyr_up.  Values are identical to
    laplacian_pyramid()'s kept levels (same stencils on the same gauss).
    """
    first = cfg.skip_levels_at_top
    last = cfg.pyramid_levels - 2
    gauss = gaussian_pyramid(vid, cfg.pyramid_levels)
    return {i: gauss[i] - pyr_up(gauss[i + 1], gauss[i].shape[-2:])
            for i in range(first, last + 1)}


def eulerian_magnification_bandpass(vid: jnp.ndarray, fps: float,
                                    cfg: CalibrationConfig) -> EVMResult:
    """transforms.py:144-198 as one traced computation.

    vid: (T, H, W) float frames in [0, 1], or camera-native uint8 (widened
    on device to float32, bit-equal to the host chain — see ``locate``).
    """
    if vid.dtype == jnp.uint8:
        vid = uint8_to_float(vid)
    t_len, h, w = vid.shape
    levels = cfg.pyramid_levels
    shapes = pyramid_shapes(h, w, levels)

    band_lap = _band_laplacian_levels(vid, cfg)

    # Bandpass the kept levels (skip top `skip_levels_at_top` and bottom 1)
    # with the configured temporal filter (transforms.py:146).
    assert cfg.temporal_filter in ("fft", "iir"), \
        f"temporal_filter must be 'fft' or 'iir', got {cfg.temporal_filter!r}"
    if cfg.temporal_filter == "fft":
        filt = lambda lvl: temporal_bandpass_fft(
            lvl, fps, cfg.freq_min, cfg.freq_max, cfg.amplification)
    else:
        from respmon_tpu.ops.fft_bandpass import temporal_bandpass_iir

        filt = lambda lvl: temporal_bandpass_iir(
            lvl, fps, cfg.freq_min, cfg.freq_max, cfg.amplification)
    last = levels - 2  # inclusive; level levels-1 is the Gaussian top
    band = {i: filt(lvl) for i, lvl in band_lap.items()}

    # Collapse the (implicitly zero-padded) bandpassed pyramid: start at the
    # deepest filtered level and pyrUp-add up through level 0 (zero levels
    # just pass the upsampled image through).
    img = jnp.zeros((t_len,) + shapes[last + 1], vid.dtype)
    for lvl in range(last, -1, -1):
        img = pyr_up(img, shapes[lvl])
        if lvl in band:
            img = img + band[lvl]
    raw = img

    # Suppress-top windowing (transforms.py:184-192): values within
    # `temporal_threshold` of the global max (proportionally) -> global min.
    lo = jnp.min(raw)
    hi = jnp.max(raw)
    top = hi - (hi - lo) * cfg.temporal_threshold
    masked = jnp.where(raw >= top, lo, raw)
    return EVMResult(masked=masked, raw=raw)


def eulerian_magnification_bandpass_verbose(vid: jnp.ndarray, fps: float,
                                            cfg: CalibrationConfig) \
        -> EVMResult:
    """Per-stage timed EVM (reference transforms.py:153-155, 166-168,
    194-197 ``verbose=True``): logs each stage's wall dt and per-frame
    average.  Stages run as separate blocked device calls so the dt's are
    real — use the fused ``eulerian_magnification_bandpass`` in production
    (this variant pays extra dispatches and loses cross-stage fusion)."""
    import logging
    import time as _time

    log = logging.getLogger(__name__).info
    if vid.dtype == jnp.uint8:
        vid = uint8_to_float(vid)
    t_len = vid.shape[0]

    def stage(name, fn, *a):
        t0 = _time.time()
        out = jax.block_until_ready(fn(*a))
        dt = _time.time() - t0
        log("%s (t=%s, dt=%s)", name, t0, dt)
        log("Frame Average (t=n/a, dt=%s)", dt / float(t_len))
        return out

    band_fn = jax.jit(lambda v: _band_laplacian_levels(v, cfg))
    band_lap = stage("create_laplacian_video_pyramid", band_fn, vid)

    assert cfg.temporal_filter in ("fft", "iir")
    if cfg.temporal_filter == "fft":
        filt = lambda lvl: temporal_bandpass_fft(
            lvl, fps, cfg.freq_min, cfg.freq_max, cfg.amplification)
    else:
        from respmon_tpu.ops.fft_bandpass import temporal_bandpass_iir

        filt = lambda lvl: temporal_bandpass_iir(
            lvl, fps, cfg.freq_min, cfg.freq_max, cfg.amplification)
    band = {i: stage("temporal_bandpass_filter", jax.jit(filt), lvl)
            for i, lvl in band_lap.items()}

    def collapse_and_mask(band_vals):
        t_len_, h, w = vid.shape
        shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
        last = cfg.pyramid_levels - 2
        img = jnp.zeros((t_len_,) + shapes[last + 1], vid.dtype)
        for lvl in range(last, -1, -1):
            img = pyr_up(img, shapes[lvl])
            if lvl in band_vals:
                img = img + band_vals[lvl]
        lo = jnp.min(img)
        hi = jnp.max(img)
        top = hi - (hi - lo) * cfg.temporal_threshold
        return EVMResult(masked=jnp.where(img >= top, lo, img), raw=img)

    return stage("collapse_laplacian_video_pyramid",
                 jax.jit(collapse_and_mask), band)


def locate_verbose(vid: jnp.ndarray, fps: float,
                   cfg: CalibrationConfig) -> LocateResult:
    """``locate`` with the reference's per-stage verbose timing
    (transforms.py verbose=True): each EVM stage is dispatched and blocked
    separately so its dt is logged.  Same result, more dispatches."""
    if vid.dtype == jnp.uint8:
        vid = uint8_to_float(vid)
    evm_res = eulerian_magnification_bandpass_verbose(vid, fps, cfg)
    return _locate_from_evm(evm_res, cfg)


@partial(jax.jit, static_argnames=("fps", "cfg"))
def locate(vid: jnp.ndarray, fps: float, cfg: CalibrationConfig) \
        -> LocateResult:
    """base.py:547-601 on device: EVM heatmap -> normalize -> threshold ->
    largest 8-connected region -> bounding box.

    Returns found=False when the threshold image has no foreground (the
    reference's `len(contours) <= 0 -> None` retry path, base.py:569-570).

    ``vid`` may be float frames in [0, 1] (the capture convention) OR
    camera-native ``uint8`` — bytes ship to the device at 4x less H2D
    bandwidth and widen here, bit-equal to the host reference conversion
    chain (ops/dtype.uint8_to_float; reference transforms.py:20-23).
    """
    if vid.dtype == jnp.uint8:
        vid = uint8_to_float(vid)
    t_len, h, w = vid.shape
    shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
    last = cfg.pyramid_levels - 2

    band_lap = _band_laplacian_levels(vid, cfg)
    assert cfg.temporal_filter in ("fft", "iir"), \
        f"temporal_filter must be 'fft' or 'iir', got {cfg.temporal_filter!r}"
    if cfg.temporal_filter == "fft":
        filt = lambda lvl: temporal_bandpass_fft(
            lvl, fps, cfg.freq_min, cfg.freq_max, cfg.amplification)
    else:
        from respmon_tpu.ops.fft_bandpass import temporal_bandpass_iir

        filt = lambda lvl: temporal_bandpass_iir(
            lvl, fps, cfg.freq_min, cfg.freq_max, cfg.amplification)
    band = {i: filt(lvl) for i, lvl in band_lap.items()}

    def collapse(levels_dict, t):
        img = jnp.zeros((t,) + shapes[last + 1], vid.dtype)
        for lvl in range(last, -1, -1):
            img = pyr_up(img, shapes[lvl])
            if lvl in levels_dict:
                img = img + levels_dict[lvl]
        return img

    raw = collapse(band, t_len)
    lo = jnp.min(raw)
    hi = jnp.max(raw)
    top = hi - (hi - lo) * cfg.temporal_threshold
    # The masked video is consumed only through its T-mean, so the
    # suppress-top `where` fuses straight into the reduction — the (T, H, W)
    # masked array itself is never materialized (at 1080p that's a ~1 GB
    # HBM round trip the reference formulation pays).
    avg = jnp.mean(jnp.where(raw >= top, lo, raw), axis=0)

    # pyrUp is linear, so mean_T(collapse(band)) == collapse(mean_T(band)):
    # the raw heatmap needs one single-frame collapse of the tiny band
    # levels, not a second full-resolution (T, H, W) pass.  NOTE this is an
    # intentional ULP-level FP reordering vs the reference's
    # mean(collapse(band)) (base.py:585) — raw_heat_u8 is diagnostic-only
    # (calibration montage), and the wrap-mod-256 uint8 conversion can turn
    # a 1-ULP difference at a k/255 boundary into ±255, so oracle tests
    # compare it with a quantization tolerance; parallel/spatial.py matches
    # THIS formulation bit-for-bit.
    mean_band = {i: jnp.mean(lvl, axis=0, keepdims=True)
                 for i, lvl in band.items()}
    raw_avg = collapse(mean_band, 1)[0]

    return _finish_locate(avg, raw_avg, cfg)


def _finish_locate(avg: jnp.ndarray, raw_avg: jnp.ndarray,
                   cfg: CalibrationConfig) -> LocateResult:
    """Normalize -> threshold -> largest component (base.py:560-575) from
    the already-reduced masked/raw average frames."""
    avg_norm = (avg - jnp.min(avg)) / (jnp.max(avg) - jnp.min(avg))
    heat_u8 = float_to_uint8(avg_norm)

    threshold = jnp.round(cfg.threshold * 255.0).astype(jnp.int32)
    fg = heat_u8.astype(jnp.int32) > threshold   # cv2.THRESH_BINARY strict >
    thresh_img = jnp.where(fg, jnp.uint8(255), jnp.uint8(0))

    box = ccl.largest_component_bbox(fg)

    raw_norm = (raw_avg - jnp.min(raw_avg)) / \
        (jnp.max(raw_avg) - jnp.min(raw_avg))
    raw_u8 = float_to_uint8(raw_norm)

    return LocateResult(found=box.found, x=box.x, y=box.y, w=box.w, h=box.h,
                        heatmap_u8=heat_u8, thresh=thresh_img,
                        raw_heat_u8=raw_u8)


@partial(jax.jit, static_argnames=("cfg",))
def _locate_from_evm(evm: EVMResult, cfg: CalibrationConfig) -> LocateResult:
    return _finish_locate(jnp.mean(evm.masked, axis=0),
                          jnp.mean(evm.raw, axis=0), cfg)
