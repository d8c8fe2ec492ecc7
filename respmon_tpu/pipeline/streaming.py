"""Streaming (incremental) EVM calibrator.

The reference prototyped a sliding-window EVM that re-filters a rolling
pyramid buffer every frame instead of batch-calibrating once per 128 frames
(prototypes/locating.py:94-147 — flagged in SURVEY.md §2.0b as the precedent
for a streaming calibrator).  Production only ships the batch variant;
here streaming is a first-class mode:

Design: per-level rolling (T, h_i, w_i) device buffers updated
with a roll+write (no host copies); each ``update`` runs the temporal
bandpass as the precomputed (T, T) matmul over the kept levels, collapses,
and reduces the heatmap — all one jitted program per frame.  Because the
bandpass operator is a fixed matrix, re-filtering the full window costs one
small matmul per level per frame; the localizer can therefore track a
*moving* subject continuously instead of freezing the ROI at calibration
time.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig
from respmon_tpu.ops import ccl
from respmon_tpu.ops.dtype import float_to_uint8, uint8_to_float
from respmon_tpu.ops.fft_bandpass import temporal_bandpass_fft
from respmon_tpu.ops.pyramid import pyr_up, pyramid_shapes


class StreamingState(NamedTuple):
    levels: Tuple[jnp.ndarray, ...]   # per-kept-level (T, h_i, w_i) rings
    count: jnp.ndarray                # frames absorbed (saturates at T)


class StreamingLocate(NamedTuple):
    ready: jnp.ndarray
    found: jnp.ndarray
    x: jnp.ndarray
    y: jnp.ndarray
    w: jnp.ndarray
    h: jnp.ndarray
    heatmap_u8: jnp.ndarray


def _kept_levels(cfg: CalibrationConfig):
    return list(range(cfg.skip_levels_at_top, cfg.pyramid_levels - 1))


def init_streaming_state(h: int, w: int, cfg: CalibrationConfig,
                         dtype=jnp.float32) -> StreamingState:
    shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
    levels = tuple(
        jnp.zeros((cfg.buffer_length,) + shapes[i], dtype)
        for i in _kept_levels(cfg))
    return StreamingState(levels=levels, count=jnp.asarray(0, jnp.int32))


@partial(jax.jit, static_argnames=("cfg",))
def init_streaming_from_buffer(buffer: jnp.ndarray,
                               cfg: CalibrationConfig) -> StreamingState:
    """Warm-start the streaming rings from a full (T, H, W) calibration
    buffer in ONE batched program (vmapped pyramids), so a monitor that
    just batch-calibrated can enter streaming mode with a ready window
    instead of waiting ``buffer_length`` frames.

    ``buffer`` must hold at least ``cfg.buffer_length`` frames; the last
    ``buffer_length`` fill the rings (newest last, matching
    ``streaming_update``'s roll+write order)."""
    from respmon_tpu.pipeline import evm

    t = cfg.buffer_length
    buf = buffer[-t:]
    if buf.dtype == jnp.uint8:   # camera-native ingest (ops/dtype contract)
        buf = uint8_to_float(buf)
    band_lap = evm._band_laplacian_levels(buf, cfg)
    levels = tuple(band_lap[i] for i in _kept_levels(cfg))
    return StreamingState(levels=levels, count=jnp.asarray(t, jnp.int32))


@partial(jax.jit, static_argnames=("cfg",))
def streaming_absorb(state: StreamingState, frame: jnp.ndarray,
                     cfg: CalibrationConfig) -> StreamingState:
    """Absorb one frame into the rolling pyramid rings WITHOUT localizing —
    the cheap per-frame half of ``streaming_update``.  The monitor's
    streaming-ROI mode absorbs every frame (the bandpass assumes a
    contiguous fps-rate window) but only pays the localize half every
    ``streaming_interval`` frames.

    Only the KEPT Laplacian levels are built (evm._band_laplacian_levels)
    — the
    full-resolution Laplacian levels below ``skip_levels_at_top``, which
    the rings never store, are not computed at all (they were the dominant
    cost of the previous full-pyramid absorb at 1080p)."""
    from respmon_tpu.pipeline import evm

    if frame.dtype == jnp.uint8:  # camera-native ingest (ops/dtype contract)
        frame = uint8_to_float(frame)
    kept = _kept_levels(cfg)
    band_lap = evm._band_laplacian_levels(frame[None], cfg)
    new_levels = []
    for ring, lvl in zip(state.levels, kept):
        rolled = jnp.roll(ring, -1, axis=0)
        new_levels.append(rolled.at[-1].set(band_lap[lvl][0]))
    return StreamingState(
        levels=tuple(new_levels),
        count=jnp.minimum(state.count + 1, cfg.buffer_length))


def streaming_absorb_batch(state: StreamingState, frames: jnp.ndarray,
                           cfg: CalibrationConfig) -> StreamingState:
    """Fleet absorb: ``frames`` (S, H, W) into batched rings (S, T, h, w).

    Formulated over the whole S-stack (the pyramid ops batch over leading
    axes) instead of ``vmap``-of-``streaming_absorb``."""
    if frames.dtype == jnp.uint8:
        frames = uint8_to_float(frames)
    from respmon_tpu.pipeline import evm

    kept = _kept_levels(cfg)
    band_lap = evm._band_laplacian_levels(frames, cfg)
    new_levels = []
    for ring, lvl in zip(state.levels, kept):
        rolled = jnp.roll(ring, -1, axis=1)
        new_levels.append(rolled.at[:, -1].set(band_lap[lvl]))
    return StreamingState(
        levels=tuple(new_levels),
        count=jnp.minimum(state.count + 1, cfg.buffer_length))


def init_streaming_from_buffers_batch(buffers: jnp.ndarray,
                                      cfg: CalibrationConfig
                                      ) -> StreamingState:
    """Fleet warm-start: (S, T, H, W) buffers -> batched rings, via ONE
    kept-levels pass over the flattened (S*T, H, W) stack."""
    from respmon_tpu.pipeline import evm

    s = buffers.shape[0]
    t = cfg.buffer_length
    buf = buffers[:, -t:]
    if buf.dtype == jnp.uint8:
        buf = uint8_to_float(buf)
    flat = buf.reshape((s * t,) + buf.shape[2:])
    band_lap = evm._band_laplacian_levels(flat, cfg)
    levels = tuple(
        band_lap[i].reshape((s, t) + band_lap[i].shape[1:])
        for i in _kept_levels(cfg))
    return StreamingState(levels=levels,
                          count=jnp.full((s,), t, jnp.int32))


def _localize_window(state: StreamingState, frame_hw: Tuple[int, int],
                     dtype, fps: float, cfg: CalibrationConfig,
                     coarse: bool) -> StreamingLocate:
    """The localize half of ``streaming_update``: bandpass the rolling
    rings, collapse (to full res, or to the kept-level resolution when
    ``coarse``), suppress-top, heatmap, threshold, CCL bbox.  It vmaps
    cleanly for the fleet path."""
    h0, w0 = frame_hw
    shapes = pyramid_shapes(h0, w0, cfg.pyramid_levels)
    kept = _kept_levels(cfg)

    band = {lvl: temporal_bandpass_fft(ring, fps, cfg.freq_min,
                                       cfg.freq_max, cfg.amplification)
            for ring, lvl in zip(state.levels, kept)}
    last = cfg.pyramid_levels - 2
    stop = cfg.skip_levels_at_top if coarse else 0
    img = jnp.zeros((cfg.buffer_length,) + shapes[last + 1], dtype)
    for lvl in range(last, stop - 1, -1):
        img = pyr_up(img, shapes[lvl])
        if lvl in band:
            img = img + band[lvl]

    lo = jnp.min(img)
    hi = jnp.max(img)
    top = hi - (hi - lo) * cfg.temporal_threshold
    masked = jnp.where(img >= top, lo, img)

    avg = jnp.mean(masked, axis=0)
    norm = (avg - jnp.min(avg)) / (jnp.max(avg) - jnp.min(avg))
    heat = float_to_uint8(norm)
    fg = heat.astype(jnp.int32) > jnp.round(cfg.threshold * 255.0) \
        .astype(jnp.int32)
    box = ccl.largest_component_bbox(fg)

    if coarse:
        s = 1 << stop
        bx = box.x * s
        by = box.y * s
        bw = jnp.minimum(box.w * s, w0 - bx)
        bh = jnp.minimum(box.h * s, h0 - by)
    else:
        bx, by, bw, bh = box.x, box.y, box.w, box.h

    ready = state.count >= cfg.buffer_length
    return StreamingLocate(
        ready=ready, found=box.found & ready, x=bx, y=by,
        w=bw, h=bh, heatmap_u8=heat)


@partial(jax.jit, static_argnames=("fps", "cfg", "coarse"))
def streaming_update(state: StreamingState, frame: jnp.ndarray, fps: float,
                     cfg: CalibrationConfig, coarse: bool = False) \
        -> Tuple[StreamingState, StreamingLocate]:
    """Absorb one frame and localize over the current window.

    ``ready`` is False until the ring holds ``buffer_length`` frames
    (matching the prototype, which waits for a full deque before filtering,
    locating.py:117-143).

    ``coarse`` (static) stops the collapse at level ``skip_levels_at_top``
    instead of full resolution: the suppress-top window, heatmap, threshold,
    and CCL all run on the (T, h_c, w_c) coarse image and the bbox is
    scaled back by ``2**skip``.  At 1080p with skip=4 this removes the
    (T, 1080, 1920) collapse — ~256x less pixel work and HBM traffic for
    the localize half — at the cost of ``2**skip``-pixel bbox granularity,
    which is exactly what a re-lock drift detector needs (not the exact
    batch-calibration semantics; the fleet streaming mode uses this).
    The returned ``heatmap_u8`` is the coarse heatmap in this mode.
    """
    if frame.dtype == jnp.uint8:  # camera-native ingest (ops/dtype contract)
        frame = uint8_to_float(frame)
    new_state = streaming_absorb(state, frame, cfg)
    return new_state, _localize_window(new_state, frame.shape, frame.dtype,
                                       fps, cfg, coarse)
