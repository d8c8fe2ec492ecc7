"""Whole-clip fast path: the entire measure loop as one ``lax.scan``.

The reference processes clips frame-by-frame in Python at 5-10 fps
(SURVEY.md §6).  Here a full clip runs in two device calls:

  1. ``evm.locate`` on the calibration buffer (one fused program), then
  2. ``measure_clip``: ``lax.scan`` of the motion step over all remaining
     frames, optionally fusing a per-frame BPM estimate (the reference runs
     its full filter+peak-fit ``measure()`` every frame, base.py:489-491) —
     yielding the per-frame sample trace, BPM trace, and final state.

This is the benchmark path (BASELINE.md: >=100x real-time at 640x480) and
the template the multi-stream vmapped pipeline (parallel/streams.py) maps
over.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from respmon_tpu.config import MonitorConfig
from respmon_tpu.ops import filters
from respmon_tpu.ops.dtype import ingest_frames
from respmon_tpu.pipeline import bpm as bpm_mod
from respmon_tpu.pipeline import evm, motion


class ClipMeasureResult(NamedTuple):
    samples: jnp.ndarray    # (T,) per-frame motion values
    t: jnp.ndarray          # (T,) time axis
    bpm: jnp.ndarray        # (T,) BPM trace (valid where has_bpm)
    has_bpm: jnp.ndarray    # (T,) bool
    error: jnp.ndarray      # (T,) bool — per-frame error flag
    final_state: motion.MeasureState


def bpm_trace(samples: jnp.ndarray, fps: float,
              coeffs: filters.FilterCoeffs, min_dist: int, cfg):
    """Per-frame BPM trace for a whole clip, computed in one batch.

    The reference re-runs its full ``measure()`` on the growing buffer every
    frame (base.py:489-491) — sequential, quadratic-ish work.  Each frame's
    estimate depends only on its sample-window prefix, not on any carried
    state, so all T estimates vectorize: build the (T, N) matrix of
    right-aligned ring windows and ``vmap`` the BPM stage over rows.  This
    replaces T sequential trust-region LM solves with one batched
    solve whose while_loop runs to the slowest lane — orders of magnitude
    less sequential depth.

    Results match the streaming monitor to float tolerance, not bit-exactly:
    the t axis here is ``arange(T)/fps`` while the monitor accumulates
    ``t[-1] + 1/fps`` (float32 accumulation drifts slightly on long clips).
    """
    t_len = samples.shape[0]
    n = cfg.buffer_length
    j = jnp.arange(n)[None, :]
    src = jnp.arange(t_len)[:, None] - (n - 1) + j
    wins = samples[jnp.clip(src, 0, t_len - 1)]
    ts = src.astype(samples.dtype) / fps          # == the monitor's t axis
    counts = jnp.minimum(jnp.arange(t_len) + 1, n)

    def one(w, tw, c):
        r = bpm_mod.estimate_bpm(w, tw, c, coeffs, min_dist, cfg)
        return r.bpm, r.has_bpm

    bpm, has = jax.vmap(one)(wins, ts, counts)
    has = has & (counts > cfg.initialization_length)
    return bpm, has


def _flow_samples_clip(crops: jnp.ndarray, mask: jnp.ndarray,
                       spec: motion.MeasureSpec):
    """Flow-mode motion samples for a whole clip.

    All per-frame heavy lifting (pyramids, Scharr, padding, im2col patch
    matrices) happens as ONE batched vmap over frames before the scan —
    clips are known upfront, so none of it needs to live on the sequential
    path.  The scan then carries only the tiny tracking state (points,
    masks, motion ring) and does window slices + Newton iterations.

    Error semantics: this is ONE calibrate→measure episode.  Once tracking
    is lost, samples stay NaN for the remainder (no corner re-detection) —
    the per-frame ``error`` flags surface where the streaming monitor would
    have entered its error state and recalibrated; callers wanting recovery
    should re-run ``process_clip`` from the loss point.
    """
    from respmon_tpu.ops import corners, lk

    t_len = crops.shape[0]
    n_ring = spec.buffer_length
    win = spec.lk.win_size[0]
    max_level = spec.lk.max_level
    u8_in = crops.dtype == jnp.uint8
    dtype = jnp.dtype(jnp.float32) if u8_in else crops.dtype

    # u8 crops are ALREADY the exact [0,255] lattice the float path's
    # trunc(f*255) reconstructs — widen and mask, skipping the roundtrip
    # (same as motion.measure_step's crop_is_u8_scale path).
    crops_u8 = jnp.where(mask, crops, 0).astype(dtype) if u8_in \
        else motion._to_u8_scale(jnp.where(mask, crops, 0.0))

    nxt_mode = spec.clip_lk_sample
    prev_mode = spec.clip_prev_sample
    inputs = jax.vmap(
        lambda c: lk.precompute_frame_inputs(
            c, win, max_level,
            with_patches=nxt_mode in ("patches", "patches16"),
            with_images=nxt_mode in ("slices", "onehot"),
            patch_dtype=jnp.bfloat16 if nxt_mode == "patches16"
            else None))(crops_u8)

    cs = corners.good_features_to_track(
        crops_u8[0], max_corners=spec.features.max_corners,
        quality_level=spec.features.quality_level,
        min_distance=spec.features.min_distance,
        block_size=spec.features.block_size, roi_mask=mask)
    first_error = cs.count < 1   # base.py:367-368

    shapes, wprimes = lk.level_geometry(spec.crop_h, spec.crop_w, win,
                                        max_level)
    shapes = tuple(shapes)
    wprimes = tuple(wprimes)

    prev_ins = jax.tree_util.tree_map(lambda a: a[:-1], inputs)
    next_ins = jax.tree_util.tree_map(lambda a: a[1:], inputs)

    def body(carry, xs):
        pts, valid, motion_xy, motion_count = carry
        prev_in, next_in = xs
        fr = lk.lk_track_precomputed(
            prev_in, next_in, pts, valid, shapes, wprimes, win, max_level,
            spec.lk.max_iters, spec.lk.epsilon, sample=nxt_mode,
            prev_sample=prev_mode)
        sample, good, motion_xy, motion_count, lost = motion.flow_update(
            fr, pts, valid, motion_xy, motion_count, n_ring, dtype)
        return (fr.pts, good, motion_xy, motion_count), (sample, lost)

    carry0 = (cs.pts, cs.valid,
              jnp.zeros((n_ring, 2), dtype), jnp.asarray(0, jnp.int32))
    (pts_f, valid_f, motion_xy_f, motion_count_f), (samples, lost) = \
        jax.lax.scan(body, carry0, (prev_ins, next_ins))

    # Frame 0: corner detection, sample 0.0 (base.py:363-369).
    samples = jnp.concatenate([jnp.zeros((1,), dtype), samples])
    errors = jnp.concatenate([first_error[None], lost])
    flow_state = dict(initialized=jnp.asarray(True),
                      prev_crop=crops_u8[-1].astype(dtype),
                      pts=pts_f, pts_valid=valid_f,
                      motion_xy=motion_xy_f, motion_count=motion_count_f)
    return samples, errors, flow_state


@partial(jax.jit, static_argnames=("spec", "coeffs", "min_dist", "cfg",
                                   "estimate_every_frame"))
def measure_clip(frames: jnp.ndarray, roi: jnp.ndarray,
                 spec: motion.MeasureSpec,
                 coeffs: filters.FilterCoeffs, min_dist: int,
                 cfg,  # MeasureConfig (hashable)
                 estimate_every_frame: bool = True) -> ClipMeasureResult:
    """Whole-clip measurement: batched crops → (parallel pixel means |
    batch-precomputed LK scan) → batched BPM trace.

    Average mode has no sequential stage at all; flow mode's scan carries
    only the tracking state.  Semantics match the streaming monitor's
    per-frame path (verified in tests/test_scan_clip.py).

    ``frames`` may be float in [0, 1] (the capture convention) OR
    camera-native ``uint8`` — the clip ships to the device as bytes (4x
    less H2D) and the ROI crop widens on device, mirroring
    ``motion.measure_step``'s u8 ingest: the flow path lands on the exact
    same u8-lattice crops (bit-identical samples); average mode sums the
    exact integer lattice and rescales once (ULP-level FP reordering vs
    the float path's per-pixel converted sum).
    """
    t_len = frames.shape[0]
    u8_in = frames.dtype == jnp.uint8
    dtype = jnp.dtype(jnp.float32) if u8_in else frames.dtype
    n_ring = spec.buffer_length
    crops, mask = motion.crop_clip_and_mask(frames, roi, spec)

    if spec.method == "average":
        vals = crops.astype(dtype) if u8_in else crops
        msum = jnp.sum(jnp.where(mask, vals, 0.0), axis=(1, 2))
        samples = msum / jnp.maximum(jnp.sum(mask), 1)
        if u8_in:
            samples = samples * (1.0 / 255.0)  # match the [0, 1] scale
        errors = jnp.zeros((t_len,), bool)
        flow_state = None
    else:
        samples, errors, flow_state = _flow_samples_clip(crops, mask, spec)

    t = jnp.arange(t_len, dtype=dtype) / spec.fps

    if estimate_every_frame:
        bpm, has = bpm_trace(samples, spec.fps, coeffs, min_dist, cfg)
    else:
        bpm = jnp.zeros_like(samples)
        has = jnp.zeros(samples.shape, bool)

    # Reconstruct the final MeasureState (for resume / API parity).
    count = jnp.minimum(jnp.asarray(t_len), n_ring)
    src = jnp.arange(n_ring) + t_len - n_ring
    ring = jnp.where(src >= 0, samples[jnp.clip(src, 0, t_len - 1)], 0.0)
    t_ring = jnp.where(src >= 0, t[jnp.clip(src, 0, t_len - 1)], 0.0)
    final = motion.init_state(spec, (0, 0, 0, 0), dtype=dtype)
    final = final._replace(roi=roi.astype(jnp.int32), data=ring,
                           t=t_ring, count=count.astype(jnp.int32),
                           error=errors[-1])
    if flow_state is not None:
        final = final._replace(**flow_state)

    return ClipMeasureResult(samples=samples, t=t, bpm=bpm, has_bpm=has,
                             error=errors, final_state=final)


class ClipRunResult(NamedTuple):
    found: bool
    roi: Optional[Tuple[int, int, int, int]]
    measure: Optional[ClipMeasureResult]
    final_bpm: Optional[float]
    # First measured frame where the streaming monitor would have entered
    # its error state (lost tracking / no keypoints), or None.  The clip
    # path does NOT recalibrate mid-clip; samples after this frame are NaN.
    error_frame: Optional[int] = None


def process_clip(frames: np.ndarray, fps: float, cfg: MonitorConfig,
                 dtype=jnp.float32,
                 estimate_every_frame: bool = True) -> ClipRunResult:
    """Calibrate on the first buffer_length frames, then scan-measure the
    rest.  Two device dispatches total (the ROI's bucketed crop shape is a
    static compile parameter, so locate's result crosses the host once).

    This is ONE calibrate→measure episode: unlike the streaming monitor it
    does not recalibrate after tracking loss — ``error_frame`` reports where
    that would have happened so callers can resume from there.

    A camera-native ``uint8`` clip ships to the device as bytes (4x less
    H2D than the float convention) and widens on device — locate and
    measure_clip both accept u8 natively."""
    cal_len = cfg.calibration.buffer_length
    assert frames.shape[0] > cal_len + 2, "clip shorter than calibration"
    # Frame 0 is consumed by the monitor's 'initialize' state before
    # buffering begins (base.py:423-425), so calibration covers frames
    # 1..cal_len.
    cal = ingest_frames(frames[1:cal_len + 1], dtype)

    loc = evm.locate(cal, float(fps), cfg.calibration)
    if not bool(loc.found):
        return ClipRunResult(found=False, roi=None, measure=None,
                             final_bpm=None)
    x, y, w, h = int(loc.x), int(loc.y), int(loc.w), int(loc.h)

    from respmon_tpu.utils.bbox import reduce_bounding_box

    x, y, w, h = reduce_bounding_box(
        x, y, w, h, cfg.calibration.maximum_bounding_box_area)

    spec = motion.MeasureSpec.for_roi(cfg, frames.shape[1], frames.shape[2],
                                      w, h, float(fps))
    coeffs = filters.design_butter_lowpass(
        cfg.calibration.freq_max * 0.5, float(fps),
        cfg.measure.filter_order)
    min_dist = max(int(np.floor(fps / cfg.calibration.freq_max)), 1)

    # The frame right after the buffer is dropped by the reference loop (it
    # arrives during the locate iteration, base.py:427-463).
    rest = ingest_frames(frames[cal_len + 2:], dtype)
    res = measure_clip(rest, jnp.asarray([x, y, w, h]), spec, coeffs,
                       min_dist, cfg.measure,
                       estimate_every_frame=estimate_every_frame)

    has = np.asarray(res.has_bpm)
    final_bpm = float(np.asarray(res.bpm)[has][-1]) if has.any() else None
    errs = np.asarray(res.error)
    error_frame = int(np.argmax(errs)) if errs.any() else None
    return ClipRunResult(found=True, roi=(x, y, w, h), measure=res,
                         final_bpm=final_bpm, error_frame=error_frame)


class ClipEpisode(NamedTuple):
    start_frame: int           # absolute clip index this episode began at
    result: ClipRunResult


class AutoClipResult(NamedTuple):
    episodes: Tuple[ClipEpisode, ...]
    final_bpm: Optional[float]     # last BPM across all episodes
    recoveries: int                # episodes begun after a tracking loss
    exhausted: bool                # stopped on max_episodes, not clip end


def process_clip_auto(frames: np.ndarray, fps: float, cfg: MonitorConfig,
                      dtype=jnp.float32, estimate_every_frame: bool = True,
                      max_episodes: int = 8,
                      error_reset_delay: float = 0.0) -> AutoClipResult:
    """Whole-clip fast path WITH the streaming monitor's error→recalibrate
    cycle (reference base.py:496-533): when an episode reports
    ``error_frame`` (tracking lost / no keypoints), calibration+measurement
    re-runs from the loss point, bounded by ``max_episodes``.

    Frame-accounting parity with the streaming monitor at
    ``error_reset_delay=0``: the error-state step consumes one frame, then
    calibration buffering restarts on the next (monitor.py error branch), so
    episode k+1 starts at ``loss_frame + 1 + round(error_reset_delay*fps)``
    — each episode's own ``process_clip`` then replays the initialize-eats-
    frame-0 and dropped-locate-frame rules.  ``found=False`` calibrations
    retry on the next ``buffer_length`` frames (the monitor's
    retry-on-no-contour path, base.py:452-454).
    """
    cal_len = cfg.calibration.buffer_length
    delay_frames = int(round(error_reset_delay * fps))
    episodes = []
    recoveries = 0
    start = 0
    n = int(frames.shape[0])
    clean_end = False
    while len(episodes) < max_episodes and n - start > cal_len + 2:
        res = process_clip(frames[start:], fps, cfg, dtype=dtype,
                           estimate_every_frame=estimate_every_frame)
        episodes.append(ClipEpisode(start_frame=start, result=res))
        if not res.found:
            # no-contour retry: buffer the next cal_len frames
            # (calibration_buffer_idx reset, base.py:452-454)
            start += cal_len
            continue
        if res.error_frame is None:
            clean_end = True
            break  # clean run to the end of the clip
        # Absolute frame of the loss: episode's measure covers
        # frames[start + cal_len + 2 :].
        lost_abs = start + cal_len + 2 + res.error_frame
        start = lost_abs + 1 + delay_frames
        recoveries += 1
    # Exhausted = stopped on the episode cap with processable clip left —
    # whether the cap was burned by error recoveries OR by found=False
    # retries; a natural end (clean run / frames ran out) is not exhausted.
    exhausted = (not clean_end and len(episodes) >= max_episodes
                 and n - start > cal_len + 2)

    final_bpm = None
    for ep in episodes:
        if ep.result.final_bpm is not None:
            final_bpm = ep.result.final_bpm
    return AutoClipResult(episodes=tuple(episodes), final_bpm=final_bpm,
                          recoveries=recoveries, exhausted=exhausted)
