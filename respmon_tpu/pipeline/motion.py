"""Per-frame motion extraction — the reference's measure-state inner loop as
a pure, scannable device function.

Reference semantics (base.py:354-407 + 464-494): crop the frame to the
calibrated ROI, then either
  - 'average': mean of the cropped pixels (base.py:355-358), or
  - 'flow': Shi-Tomasi corners on the first frame (error if none), pyramidal
    LK tracking afterwards, surviving-point bookkeeping, NaN on lost
    tracking, mean (old - new) displacement pushed to a motion buffer, and a
    full-buffer PCA first-eigenvector projection of the newest sample
    (base.py:360-407);
plus the ring-buffer discipline (popleft at capacity, base.py:473-475) and
the time axis t += 1/fps (base.py:481-484).

Design: the ROI crop is a ``lax.dynamic_slice`` into a
*statically-bucketed* window (ROI dims rounded up to ``roi_bucket`` so jit
compiles once per bucket, not per ROI) with a validity mask; the flow state
(points + masks + motion ring) lives in a NamedTuple pytree carried through
``lax.scan``; NaN-sample error detection becomes an explicit boolean flag
(the reference's ``detect_errors`` identity-checks the np.nan singleton,
which only flow-mode NaNs produce — base.py:543-545).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from respmon_tpu.config import FeatureParams, LKParams, MonitorConfig
from respmon_tpu.ops import corners, lk, pca


@dataclasses.dataclass(frozen=True)
class MeasureSpec:
    """Static (hashable) parameters of the measurement program."""

    frame_h: int
    frame_w: int
    crop_h: int                 # bucketed ROI height (static)
    crop_w: int                 # bucketed ROI width (static)
    buffer_length: int          # signal ring capacity (reference 128)
    method: str                 # 'average' | 'flow'
    fps: float
    features: FeatureParams = FeatureParams()
    lk: LKParams = LKParams()
    # LK window sampling modes (see ops/lk.py calc_optical_flow_pyr_lk).
    # 'slices' takes one contiguous dynamic slice per point and is the
    # bitwise reference; it is the default in every role because it was
    # the fastest on the GPU for both the live fleet step and the
    # whole-clip scan.  The other modes ('onehot', 'patches', 'patches16';
    # prev-window 'onehot1' for the live step, 'onehot' for the clip
    # scan) stay selectable here.
    lk_sample: str = "slices"         # live step, next window
    lk_prev_sample: str = "slices"    # live step, prev window
    clip_lk_sample: str = "slices"    # whole-clip scan, next window
    clip_prev_sample: str = "slices"  # whole-clip scan, prev window

    @staticmethod
    def bucket(dim: int, bucket: int, cap: int) -> int:
        return min(-(-dim // bucket) * bucket, cap)

    @classmethod
    def for_roi(cls, cfg: MonitorConfig, frame_h: int, frame_w: int,
                roi_w: int, roi_h: int, fps: float,
                lk_sample: str = "slices") -> "MeasureSpec":
        return cls(frame_h=frame_h, frame_w=frame_w,
                   crop_h=cls.bucket(roi_h, cfg.roi_bucket, frame_h),
                   crop_w=cls.bucket(roi_w, cfg.roi_bucket, frame_w),
                   buffer_length=cfg.measure.buffer_length,
                   method=cfg.motion_extraction_method, fps=fps,
                   features=cfg.features, lk=cfg.lk, lk_sample=lk_sample)


class MeasureState(NamedTuple):
    """Device-side measurement state (a pytree scanned over frames)."""

    # Signal ring buffers (right-aligned, newest last).
    data: jnp.ndarray          # (N,)
    t: jnp.ndarray             # (N,)
    count: jnp.ndarray         # int32 valid samples
    # ROI (dynamic so one compiled program serves any ROI of this bucket).
    roi: jnp.ndarray           # (4,) int32: x, y, w, h
    # Flow state.
    initialized: jnp.ndarray   # bool — corners detected yet
    prev_crop: jnp.ndarray     # (crop_h, crop_w) uint8-scale float
    pts: jnp.ndarray           # (max_corners, 2) float32 crop coords
    pts_valid: jnp.ndarray     # (max_corners,) bool
    motion_xy: jnp.ndarray     # (N, 2) mean-displacement ring
    motion_count: jnp.ndarray  # int32
    # Error channel (the NaN-singleton detect_errors analog).
    error: jnp.ndarray         # bool — tracking lost / no keypoints


def init_state(spec: MeasureSpec, roi: Tuple[int, int, int, int],
               dtype=jnp.float32) -> MeasureState:
    n = spec.buffer_length
    m = spec.features.max_corners
    return MeasureState(
        data=jnp.zeros((n,), dtype),
        t=jnp.zeros((n,), dtype),
        count=jnp.asarray(0, jnp.int32),
        roi=jnp.asarray(roi, jnp.int32),
        initialized=jnp.asarray(False),
        prev_crop=jnp.zeros((spec.crop_h, spec.crop_w), dtype),
        pts=jnp.zeros((m, 2), jnp.float32),
        pts_valid=jnp.zeros((m,), bool),
        motion_xy=jnp.zeros((n, 2), dtype),
        motion_count=jnp.asarray(0, jnp.int32),
        error=jnp.asarray(False),
    )


def _roi_window_mask(roi: jnp.ndarray, spec: MeasureSpec):
    """Clamped window start + validity mask for a bucketed ROI crop.
    dynamic_slice clamps the start to fit, so the ROI may sit at an offset
    inside the window; the mask accounts for it."""
    x, y, w, h = roi[0], roi[1], roi[2], roi[3]
    sx = jnp.clip(x, 0, spec.frame_w - spec.crop_w)
    sy = jnp.clip(y, 0, spec.frame_h - spec.crop_h)
    dx = x - sx
    dy = y - sy
    rows = jnp.arange(spec.crop_h)[:, None]
    cols = jnp.arange(spec.crop_w)[None, :]
    mask = (rows >= dy) & (rows < dy + h) & (cols >= dx) & (cols < dx + w)
    return (sy, sx), mask, (dx, dy)


def _crop_and_mask(frame: jnp.ndarray, roi: jnp.ndarray, spec: MeasureSpec):
    """Bucketed ROI crop of a single frame."""
    (sy, sx), mask, offs = _roi_window_mask(roi, spec)
    crop = jax.lax.dynamic_slice(frame, (sy, sx), (spec.crop_h, spec.crop_w))
    return crop, mask, offs


def crop_clip_and_mask(frames: jnp.ndarray, roi: jnp.ndarray,
                       spec: MeasureSpec):
    """Bucketed ROI crop of a whole (T, H, W) clip in ONE dynamic slice
    (the ROI is fixed for the clip)."""
    (sy, sx), mask, _ = _roi_window_mask(roi, spec)
    zero = jnp.zeros((), sy.dtype)
    crops = jax.lax.dynamic_slice(
        frames, (zero, sy, sx),
        (frames.shape[0], spec.crop_h, spec.crop_w))
    return crops, mask


def _to_u8_scale(img: jnp.ndarray) -> jnp.ndarray:
    """float [0,1] -> float on the uint8 [0,255] lattice (the reference runs
    corners/LK on float_to_uint8 crops, base.py:364-371)."""
    return jnp.trunc(img * 255.0)


def _push(ring: jnp.ndarray, value) -> jnp.ndarray:
    return jnp.concatenate([ring[1:], jnp.reshape(
        jnp.asarray(value, ring.dtype), (1,) + ring.shape[1:])], axis=0)


def measure_step(state: MeasureState, frame: jnp.ndarray,
                 spec: MeasureSpec,
                 initialized_hint: bool = False
                 ) -> Tuple[MeasureState, jnp.ndarray]:
    """One frame of the measure state: crop -> motion value -> ring push.

    Returns (new_state, sample).  ``new_state.error`` reports the reference's
    error triggers (no keypoints at init / NaN from lost tracking).

    ``initialized_hint`` (static) promises every batched state already has
    ``initialized=True`` so the compiled program can omit the first-frame
    corner-detection branch entirely.  This matters for vmapped fleets:
    batched ``lax.cond`` lowers to a select that executes BOTH branches, so
    without the hint Shi-Tomasi runs over every stream's crop every step.

    ``frame`` may be float in [0, 1] (the capture convention) OR native
    ``uint8`` (camera bytes shipped to the device untouched — 4x less
    upload/staging HBM).  The u8 path crops the u8 frame then widens the
    crop to float on the exact [0, 255] integer lattice, which is
    precisely what the reference's cv2 kernels consume (base.py:364-371)
    — it SKIPS the float path's ``trunc(f * 255)`` reconstruction, so
    both ingests land on identical u8-lattice crops.
    """
    crop, mask, _ = _crop_and_mask(frame, state.roi, spec)
    u8_in = frame.dtype == jnp.uint8
    dtype = state.data.dtype
    if u8_in:
        crop = crop.astype(dtype)          # exact [0, 255] lattice

    if spec.method == "average":
        total = jnp.sum(jnp.where(mask, crop, 0))
        sample = total / jnp.maximum(jnp.sum(mask), 1)
        if u8_in:
            sample = sample * (1.0 / 255.0)   # match the [0, 1] float scale
        new_state = state
        error = state.error
    else:
        sample, new_state, error = _flow_motion(state, crop, mask, spec,
                                                initialized_hint,
                                                crop_is_u8_scale=u8_in)

    t_next = jnp.where(state.count == 0, 0.0,
                       state.t[-1] + 1.0 / spec.fps)
    new_state = new_state._replace(
        data=_push(state.data, sample),
        t=_push(state.t, t_next),
        count=jnp.minimum(state.count + 1, spec.buffer_length),
        error=error,
    )
    return new_state, sample


@partial(jax.jit, static_argnames=("spec",))
def relock_state(state: MeasureState, frame: jnp.ndarray,
                 new_roi: jnp.ndarray, spec: MeasureSpec) -> MeasureState:
    """Move a measurement state onto a new ROI without losing tracking
    (the streaming-ROI monitor mode's re-lock step; no reference analog —
    the reference can only recalibrate from scratch).

    The crop window shifts with the ROI, so tracked points are translated
    by the window-origin delta (they keep referencing the same physical
    pixels) and ``prev_crop`` is re-cropped from the CURRENT frame at the
    new window so the next LK step sees a consistent prev/next pair.
    Points that leave the new window are invalidated; if none survive,
    ``initialized`` drops so the next measure step re-detects corners on
    the new crop (no error state — the signal rings persist).

    ``frame`` accepts float [0,1] or camera-native uint8 like
    ``measure_step``."""
    (sy_old, sx_old), _, _ = _roi_window_mask(state.roi, spec)
    new_roi = new_roi.astype(jnp.int32)
    crop, mask, _ = _crop_and_mask(frame, new_roi, spec)
    if frame.dtype == jnp.uint8:
        crop_u8 = jnp.where(mask, crop, 0).astype(state.prev_crop.dtype)
    else:
        crop_u8 = _to_u8_scale(jnp.where(mask, crop, 0.0)) \
            .astype(state.prev_crop.dtype)
    (sy_new, sx_new), _, _ = _roi_window_mask(new_roi, spec)
    shift = jnp.stack([sx_old - sx_new, sy_old - sy_new]) \
        .astype(state.pts.dtype)
    pts = state.pts + shift[None, :]
    inb = (pts[:, 0] >= 0) & (pts[:, 0] <= spec.crop_w - 1) & \
          (pts[:, 1] >= 0) & (pts[:, 1] <= spec.crop_h - 1)
    valid = state.pts_valid & inb
    return state._replace(
        roi=new_roi, prev_crop=crop_u8, pts=pts, pts_valid=valid,
        initialized=state.initialized & (jnp.sum(valid) > 0))


class FlowCache(NamedTuple):
    """Carried LK frame structures of the PREVIOUS frame (fleet fast path).

    ``measure_step`` rebuilds the prev frame's pyramid + Scharr + padding
    from ``state.prev_crop`` every step — but the previous step already
    computed that exact pyramid for the same image in its *next* role.
    Carrying the per-level padded (image, dx, dy) stacks between steps
    (donated, so the carry is an in-place alias, ~2.3 MB/stream at
    256x448 crops) removes one full pyramid+pad build per step,
    bit-identically: the stacks are a deterministic function of the same
    crop values ``prev_crop`` stores, and the padded next-role images are
    channel 0 of the same stacks (`tests/test_parallel.py` pins
    step-for-step bitwise equality with the uncached path).
    """

    stacks: Tuple[jnp.ndarray, ...]   # per-level (3, Hp, Wp), prev frame


def init_flow_cache(spec: MeasureSpec, dtype=jnp.float32) -> FlowCache:
    """Zero-filled cache with the right static shapes (jit placeholder for
    the ``cache_valid=False`` program variant, which ignores the values and
    rebuilds from ``state.prev_crop``)."""
    from respmon_tpu.ops import lk

    win = spec.lk.win_size[0]
    shapes, _ = lk.level_geometry(spec.crop_h, spec.crop_w, win,
                                  spec.lk.max_level)
    pad = 2 * (win + 2)
    return FlowCache(stacks=tuple(
        jnp.zeros((3, h + pad, w + pad), dtype) for h, w in shapes))


def measure_step_cached(state: MeasureState, cache: FlowCache,
                        frame: jnp.ndarray, spec: MeasureSpec,
                        initialized_hint: bool = False,
                        cache_valid: bool = True
                        ) -> Tuple[MeasureState, FlowCache, jnp.ndarray]:
    """``measure_step`` with the carried prev-frame LK cache (flow mode).

    Bit-identical to ``measure_step`` (same pixels, same FP order — the
    cache holds exactly what the uncached path recomputes), one pyramid
    build cheaper per step.  ``cache_valid=False`` (static) compiles the
    rebuild variant: prev structures come from ``state.prev_crop`` (the
    first step after calibrate/restore, where no prior step populated the
    cache); the returned cache is valid either way.

    Only flow mode with O(points)-memory sampling ('slices'/'onehot' — the
    live modes) benefits; average mode and the patches modes (which need
    im2col matrices the cache doesn't carry) fall back to the uncached
    step and return the cache untouched.
    """
    if spec.method != "flow" or spec.lk_sample not in ("slices", "onehot"):
        new_state, sample = measure_step(state, frame, spec,
                                         initialized_hint)
        return new_state, cache, sample

    crop, mask, _ = _crop_and_mask(frame, state.roi, spec)
    u8_in = frame.dtype == jnp.uint8
    dtype = state.data.dtype
    if u8_in:
        crop = crop.astype(dtype)          # exact [0, 255] lattice

    sample, new_state, new_cache, error = _flow_motion_cached(
        state, cache, crop, mask, spec, initialized_hint,
        crop_is_u8_scale=u8_in, cache_valid=cache_valid)

    t_next = jnp.where(state.count == 0, 0.0,
                       state.t[-1] + 1.0 / spec.fps)
    new_state = new_state._replace(
        data=_push(state.data, sample),
        t=_push(state.t, t_next),
        count=jnp.minimum(state.count + 1, spec.buffer_length),
        error=error,
    )
    return new_state, new_cache, sample


def _flow_motion_cached(state: MeasureState, cache: FlowCache, crop, mask,
                        spec: MeasureSpec, initialized_hint: bool,
                        crop_is_u8_scale: bool, cache_valid: bool):
    from respmon_tpu.ops import corners, lk

    crop_u8 = jnp.where(mask, crop, 0) if crop_is_u8_scale \
        else _to_u8_scale(jnp.where(mask, crop, 0.0))
    crop_u8 = crop_u8.astype(state.prev_crop.dtype)

    win = spec.lk.win_size[0]
    max_level = spec.lk.max_level
    # One build serves both roles this step: channel 0 of each stack IS the
    # padded next-role image, and the full stacks are next step's prev.
    cur = lk.precompute_frame_inputs(crop_u8, win, max_level,
                                     with_patches=False)
    new_cache = FlowCache(stacks=cur.stacks)
    shapes, wprimes = lk.level_geometry(spec.crop_h, spec.crop_w, win,
                                        max_level)

    def first_frame(state):
        cs = corners.good_features_to_track(
            crop_u8, max_corners=spec.features.max_corners,
            quality_level=spec.features.quality_level,
            min_distance=spec.features.min_distance,
            block_size=spec.features.block_size, roi_mask=mask)
        err = cs.count < 1  # "No motion key points found" (base.py:367-368)
        new = state._replace(initialized=jnp.asarray(True),
                             prev_crop=crop_u8,
                             pts=cs.pts, pts_valid=cs.valid)
        return jnp.asarray(0.0, crop.dtype), new, err

    def track_frame(state):
        if cache_valid:
            prev_ins = lk.LKFrameInputs(stacks=cache.stacks, patches=(),
                                        images=())
        else:
            prev_ins = lk.precompute_frame_inputs(
                state.prev_crop, win, max_level, with_patches=False)
        nxt_ins = lk.LKFrameInputs(
            stacks=(), patches=(),
            images=tuple(s[0] for s in cur.stacks))
        fr = lk.lk_track_precomputed(
            prev_ins, nxt_ins, state.pts, state.pts_valid,
            tuple(shapes), tuple(wprimes), win, max_level,
            spec.lk.max_iters, spec.lk.epsilon, sample=spec.lk_sample,
            prev_sample=spec.lk_prev_sample)
        sample, good, motion_xy, motion_count, lost = flow_update(
            fr, state.pts, state.pts_valid, state.motion_xy,
            state.motion_count, spec.buffer_length, crop.dtype)
        new = state._replace(
            prev_crop=crop_u8,
            pts=fr.pts, pts_valid=good,
            motion_xy=motion_xy, motion_count=motion_count)
        return sample, new, lost

    if initialized_hint:
        sample, new_state, error = track_frame(state)
    else:
        sample, new_state, error = jax.lax.cond(
            state.initialized, track_frame, first_frame, state)
    return sample, new_state, new_cache, error


def flow_update(fr, pts, valid, motion_xy, motion_count,
                buffer_length: int, dtype):
    """Shared post-LK bookkeeping (base.py:377-407): surviving-point
    selection, mean (old - new) displacement, motion-ring push, PCA
    projection, NaN on lost tracking.  Used by both the streaming step and
    the whole-clip scan so the two paths cannot desynchronize.

    Returns (sample, good_mask, motion_xy, motion_count, lost).
    """
    good = fr.status & valid
    n_good = jnp.sum(good)
    lost = n_good == 0   # -> NaN sample (base.py:373-386)

    disp = pts - fr.pts  # old - new (base.py:388)
    gw = good.astype(dtype)[:, None]
    mean_disp = jnp.sum(disp * gw, axis=0) / \
        jnp.maximum(n_good, 1).astype(dtype)

    motion_xy = jnp.where(
        lost, motion_xy,
        jnp.concatenate([motion_xy[1:], mean_disp[None].astype(
            motion_xy.dtype)], axis=0))
    motion_count = jnp.where(
        lost, motion_count, jnp.minimum(motion_count + 1, buffer_length))

    # PCA projection of the newest sample once >= 2 motions buffered
    # (base.py:396-407); before that the sample is 0.0.
    mmask = jnp.arange(buffer_length) >= (buffer_length - motion_count)
    proj = pca.pca_project_last(motion_xy, mmask)
    sample = jnp.where(motion_count >= 2, proj, 0.0)
    sample = jnp.where(lost, jnp.nan, sample).astype(dtype)
    return sample, good, motion_xy, motion_count, lost


def _flow_motion(state: MeasureState, crop, mask, spec: MeasureSpec,
                 initialized_hint: bool = False,
                 crop_is_u8_scale: bool = False):
    crop_u8 = jnp.where(mask, crop, 0) if crop_is_u8_scale \
        else _to_u8_scale(jnp.where(mask, crop, 0.0))

    def first_frame(state):
        cs = corners.good_features_to_track(
            crop_u8, max_corners=spec.features.max_corners,
            quality_level=spec.features.quality_level,
            min_distance=spec.features.min_distance,
            block_size=spec.features.block_size, roi_mask=mask)
        err = cs.count < 1  # "No motion key points found" (base.py:367-368)
        new = state._replace(initialized=jnp.asarray(True),
                             prev_crop=crop_u8.astype(state.prev_crop.dtype),
                             pts=cs.pts, pts_valid=cs.valid)
        return jnp.asarray(0.0, crop.dtype), new, err

    def track_frame(state):
        fr = lk.calc_optical_flow_pyr_lk(
            state.prev_crop, crop_u8.astype(state.prev_crop.dtype),
            state.pts, state.pts_valid,
            win=spec.lk.win_size[0], max_level=spec.lk.max_level,
            max_iters=spec.lk.max_iters, eps=spec.lk.epsilon,
            sample=spec.lk_sample, prev_sample=spec.lk_prev_sample)
        # prev windows: 'slices' (bitwise reference) or 'onehot1' (matmul
        # throughput mode; exact pixels but ulp-level bilinear drift under
        # different XLA fusion — same caveat as _window_onehot3, which
        # stays reserved for the whole-clip scan where both compared
        # paths use it consistently).
        sample, good, motion_xy, motion_count, lost = flow_update(
            fr, state.pts, state.pts_valid, state.motion_xy,
            state.motion_count, spec.buffer_length, crop.dtype)

        new = state._replace(
            prev_crop=crop_u8.astype(state.prev_crop.dtype),
            pts=fr.pts, pts_valid=good,
            motion_xy=motion_xy, motion_count=motion_count)
        return sample, new, lost

    if initialized_hint:
        return track_frame(state)
    return jax.lax.cond(state.initialized, track_frame, first_frame, state)
