"""Multi-stream (multi-kennel) monitoring: vmap over streams, shard over
chips.

BASELINE.md config 5: 64 concurrent 1080p streams.  Each stream is an
independent monitor (own ROI, own signal state), so the scaling strategy is
pure data parallelism: ``vmap`` the single-stream pipeline over a leading
stream axis and shard that axis across the mesh with ``NamedSharding`` —
XLA compiles one SPMD program per chip with zero inter-chip collectives
(SURVEY.md §2.2 table).

All streams share one compiled program, which requires common static shapes:
frames are batched (S, T, H, W) and ROI crops use one common bucket (the max
over streams, rounded to the configured bucket size).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from respmon_tpu.config import MonitorConfig
from respmon_tpu.ops import filters
from respmon_tpu.ops.dtype import ingest_frames
from respmon_tpu.parallel.mesh import stream_sharding
from respmon_tpu.pipeline import evm, motion, scan
from respmon_tpu.pipeline import bpm as bpm_mod


class BatchedLocate(NamedTuple):
    found: jnp.ndarray   # (S,) bool
    boxes: jnp.ndarray   # (S, 4) int32 x,y,w,h


@partial(jax.jit, static_argnames=("fps", "cfg"))
def locate_streams(buffers: jnp.ndarray, fps: float, cfg) -> BatchedLocate:
    """vmapped EVM calibration over (S, T, H, W)."""

    def one(buf):
        r = evm.locate(buf, fps, cfg)
        return r.found, jnp.stack([r.x, r.y, r.w, r.h])

    found, boxes = jax.vmap(one)(buffers)
    return BatchedLocate(found=found, boxes=boxes)


@partial(jax.jit, static_argnames=("spec", "coeffs", "min_dist", "cfg",
                                   "estimate_every_frame"))
def measure_clip_streams(frames: jnp.ndarray, rois: jnp.ndarray,
                         spec: motion.MeasureSpec,
                         coeffs: filters.FilterCoeffs, min_dist: int, cfg,
                         estimate_every_frame: bool = True):
    """vmapped whole-clip measurement over (S, T, H, W) + (S, 4) ROIs."""
    fn = partial(scan.measure_clip, spec=spec, coeffs=coeffs,
                 min_dist=min_dist, cfg=cfg,
                 estimate_every_frame=estimate_every_frame)
    return jax.vmap(lambda f, r: fn(f, r))(frames, rois)


class StreamStepResult(NamedTuple):
    state: motion.MeasureState     # batched (S, ...)
    samples: jnp.ndarray           # (S,)
    bpm: jnp.ndarray               # (S,)
    has_bpm: jnp.ndarray           # (S,) bool
    error: jnp.ndarray             # (S,) bool


def _monitor_step_batched(states: motion.MeasureState, frames: jnp.ndarray,
                          spec: motion.MeasureSpec,
                          coeffs: filters.FilterCoeffs, min_dist: int,
                          cfg, initialized: bool = False) -> StreamStepResult:
    def one(state, frame):
        state, sample = motion.measure_step(state, frame, spec,
                                            initialized_hint=initialized)
        res = bpm_mod.estimate_bpm(state.data, state.t, state.count,
                                   coeffs, min_dist, cfg)
        ran = state.count > cfg.initialization_length
        return state, sample, res.bpm, res.has_bpm & ran, state.error

    states, samples, bpm, has, err = jax.vmap(one)(states, frames)
    return StreamStepResult(state=states, samples=samples, bpm=bpm,
                            has_bpm=has, error=err)


@partial(jax.jit, static_argnames=("spec", "coeffs", "min_dist", "cfg",
                                   "initialized"), donate_argnums=(0,))
def monitor_step_streams(states: motion.MeasureState, frames: jnp.ndarray,
                         spec: motion.MeasureSpec,
                         coeffs: filters.FilterCoeffs, min_dist: int,
                         cfg, initialized: bool = False) -> StreamStepResult:
    """One live monitoring step for S streams at once (single-device /
    GSPMD path).  NOTE: under GSPMD sharding the vmapped ``while_loop``
    conditions reduce across ALL streams, inserting per-iteration
    all-reduces; multi-chip deployments should use
    ``make_sharded_monitor_step`` (shard_map) instead, where each chip's
    loops exit independently.

    ``initialized=True`` (static) compiles the steady-state program with no
    corner-detection branch (see motion.measure_step).

    The incoming ``states`` pytree is DONATED: every step consumes the
    previous step's output state, so XLA aliases the state outputs onto the
    input buffers instead of allocating+copying ~(S x state) HBM each call.
    Callers must not touch a states object after passing it here (rebind to
    ``result.state``, as ``MultiStreamMonitor.step`` does)."""
    return _monitor_step_batched(states, frames, spec, coeffs, min_dist,
                                 cfg, initialized)


def _monitor_step_batched_cached(states: motion.MeasureState,
                                 cache: motion.FlowCache,
                                 frames: jnp.ndarray,
                                 spec: motion.MeasureSpec,
                                 coeffs: filters.FilterCoeffs, min_dist: int,
                                 cfg, initialized: bool,
                                 cache_valid: bool):
    """Cached-LK variant of ``_monitor_step_batched``: threads the carried
    prev-frame pyramid stacks (see motion.FlowCache) so each step builds
    ONE pyramid instead of two.  Bit-identical results (tested)."""

    def one(state, cch, frame):
        state, cch, sample = motion.measure_step_cached(
            state, cch, frame, spec, initialized_hint=initialized,
            cache_valid=cache_valid)
        res = bpm_mod.estimate_bpm(state.data, state.t, state.count,
                                   coeffs, min_dist, cfg)
        ran = state.count > cfg.initialization_length
        return state, cch, sample, res.bpm, res.has_bpm & ran, state.error

    states, cache, samples, bpm, has, err = jax.vmap(one)(states, cache,
                                                          frames)
    return StreamStepResult(state=states, samples=samples, bpm=bpm,
                            has_bpm=has, error=err), cache


@partial(jax.jit, static_argnames=("spec", "coeffs", "min_dist", "cfg",
                                   "initialized", "cache_valid"),
         donate_argnums=(0, 1))
def monitor_step_streams_cached(states, cache, frames, spec, coeffs,
                                min_dist, cfg, initialized: bool = False,
                                cache_valid: bool = True):
    """Single-device / GSPMD cached fleet step (see monitor_step_streams
    for the donation/while_loop caveats — both apply here; the cache is
    donated too, so each step's stacks alias the previous step's
    buffers)."""
    return _monitor_step_batched_cached(states, cache, frames, spec,
                                        coeffs, min_dist, cfg, initialized,
                                        cache_valid)


@lru_cache(maxsize=64)
def make_sharded_monitor_step_cached(mesh: Mesh, spec: motion.MeasureSpec,
                                     coeffs: filters.FilterCoeffs,
                                     min_dist: int, cfg,
                                     axis: str = "streams",
                                     initialized: bool = False,
                                     cache_valid: bool = True):
    """shard_map-wrapped cached fleet step (collective-free, donated
    states+cache; see make_sharded_monitor_step)."""
    p = jax.sharding.PartitionSpec(axis)

    def local(states, cache, frames):
        return _monitor_step_batched_cached(states, cache, frames, spec,
                                            coeffs, min_dist, cfg,
                                            initialized, cache_valid)

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(p, p, p),
        out_specs=(p, p), check_vma=False), donate_argnums=(0, 1))


def init_fleet_cache(spec: motion.MeasureSpec, n_streams: int,
                     dtype=jnp.float32) -> motion.FlowCache:
    """Zero-filled batched (S, ...) cache placeholder for the
    ``cache_valid=False`` rebuild step."""
    base = motion.init_flow_cache(spec, dtype)
    return motion.FlowCache(stacks=tuple(
        jnp.zeros((n_streams,) + s.shape, s.dtype) for s in base.stacks))


class StreamBatchResult(NamedTuple):
    state: motion.MeasureState     # final batched (S, ...) state
    samples: jnp.ndarray           # (K, S)
    bpm: jnp.ndarray               # (K, S)
    has_bpm: jnp.ndarray           # (K, S) bool
    error: jnp.ndarray             # (K, S) bool


def _monitor_scan_batched(states: motion.MeasureState, frames: jnp.ndarray,
                          spec: motion.MeasureSpec,
                          coeffs: filters.FilterCoeffs, min_dist: int,
                          cfg, initialized: bool) -> StreamBatchResult:
    """K lockstep steps in one program: ``lax.scan`` over a (K, S, H, W)
    frame batch (adds K frames of result latency; per-frame BPM is still
    produced for every frame).

    Chained single ``step`` dispatches with deferred fetches pipeline
    dispatch against execution; prefer ``step`` unless dispatch latency
    on the target deployment dominates (not measured on the GPU yet)."""

    def body(st, fr):
        r = _monitor_step_batched(st, fr, spec, coeffs, min_dist, cfg,
                                  initialized)
        return r.state, (r.samples, r.bpm, r.has_bpm, r.error)

    states, (samples, bpm, has, err) = jax.lax.scan(body, states, frames)
    return StreamBatchResult(state=states, samples=samples, bpm=bpm,
                             has_bpm=has, error=err)


@partial(jax.jit, static_argnames=("spec", "coeffs", "min_dist", "cfg",
                                   "initialized"), donate_argnums=(0,))
def monitor_scan_streams(states, frames, spec, coeffs, min_dist, cfg,
                         initialized: bool = False) -> StreamBatchResult:
    """Single-device / GSPMD K-frame lockstep batch (see
    _monitor_scan_batched).  ``states`` is donated (see
    monitor_step_streams)."""
    return _monitor_scan_batched(states, frames, spec, coeffs, min_dist,
                                 cfg, initialized)


@lru_cache(maxsize=64)
def make_sharded_monitor_scan(mesh: Mesh, spec: motion.MeasureSpec,
                              coeffs: filters.FilterCoeffs, min_dist: int,
                              cfg, axis: str = "streams",
                              initialized: bool = False):
    """shard_map-wrapped K-frame lockstep batch (collective-free like the
    single-step program)."""
    p = jax.sharding.PartitionSpec(axis)
    pk = jax.sharding.PartitionSpec(None, axis)

    def local(states, frames):
        return _monitor_scan_batched(states, frames, spec, coeffs,
                                     min_dist, cfg, initialized)

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(p, pk),
        out_specs=StreamBatchResult(
            state=p, samples=pk, bpm=pk, has_bpm=pk, error=pk),
        check_vma=False), donate_argnums=(0,))


@lru_cache(maxsize=64)
def make_sharded_monitor_step(mesh: Mesh, spec: motion.MeasureSpec,
                              coeffs: filters.FilterCoeffs, min_dist: int,
                              cfg, axis: str = "streams",
                              initialized: bool = False):
    """shard_map-wrapped stream step: the per-chip program is completely
    local (zero collectives — each chip monitors its own kennels), so
    convergence loops on one chip never stall another."""
    p = jax.sharding.PartitionSpec(axis)

    def local(states, frames):
        return _monitor_step_batched(states, frames, spec, coeffs,
                                     min_dist, cfg, initialized)

    # check_vma=False: the step is collective-free by construction (verified
    # in tests via HLO inspection); the varying-axis analysis rejects scan
    # carries initialized from constants inside the per-shard program.
    # States are donated: each step consumes its predecessor's output (see
    # monitor_step_streams).
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(p, p),
                                 out_specs=p, check_vma=False),
                   donate_argnums=(0,))


@lru_cache(maxsize=64)
def make_sharded_locate(mesh: Mesh, fps: float, cfg,
                        axis: str = "streams"):
    """shard_map-wrapped batched calibration (locate per local stream).

    lru_cached on (mesh, fps, cfg, axis): repeated fleet
    calibrate/recalibrate calls reuse the same jitted closure, so jax's
    compile cache hits instead of re-tracing a fresh shard_map each time."""
    p = jax.sharding.PartitionSpec(axis)

    def local(buffers):
        def one(buf):
            r = evm.locate(buf, fps, cfg)
            return r.found, jnp.stack([r.x, r.y, r.w, r.h])

        found, boxes = jax.vmap(one)(buffers)
        return BatchedLocate(found=found, boxes=boxes)

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(p,),
                                 out_specs=p, check_vma=False))


# ---------------------------------------------------------------------------
# Fleet streaming-ROI re-lock: the single monitor's _streaming_roi_step at
# fleet scale.  Rolling pyramid rings are batched (S, T, h, w)
# per kept level; every fleet step absorbs all S frames in one dispatch, the
# localize half runs every streaming_interval frames with the COARSE collapse
# (pipeline/streaming.py streaming_update(coarse=True): suppress-top/heatmap/
# CCL at level skip_levels_at_top — at 1080p that removes the (T, 1080, 1920)
# collapse, ~256x less localize work, with 2**skip-px bbox granularity, which
# is what a drift detector needs), and drifted streams re-lock via batched
# motion.relock_state — tracked points and signal rings survive, so moving
# subjects never hit the error->recalibrate stall (128 frames dead time).
# ---------------------------------------------------------------------------


def init_fleet_streaming(frame_hw: Tuple[int, int], cfg, n_streams: int,
                         dtype=jnp.float32):
    """Zero-filled batched streaming rings for S streams."""
    from respmon_tpu.pipeline import streaming as streaming_mod

    base = streaming_mod.init_streaming_state(frame_hw[0], frame_hw[1],
                                              cfg, dtype)
    return streaming_mod.StreamingState(
        levels=tuple(jnp.zeros((n_streams,) + lv.shape, lv.dtype)
                     for lv in base.levels),
        count=jnp.zeros((n_streams,), jnp.int32))


@partial(jax.jit, static_argnames=("cfg",))
def init_fleet_streaming_from_buffers(buffers: jnp.ndarray, cfg):
    """Warm-start batched rings from the (S, T, H, W) calibration buffers
    (one kept-levels pass over the flattened stack — no vmap over the
    Pallas pyramid kernel)."""
    from respmon_tpu.pipeline import streaming as streaming_mod

    return streaming_mod.init_streaming_from_buffers_batch(buffers, cfg)


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def absorb_streams(sstate, frames: jnp.ndarray, cfg):
    """Absorb one (S, H, W) frame batch into the batched rings (donated —
    each step's rings alias the previous step's buffers)."""
    from respmon_tpu.pipeline import streaming as streaming_mod

    return streaming_mod.streaming_absorb_batch(sstate, frames, cfg)


def _update_streams_batched(sstate, frames, fps, cfg, coarse):
    """Batched absorb (S-stack through one pyramid pass), then the
    localize half vmapped per stream (pure XLA — vmap-safe)."""
    from respmon_tpu.pipeline import streaming as streaming_mod

    new_state = streaming_mod.streaming_absorb_batch(sstate, frames, cfg)
    hw = frames.shape[-2:]
    dtype = new_state.levels[0].dtype
    loc = jax.vmap(
        lambda st: streaming_mod._localize_window(st, hw, dtype, fps, cfg,
                                                  coarse))(new_state)
    return new_state, loc


@partial(jax.jit, static_argnames=("fps", "cfg", "coarse"),
         donate_argnums=(0,))
def update_streams(sstate, frames: jnp.ndarray, fps: float, cfg,
                   coarse: bool = True):
    """Absorb one (S, H, W) frame batch AND localize every stream over its
    rolling window."""
    return _update_streams_batched(sstate, frames, fps, cfg, coarse)


@lru_cache(maxsize=64)
def make_sharded_absorb(mesh: Mesh, cfg, axis: str = "streams"):
    from respmon_tpu.pipeline import streaming as streaming_mod

    p = jax.sharding.PartitionSpec(axis)

    def local(sstate, frames):
        return streaming_mod.streaming_absorb_batch(sstate, frames, cfg)

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(p, p),
                                 out_specs=p, check_vma=False),
                   donate_argnums=(0,))


@lru_cache(maxsize=64)
def make_sharded_update(mesh: Mesh, fps: float, cfg,
                        axis: str = "streams", coarse: bool = True):
    p = jax.sharding.PartitionSpec(axis)

    def local(sstate, frames):
        return _update_streams_batched(sstate, frames, fps, cfg, coarse)

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(p, p),
                                 out_specs=p, check_vma=False),
                   donate_argnums=(0,))


@partial(jax.jit, static_argnames=("spec",), donate_argnums=(0,))
def relock_streams(states: motion.MeasureState, frames: jnp.ndarray,
                   new_rois: jnp.ndarray, apply: jnp.ndarray,
                   spec: motion.MeasureSpec) -> motion.MeasureState:
    """Batched masked re-lock: streams where ``apply`` is True move their
    measurement window onto ``new_rois`` via motion.relock_state (tracked
    points translate with the window; signal rings persist); other streams
    keep their state bit-untouched."""
    relocked = jax.vmap(
        lambda st, f, r: motion.relock_state(st, f, r, spec))(
            states, frames, new_rois)

    def merge(cur, new):
        m = apply.reshape((-1,) + (1,) * (cur.ndim - 1))
        return jnp.where(m, new, cur)

    return jax.tree_util.tree_map(merge, states, relocked)


@lru_cache(maxsize=64)
def make_sharded_relock(mesh: Mesh, spec: motion.MeasureSpec,
                        axis: str = "streams"):
    p = jax.sharding.PartitionSpec(axis)

    def local(states, frames, new_rois, apply):
        relocked = jax.vmap(
            lambda st, f, r: motion.relock_state(st, f, r, spec))(
                states, frames, new_rois)

        def merge(cur, new):
            m = apply.reshape((-1,) + (1,) * (cur.ndim - 1))
            return jnp.where(m, new, cur)

        return jax.tree_util.tree_map(merge, states, relocked)

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(p, p, p, p),
                                 out_specs=p, check_vma=False),
                   donate_argnums=(0,))


def init_stream_states(spec: motion.MeasureSpec, rois: np.ndarray,
                       dtype=jnp.float32) -> motion.MeasureState:
    """Batched initial states from per-stream ROIs (S, 4)."""
    s = rois.shape[0]
    base = motion.init_state(spec, (0, 0, 0, 0), dtype=dtype)
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (s,) + x.shape).copy(), base)
    return batched._replace(roi=jnp.asarray(rois, jnp.int32))


def shard_streams(tree, mesh: Mesh, axis: str = "streams"):
    """Place a pytree with leading stream axes onto the mesh."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(
            x, stream_sharding(mesh, np.ndim(x), axis)), tree)


class MultiStreamMonitor:
    """Fleet monitor: S concurrent streams on a device mesh.

    The multi-kennel deployment surface (BASELINE.md config 5): calibrate
    all streams, then step frames in lockstep batches.  Per-stream error
    flags surface so the host can recalibrate individual streams (by
    re-running ``calibrate`` on fresh buffers and patching ``states.roi``).
    """

    def __init__(self, cfg: MonitorConfig, mesh: Optional[Mesh],
                 frame_hw: Tuple[int, int], fps: float,
                 dtype=jnp.float32,
                 streaming_coarse: bool = True) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.fps = float(fps)
        self.frame_hw = frame_hw
        self.dtype = dtype
        self.spec: Optional[motion.MeasureSpec] = None
        self._states: Optional[motion.MeasureState] = None
        # Fleet streaming-ROI re-lock (cfg.streaming_roi): batched rolling
        # pyramid rings + per-stream drift re-lock.  ``streaming_coarse``
        # keeps the per-interval localize at level-skip_levels_at_top
        # resolution (the fleet default; pass False for the single-stream
        # monitor's exact full-res localizer semantics at ~256x the cost
        # per 1080p update).
        self.streaming_coarse = bool(streaming_coarse)
        self._streaming = None
        self._stream_tick = 0
        self._rois: Optional[np.ndarray] = None   # host mirror (S, 4)
        self.relocks = 0
        # Fleet BPM tier (see MonitorConfig.fleet_f64_refine): unless
        # opted in, the lockstep step runs without the f64 wild-fit
        # refinement — one persistent suspect lane would otherwise make
        # EVERY step pay the emulated-f64 refit loop.
        self.measure_cfg = cfg.measure
        if not cfg.fleet_f64_refine and cfg.measure.f64_refine:
            self.measure_cfg = dataclasses.replace(cfg.measure,
                                                   f64_refine=False)
        # Carried prev-frame LK stacks (motion.FlowCache, batched (S,...));
        # None = next step compiles the rebuild variant.  Any EXTERNAL
        # assignment to .states (recalibration merges, checkpoint restore,
        # bench fixtures) invalidates it via the property setter — the
        # cache is only guaranteed consistent with states step() itself
        # produced.
        self._cache = None
        # True until every stream has taken its corner-detection step; the
        # steady-state program (the common case) then compiles without the
        # first-frame branch (batched cond executes BOTH sides).
        self._needs_init = True
        self._set_fps(fps)

    @property
    def states(self) -> Optional[motion.MeasureState]:
        return self._states

    @states.setter
    def states(self, value) -> None:
        self._states = value
        self._cache = None

    def _set_fps(self, fps: float) -> None:
        """Install ``fps`` and everything derived from it (the lowpass
        design and the peak min-distance).  The single place these formulas
        live — checkpoint restore calls it too, so a fleet restored at a
        different fps never filters/peak-picks with stale parameters."""
        self.fps = float(fps)
        cfg = self.cfg
        self.coeffs = filters.design_butter_lowpass(
            cfg.calibration.freq_max * 0.5, self.fps,
            cfg.measure.filter_order)
        self.min_dist = max(
            int(np.floor(self.fps / cfg.calibration.freq_max)), 1)

    def calibrate(self, buffers: np.ndarray) -> BatchedLocate:
        """buffers: (S, T, H, W) float in [0,1], or camera-native uint8
        (bytes ship to the device at 4x less H2D bandwidth and staging HBM;
        evm.locate widens on device).  Sets up batched measure state."""
        dev = ingest_frames(buffers, self.dtype)
        if self.mesh is not None:
            dev = shard_streams(dev, self.mesh)
            loc = make_sharded_locate(self.mesh, self.fps,
                                      self.cfg.calibration)(dev)
        else:
            loc = locate_streams(dev, self.fps, self.cfg.calibration)
        boxes = np.asarray(loc.boxes)
        wmax = int(boxes[:, 2].max(initial=1))
        hmax = int(boxes[:, 3].max(initial=1))
        self.spec = motion.MeasureSpec.for_roi(
            self.cfg, self.frame_hw[0], self.frame_hw[1], wmax, hmax,
            self.fps)
        self.states = init_stream_states(self.spec, boxes, self.dtype)
        self._needs_init = True
        if self.mesh is not None:
            self.states = shard_streams(self.states, self.mesh)
        self._rois = boxes.astype(np.int32).copy()
        if self.cfg.streaming_roi:
            rings = init_fleet_streaming_from_buffers(dev,
                                                      self.cfg.calibration)
            if self.mesh is not None:
                rings = shard_streams(rings, self.mesh)
            self._streaming = rings
            self._stream_tick = 0
        return loc

    def recalibrate(self, buffers: np.ndarray,
                    stream_mask: Optional[np.ndarray] = None
                    ) -> BatchedLocate:
        """Recalibrate a subset of streams in place (the fleet analog of the
        single monitor's error→recalibrate cycle).

        Streams where ``stream_mask`` is True (default: all) AND calibration
        found an ROI get a fresh measurement state with the new ROI; other
        streams keep their state untouched.  New ROIs are clipped to the
        fleet's common crop bucket — if a new ROI exceeds it, call
        ``calibrate`` instead (which rebuilds the compiled spec).
        """
        assert self.states is not None, "calibrate() first"
        dev = ingest_frames(buffers, self.dtype)
        if self.mesh is not None:
            dev = shard_streams(dev, self.mesh)
            loc = make_sharded_locate(self.mesh, self.fps,
                                      self.cfg.calibration)(dev)
        else:
            loc = locate_streams(dev, self.fps, self.cfg.calibration)

        boxes = np.asarray(loc.boxes).copy()
        clipped = (boxes[:, 2] > self.spec.crop_w) | \
                  (boxes[:, 3] > self.spec.crop_h)
        boxes[:, 2] = np.minimum(boxes[:, 2], self.spec.crop_w)
        boxes[:, 3] = np.minimum(boxes[:, 3], self.spec.crop_h)
        apply = np.asarray(loc.found)
        if stream_mask is not None:
            apply = apply & np.asarray(stream_mask)
        if (clipped & apply).any():
            import logging

            logging.getLogger(__name__).warning(
                "recalibrate: ROI(s) for streams %s exceed the fleet crop "
                "bucket (%dx%d) and were clipped; run calibrate() to "
                "rebuild the fleet spec if this persists",
                np.where(clipped & apply)[0].tolist(),
                self.spec.crop_w, self.spec.crop_h)

        fresh = init_stream_states(self.spec, boxes, self.dtype)
        sel = jnp.asarray(apply)

        def merge(cur, new):
            m = sel.reshape((-1,) + (1,) * (cur.ndim - 1))
            return jnp.where(m, new, cur)

        self.states = jax.tree_util.tree_map(merge, self.states, fresh)
        if self.mesh is not None:
            self.states = shard_streams(self.states, self.mesh)
        if bool(np.asarray(apply).any()):
            self._needs_init = True  # fresh streams re-detect corners
        apply_np = np.asarray(apply)
        if self._rois is not None:
            self._rois[apply_np] = boxes[apply_np].astype(np.int32)
        if self.cfg.streaming_roi and self._streaming is not None:
            # Recalibrated streams warm-start their rings from the fresh
            # buffers; others keep rolling.
            fresh_rings = init_fleet_streaming_from_buffers(
                dev, self.cfg.calibration)
            sel_rings = jnp.asarray(apply_np)

            def merge_r(cur, new):
                m = sel_rings.reshape((-1,) + (1,) * (cur.ndim - 1))
                return jnp.where(m, new, cur)

            rings = jax.tree_util.tree_map(merge_r, self._streaming,
                                           fresh_rings)
            if self.mesh is not None:
                rings = shard_streams(rings, self.mesh)
            self._streaming = rings
        # Report the boxes actually installed (clipped where applicable).
        return BatchedLocate(found=loc.found,
                             boxes=jnp.asarray(boxes, jnp.int32))

    def step(self, frames: np.ndarray) -> StreamStepResult:
        """frames: (S, H, W) — one new frame per stream.  ``uint8`` frames
        are shipped to the device as-is (4x less upload/staging HBM than
        float; crops widen to the exact u8 lattice on device, see
        motion.measure_step)."""
        assert self.states is not None, "calibrate() first"
        dev = ingest_frames(frames, self.dtype)
        initialized = not self._needs_init
        use_cache = (self.spec.method == "flow"
                     and self.spec.lk_sample in ("slices", "onehot"))
        if use_cache:
            cache = self._cache
            cache_valid = cache is not None
            if not cache_valid:
                cache = init_fleet_cache(self.spec, frames.shape[0],
                                         self.dtype)
            if self.mesh is not None:
                dev = shard_streams(dev, self.mesh)
                if not cache_valid:
                    cache = shard_streams(cache, self.mesh)
                fn = make_sharded_monitor_step_cached(
                    self.mesh, self.spec, self.coeffs, self.min_dist,
                    self.measure_cfg, initialized=initialized,
                    cache_valid=cache_valid)
                res, new_cache = fn(self._states, cache, dev)
            else:
                res, new_cache = monitor_step_streams_cached(
                    self._states, cache, dev, self.spec, self.coeffs,
                    self.min_dist, self.measure_cfg,
                    initialized=initialized, cache_valid=cache_valid)
            self._states = res.state
            self._cache = new_cache
            self._needs_init = False
            self._streaming_step(dev)
            return res
        if self.mesh is not None:
            dev = shard_streams(dev, self.mesh)
            fn = make_sharded_monitor_step(
                self.mesh, self.spec, self.coeffs, self.min_dist,
                self.measure_cfg, initialized=initialized)
            res = fn(self.states, dev)
        else:
            res = monitor_step_streams(self.states, dev, self.spec,
                                       self.coeffs, self.min_dist,
                                       self.measure_cfg,
                                       initialized=initialized)
        self.states = res.state
        self._needs_init = False
        self._streaming_step(dev)
        return res

    def _streaming_step(self, dev) -> None:
        """Per-step half of the fleet streaming-ROI mode: absorb this
        step's (S, H, W) frame batch into the rolling rings (one dispatch);
        every ``streaming_interval`` steps run the batched coarse localizer
        and re-lock drifted streams.  No-op unless cfg.streaming_roi."""
        if not self.cfg.streaming_roi or self._streaming is None:
            return
        self._stream_tick += 1
        cal = self.cfg.calibration
        if self._stream_tick % self.cfg.streaming_interval:
            if self.mesh is not None:
                self._streaming = make_sharded_absorb(self.mesh, cal)(
                    self._streaming, dev)
            else:
                self._streaming = absorb_streams(self._streaming, dev, cal)
            return
        if self.mesh is not None:
            fn = make_sharded_update(self.mesh, self.fps, cal,
                                     coarse=self.streaming_coarse)
            self._streaming, loc = fn(self._streaming, dev)
        else:
            self._streaming, loc = update_streams(
                self._streaming, dev, self.fps, cal,
                coarse=self.streaming_coarse)
        self._maybe_relock(loc, dev)

    def _maybe_relock(self, loc, dev) -> None:
        """Host drift decision + batched masked re-lock (one small fetch of
        the per-stream boxes each localize interval).  Keeps each stream's
        calibrated window SIZE (recentred on the localized bbox, clipped to
        the frame) like the single-stream monitor's re-lock."""
        found = np.asarray(loc.found)
        if not found.any():
            return
        cur = self._rois
        cx = np.asarray(loc.x) + np.asarray(loc.w) / 2.0
        cy = np.asarray(loc.y) + np.asarray(loc.h) / 2.0
        drift = np.hypot(cx - (cur[:, 0] + cur[:, 2] / 2.0),
                         cy - (cur[:, 1] + cur[:, 3] / 2.0))
        apply = found & (drift >= self.cfg.streaming_drift_px)
        if not apply.any():
            return
        h_f, w_f = self.frame_hw
        w = cur[:, 2]
        h = cur[:, 3]
        x2 = np.clip(np.round(cx - w / 2.0), 0, w_f - w).astype(np.int32)
        y2 = np.clip(np.round(cy - h / 2.0), 0, h_f - h).astype(np.int32)
        apply &= (x2 != cur[:, 0]) | (y2 != cur[:, 1])
        if not apply.any():
            return
        new_rois = np.stack([x2, y2, w, h], axis=1).astype(np.int32)
        nr = jnp.asarray(new_rois)
        ap = jnp.asarray(apply)
        if self.mesh is not None:
            nr = shard_streams(nr, self.mesh)
            ap = shard_streams(ap, self.mesh)
            states = make_sharded_relock(self.mesh, self.spec)(
                self._states, dev, nr, ap)
        else:
            states = relock_streams(self._states, dev, nr, ap, self.spec)
        # Property setter: also invalidates the carried LK cache (re-locked
        # streams re-cropped prev from the current frame).
        self.states = states
        self._rois[apply] = new_rois[apply]
        self.relocks += int(apply.sum())

    def step_many(self, frames: np.ndarray) -> StreamBatchResult:
        """frames: (K, S, H, W) — K lockstep frames per stream in ONE
        dispatch (lax.scan); per-frame outputs (samples/bpm/error) come
        back stacked (K, S).  NOTE: measured ~10% slower per frame than
        chained ``step`` calls with deferred fetches (see
        _monitor_scan_batched); use for dispatch-starved deployments or
        offline batch replay, not as the default throughput mode.  Accepts
        ``uint8`` frame batches like ``step`` (4x smaller staged batch).
        The streaming-ROI re-lock mode is serviced by ``step`` only: this
        batch path does NOT absorb frames into the rolling rings (a
        K-frame gap would break the bandpass's contiguous-window
        assumption) — fleets using streaming_roi should stay on
        ``step``."""
        assert self.states is not None, "calibrate() first"
        dev = ingest_frames(frames, self.dtype)
        initialized = not self._needs_init
        if self.mesh is not None:
            dev = jax.device_put(dev, jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec(None, "streams")))
            fn = make_sharded_monitor_scan(
                self.mesh, self.spec, self.coeffs, self.min_dist,
                self.measure_cfg, initialized=initialized)
            res = fn(self.states, dev)
        else:
            res = monitor_scan_streams(self.states, dev, self.spec,
                                       self.coeffs, self.min_dist,
                                       self.measure_cfg,
                                       initialized=initialized)
        self.states = res.state
        self._needs_init = False
        return res
