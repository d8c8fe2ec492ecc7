"""Multi-chip tests on the virtual 8-device CPU mesh (SURVEY.md §4):
stream-axis data parallelism and width-sharded halo-exchange pyramids."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig, MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.ops.pyramid import pyr_down
from respmon_tpu.parallel import streams as streams_mod
from respmon_tpu.parallel.mesh import make_mesh
from respmon_tpu.parallel.spatial import pyr_down_w_sharded

FPS = 10.0
SMALL_CFG = MonitorConfig(
    calibration=CalibrationConfig(buffer_length=32, pyramid_levels=4,
                                  skip_levels_at_top=1))
FLOW_CFG = MonitorConfig(
    motion_extraction_method="flow", calibration=SMALL_CFG.calibration)


def _stream_clips(s, t, seed0=0, bpms=None):
    bpms = bpms or [18.0] * s
    # Strong, low-noise patches: a 32-frame calibration buffer holds only
    # ~1 breathing cycle, so weak signals make EVM localization fragile
    # (in the reference just as much as here).
    return np.stack([
        breathing_clip(num_frames=t, height=60, width=80, fps=FPS,
                       bpm=bpms[i], patch_center=(30, 40),
                       patch_size=(16, 20), amplitude=0.25, noise=0.002,
                       seed=seed0 + i)
        for i in range(s)])


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_pyr_down_w_sharded_matches_single_device():
    mesh = make_mesh(axis_names=("space",))
    rng = np.random.default_rng(0)
    x = rng.random((48, 64)).astype(np.float32)
    got = np.asarray(pyr_down_w_sharded(jnp.asarray(x), mesh, axis="space"))
    want = np.asarray(pyr_down(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_locate_streams_sharded_matches_per_stream():
    from respmon_tpu.pipeline import evm

    mesh = make_mesh(axis_names=("streams",))
    clips = _stream_clips(8, 32)
    dev = streams_mod.shard_streams(jnp.asarray(clips), mesh)
    res = streams_mod.locate_streams(dev, FPS, SMALL_CFG.calibration)
    assert bool(np.asarray(res.found).all())
    for i in range(8):
        single = evm.locate(jnp.asarray(clips[i]), FPS,
                            SMALL_CFG.calibration)
        np.testing.assert_array_equal(
            np.asarray(res.boxes[i]),
            [int(single.x), int(single.y), int(single.w), int(single.h)])


def test_multistream_monitor_end_to_end():
    mesh = make_mesh(axis_names=("streams",))
    bpms = [15.0, 18.0, 21.0, 24.0] * 2
    total = 32 + 90
    clips = _stream_clips(8, total, bpms=bpms)

    mon = streams_mod.MultiStreamMonitor(SMALL_CFG, mesh, (60, 80), FPS)
    loc = mon.calibrate(clips[:, :32])
    assert bool(np.asarray(loc.found).all())

    last_bpm = np.full(8, np.nan)
    for f in range(33, total):
        res = mon.step(clips[:, f])
        has = np.asarray(res.has_bpm)
        bpm = np.asarray(res.bpm)
        last_bpm[has] = bpm[has]

    assert np.isfinite(last_bpm).all(), f"streams without BPM: {last_bpm}"
    np.testing.assert_allclose(last_bpm, bpms, atol=1.0)


def test_stream_axis_sharding_is_collective_free():
    # The shard_map stream step must contain no cross-device collectives
    # (pure data parallelism, SURVEY.md §2.2) — in particular no
    # per-iteration all-reduce from batched while_loop conditions, which
    # GSPMD would insert.
    from respmon_tpu.ops import filters
    from respmon_tpu.pipeline import motion

    mesh = make_mesh(axis_names=("streams",))
    cfg = SMALL_CFG
    spec = motion.MeasureSpec.for_roi(cfg, 60, 80, 20, 16, FPS)
    rois = np.tile([30, 22, 20, 16], (8, 1))
    states = streams_mod.init_stream_states(spec, rois)
    states = streams_mod.shard_streams(states, mesh)
    frames = streams_mod.shard_streams(
        jnp.zeros((8, 60, 80), jnp.float32), mesh)
    coeffs = filters.design_butter_lowpass(0.5, FPS, 3)

    step = streams_mod.make_sharded_monitor_step(mesh, spec, coeffs, 10,
                                                 cfg.measure)
    hlo = step.lower(states, frames).compile().as_text()
    for coll in ("all-reduce", "all-gather", "collective-permute",
                 "all-to-all"):
        assert coll not in hlo, f"unexpected collective {coll} in HLO"


def test_recalibrate_subset_of_streams():
    mesh = make_mesh(axis_names=("streams",))
    clips = _stream_clips(8, 40)
    mon = streams_mod.MultiStreamMonitor(SMALL_CFG, mesh, (60, 80), FPS)
    mon.calibrate(clips[:, :32])
    # Advance a few steps so states diverge from fresh.
    for f in range(33, 38):
        mon.step(clips[:, f])
    counts_before = np.asarray(mon.states.count).copy()
    rois_before = np.asarray(mon.states.roi).copy()

    # Recalibrate only streams 0 and 3 with shifted-patch buffers.
    new_clips = _stream_clips(8, 32, seed0=100)
    mask = np.zeros(8, bool)
    mask[[0, 3]] = True
    loc = mon.recalibrate(new_clips, stream_mask=mask)
    assert bool(np.asarray(loc.found)[[0, 3]].all())

    counts_after = np.asarray(mon.states.count)
    rois_after = np.asarray(mon.states.roi)
    # Recalibrated streams reset; others untouched.
    assert (counts_after[[0, 3]] == 0).all()
    np.testing.assert_array_equal(counts_after[[1, 2, 4, 5, 6, 7]],
                                  counts_before[[1, 2, 4, 5, 6, 7]])
    np.testing.assert_array_equal(rois_after[[1, 2, 4, 5, 6, 7]],
                                  rois_before[[1, 2, 4, 5, 6, 7]])
    # Stepping still works after the patch.
    res = mon.step(clips[:, 38])
    assert np.asarray(res.samples).shape == (8,)


# Per-stream subject drifts for the fleet streaming tests.  All streams
# share background seed 0: EVM localization under the suppress-top quirk is
# background-seed-sensitive for small off-center patches (several seeds
# localize a spurious corner box — in the reference just as much as here),
# and the test's subject is the re-lock machinery, not localizer robustness.
_FLEET_DRIFTS = [(14.0, 24.0), (12.0, 20.0), (10.0, 26.0), (14.0, 18.0),
                 (16.0, 22.0), (12.0, 26.0), (10.0, 20.0), (16.0, 26.0)]


def _drifting_fleet(s, n, t, method="average", mesh=None):
    import dataclasses

    cal = CalibrationConfig(buffer_length=t, pyramid_levels=4,
                            skip_levels_at_top=1)
    cfg = dataclasses.replace(
        SMALL_CFG, calibration=cal, streaming_roi=True,
        streaming_interval=4, streaming_drift_px=2.0,
        motion_extraction_method=method)
    # bpm 37.5 at 10 fps = one full period per 16-frame window (phase-
    # stable bandpass energy; same geometry as the single-stream streaming
    # tests in test_streaming_checkpoint_faults.py).
    clips = np.stack([
        breathing_clip(num_frames=n, height=60, width=80, fps=FPS,
                       bpm=37.5, patch_center=(20, 24),
                       patch_size=(14, 18), amplitude=0.3,
                       drift_px=_FLEET_DRIFTS[i], noise=0.002,
                       motion_px=1.5 if method == "flow" else 0.0,
                       texture_motion=method == "flow", seed=0)
        for i in range(s)])
    mon = streams_mod.MultiStreamMonitor(cfg, mesh, (60, 80), FPS)
    loc = mon.calibrate(clips[:, :t])
    assert bool(np.asarray(loc.found).all())
    return mon, clips


def test_fleet_streaming_relock_follows_moving_subjects():
    # The fleet analog of the monitor's streaming-ROI
    # re-lock — drifting subjects must be followed via batched coarse
    # localization + masked relock_streams, never the error-reset stall.
    n = 96
    s = 8
    mon, clips = _drifting_fleet(s, n, 16,
                                 mesh=make_mesh(axis_names=("streams",)))
    errors = 0
    for f in range(17, n):
        res = mon.step(clips[:, f])
        errors += int(np.asarray(res.error).sum())
    assert errors == 0
    assert mon.relocks >= s, f"only {mon.relocks} re-locks across the fleet"
    # Every stream's final window contains its subject's final center
    # (the initial calibrated box would have lost it).
    for i in range(s):
        ty = 20.0 + _FLEET_DRIFTS[i][0]
        tx = 24.0 + _FLEET_DRIFTS[i][1]
        x, y, w, h = mon._rois[i]
        assert x <= tx <= x + w, (i, x, w, tx)
        assert y <= ty <= y + h, (i, y, h, ty)
    # Device states agree with the host ROI mirror.
    np.testing.assert_array_equal(np.asarray(mon.states.roi), mon._rois)


def test_fleet_streaming_relock_preserves_flow_tracking():
    # Re-locks translate tracked points with the window (batched
    # relock_state): flow tracking must survive without NaN samples.
    n = 80
    mon, clips = _drifting_fleet(3, n, 16, method="flow")
    samples = []
    for f in range(17, n):
        res = mon.step(clips[:, f])
        samples.append(np.asarray(res.samples))
        assert not np.asarray(res.error).any()
    assert mon.relocks >= 1
    assert np.isfinite(np.asarray(samples)).all(), \
        "tracking lost across a fleet re-lock"


def test_streaming_update_coarse_tracks_exact():
    # The coarse localizer (collapse stopped at skip_levels_at_top) must
    # agree with the exact full-res localizer to within its granularity
    # (2**skip px per edge) on a clean scene.
    from respmon_tpu.pipeline import streaming

    cal = CalibrationConfig(buffer_length=16, pyramid_levels=4,
                            skip_levels_at_top=1)
    clip = breathing_clip(num_frames=16, height=60, width=80, fps=FPS,
                          bpm=37.5, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.3, noise=0.0)
    s_exact = streaming.init_streaming_state(60, 80, cal)
    s_coarse = streaming.init_streaming_state(60, 80, cal)
    for i in range(16):
        f = jnp.asarray(clip[i])
        s_exact, r_exact = streaming.streaming_update(s_exact, f, FPS, cal)
        s_coarse, r_coarse = streaming.streaming_update(s_coarse, f, FPS,
                                                        cal, coarse=True)
    assert bool(r_exact.found) and bool(r_coarse.found)
    g = 2 ** cal.skip_levels_at_top
    cx_e = float(r_exact.x) + float(r_exact.w) / 2
    cy_e = float(r_exact.y) + float(r_exact.h) / 2
    cx_c = float(r_coarse.x) + float(r_coarse.w) / 2
    cy_c = float(r_coarse.y) + float(r_coarse.h) / 2
    assert abs(cx_e - cx_c) <= 2 * g and abs(cy_e - cy_c) <= 2 * g, \
        ((cx_e, cy_e), (cx_c, cy_c))


def test_fleet_compiled_programs_are_cached():
    # Repeated fleet calibrations/steps must NOT rebuild (and thus
    # recompile) the shard_map closures: the factories are lru_cached so
    # identical arguments return the identical jitted callable.
    from respmon_tpu.ops import filters
    from respmon_tpu.parallel.spatial import _make_pyr_down_w_sharded
    from respmon_tpu.pipeline import motion

    mesh = make_mesh(axis_names=("streams",))
    cfg = SMALL_CFG
    f1 = streams_mod.make_sharded_locate(mesh, FPS, cfg.calibration)
    f2 = streams_mod.make_sharded_locate(mesh, FPS, cfg.calibration)
    assert f1 is f2

    spec = motion.MeasureSpec.for_roi(cfg, 60, 80, 20, 16, FPS)
    coeffs = filters.design_butter_lowpass(0.5, FPS, 3)
    s1 = streams_mod.make_sharded_monitor_step(mesh, spec, coeffs, 10,
                                               cfg.measure)
    s2 = streams_mod.make_sharded_monitor_step(mesh, spec, coeffs, 10,
                                               cfg.measure)
    assert s1 is s2

    mesh_sp = make_mesh(axis_names=("space",))
    p1 = _make_pyr_down_w_sharded(mesh_sp, "space", 2, 8)
    p2 = _make_pyr_down_w_sharded(mesh_sp, "space", 2, 8)
    assert p1 is p2

    # End-to-end: two recalibrations on a live fleet reuse the cached
    # locate program (the jit compile-cache keeps hitting).
    clips = _stream_clips(8, 32)
    mon = streams_mod.MultiStreamMonitor(cfg, mesh, (60, 80), FPS)
    mon.calibrate(clips[:, :32])
    misses0 = f1._cache_size()
    mon.recalibrate(clips)
    mon.recalibrate(clips)
    assert f1._cache_size() == misses0, "recalibrate recompiled locate"


def test_iir_temporal_filter_config():
    # The reference's pluggable temporal filter (transforms.py:146): the IIR
    # variant must localize the same synthetic patch.
    import dataclasses

    from respmon_tpu.pipeline import evm
    import jax.numpy as jnp

    cfg = dataclasses.replace(SMALL_CFG.calibration, temporal_filter="iir")
    clip = _stream_clips(1, 32)[0]
    res = evm.locate(jnp.asarray(clip), FPS, cfg)
    assert bool(res.found)
    assert res.x <= 40 <= res.x + res.w
    assert res.y <= 30 <= res.y + res.h


def test_locate_tsharded_matches_single_device():
    # Sequence parallelism (SURVEY §2.2 SP): calibration buffer sharded
    # along T over all 8 devices; bandpass via reduce-scatter matmul;
    # result must match the unsharded locate.
    from respmon_tpu.parallel.temporal import locate_tsharded
    from respmon_tpu.pipeline import evm

    mesh = make_mesh(axis_names=("time",))
    clip = _stream_clips(1, 32)[0]
    vid = jnp.asarray(clip, jnp.float32)

    want = evm.locate(vid, FPS, SMALL_CFG.calibration)
    got = locate_tsharded(vid, mesh, FPS, SMALL_CFG.calibration)

    assert bool(got.found) == bool(want.found)
    assert (int(got.x), int(got.y), int(got.w), int(got.h)) == \
        (int(want.x), int(want.y), int(want.w), int(want.h))
    # Heatmaps agree to quantization (reductions reassociate across shards).
    assert np.abs(np.asarray(got.heatmap_u8, np.int32)
                  - np.asarray(want.heatmap_u8, np.int32)).max() <= 1
    np.testing.assert_array_equal(np.asarray(got.thresh) > 0,
                                  np.asarray(want.thresh) > 0)


def test_locate_tsharded_nondivisible_t_matches_single_device():
    # BASELINE config 3 geometry: buffer lengths not divisible by the mesh
    # (e.g. 300 frames on 8 devices) zero-pad the tail shard and mask it
    # out of the temporal statistics; the result must still match the
    # unsharded locate on the TRUE-length buffer.
    from respmon_tpu.parallel.temporal import locate_tsharded
    from respmon_tpu.pipeline import evm

    mesh = make_mesh(axis_names=("time",))
    clip = _stream_clips(1, 32)[0][:27]   # 27 % 8 != 0 -> pads to 32
    vid = jnp.asarray(clip, jnp.float32)

    want = evm.locate(vid, FPS, SMALL_CFG.calibration)
    got = locate_tsharded(vid, mesh, FPS, SMALL_CFG.calibration)

    assert bool(got.found) == bool(want.found)
    assert (int(got.x), int(got.y), int(got.w), int(got.h)) == \
        (int(want.x), int(want.y), int(want.w), int(want.h))
    assert np.abs(np.asarray(got.heatmap_u8, np.int32)
                  - np.asarray(want.heatmap_u8, np.int32)).max() <= 1
    np.testing.assert_array_equal(np.asarray(got.thresh) > 0,
                                  np.asarray(want.thresh) > 0)


def test_locate_tsharded_collectives_are_expected():
    # The SP program's collectives must be the designed set (reduce-scatter
    # + scalar/global psums) — in particular no all-to-alls or gathers of
    # the full video.
    from respmon_tpu.parallel.temporal import make_tsharded_locate

    mesh = make_mesh(axis_names=("time",))
    fn = make_tsharded_locate(mesh, FPS, SMALL_CFG.calibration, 32)
    vid = jnp.zeros((32, 60, 80), jnp.float32)
    txt = fn.lower(jax.device_put(
        vid, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("time", None, None)))
    ).compile().as_text()
    assert "reduce-scatter" in txt or "all-reduce" in txt
    assert "all-to-all" not in txt


def test_fleet_lk_sampling_modes_step_agree():
    # The one-hot LK sampling mode ("onehot")
    # must be BIT-identical to the exact slice mode on a live step chain;
    # the legacy "patches16" mode (bf16 im2col) agrees within bf16
    # rounding.
    import dataclasses

    from respmon_tpu.ops import filters
    from respmon_tpu.pipeline import motion

    clips = _stream_clips(4, 40)
    spec = motion.MeasureSpec.for_roi(FLOW_CFG, clips.shape[2],
                                      clips.shape[3], 30, 24, FPS)
    coeffs = filters.design_butter_lowpass(
        FLOW_CFG.calibration.freq_max * 0.5, FPS,
        FLOW_CFG.measure.filter_order)
    boxes = np.tile(np.asarray([[2, 2, 30, 24]], np.int32), (4, 1))

    results = {}
    for mode in ("slices", "onehot", "patches16"):
        sp = dataclasses.replace(spec, lk_sample=mode)
        states = streams_mod.init_stream_states(sp, boxes)
        samples = []
        for t in range(8):
            res = streams_mod.monitor_step_streams(
                states, jnp.asarray(clips[:, t]), sp, coeffs, 3,
                FLOW_CFG.measure, initialized=t > 0)
            states = res.state
            samples.append(np.asarray(res.samples))
        results[mode] = np.stack(samples)
        assert not np.asarray(states.error).any()

    np.testing.assert_array_equal(results["onehot"], results["slices"])
    np.testing.assert_allclose(results["patches16"], results["slices"],
                               atol=5e-3)


def test_fleet_u8_ingest_bit_identical_to_float():
    # Camera-native uint8 frames (4x less upload/staging HBM) must produce
    # the SAME measurements as the float [0,1] convention: both ingests
    # land on the identical u8-lattice crop (trunc(f*255) reconstructs
    # every byte exactly — verified for all 256 values), so samples and
    # BPM agree bit-for-bit.
    import dataclasses

    from respmon_tpu.ops import filters
    from respmon_tpu.pipeline import motion

    clips = _stream_clips(4, 40)
    clips_u8 = np.clip(np.trunc(clips * 255.0), 0, 255).astype(np.uint8)
    clips_f = clips_u8.astype(np.float32) / np.float32(255.0)

    spec = motion.MeasureSpec.for_roi(FLOW_CFG, clips.shape[2],
                                      clips.shape[3], 30, 24, FPS)
    coeffs = filters.design_butter_lowpass(
        FLOW_CFG.calibration.freq_max * 0.5, FPS,
        FLOW_CFG.measure.filter_order)
    boxes = np.tile(np.asarray([[2, 2, 30, 24]], np.int32), (4, 1))

    results = {}
    for name, frames in (("f32", clips_f), ("u8", clips_u8)):
        sp = dataclasses.replace(spec, lk_sample="slices")
        states = streams_mod.init_stream_states(sp, boxes)
        samples, bpms = [], []
        for t in range(8):
            res = streams_mod.monitor_step_streams(
                states, jnp.asarray(frames[:, t]), sp, coeffs, 3,
                FLOW_CFG.measure, initialized=t > 0)
            states = res.state
            samples.append(np.asarray(res.samples))
            bpms.append(np.asarray(res.bpm))
        results[name] = (np.stack(samples), np.stack(bpms))
        assert not np.asarray(states.error).any()

    np.testing.assert_array_equal(results["u8"][0], results["f32"][0])
    np.testing.assert_array_equal(results["u8"][1], results["f32"][1])


def test_measure_step_u8_average_mode_matches_float():
    # Average mode: the u8 path divides the mean by 255 to land on the
    # float convention's [0,1] sample scale.
    from respmon_tpu.pipeline import motion

    rng = np.random.default_rng(3)
    fr_u8 = rng.integers(0, 256, (60, 80), np.uint8)
    fr_f = fr_u8.astype(np.float32) / np.float32(255.0)
    spec = motion.MeasureSpec.for_roi(SMALL_CFG, 60, 80, 20, 16, FPS)
    st = motion.init_state(spec, (10, 12, 20, 16))
    _, s_f = motion.measure_step(st, jnp.asarray(fr_f), spec)
    _, s_u8 = motion.measure_step(st, jnp.asarray(fr_u8), spec)
    np.testing.assert_allclose(float(s_u8), float(s_f), rtol=1e-6)


def test_locate_wsharded_bit_identical_to_single_device():
    # Whole-EVM W-sharded calibration: sharded pyramid/bandpass/collapse
    # with halo exchange, replicated deep tail, replicated finish.  All
    # cross-shard reductions are min/max/concat, so the result must be
    # BIT-identical to the single-device locate.
    from respmon_tpu.parallel.spatial import locate_wsharded
    from respmon_tpu.pipeline import evm

    mesh = make_mesh(axis_names=("space",))
    cfg = CalibrationConfig(buffer_length=16, pyramid_levels=4,
                            skip_levels_at_top=1)
    clip = breathing_clip(num_frames=16, height=48, width=64, fps=FPS,
                          bpm=18.0, patch_center=(24, 32),
                          patch_size=(16, 20), amplitude=0.2, seed=3)
    vid = jnp.asarray(clip, jnp.float32)

    want = evm.locate(vid, FPS, cfg)
    got = locate_wsharded(vid, mesh, FPS, cfg, axis="space")

    assert bool(got.found) == bool(want.found)
    assert (int(got.x), int(got.y), int(got.w), int(got.h)) == \
        (int(want.x), int(want.y), int(want.w), int(want.h))
    np.testing.assert_array_equal(np.asarray(got.heatmap_u8),
                                  np.asarray(want.heatmap_u8))
    np.testing.assert_array_equal(np.asarray(got.thresh),
                                  np.asarray(want.thresh))
    np.testing.assert_array_equal(np.asarray(got.raw_heat_u8),
                                  np.asarray(want.raw_heat_u8))


def test_locate_wsharded_deep_pyramid_sharded_boundaries():
    # A deeper pyramid exercises both boundary cases: sharded lap with a
    # replicated pyrUp source, and the replicated->sharded collapse
    # re-entry.  Width 128 over 8 shards: levels 0 (16/shard) and 1
    # (8/shard) sharded, 2+ replicated.
    from respmon_tpu.parallel.spatial import locate_wsharded
    from respmon_tpu.pipeline import evm

    mesh = make_mesh(axis_names=("space",))
    cfg = CalibrationConfig(buffer_length=16, pyramid_levels=5,
                            skip_levels_at_top=1)
    clip = breathing_clip(num_frames=16, height=96, width=128, fps=FPS,
                          bpm=20.0, patch_center=(48, 64),
                          patch_size=(30, 40), amplitude=0.2, seed=5)
    vid = jnp.asarray(clip, jnp.float32)

    want = evm.locate(vid, FPS, cfg)
    got = locate_wsharded(vid, mesh, FPS, cfg, axis="space")
    assert bool(got.found) == bool(want.found)
    assert (int(got.x), int(got.y), int(got.w), int(got.h)) == \
        (int(want.x), int(want.y), int(want.w), int(want.h))
    np.testing.assert_array_equal(np.asarray(got.heatmap_u8),
                                  np.asarray(want.heatmap_u8))


def test_step_many_matches_sequential_steps():
    # The K-frame lockstep batch must produce exactly the per-frame
    # results of K sequential step() calls (same programs, scanned).
    mesh = make_mesh(axis_names=("streams",))
    clips = _stream_clips(8, 48)

    mon_a = streams_mod.MultiStreamMonitor(FLOW_CFG, mesh, (60, 80), FPS)
    mon_a.calibrate(clips[:, :32])
    mon_b = streams_mod.MultiStreamMonitor(FLOW_CFG, mesh, (60, 80), FPS)
    mon_b.calibrate(clips[:, :32])

    seq = [mon_a.step(clips[:, f]) for f in range(33, 41)]
    batch = mon_b.step_many(np.swapaxes(clips[:, 33:41], 0, 1))

    np.testing.assert_array_equal(
        np.stack([np.asarray(r.samples) for r in seq]),
        np.asarray(batch.samples))
    np.testing.assert_array_equal(
        np.stack([np.asarray(r.has_bpm) for r in seq]),
        np.asarray(batch.has_bpm))
    got_bpm = np.asarray(batch.bpm)
    want_bpm = np.stack([np.asarray(r.bpm) for r in seq])
    has = np.asarray(batch.has_bpm)
    np.testing.assert_array_equal(got_bpm[has], want_bpm[has])
    np.testing.assert_array_equal(
        np.asarray(mon_a.states.count), np.asarray(mon_b.states.count))
    np.testing.assert_array_equal(
        np.asarray(mon_a.states.data), np.asarray(mon_b.states.data))


def test_steady_state_step_elides_the_init_cond():
    # Batched lax.cond executes BOTH branches (vmap lowers it to select),
    # so without the static initialized hint every fleet step would run
    # Shi-Tomasi over every stream's crop.  The hint's whole job is to
    # remove that cond from the traced program — assert it at the jaxpr
    # level (measure_step's only cond is the init/track dispatch).
    from respmon_tpu.pipeline import motion

    cfg = FLOW_CFG
    spec = motion.MeasureSpec.for_roi(cfg, 60, 80, 20, 16, FPS)
    state = motion.init_state(spec, (30, 22, 20, 16))
    frame = jnp.zeros((60, 80), jnp.float32)

    def prims(hint):
        jaxpr = jax.make_jaxpr(
            lambda st, fr: motion.measure_step(st, fr, spec,
                                               initialized_hint=hint)
        )(state, frame)
        return {e.primitive.name for e in jaxpr.eqns}

    assert "cond" not in prims(True), \
        "steady-state step still contains the init/track cond"
    assert "cond" in prims(False)


def test_fleet_calibrate_accepts_u8_buffers():
    # Fleet calibration on camera-native uint8 buffers must find the same
    # ROIs as the host-converted float path (evm.locate widens on device,
    # bit-equal to the capture chain — tests/test_u8_ingest.py).
    clips = _stream_clips(4, 34)
    clips_u8 = np.clip(np.round(clips * 255.0), 0, 255).astype(np.uint8)
    clips_f = (clips_u8.astype(np.float64) * (1.0 / 255.0)).astype(
        np.float32)

    mesh = make_mesh(axis_sizes=(4,), axis_names=("streams",),
                     devices=jax.devices()[:4])
    mon_u8 = streams_mod.MultiStreamMonitor(SMALL_CFG, mesh, (60, 80), FPS)
    loc_u8 = mon_u8.calibrate(clips_u8[:, :32])
    mon_f = streams_mod.MultiStreamMonitor(SMALL_CFG, mesh, (60, 80), FPS)
    loc_f = mon_f.calibrate(clips_f[:, :32])

    np.testing.assert_array_equal(np.asarray(loc_u8.found),
                                  np.asarray(loc_f.found))
    np.testing.assert_array_equal(np.asarray(loc_u8.boxes),
                                  np.asarray(loc_f.boxes))

    # And the recalibrate path takes u8 too.
    loc_r = mon_u8.recalibrate(clips_u8[:, 1:33])
    assert np.asarray(loc_r.found).shape == (4,)


def test_cached_fleet_step_bit_identical_to_uncached():
    # The fleet step carries the prev-frame LK pyramid stacks between
    # steps (motion.FlowCache) so each step builds one pyramid instead of
    # two.  The stacks are a deterministic function of the same crop
    # values prev_crop stores, so every output must be BITWISE-equal to
    # the uncached program — including the rebuild variant
    # (cache_valid=False, the first step after calibrate/restore).
    import dataclasses

    from respmon_tpu.ops import filters
    from respmon_tpu.pipeline import motion

    clips = _stream_clips(4, 44)
    spec = motion.MeasureSpec.for_roi(FLOW_CFG, clips.shape[2],
                                      clips.shape[3], 30, 24, FPS)
    spec = dataclasses.replace(spec, lk_sample="onehot")
    coeffs = filters.design_butter_lowpass(
        FLOW_CFG.calibration.freq_max * 0.5, FPS,
        FLOW_CFG.measure.filter_order)
    boxes = np.tile(np.asarray([[2, 2, 30, 24]], np.int32), (4, 1))

    states_u = streams_mod.init_stream_states(spec, boxes)
    states_c = streams_mod.init_stream_states(spec, boxes)
    cache = streams_mod.init_fleet_cache(spec, 4)
    cache_valid = False
    for t in range(9):
        frames = jnp.asarray(clips[:, t])
        res_u = streams_mod.monitor_step_streams(
            states_u, frames, spec, coeffs, 3, FLOW_CFG.measure,
            initialized=t > 0)
        states_u = res_u.state
        res_c, cache = streams_mod.monitor_step_streams_cached(
            states_c, cache, frames, spec, coeffs, 3, FLOW_CFG.measure,
            initialized=t > 0, cache_valid=cache_valid)
        states_c = res_c.state
        np.testing.assert_array_equal(np.asarray(res_u.samples),
                                      np.asarray(res_c.samples))
        np.testing.assert_array_equal(np.asarray(res_u.bpm),
                                      np.asarray(res_c.bpm))
        np.testing.assert_array_equal(np.asarray(res_u.state.pts),
                                      np.asarray(res_c.state.pts))
        # Re-enter through the rebuild variant mid-chain too (t == 3
        # simulates a checkpoint restore / external states install).
        cache_valid = t != 3
    np.testing.assert_array_equal(np.asarray(states_u.data),
                                  np.asarray(states_c.data))
    assert not np.asarray(states_c.error).any()


def test_fleet_cache_invalidated_by_external_states_assignment():
    # Any external assignment to .states (recalibration merges, checkpoint
    # restore, bench fixtures) must drop the carried LK cache — the stacks
    # are only consistent with states step() itself produced.
    clips = _stream_clips(4, 40)
    mesh = make_mesh(axis_sizes=(4,), axis_names=("streams",),
                     devices=jax.devices()[:4])
    mon = streams_mod.MultiStreamMonitor(FLOW_CFG, mesh, (60, 80), FPS)
    mon.calibrate(clips[:, :32])
    assert mon._cache is None
    mon.step(clips[:, 33])
    mon.step(clips[:, 34])
    assert mon._cache is not None
    mon.states = mon.states          # external install
    assert mon._cache is None
    res = mon.step(clips[:, 35])     # rebuild variant recovers
    assert np.isfinite(np.asarray(res.samples)).all()
    assert mon._cache is not None
    # recalibrate() goes through the setter too.
    mon.recalibrate(clips[:, 4:36])
    assert mon._cache is None


def test_fleet_prev_onehot1_tolerance_and_exact_knob():
    # The one-hot prev-window mode ("onehot1", per-channel one-hot
    # extraction) is ulp-seeded against the exact slice path: Newton
    # iterates may drift within the same class as cv2's own SIMD-variant
    # spread.  Pin the contract: identical status decisions, sub-cv2-
    # tolerance point drift on realistic texture, and the slice path as
    # the fleet's sampling mode.
    import dataclasses

    from respmon_tpu.ops import filters
    from respmon_tpu.pipeline import motion

    clips = _stream_clips(4, 42)
    spec = motion.MeasureSpec.for_roi(FLOW_CFG, clips.shape[2],
                                      clips.shape[3], 30, 24, FPS)
    coeffs = filters.design_butter_lowpass(
        FLOW_CFG.calibration.freq_max * 0.5, FPS,
        FLOW_CFG.measure.filter_order)
    boxes = np.tile(np.asarray([[2, 2, 30, 24]], np.int32), (4, 1))

    results = {}
    for prev in ("slices", "onehot1"):
        sp = dataclasses.replace(spec, lk_sample="onehot",
                                 lk_prev_sample=prev)
        states = streams_mod.init_stream_states(sp, boxes)
        pts_trace, samples = [], []
        for t in range(8):
            res = streams_mod.monitor_step_streams(
                states, jnp.asarray(clips[:, t]), sp, coeffs, 3,
                FLOW_CFG.measure, initialized=t > 0)
            states = res.state
            pts_trace.append(np.asarray(states.pts))
            samples.append(np.asarray(res.samples))
        results[prev] = (np.stack(pts_trace), np.stack(samples),
                         np.asarray(states.pts_valid),
                         np.asarray(states.error))

    np.testing.assert_array_equal(results["onehot1"][2],
                                  results["slices"][2])   # survivors
    np.testing.assert_array_equal(results["onehot1"][3],
                                  results["slices"][3])   # error flags
    alive = results["slices"][2]
    d = np.abs(results["onehot1"][0][:, alive] - results["slices"][0][:,
                                                                      alive])
    assert d.max() < 0.05, f"prev-mode drift {d.max()} px"
    ds = np.abs(results["onehot1"][1] - results["slices"][1])
    assert np.nanmax(ds) < 0.01, f"sample drift {np.nanmax(ds)}"

    # Fleets take the slice path in both roles whatever the backend:
    # calibrate() installs it, so fleet steps reproduce the single-stream
    # monitor bit-for-bit.
    mon = streams_mod.MultiStreamMonitor(FLOW_CFG, None, (60, 80), FPS)
    mon.calibrate(clips[:, :32])
    assert (mon.spec.lk_sample, mon.spec.lk_prev_sample) == ("slices",
                                                             "slices")
