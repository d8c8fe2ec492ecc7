"""Tests: detect_peaks alternative, streaming calibrator, checkpoint/resume,
fault injection (SURVEY.md §2.0b prototypes + §5 aux subsystems)."""

import numpy as np
import pytest

import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig, MonitorConfig
from respmon_tpu.io.capture import ArrayCapture
from respmon_tpu.io.faults import FaultInjector, FaultSchedule
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.ops.detect_peaks import detect_peaks
from respmon_tpu.pipeline import evm, streaming
from respmon_tpu.runtime import RespiratoryMonitor
from respmon_tpu.runtime import checkpoint
from tests.golden import reference_numpy as golden

FPS = 10.0


# ---------------------------------------------------------------------------
# detect_peaks (prototypes/detect_peaks.py alternative detector)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("mpd,edge", [(1, "rising"), (5, "rising"),
                                      (3, None), (4, "both")])
def test_detect_peaks_matches_oracle(seed, mpd, edge):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(96)
    want = golden.detect_peaks_oracle(x, mpd=mpd, edge=edge)
    idx, mask = detect_peaks(jnp.asarray(x), mpd=mpd, edge=edge)
    got = np.asarray(idx)[np.asarray(mask)]
    np.testing.assert_array_equal(got, want)


def test_detect_peaks_mph_threshold_valley():
    rng = np.random.default_rng(9)
    x = np.cumsum(rng.standard_normal(80))
    for kw in ({"mph": 0.5}, {"threshold": 0.2}, {"valley": True}):
        want = golden.detect_peaks_oracle(x, **kw)
        idx, mask = detect_peaks(jnp.asarray(x), **kw)
        got = np.asarray(idx)[np.asarray(mask)]
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_detect_peaks_nan_handling():
    x = np.array([0., 1., 0., np.nan, 0., 2., 0., 1., 0.])
    want = golden.detect_peaks_oracle(x)
    idx, mask = detect_peaks(jnp.asarray(x))
    got = np.asarray(idx)[np.asarray(mask)]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Streaming calibrator (prototypes/locating.py:94-147 successor)
# ---------------------------------------------------------------------------

def test_streaming_matches_batch_locate_on_static_scene():
    cfg = CalibrationConfig(buffer_length=32, pyramid_levels=4,
                            skip_levels_at_top=1)
    clip = breathing_clip(num_frames=32, height=60, width=80, fps=FPS,
                          bpm=18.0, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.25, noise=0.002)
    state = streaming.init_streaming_state(60, 80, cfg)
    for i in range(32):
        state, res = streaming.streaming_update(
            state, jnp.asarray(clip[i]), FPS, cfg)
        if i < 31:
            assert not bool(res.ready)
    assert bool(res.ready) and bool(res.found)
    batch = evm.locate(jnp.asarray(clip), FPS, cfg)
    assert (int(res.x), int(res.y), int(res.w), int(res.h)) == \
        (int(batch.x), int(batch.y), int(batch.w), int(batch.h))


def test_streaming_tracks_roi_continuously():
    # After the window fills, every subsequent frame yields a localization —
    # the capability the batch path lacks.
    cfg = CalibrationConfig(buffer_length=16, pyramid_levels=4,
                            skip_levels_at_top=1)
    clip = breathing_clip(num_frames=40, height=60, width=80, fps=FPS,
                          bpm=24.0, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.25, noise=0.002)
    state = streaming.init_streaming_state(60, 80, cfg)
    found = 0
    for i in range(40):
        state, res = streaming.streaming_update(
            state, jnp.asarray(clip[i]), FPS, cfg)
        found += int(bool(res.found))
    assert found >= 20


def test_streaming_roi_follows_moving_subject():
    # The module's headline capability: the subject's center translates
    # across the frame and the streaming ROI must follow it (the batch
    # calibrator would freeze the ROI at its initial position and lose the
    # subject).  The reference's suppress-top quirk masks the STRONGEST
    # response region, so boxes occasionally widen over the trailing smear
    # — the robust invariants are containment of the (window-lagged) true
    # center, a small median center error, and net travel with the subject.
    T = 16
    n = 80
    drift = (16.0, 28.0)   # patch center moves (18,20) -> (34,48)
    cfg = CalibrationConfig(buffer_length=T, pyramid_levels=4,
                            skip_levels_at_top=1)
    # bpm 37.5 at 10 fps = one full breathing period per 16-frame window,
    # so the bandpass energy is phase-stable frame to frame.
    clip = breathing_clip(num_frames=n, height=60, width=80, fps=FPS,
                          bpm=37.5, patch_center=(18, 20),
                          patch_size=(10, 12), amplitude=0.35,
                          drift_px=drift, noise=0.0)

    def true_center(i):
        # The window averages frames [i-T+1, i]; the localized center lags
        # the instantaneous subject by about half a window.
        mid = i - (T - 1) / 2.0
        return (18.0 + drift[0] * mid / (n - 1),
                20.0 + drift[1] * mid / (n - 1))

    state = streaming.init_streaming_state(60, 80, cfg)
    errs = []
    centers = []
    first_box = None
    contained = 0
    for i in range(n):
        state, res = streaming.streaming_update(
            state, jnp.asarray(clip[i]), FPS, cfg)
        if i >= T + 2 and bool(res.found):
            x, y = int(res.x), int(res.y)
            w, h = int(res.w), int(res.h)
            if first_box is None:
                first_box = (x, y, w, h)
            ty, tx = true_center(i)
            contained += int((x <= tx <= x + w) and (y <= ty <= y + h))
            errs.append(np.hypot(y + h / 2.0 - ty, x + w / 2.0 - tx))
            centers.append((y + h / 2.0, x + w / 2.0))
    # Localizes on EVERY frame once the window is full...
    assert len(centers) == n - T - 2, "missed localizations while tracking"
    # ...always containing the moving subject...
    assert contained == len(centers), \
        f"subject escaped the ROI {len(centers) - contained} time(s)"
    # ...with the box center following closely...
    assert np.median(errs) <= 4.0, f"median center error {np.median(errs)}"
    # ...and traveling with the subject (not a lucky static box).
    moved = np.hypot(centers[-1][0] - centers[0][0],
                     centers[-1][1] - centers[0][1])
    true_moved = np.hypot(*drift) * (len(centers) / n)
    assert moved >= 0.4 * true_moved, (moved, true_moved)
    # A frozen calibration box would have LOST the subject: its final true
    # center lies outside the first localized box.
    fx, fy, fw, fh = first_box
    ty_f, tx_f = 18.0 + drift[0], 20.0 + drift[1]
    assert not ((fx <= tx_f <= fx + fw) and (fy <= ty_f <= fy + fh)), \
        "drift too small to demonstrate tracking"


def _streaming_monitor_run(method, n=96, drift=(14.0, 24.0)):
    T = 16
    cal = CalibrationConfig(buffer_length=T, pyramid_levels=4,
                            skip_levels_at_top=1)
    clip = breathing_clip(num_frames=n, height=60, width=80, fps=FPS,
                          bpm=37.5, patch_center=(18, 20),
                          patch_size=(10, 12), amplitude=0.35,
                          drift_px=drift, noise=0.0,
                          motion_px=1.5 if method == "flow" else 0.0,
                          texture_motion=method == "flow")
    cfg = MonitorConfig(calibration=cal, streaming_roi=True,
                        streaming_interval=4, streaming_drift_px=2.0)
    mon = RespiratoryMonitor(
        capture_target="synthetic", save_all_data=False, visualize=None,
        motion_extraction_method=method, config=cfg,
        capture=ArrayCapture(clip, fps=FPS), auto_run=False,
        sync_fps=False)
    mon.run()
    return mon, clip, drift, n


def test_monitor_streaming_relock_follows_drift():
    # Monitor-mode streaming ROI (config.streaming_roi): the subject
    # drifts far enough that the batch calibrator's frozen box would lose
    # it; the streaming mode must re-lock repeatedly, keep the subject
    # inside the window, and never enter the error state.
    mon, clip, drift, n = _streaming_monitor_run("average")
    assert mon.state == "measure", mon.error_message
    assert mon.relocks >= 2, f"only {mon.relocks} re-locks"
    ty = 18.0 + drift[0]
    tx = 20.0 + drift[1]
    assert mon.x <= tx <= mon.x + mon.w, (mon.x, mon.w, tx)
    assert mon.y <= ty <= mon.y + mon.h, (mon.y, mon.h, ty)
    # The initial calibrated window must NOT contain the final center
    # (otherwise the drift is too small to demonstrate tracking) — the
    # re-lock trail is what kept the subject covered.


def test_monitor_streaming_relock_preserves_flow_tracking():
    # relock_state shifts tracked points with the window (same physical
    # pixels) and re-crops prev from the current frame: flow tracking must
    # survive re-locks without NaN samples or the error state.
    mon, clip, drift, n = _streaming_monitor_run("flow")
    assert mon.state == "measure", mon.error_message
    assert mon.relocks >= 1
    samples = np.asarray(mon.data, float)
    assert np.isfinite(samples).all(), "tracking lost across a re-lock"


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------

def test_checkpoint_resume_continues_measurement(tmp_path):
    cal = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                            skip_levels_at_top=2)
    clip = breathing_clip(num_frames=64 + 1 + 80, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)

    def make(frames):
        return RespiratoryMonitor(
            capture_target="ckpt", save_all_data=False, visualize=None,
            motion_extraction_method="average",
            config=MonitorConfig(calibration=cal),
            capture=ArrayCapture(frames, fps=FPS), auto_run=False,
            sync_fps=False)

    split = 64 + 1 + 40
    m1 = make(clip[:split])
    m1.run()
    assert m1.state == "measure"
    path = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(path, m1)

    m2 = make(clip[split:])
    checkpoint.load_checkpoint(path, m2)
    assert m2.state == "measure"
    assert (m2.x, m2.y, m2.w, m2.h) == (m1.x, m1.y, m1.w, m1.h)
    assert checkpoint.checkpoint_roundtrip_equal(m1._measure_state,
                                                 m2._measure_state)
    m2.run()
    assert len(m2.freq) > 0
    assert abs(m2.freq[-1] - 18.0) <= 0.5


# ---------------------------------------------------------------------------
# Fault injection exercising the error state machine
# ---------------------------------------------------------------------------

def test_blackout_fault_triggers_error_and_recovery():
    cal = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                            skip_levels_at_top=2)
    good = breathing_clip(num_frames=64 + 1 + 200, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12,
                          motion_px=2.0)
    src = FaultInjector(
        ArrayCapture(good, fps=FPS),
        [FaultSchedule("blackout", start=64 + 1 + 30, end=64 + 1 + 45)])
    mon = RespiratoryMonitor(
        capture_target="fault", save_all_data=False, visualize=None,
        motion_extraction_method="flow",
        config=MonitorConfig(calibration=cal), capture=src, auto_run=False,
        sync_fps=False, error_reset_delay=0.0)
    states = set()
    while mon.cap.is_open():
        if not mon.step():
            break
        states.add(mon.state)
    assert "error" in states, "blackout never triggered the error state"
    assert mon.error_message is not None
    # The machine recovered: it recalibrated (and ideally measured again).
    assert "measure" in states
    assert mon.state in ("calibration", "measure")


def test_streaming_warm_recovery_skips_buffer_refill():
    # With streaming_roi on, the rolling rings stay warm
    # through the error state (frames absorb during the wait), so the
    # post-reset calibration localizes from the rings within a few frames
    # instead of dead-waiting a full buffer_length refill.
    cal = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                            skip_levels_at_top=2)
    good = breathing_clip(num_frames=64 + 1 + 160, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12,
                          motion_px=2.0)
    src = FaultInjector(
        ArrayCapture(good, fps=FPS),
        [FaultSchedule("blackout", start=64 + 1 + 30, end=64 + 1 + 36)])
    cfg = MonitorConfig(calibration=cal, streaming_roi=True,
                        streaming_interval=8, streaming_drift_px=4.0)
    mon = RespiratoryMonitor(
        capture_target="warmfault", save_all_data=False, visualize=None,
        motion_extraction_method="flow", config=cfg, capture=src,
        auto_run=False, sync_fps=False, error_reset_delay=0.0)
    trace = []
    while mon.cap.is_open():
        if not mon.step():
            break
        trace.append(mon.state)
    assert "error" in trace, "blackout never triggered the error state"
    i_err = trace.index("error")
    assert "measure" in trace[i_err:], "never recovered to measurement"
    i_meas = i_err + trace[i_err:].index("measure")
    # Cold recovery would spend >= buffer_length (64) frames refilling the
    # calibration buffer; warm recovery localizes from the rings as soon
    # as the blackout passes (a handful of retry frames).
    assert i_meas - i_err <= 20, \
        f"warm recovery took {i_meas - i_err} frames (cold would be >64)"


def test_measurement_bucket_reuse_across_recalibration():
    # Recovery recalibrations whose fresh ROI fits the previous crop
    # bucket must reuse the compiled measure program (spec identity) —
    # per-cycle recompiles dominated the recovery soak otherwise.  A
    # much-smaller ROI (bucket > 4x needed area) rebuilds.
    cal = CalibrationConfig(buffer_length=16, pyramid_levels=4,
                            skip_levels_at_top=1)
    clip = breathing_clip(num_frames=20, height=60, width=80, fps=FPS,
                          bpm=18.0, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.25)
    mon = RespiratoryMonitor(
        capture_target="bucket", save_all_data=False, visualize=None,
        motion_extraction_method="average",
        config=MonitorConfig(calibration=cal),
        capture=ArrayCapture(clip, fps=FPS), auto_run=False,
        sync_fps=False)
    mon.skip_calibration(10, 10, 30, 28)
    spec1 = mon._measure_spec
    # Slightly different ROI inside the same bucket -> same spec object.
    mon.skip_calibration(14, 12, 28, 26)
    assert mon._measure_spec is spec1
    # Tiny ROI (bucket area > 4x) -> rebuilt spec.
    mon.skip_calibration(14, 12, 8, 6)
    assert mon._measure_spec is not spec1


def test_nan_fault_passthrough_average_mode_no_error():
    # In average mode the reference's detect_errors identity-check never
    # fires (SURVEY.md §5) — NaN frames must not crash nor error the
    # monitor.
    cal = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                            skip_levels_at_top=2)
    good = breathing_clip(num_frames=64 + 1 + 40, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)
    src = FaultInjector(
        ArrayCapture(good, fps=FPS),
        [FaultSchedule("nan", start=64 + 1 + 10, end=64 + 1 + 12)])
    mon = RespiratoryMonitor(
        capture_target="nanfault", save_all_data=False, visualize=None,
        motion_extraction_method="average",
        config=MonitorConfig(calibration=cal), capture=src, auto_run=False,
        sync_fps=False)
    mon.run()
    assert mon.state == "measure"
    assert mon.error_message is None


def test_fleet_checkpoint_roundtrip(tmp_path):
    # Fleet suspend/resume: a restored MultiStreamMonitor must continue
    # producing EXACTLY the results of the uninterrupted fleet.
    from respmon_tpu.parallel import streams as streams_mod
    from respmon_tpu.parallel.mesh import make_mesh

    fps = 10.0
    # flow mode so the checkpoint covers the full tracking state (points,
    # validity, motion ring, prev crop), not just the signal buffers.
    cfg = MonitorConfig(
        motion_extraction_method="flow",
        calibration=CalibrationConfig(buffer_length=32, pyramid_levels=4,
                                      skip_levels_at_top=1))
    clips = np.stack([
        breathing_clip(num_frames=80, height=60, width=80, fps=fps,
                       bpm=18.0 + i, patch_center=(30, 40),
                       patch_size=(16, 20), amplitude=0.25, noise=0.002,
                       seed=i)
        for i in range(8)])

    mesh = make_mesh(axis_names=("streams",))
    mon = streams_mod.MultiStreamMonitor(cfg, mesh, (60, 80), fps)
    mon.calibrate(clips[:, :32])
    for f in range(33, 50):
        mon.step(clips[:, f])

    path = str(tmp_path / "fleet.npz")
    checkpoint.save_fleet_checkpoint(path, mon)

    resumed = streams_mod.MultiStreamMonitor(cfg, mesh, (60, 80), fps)
    checkpoint.load_fleet_checkpoint(path, resumed)
    assert checkpoint.checkpoint_roundtrip_equal(
        __import__("jax").tree_util.tree_map(np.asarray, mon.states),
        __import__("jax").tree_util.tree_map(np.asarray, resumed.states))

    for f in range(50, 60):
        a = mon.step(clips[:, f])
        b = resumed.step(clips[:, f])
        np.testing.assert_array_equal(np.asarray(a.samples),
                                      np.asarray(b.samples))
        has = np.asarray(a.has_bpm)
        np.testing.assert_array_equal(has, np.asarray(b.has_bpm))
        np.testing.assert_array_equal(np.asarray(a.bpm)[has],
                                      np.asarray(b.bpm)[has])
