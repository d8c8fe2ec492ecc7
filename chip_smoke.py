"""Smoke run of respmon's single-camera, whole-clip and fleet paths on a GPU.

    python chip_smoke.py                # phases a-d on one card
    python chip_smoke.py --four-cards   # phase e only: the stream-sharded
                                        # fleet on four cards against the
                                        # same streams on one card

Phases (one process; a JAX process reserves most of a card's memory):

  a. single camera: ``RespiratoryMonitor`` over an injected 640x480 u8
     clip at 10 fps, flow mode, reference buffer sizes, with one blackout
     that drives calibrate -> measure -> error -> recalibrate -> measure.
     ROI checked against the synthetic patch, every BPM against the
     scipy-f64 golden chain (``tests/golden/reference_numpy``).
  b. whole clip: ``pipeline.scan.process_clip`` on the same clip; ROI and
     BPM checked against phase a.
  c. fleet: ``MultiStreamMonitor`` calibrated from real 128-frame 1080p u8
     buffers, then lockstep 1080p steps (some with streaming re-lock on),
     every stream checked against the single-stream measure step.
  d. card-only parity: the u8 widen, the LM Gaussian fit against scipy, the
     f64 BPM refit, and ``evm.locate`` at 480p and 1080p against a float64
     reference.

Every check raises on failure, so the run fails as a whole.  Earlier lines
print each result with its tolerance, compile and steady times, device
memory, and the card's name and power limit.  The last line of standard
output is one JSON object naming the device; it is printed only when every
phase passed.  Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

FPS = 10.0
BPM_TRUE = 18.0
BPM_TOL = 0.5           # BASELINE.md: +-0.5 BPM against the reference chain
FLEET_SAMPLE_TOL = 0.01  # tests/test_parallel.py fleet-vs-single drift bound


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Geometry of every phase.  The defaults are the sizes users run."""

    cam_hw: tuple = (480, 640)
    cal_len: int = 128            # reference calibration buffer
    pyramid_levels: int = 9
    skip_levels: int = 4
    measure_before: int = 120     # frames measured before the blackout
    measure_after: int = 100      # frames measured after recovery
    fleet_hw: tuple = (1080, 1920)
    fleet_streams: int = 64
    fleet_min_cal: int = 8        # fewest streams calibrated at once
    fleet_steps: int = 12
    locate_shapes: tuple = ((128, 480, 640), (128, 1080, 1920))
    corpus_traces: int = 12
    four_cal_per_card: int = 8
    four_steps_per_card: int = 16
    four_steps: int = 8


# ---------------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------------

def compare_samples(got, want, atol: float):
    """(bitwise_equal, max_abs_diff, ok) for two sample arrays.  NaN must
    sit in the same places; elsewhere |got - want| <= atol."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    nan_same = np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    diff = np.abs(got[fin] - want[fin]) if fin.any() else np.zeros(1)
    max_abs = float(diff.max()) if diff.size else 0.0
    bitwise = bool(np.array_equal(got, want, equal_nan=True))
    return bitwise, max_abs, bool(nan_same and max_abs <= atol)


def bpm_agreement(windows, fps: float):
    """Compare device BPM decisions with the golden chain.

    ``windows``: iterable of (data, t, device_has, device_bpm).  Returns
    (n_windows, n_has_mismatch, n_both, max_abs_delta)."""
    from tests.golden import reference_numpy as golden

    n = mism = both = 0
    worst = 0.0
    for data, t, has, bpm in windows:
        want, _, _, _ = golden.measure_bpm(np.asarray(data, np.float64),
                                           np.asarray(t, np.float64), fps)
        n += 1
        if (want is not None) != bool(has):
            mism += 1
        elif want is not None:
            both += 1
            worst = max(worst, abs(float(bpm) - float(want)))
    return n, mism, both, worst


def roi_iou(roi, rect) -> float:
    """Intersection over union of two (x, y, w, h) boxes."""
    ax, ay, aw, ah = roi
    bx, by, bw, bh = rect
    ix = max(0, min(ax + aw, bx + bw) - max(ax, bx))
    iy = max(0, min(ay + ah, by + bh) - max(ay, by))
    inter = ix * iy
    return inter / float(aw * ah + bw * bh - inter)


def covers(roi, center) -> bool:
    x, y, w, h = roi
    cy, cx = center
    return x <= cx <= x + w and y <= cy <= y + h


def heatmap_diff(a, b) -> int:
    """Largest per-pixel difference of two uint8 heatmaps."""
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
               .max())


# ---------------------------------------------------------------------------
# Device facts
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def memory_line(devices) -> str:
    parts = []
    for d in devices:
        st = d.memory_stats() or {}
        parts.append(f"{d.id}: peak {st.get('peak_bytes_in_use', 0) / 2**30:.2f}"
                     f" GiB, in use {st.get('bytes_in_use', 0) / 2**30:.2f}"
                     f" GiB")
    return "; ".join(parts)


def _u8(clip):
    return np.clip(np.round(clip * 255.0), 0, 255).astype(np.uint8)


def _monitor_cfg(sz: Sizes, **kw):
    from respmon_tpu.config import CalibrationConfig, MonitorConfig

    cal = CalibrationConfig(buffer_length=sz.cal_len,
                            pyramid_levels=sz.pyramid_levels,
                            skip_levels_at_top=sz.skip_levels)
    return MonitorConfig(motion_extraction_method="flow", calibration=cal,
                         **kw)


def _cam_geometry(sz: Sizes):
    h, w = sz.cam_hw
    center = (h // 2, w // 2)
    size = (h // 6, w // 6 + w // 30)       # 80x100 at 640x480
    rect = (center[1] - size[1] // 2, center[0] - size[0] // 2,
            size[1], size[0])
    return center, size, rect


# ---------------------------------------------------------------------------
# Phase a: single camera through RespiratoryMonitor
# ---------------------------------------------------------------------------

def phase_single_camera(sz: Sizes):
    from respmon_tpu.io.capture import ArrayCapture
    from respmon_tpu.io.faults import FaultInjector, FaultSchedule
    from respmon_tpu.io.synthetic import breathing_clip
    from respmon_tpu.runtime import RespiratoryMonitor

    h, w = sz.cam_hw
    center, size, rect = _cam_geometry(sz)
    # initialize frame + calibration + dropped locate frame + measurement,
    # then the blackout (frame 1 errors, frame 2 is eaten by the error
    # state), then the same again after recovery.
    blackout_at = 1 + sz.cal_len + 1 + sz.measure_before
    total = blackout_at + 2 + sz.cal_len + 1 + sz.measure_after
    clip = _u8(breathing_clip(num_frames=total, height=h, width=w, fps=FPS,
                              bpm=BPM_TRUE, patch_center=center,
                              patch_size=size, amplitude=0.12,
                              motion_px=2.0, texture_motion=True))
    cfg = _monitor_cfg(sz)
    cap = FaultInjector(ArrayCapture(clip, fps=FPS),
                        [FaultSchedule("blackout", blackout_at,
                                       blackout_at + 2)])
    mon = RespiratoryMonitor(
        capture_target="chip-smoke", save_all_data=False, visualize=None,
        motion_extraction_method="flow", config=cfg, capture=cap,
        auto_run=False, sync_fps=False, error_reset_delay=0.0)

    states, rois, episodes = [], [], []
    windows = []          # (data, t, has, bpm) per measured frame
    step_s, cal_s = [], []
    while True:
        before = mon.state
        n_freq = len(mon.freq)
        t0 = time.perf_counter()
        if not mon.step():
            break
        dt = time.perf_counter() - t0
        if mon.state != before:
            states.append(mon.state)
            if mon.state == "measure":
                rois.append((mon.x, mon.y, mon.w, mon.h))
                episodes.append([])
                cal_s.append(dt)
        elif before == "measure":
            step_s.append(dt)
        if before == "measure" and mon.state in ("measure", "error"):
            new = len(mon.freq) > n_freq
            episodes[-1].append((mon.data[-1], new,
                                 mon.freq[-1] if new else np.nan))
            if len(mon.data) > cfg.measure.initialization_length:
                data = np.asarray(mon.data)
                if np.isfinite(data).all():
                    windows.append((data, np.asarray(mon.t), new,
                                    mon.freq[-1] if new else np.nan))

    log(f"[a] states: {' -> '.join(states)}")
    check(states.count("error") == 1 and states.count("measure") == 2
          and states[-1] == "measure",
          f"expected calibrate->measure->error->recalibrate->measure, got "
          f"{states}")
    for i, roi in enumerate(rois):
        iou = roi_iou(roi, rect)
        log(f"[a] ROI {i}: {roi}, synthetic patch {rect}, IoU {iou:.3f} "
            f"(need the patch centre inside and IoU >= 0.3)")
        check(covers(roi, center) and iou >= 0.3,
              f"ROI {roi} misses the patch {rect}")
    n, mism, both, worst = bpm_agreement(windows, FPS)
    log(f"[a] BPM vs golden chain on {n} windows: {mism} has-BPM "
        f"mismatches, max |dBPM| {worst:.4f} over {both} (tolerance "
        f"{BPM_TOL}, no mismatches)")
    check(n > 0 and both > 0, "no BPM windows to compare")
    check(mism == 0 and worst <= BPM_TOL, "BPM disagrees with golden chain")
    final = float(mon.freq[-1])
    log(f"[a] final BPM {final:.3f} (synthetic breathing at {BPM_TRUE})")
    steady = float(np.median(step_s[5:])) if len(step_s) > 5 else \
        float("nan")
    log(f"[a] calibrations (locate incl. first compile) "
        f"{[round(s, 3) for s in cal_s]} s; first measure frame "
        f"{step_s[0]:.3f} s; steady frame {steady * 1e3:.3f} ms "
        f"(median over {len(step_s) - 5} frames)")
    return {"clip": clip, "rois": rois, "episodes": episodes,
            "blackout_at": blackout_at}


# ---------------------------------------------------------------------------
# Phase b: whole clip
# ---------------------------------------------------------------------------

def phase_whole_clip(sz: Sizes, a):
    """process_clip is one calibrate->measure episode: on phase a's clip,
    blackout included, it must find phase a's first ROI, report the error
    at the blackout, and match phase a's BPM up to there."""
    import jax

    from respmon_tpu.pipeline import scan

    cfg = _monitor_cfg(sz)
    clip = a["clip"].copy()
    clip[a["blackout_at"]:a["blackout_at"] + 2] = 0
    t0 = time.perf_counter()
    res = scan.process_clip(clip, FPS, cfg)
    jax.block_until_ready(res.measure.samples)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = scan.process_clip(clip, FPS, cfg)
    jax.block_until_ready(res.measure.samples)
    again = time.perf_counter() - t0
    log(f"[b] process_clip of {len(clip)} frames: first call {first:.3f} s "
        f"(compile included), again {again * 1e3:.3f} ms")
    check(res.found, "process_clip found no ROI")
    log(f"[b] ROI {res.roi} vs phase a {a['rois'][0]} (must be equal)")
    check(tuple(res.roi) == tuple(a["rois"][0]), "ROI differs from phase a")
    # The monitor entered its error state on its first NaN sample; the
    # clip path must report that frame and match every frame up to it.
    ep = a["episodes"][0]
    nan_at = [i for i, e in enumerate(ep) if np.isnan(e[0])]
    check(nan_at, "phase a's first episode never lost tracking")
    m = nan_at[0] + 1
    log(f"[b] error at measured frame {res.error_frame}; phase a's at "
        f"{m - 1} (blackout from {sz.measure_before})")
    check(res.error_frame == m - 1, "process_clip missed the blackout")
    ep = ep[:m]
    bitwise, max_abs, ok = compare_samples(
        np.asarray(res.measure.samples)[:m], [e[0] for e in ep],
        FLEET_SAMPLE_TOL)
    log(f"[b] {m} samples up to the error vs phase a: bitwise {bitwise}, "
        f"max |d| {max_abs:.3e} (tolerance {FLEET_SAMPLE_TOL})")
    check(ok, "clip samples differ from phase a")
    has = np.asarray(res.measure.has_bpm)[:m]
    bpm = np.asarray(res.measure.bpm)[:m]
    mon_has = np.asarray([e[1] for e in ep])
    mon_bpm = np.asarray([e[2] for e in ep])
    mism = int(np.sum(has != mon_has))
    both = has & mon_has
    worst = float(np.abs(bpm[both] - mon_bpm[both]).max()) if both.any() \
        else float("nan")
    log(f"[b] BPM up to the error vs phase a: {mism} has-BPM mismatches, max "
        f"|dBPM| {worst:.4f} over {int(both.sum())} frames (tolerance "
        f"{BPM_TOL}, no mismatches)")
    check(mism == 0 and both.any() and worst <= BPM_TOL,
          "BPM up to the error differs from phase a")
    mon_final = float(mon_bpm[mon_has][-1])
    log(f"[b] final BPM {res.final_bpm:.3f} vs phase a's at the same frame "
        f"{mon_final:.3f} (tolerance {BPM_TOL})")
    check(res.final_bpm is not None
          and abs(res.final_bpm - mon_final) <= BPM_TOL,
          "final BPM differs from phase a")


# ---------------------------------------------------------------------------
# Phase c: the 1080p fleet
# ---------------------------------------------------------------------------

def _fleet_clip(sz: Sizes, frames: int):
    """One 1080p u8 breathing clip; stream s sees it shifted right by
    ``_fleet_shift(sz, s)`` pixels, so every stream has its own ROI."""
    from respmon_tpu.io.synthetic import breathing_clip

    h, w = sz.fleet_hw
    center = (h // 2, w // 2)
    size = (h // 6, w // 9 + w // 60)         # 180x220 at 1080p
    clip = _u8(breathing_clip(num_frames=frames, height=h, width=w, fps=FPS,
                              bpm=BPM_TRUE, patch_center=center,
                              patch_size=size, amplitude=0.12,
                              motion_px=3.0, texture_motion=True))
    return clip, center


def _fleet_shift(sz: Sizes, s: int) -> int:
    return s * max(sz.fleet_hw[1] // 80, 1)


def _stream_frames(clip, sz: Sizes, streams, t: int):
    return np.stack([np.roll(clip[t], _fleet_shift(sz, s), axis=1)
                     for s in streams])


def _stream_buffers(clip, sz: Sizes, streams):
    return np.stack([np.roll(clip[:sz.cal_len], _fleet_shift(sz, s), axis=2)
                     for s in streams])


def calibrate_capacity(sz: Sizes, device) -> int:
    """How many 1080p u8 calibration buffers one ``calibrate`` call can take
    on ``device``: the compiled single-stream locate's footprint against
    the device's free memory less a fifth kept for the allocator
    (``calibrate`` does not chunk, so the fleet calibrates them at once)."""
    import jax
    import jax.numpy as jnp

    from respmon_tpu.parallel import streams as fleet

    cfg = _monitor_cfg(sz).calibration
    h, w = sz.fleet_hw
    spec = jax.ShapeDtypeStruct((1, sz.cal_len, h, w), jnp.uint8)
    per = 0
    for name, fn in (("locate", fleet.locate_streams.lower(spec, FPS, cfg)),
                     ("ring warm start",
                      fleet.init_fleet_streaming_from_buffers.lower(spec,
                                                                    cfg))):
        ma = fn.compile().memory_analysis()
        need = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
                + ma.output_size_in_bytes)
        log(f"[c] one-stream {h}x{w} {name} needs {need / 2**30:.2f} GiB "
            f"(temp {ma.temp_size_in_bytes / 2**30:.2f})")
        per = max(per, need)
    st = device.memory_stats()
    free = st["bytes_limit"] - st["bytes_in_use"]
    cap = int(0.8 * free // per)
    log(f"[c] free {free / 2**30:.2f} GiB -> room for {cap} streams per "
        f"calibrate")
    return cap


def _reference_samples(spec, box, frames_of, steps, relocks_at=None):
    """Single-stream ``motion.measure_step`` chain over one stream's frames,
    re-locking where the fleet re-locked that stream."""
    import jax
    import jax.numpy as jnp

    from respmon_tpu.pipeline import motion

    step = jax.jit(motion.measure_step, static_argnames=("spec",))
    relock = jax.jit(motion.relock_state, static_argnames=("spec",))
    state = motion.init_state(spec, tuple(int(v) for v in box))
    out = []
    for k in range(steps):
        frame = jnp.asarray(frames_of(k))
        state, sample = step(state, frame, spec=spec)
        out.append(float(sample))
        if relocks_at and k in relocks_at:
            state = relock(state, frame, jnp.asarray(relocks_at[k]),
                           spec=spec)
    return np.asarray(out)


def _check_fleet_samples(tag, got, want):
    bitwise, max_abs, ok = compare_samples(got, want, FLEET_SAMPLE_TOL)
    log(f"{tag} fleet vs single-stream samples: bitwise {bitwise}, max |d| "
        f"{max_abs:.3e} (tolerance {FLEET_SAMPLE_TOL}, NaN in the same "
        f"places)")
    check(ok, f"{tag} fleet samples differ from the single-stream path")
    return bitwise, max_abs


def phase_fleet(sz: Sizes):
    import jax
    import jax.numpy as jnp

    from respmon_tpu.parallel import streams as fleet
    from respmon_tpu.pipeline import evm, motion

    dev = jax.devices()[0]
    cfg = _monitor_cfg(sz)
    cfg_s = _monitor_cfg(sz, streaming_roi=True)
    h, w = sz.fleet_hw
    relock_steps = 2 * cfg_s.streaming_interval + 1
    n_cal = calibrate_capacity(sz, dev)
    check(n_cal >= sz.fleet_min_cal,
          f"one card holds only {n_cal} 1080p calibrations")
    t0 = time.perf_counter()
    clip, center = _fleet_clip(sz, sz.cal_len + max(relock_steps,
                                                    sz.fleet_steps))
    buffers = _stream_buffers(clip, sz, range(n_cal))
    log(f"[c] generated {n_cal} x {sz.cal_len}-frame {h}x{w} u8 buffers "
        f"({buffers.nbytes / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.1f} s")

    # Calibrate with streaming re-lock on: locate plus the ring warm start.
    mon = fleet.MultiStreamMonitor(cfg_s, None, (h, w), FPS)
    t0 = time.perf_counter()
    loc = mon.calibrate(buffers)
    boxes = np.asarray(loc.boxes)
    log(f"[c] calibrate {n_cal} streams: {time.perf_counter() - t0:.1f} s "
        f"(compile included); {memory_line([dev])}")
    check(np.asarray(loc.found).all(), "fleet calibration missed a stream")
    one = jax.jit(lambda b: evm.locate(b, FPS, cfg.calibration))
    for s in range(n_cal):
        c = (center[0], center[1] + _fleet_shift(sz, s))
        check(covers(boxes[s], c), f"stream {s} box {boxes[s]} misses {c}")
        r = one(jnp.asarray(buffers[s]))
        single = (int(r.x), int(r.y), int(r.w), int(r.h))
        check(tuple(int(v) for v in boxes[s]) == single,
              f"stream {s}: fleet box {boxes[s]} != single locate {single}")
    log(f"[c] {n_cal} fleet boxes equal the single-stream locate and cover "
        f"their patches")
    del buffers

    # Steps with streaming re-lock: absorb every step, coarse localize and
    # re-lock every streaming_interval steps.
    rois = [mon._rois.copy()]
    got = []
    for k in range(relock_steps):
        res = mon.step(_stream_frames(clip, sz, range(n_cal),
                                      sz.cal_len + k))
        got.append(np.asarray(res.samples))
        rois.append(mon._rois.copy())
    got = np.stack(got)
    log(f"[c] {relock_steps} streaming steps: {mon.relocks} re-locks")
    for s in range(n_cal):
        relocks_at = {k: rois[k + 1][s] for k in range(relock_steps)
                      if not np.array_equal(rois[k + 1][s], rois[k][s])}
        want = _reference_samples(
            mon.spec, boxes[s],
            lambda k: np.roll(clip[sz.cal_len + k], _fleet_shift(sz, s),
                              axis=1), relock_steps, relocks_at)
        _check_fleet_samples(f"[c] streaming stream {s}:", got[:, s], want)
    spec = mon.spec
    del mon

    # The lockstep fleet at full width, states built from the located ROIs.
    n = sz.fleet_streams
    sel = [s % n_cal for s in range(n)]
    mon = fleet.MultiStreamMonitor(cfg, None, (h, w), FPS)
    mon.spec = spec
    mon.states = fleet.init_stream_states(spec, boxes[sel])
    got, times = [], []
    for k in range(sz.fleet_steps):
        frames = _stream_frames(clip, sz, sel, sz.cal_len + k)
        t0 = time.perf_counter()
        res = mon.step(frames)
        jax.block_until_ready(res.samples)
        times.append(time.perf_counter() - t0)
        got.append(np.asarray(res.samples))
    got = np.stack(got)
    steady = float(np.median(times[2:]))
    log(f"[c] {n}x{h}x{w} lockstep: first two steps {times[0]:.2f} s, "
        f"{times[1]:.2f} s (compile); steady {steady * 1e3:.3f} ms/step "
        f"(median of {len(times) - 2}, u8 frames uploaded each step) -> "
        f"{n / steady:.0f} stream-frames/s; {memory_line([dev])}")
    worst = 0.0
    all_bitwise = True
    for s in range(n_cal):
        want = _reference_samples(
            spec, boxes[s],
            lambda k: np.roll(clip[sz.cal_len + k], _fleet_shift(sz, s),
                              axis=1), sz.fleet_steps)
        for j in [i for i in range(n) if sel[i] == s]:
            b, m = _check_fleet_samples(f"[c] stream {j}:", got[:, j], want)
            all_bitwise &= b
            worst = max(worst, m)
    log(f"[c] all {n} streams: bitwise {all_bitwise}, max |d| {worst:.3e}")


# ---------------------------------------------------------------------------
# Phase d: card-only parity
# ---------------------------------------------------------------------------

def _corpus_check(sz: Sizes):
    """The BPM estimator, with its f64 wild-fit refit (pipeline/bpm.py, run
    under jax.enable_x64 inside the trace), against the golden chain on
    every sliding window of a trace corpus (``bench.py --bpm-corpus``)."""
    from respmon_tpu.utils import parity
    from tests.golden import reference_numpy as golden

    st = parity.corpus_summary(parity.bpm_corpus(
        parity.corpus_traces(sz.corpus_traces),
        lambda y, t, fps: golden.measure_bpm(y, t, fps)[0]))
    log(f"[d] BPM corpus with the f64 refit ({st['n_traces']} traces): "
        f"has-BPM mismatch rate {st['has_bpm_mismatch_rate']}, p99 |dBPM| "
        f"{st['delta_p99']}, max {st['value']} over {st['n_both_have_bpm']} "
        f"(tolerance: mismatch rate <= 0.005, p99 <= {BPM_TOL})")
    check(st["has_bpm_mismatch_rate"] <= 0.005 and st["delta_p99"] <= BPM_TOL,
          "f64 refit BPM disagrees with the golden chain")


def locate_reference(vid_u8, cfg):
    """Float64 locate of a u8 buffer on the host CPU device: the jitted
    program the CPU suite pins to the cv2 golden chain."""
    import jax

    from respmon_tpu.pipeline import evm

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        vid = jax.device_put(vid_u8.astype(np.float64) * (1.0 / 255.0), cpu)
        r = evm.locate(vid, FPS, cfg)
        return ((int(r.x), int(r.y), int(r.w), int(r.h)),
                np.asarray(r.heatmap_u8))


def phase_parity(sz: Sizes):
    import jax
    import jax.numpy as jnp

    from respmon_tpu.io.synthetic import breathing_clip
    from respmon_tpu.pipeline import evm
    from respmon_tpu.utils import parity

    bad = parity.u8_widen_mismatches()
    log(f"[d] u8 widen vs the host chain: {256 - bad.size}/256 bytes "
        f"bit-exact (need all)")
    check(bad.size == 0, f"u8 widen differs on bytes {bad.tolist()}")
    ar, an, nr, nn = parity.gaussfit_agreement()
    # tests/test_gaussfit.py pins the float32 envelope of this probe at
    # 75/80 realistic windows; allow one more flip on the card.
    need = 74 / 80
    log(f"[d] gaussfit accept/reject vs scipy curve_fit: realistic "
        f"{ar:.4f} of {nr} (need >= {need:.4f}), pure noise {an:.4f} of "
        f"{nn} (reported only)")
    check(ar >= need, "device LM fit disagrees with scipy beyond the "
                      "float32 envelope")
    _corpus_check(sz)

    cfg = _monitor_cfg(sz).calibration
    try:
        import cv2  # noqa: F401
        from tests.golden import reference_numpy as golden
    except ImportError:
        golden = None
    for t, h, w in sz.locate_shapes:
        clip = _u8(breathing_clip(num_frames=t, height=h, width=w, fps=FPS,
                                  bpm=BPM_TRUE, patch_size=(h // 6, w // 6),
                                  amplitude=0.12, motion_px=2.0,
                                  texture_motion=True))
        fn = jax.jit(lambda v: evm.locate(v, FPS, cfg))
        dev = jnp.asarray(clip)
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(dev))
        comp = time.perf_counter() - t0
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(dev))
            reps.append(time.perf_counter() - t0)
        got = (int(r.x), int(r.y), int(r.w), int(r.h))
        t0 = time.perf_counter()
        want, heat = locate_reference(clip, cfg)
        ref_s = time.perf_counter() - t0
        dh = heatmap_diff(r.heatmap_u8, heat)
        log(f"[d] locate {t}x{h}x{w} u8: first call {comp:.2f} s, steady "
            f"{np.median(reps) * 1e3:.3f} ms; box {got} vs host float64 "
            f"{want} over all {t} frames ({ref_s:.1f} s; must be equal); "
            f"heatmap max |d| {dh} (tolerance 1 level of 255)")
        check(got == want and dh <= 1, "locate differs from the float64 "
                                       "reference")
        if golden is not None:
            g = golden.locate(clip.astype(np.float64) / 255.0, FPS,
                              pyramid_levels=cfg.pyramid_levels,
                              skip_levels_at_top=cfg.skip_levels_at_top)
            log(f"[d] cv2 golden chain box {g} (must be equal)")
            check(g is not None and tuple(g) == got,
                  "locate differs from the cv2 golden chain")
        else:
            log("[d] cv2 not installed: the host float64 program is the "
                "locate reference")
    log(f"[d] {memory_line([jax.devices()[0]])}")


# ---------------------------------------------------------------------------
# Phase e: four cards
# ---------------------------------------------------------------------------

def phase_four_cards(sz: Sizes):
    import jax
    import jax.numpy as jnp

    from respmon_tpu.parallel import streams as fleet
    from respmon_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 devices, found {len(devs)}")
    mesh = make_mesh()
    cfg = _monitor_cfg(sz)
    h, w = sz.fleet_hw
    n_cal = 4 * sz.four_cal_per_card
    n = 4 * sz.four_steps_per_card
    clip, center = _fleet_clip(sz, sz.cal_len + sz.four_steps)
    buffers = _stream_buffers(clip, sz, range(n_cal))

    mon4 = fleet.MultiStreamMonitor(cfg, mesh, (h, w), FPS)
    t0 = time.perf_counter()
    loc4 = mon4.calibrate(buffers)
    boxes = np.asarray(loc4.boxes)
    log(f"[e] sharded calibrate of {n_cal} streams: "
        f"{time.perf_counter() - t0:.1f} s (compile included)")
    check(np.asarray(loc4.found).all(), "sharded calibration missed a stream")
    sel = [s % n_cal for s in range(n)]
    mon4.states = fleet.shard_streams(
        fleet.init_stream_states(mon4.spec, boxes[sel]), mesh)
    got4, times4 = [], []
    for k in range(sz.four_steps):
        frames = _stream_frames(clip, sz, sel, sz.cal_len + k)
        t0 = time.perf_counter()
        res = mon4.step(frames)
        jax.block_until_ready(res.samples)
        times4.append(time.perf_counter() - t0)
        got4.append(np.asarray(res.samples))
    got4 = np.stack(got4)
    log(f"[e] sharded {n}-stream step: steady "
        f"{np.median(times4[2:]) * 1e3:.3f} ms (first two {times4[0]:.2f} s, "
        f"{times4[1]:.2f} s)")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs]
    log(f"[e] per-device peak after the sharded fleet: {memory_line(devs)}")
    check(min(peaks) >= 0.5 * max(peaks),
          "the sharded fleet did not spread over the four cards")

    # The same streams on one card (mesh=None): calibrate in chunks that
    # fit it, then the same lockstep steps.
    boxes1 = []
    for lo in range(0, n_cal, sz.four_cal_per_card):
        chunk = jax.device_put(buffers[lo:lo + sz.four_cal_per_card],
                               devs[0])
        r = fleet.locate_streams(chunk, FPS, cfg.calibration)
        check(np.asarray(r.found).all(), "one-card calibration missed")
        boxes1.append(np.asarray(r.boxes))
    boxes1 = np.concatenate(boxes1)
    check(np.array_equal(boxes, boxes1),
          "sharded calibration boxes differ from one card")
    log(f"[e] all {n_cal} sharded boxes equal the one-card boxes")
    del buffers
    mon1 = fleet.MultiStreamMonitor(cfg, None, (h, w), FPS)
    mon1.spec = mon4.spec
    mon1.states = fleet.init_stream_states(mon4.spec, boxes[sel])
    got1, times1 = [], []
    for k in range(sz.four_steps):
        frames = _stream_frames(clip, sz, sel, sz.cal_len + k)
        t0 = time.perf_counter()
        res = mon1.step(jnp.asarray(frames))
        jax.block_until_ready(res.samples)
        times1.append(time.perf_counter() - t0)
        got1.append(np.asarray(res.samples))
    got1 = np.stack(got1)
    log(f"[e] one-card {n}-stream step: steady "
        f"{np.median(times1[2:]) * 1e3:.3f} ms")
    bitwise, max_abs, ok = compare_samples(got4, got1, FLEET_SAMPLE_TOL)
    log(f"[e] {n} streams x {sz.four_steps} steps, four cards vs one: "
        f"bitwise {bitwise}, max |d| {max_abs:.3e} (tolerance "
        f"{FLEET_SAMPLE_TOL})")
    check(ok, "sharded fleet samples differ from one card")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the stream-sharded fleet on four cards "
                        "and its one-card comparison")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2

    from respmon_tpu.io.native import load_native
    from respmon_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    log(f"devices: {jax.devices()}")
    log(f"native frame ring: "
        f"{'loaded' if load_native() is not None else 'not loaded'}")
    sz = Sizes()
    t_all = time.perf_counter()
    if args.four_cards:
        phases = [("e four cards", lambda: phase_four_cards(sz))]
    else:
        state = {}
        phases = [
            ("a single camera",
             lambda: state.setdefault("a", phase_single_camera(sz))),
            ("b whole clip", lambda: phase_whole_clip(sz, state["a"])),
            ("c fleet", lambda: phase_fleet(sz)),
            ("d parity", lambda: phase_parity(sz)),
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        log(f"=== phase {name}")
        run()
        log(f"=== phase {name}: passed in {time.perf_counter() - t0:.1f} s;"
            f" {memory_line(jax.devices())}")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(f"card: {card_line()}")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
