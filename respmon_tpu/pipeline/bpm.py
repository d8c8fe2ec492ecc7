"""BPM estimation stage — the reference's ``measure()`` as one device call.

Reference semantics (base.py:312-352), run every frame once >12 samples are
buffered: Butterworth-lowpass the motion deque at ``freq_max*0.5`` (order 3,
filtfilt), peakutils min-distance peak detection, per-candidate Gaussian
curve-fit filtering (drop non-converged, accept signed dev < 10.0), BPM = 60 /
mean(peak-to-peak interval), appended only when >= 2 accepted peaks.

Design: fixed-size right-aligned ring buffers with a valid count;
masked filtfilt → masked peak detection → all candidate windows extracted and
LM-fit in one vmapped batch → masked interval mean.  Everything is one jitted
function of static (fps-derived) parameters, reused by both the streaming
monitor and the whole-clip ``lax.scan`` fast path.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from respmon_tpu.config import MeasureConfig
from respmon_tpu.ops import filters, gaussfit, peaks


class BPMResult(NamedTuple):
    has_bpm: jnp.ndarray       # bool — a new frequency estimate was produced
    bpm: jnp.ndarray           # float — valid iff has_bpm
    filtered: jnp.ndarray      # (N,) right-aligned filtered signal
    cand_idx: jnp.ndarray      # (max_peaks,) candidate buffer indices
    cand_mask: jnp.ndarray     # (max_peaks,) candidates validity
    accept_mask: jnp.ndarray   # (max_peaks,) accepted (post Gaussian filter)
    peak_count: jnp.ndarray    # int32 number of accepted peaks


def estimate_bpm(data: jnp.ndarray, t: jnp.ndarray, count: jnp.ndarray,
                 coeffs: filters.FilterCoeffs, min_dist: int,
                 cfg: MeasureConfig) -> BPMResult:
    """One ``measure()`` call on right-aligned (N,) buffers with ``count``
    valid samples.  ``coeffs`` is the host-designed lowpass (freq_max*0.5,
    order cfg.filter_order); ``min_dist`` = floor(fps / freq_max)."""
    n = data.shape[0]
    width = max(min_dist, 1)
    max_peaks = cfg.max_peaks

    filtered = filters.filtfilt_masked(coeffs, data, count)

    cand_idx, cand_mask = peaks.peak_indexes_masked(
        filtered, count, min_dist, thres=cfg.peak_threshold,
        max_peaks=max_peaks)

    start = n - count

    # Reference window clamping (base.py:319-323), including the quirk that
    # the right clamp tests the already-reduced w.
    i_loc = cand_idx - start
    w1 = jnp.where(i_loc - width < 0, i_loc, width)
    w2 = jnp.where(i_loc + w1 > count, count - i_loc, w1)

    # Gather fixed (max_peaks, 2*width) windows starting at cand_idx - w2.
    offs = jnp.arange(2 * width)
    gidx = cand_idx[:, None] - w2[:, None] + offs[None, :]
    gclip = jnp.clip(gidx, 0, n - 1)
    win_t = t[gclip]
    win_y = filtered[gclip]
    win_mask = cand_mask[:, None] & (offs[None, :] < 2 * w2[:, None]) \
        & (gidx >= 0) & (gidx < n)

    # Static bound on how many peaks suppression can keep: at spacing
    # min_dist+1 at most n//(min_dist+1)+1 survive (peaks.py caps its
    # greedy loop there), and peak_indexes_masked compacts kept indices
    # ascending — so candidate slots >= fit_lanes are provably empty.
    # Fit only the live slots: the batched LM while_loop's per-iteration
    # cost scales with lane count, and a 128-sample ring at min_dist 10
    # can occupy at most 14 of the 32 static slots.
    fit_lanes = min(max_peaks, n // (min_dist + 1) + 1) if min_dist > 1 \
        else max_peaks
    vt = win_t[:fit_lanes]
    vy = win_y[:fit_lanes]
    vm = win_mask[:fit_lanes]
    fit = gaussfit.gaussian_fit_batch(vt, vy, vm)
    acc_lane = fit.converged & (fit.dev < cfg.gaussian_cutoff)

    if cfg.f64_refine:
        # Hybrid f64 refinement (see MeasureConfig.f64_refine): an accepted
        # f32 fit whose Gaussian is WILD — center far outside the window or
        # amplitude far above the data — marks the scipy-maxfev flip class:
        # the f64 reference path wanders past its budget (reference drops
        # the peak, base.py:336-337) while the f32 loop's loose ftol
        # (3.45e-4, the f32 roundoff floor) calls it converged.  Those
        # lanes re-fit in f64 (jax.enable_x64 inside the trace) at
        # MINPACK-grade tolerances; non-suspect lanes mask out
        # and cost nothing (done-at-init, the while_loop exits
        # immediately when no lane is live).
        big = jnp.asarray(jnp.inf, vt.dtype)
        t_lo = jnp.min(jnp.where(vm, vt, big), axis=1)
        t_hi = jnp.max(jnp.where(vm, vt, -big), axis=1)
        span = jnp.maximum(t_hi - t_lo, jnp.asarray(1e-9, vt.dtype))
        dist = jnp.maximum(jnp.maximum(t_lo - fit.center,
                                       fit.center - t_hi), 0.0) / span
        ymax = jnp.max(jnp.where(vm, jnp.abs(vy), 0.0), axis=1)
        ar = jnp.abs(fit.ampl) / jnp.maximum(ymax, 1e-12)
        # Wild CONVERGED fits refit in either decision direction: an
        # accepted wild fit may be the scipy-maxfev drop class, and a
        # REJECTED wild fit may be an iterate-path divergence away from a
        # narrow-spike minimum scipy accepts (both observed on the corpus).
        suspect = fit.converged & ((dist > 2.0) | (ar > 5.0))
        with jax.enable_x64(True):
            f64 = jnp.float64
            fit64 = gaussfit.gaussian_fit_batch(
                vt.astype(f64), vy.astype(f64), vm & suspect[:, None],
                iters=500)
            acc64 = fit64.converged & \
                (fit64.dev < jnp.asarray(cfg.gaussian_cutoff, f64))
        acc_lane = jnp.where(suspect, acc64, acc_lane)

    pad = (0, max_peaks - fit_lanes)
    accept = cand_mask & jnp.pad(acc_lane, pad)

    # Peak times of accepted candidates, compacted in ascending order.
    times = t[jnp.clip(cand_idx, 0, n - 1)]
    order = jnp.cumsum(accept) - 1
    slot = jnp.where(accept, order, max_peaks)
    compact = jnp.full((max_peaks + 1,), 0.0, times.dtype)
    compact = compact.at[slot].set(times, mode="drop")[:max_peaks]
    k = jnp.sum(accept)

    pair_mask = jnp.arange(max_peaks - 1) < (k - 1)
    diffs = compact[1:] - compact[:-1]
    interval = jnp.sum(jnp.where(pair_mask, diffs, 0.0)) / \
        jnp.maximum(jnp.sum(pair_mask), 1)
    has_bpm = k >= 2
    bpm = 60.0 / jnp.where(interval != 0, interval, 1.0)

    return BPMResult(has_bpm=has_bpm, bpm=bpm, filtered=filtered,
                     cand_idx=cand_idx, cand_mask=cand_mask,
                     accept_mask=accept, peak_count=k.astype(jnp.int32))


@partial(jax.jit, static_argnames=("coeffs", "min_dist", "cfg"))
def estimate_bpm_jit(data, t, count, coeffs, min_dist, cfg: MeasureConfig):
    return estimate_bpm(data, t, count, coeffs, min_dist, cfg)
