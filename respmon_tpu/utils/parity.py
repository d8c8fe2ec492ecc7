"""Parity probes: the device numerics against host references.

The CPU suite pins each of these on the CPU backend.  ``chip_smoke.py`` and
``bench.py`` repeat them on the backend they run on, where another rounding
of the u8 widen or reduced-precision matmuls in the LM fit would show.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np


def u8_widen_mismatches() -> np.ndarray:
    """Bytes whose device u8->f32 widen differs bitwise from the host chain
    (float64 x 1/255 rounded to float32); empty when all 256 agree."""
    import jax
    import jax.numpy as jnp

    from respmon_tpu.ops.dtype import uint8_to_float

    b = np.arange(256, dtype=np.uint8)
    want = (b.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    got = np.asarray(jax.jit(uint8_to_float)(jnp.asarray(b)))
    return np.nonzero(got.view(np.uint32) != want.view(np.uint32))[0]


def gaussfit_agreement(n_windows: int = 120):
    """Accept/reject agreement of the device LM Gaussian fit with scipy's
    ``curve_fit`` on windows shaped like the reference call site
    (base.py:319-337: ~2 s at 10 fps around a candidate peak).

    Returns (agreement_realistic, agreement_noise, n_realistic, n_noise).
    Pure-noise windows are counted apart: their decisions are near-arbitrary
    (tiny numeric differences flip scipy itself), as in
    tests/test_gaussfit.py."""
    import jax
    import jax.numpy as jnp
    from scipy.optimize import curve_fit

    from respmon_tpu.ops import gaussfit

    rng = np.random.default_rng(2024)
    fps = 10.0
    pad = 32
    wins, kinds = [], []
    for trial in range(n_windows):
        n = int(rng.integers(4, 21))
        t0 = rng.uniform(0, 12)
        t = t0 + np.arange(n) / fps
        kind = trial % 3
        if kind == 0:    # genuine peak (sigma swept across the cutoff)
            sig = rng.uniform(0.1, 1.2)
            c = t0 + n / (2 * fps)
            y = rng.uniform(0.2, 3) * np.exp(-((t - c) ** 2)
                                             / (2 * sig ** 2)) \
                + rng.normal(0, 0.05, n)
        elif kind == 1:  # oscillation fragment (filtered-signal look)
            y = np.sin(2 * np.pi * rng.uniform(0.2, 0.45) * t) \
                + rng.normal(0, 0.1, n)
        else:            # pure noise
            y = rng.normal(0, 1, n)
        wins.append((t, y))
        kinds.append(kind)

    T = np.zeros((n_windows, pad), np.float32)
    Y = np.zeros((n_windows, pad), np.float32)
    M = np.zeros((n_windows, pad), bool)
    for i, (t, y) in enumerate(wins):
        T[i, :len(t)] = t
        Y[i, :len(y)] = y
        M[i, :len(t)] = True
    res = jax.jit(gaussfit.gaussian_fit_batch)(
        jnp.asarray(T), jnp.asarray(Y), jnp.asarray(M))
    got_dev = np.asarray(res.dev)
    got_conv = np.asarray(res.converged)

    def gauss(x, a, c, s):
        return a * np.exp(-((x - c) ** 2) / (2 * s ** 2))

    agree = [0, 0]
    total = [0, 0]
    for i, (t, y) in enumerate(wins):
        try:
            p, _ = curve_fit(gauss, t, y,
                             p0=[y.max(), t[0], (t[1] - t[0]) * 5])
            want = p[2] < 10.0
        except (RuntimeError, TypeError):
            want = False
        got = bool(got_conv[i]) and float(got_dev[i]) < 10.0
        b = 1 if kinds[i] == 2 else 0
        total[b] += 1
        agree[b] += int(got == want)
    return (agree[0] / max(total[0], 1), agree[1] / max(total[1], 1),
            total[0], total[1])


def corpus_traces(n_traces: int, length: int = 192):
    """Synthetic motion-trace corpus across BPM/noise/fps/fault regimes.
    Returns a list of dicts with float64 ``y``/``t``."""
    kinds = ("clean", "drift", "spike", "step")
    bpms = (8.0, 12.0, 16.0, 18.0, 22.0, 26.0, 30.0)
    noises = (0.02, 0.05, 0.1, 0.2, 0.4)
    fpss = (5.01, 7.68, 10.0)
    out = []
    i = 0
    while len(out) < n_traces:
        bpm = bpms[i % len(bpms)]
        noise = noises[(i // len(bpms)) % len(noises)]
        fps = fpss[(i // (len(bpms) * len(noises))) % len(fpss)]
        kind = kinds[i % len(kinds)]
        rng = np.random.default_rng(1000 + i)
        t = np.arange(length) / fps
        f = bpm / 60.0
        if kind == "step":        # rate change mid-trace (subject settles)
            f2 = f * rng.uniform(0.6, 1.5)
            phase = np.where(t < t[length // 2],
                             2 * np.pi * f * t,
                             2 * np.pi * f * t[length // 2]
                             + 2 * np.pi * f2 * (t - t[length // 2]))
            y = np.sin(phase)
        else:
            y = np.sin(2 * np.pi * f * t)
        if kind == "drift":       # amplitude decay (weakening signal)
            y = y * np.linspace(1.0, 0.25, length)
        if kind == "spike":       # transient occlusion-like bursts
            for s in rng.integers(20, length - 4, size=3):
                y[s:s + 3] += rng.uniform(2.0, 5.0)
        y = y + noise * rng.standard_normal(length)
        out.append({"y": y, "t": t, "fps": fps, "bpm": bpm,
                    "noise": noise, "kind": kind})
        i += 1
    return out


class CorpusResult(NamedTuple):
    deltas: np.ndarray      # |dBPM| where both chains have a BPM
    kinds: list             # the trace kind of each delta
    per_trace_max: np.ndarray
    n_steps: int
    n_mismatch: int         # steps where only one chain has a BPM


def bpm_corpus(traces, reference: Callable[..., Optional[float]], cfg=None,
               stride: int = 1) -> CorpusResult:
    """The device BPM estimator (f32, with its f64 refit) over every
    ``stride``-th sliding ring window of every trace, window by window
    against ``reference(y, t, fps)`` (a BPM or None), as the monitor runs
    ``measure()`` on its full ring every frame (reference base.py:312-352).
    """
    import jax
    import jax.numpy as jnp

    from respmon_tpu.config import MeasureConfig
    from respmon_tpu.ops import filters
    from respmon_tpu.pipeline import bpm as bpm_mod

    cfg = cfg or MeasureConfig()
    n_ring = cfg.buffer_length
    fns = {}
    deltas, kinds, per_trace = [], [], []
    n_steps = n_mismatch = 0
    for tr in traces:
        y, t, fps = tr["y"], tr["t"], tr["fps"]
        if fps not in fns:
            coeffs = filters.design_butter_lowpass(0.5, fps,
                                                   cfg.filter_order)
            min_dist = max(int(np.floor(fps / 1.0)), 1)
            fns[fps] = jax.jit(jax.vmap(
                lambda d, tt, c, co=coeffs, md=min_dist:
                bpm_mod.estimate_bpm(d, tt, c, co, md, cfg)))
        steps = list(range(cfg.initialization_length + 1, len(y) + 1,
                           stride))
        k = len(steps)
        D = np.zeros((k, n_ring), np.float32)
        T = np.zeros((k, n_ring), np.float32)
        C = np.zeros((k,), np.int32)
        for j, c in enumerate(steps):
            m = min(c, n_ring)
            D[j, n_ring - m:] = y[c - m:c]
            T[j, n_ring - m:] = t[c - m:c]
            C[j] = m
        res = fns[fps](jnp.asarray(D), jnp.asarray(T), jnp.asarray(C))
        dev_has = np.asarray(res.has_bpm)
        dev_bpm = np.asarray(res.bpm)
        worst = 0.0
        for j, c in enumerate(steps):
            m = min(c, n_ring)
            ob = reference(y[c - m:c], t[c - m:c], fps)
            n_steps += 1
            if (ob is not None) != bool(dev_has[j]):
                n_mismatch += 1
            elif ob is not None:
                d = abs(float(dev_bpm[j]) - ob)
                deltas.append(d)
                kinds.append(tr["kind"])
                worst = max(worst, d)
        per_trace.append(worst)
    return CorpusResult(np.asarray(deltas), kinds, np.asarray(per_trace),
                        n_steps, n_mismatch)


def corpus_summary(res: CorpusResult) -> dict:
    """The corpus result as one JSON-ready record."""
    d = res.deltas
    by_kind = {}
    for kind, v in zip(res.kinds, d):
        by_kind.setdefault(kind, []).append(v)
    return {
        "metric": "bpm_corpus_max_abs_delta_vs_scipy_f64",
        "value": round(float(d.max()) if d.size else 0.0, 4),
        "unit": "bpm",
        "vs_baseline": 0.5,   # BASELINE bar: +-0.5 BPM
        "n_traces": len(res.per_trace_max),
        "n_steps": res.n_steps,
        "n_both_have_bpm": int(d.size),
        "has_bpm_mismatch_rate": round(res.n_mismatch
                                       / max(res.n_steps, 1), 5),
        "delta_p50": round(float(np.percentile(d, 50)), 5),
        "delta_p99": round(float(np.percentile(d, 99)), 5),
        "delta_p999": round(float(np.percentile(d, 99.9)), 5),
        "traces_within_half_bpm": int((res.per_trace_max <= 0.5).sum()),
        "per_kind_max": {k: round(float(np.max(v)), 4)
                         for k, v in sorted(by_kind.items())},
        "per_kind_p99": {k: round(float(np.percentile(v, 99)), 4)
                         for k, v in sorted(by_kind.items())},
    }
