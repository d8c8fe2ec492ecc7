"""Parity tests: trust-region LM Gaussian fit vs scipy curve_fit
(reference base.py:327-337 via peakutils.gaussian_fit)."""

import numpy as np
import pytest

import jax.numpy as jnp

from respmon_tpu.ops import gaussfit
from tests.golden import reference_numpy as golden

PAD = 32


def _pack(windows):
    """Pack variable-length (t, y) windows into fixed (B, PAD) arrays."""
    B = len(windows)
    t = np.zeros((B, PAD))
    y = np.zeros((B, PAD))
    m = np.zeros((B, PAD), dtype=bool)
    for i, (ti, yi) in enumerate(windows):
        k = len(ti)
        t[i, :k] = ti
        y[i, :k] = yi
        m[i, :k] = True
    return jnp.asarray(t), jnp.asarray(y), jnp.asarray(m)


def test_clean_gaussian_recovery():
    # Windows shaped like the reference call site: ±width around a detected
    # peak (≈±1 s at fps 10), so the peakutils initial guess (center at the
    # window start, σ = 5 samples) overlaps the true peak.
    rng = np.random.default_rng(0)
    windows = []
    truths = []
    for _ in range(8):
        ampl = rng.uniform(0.5, 3.0)
        dev = rng.uniform(0.2, 0.8)
        t = np.arange(0.0, 2.0, 0.1)
        y = golden.peakutils_gaussian(t, ampl, 1.0, dev)
        windows.append((t, y))
        truths.append((ampl, 1.0, dev))
    t, y, m = _pack(windows)
    res = gaussfit.gaussian_fit_batch(t, y, m)
    for i, (ampl, center, dev) in enumerate(truths):
        assert bool(res.converged[i]), f"window {i} did not converge"
        np.testing.assert_allclose(
            [float(res.ampl[i]), float(res.center[i]), abs(float(res.dev[i]))],
            [ampl, center, dev], rtol=1e-3)


def test_decision_agreement_with_curve_fit():
    # What matters for BPM parity is the accept/reject decision
    # (converged AND params[2] < gaussian_cutoff, base.py:334-337).
    rng = np.random.default_rng(42)
    windows = []
    for trial in range(60):
        fps = 10.0
        n = int(rng.integers(4, 21))
        t0 = rng.uniform(0, 10)
        t = t0 + np.arange(n) / fps
        kind = trial % 3
        if kind == 0:  # genuine peak
            y = golden.peakutils_gaussian(
                t, rng.uniform(0.2, 3), t0 + n / (2 * fps),
                rng.uniform(0.1, 1.0)) + rng.normal(0, 0.05, n)
        elif kind == 1:  # oscillation fragment
            y = np.sin(2 * np.pi * 0.3 * t) + rng.normal(0, 0.1, n)
        else:  # pure noise (decision near-arbitrary; excluded from scoring)
            y = rng.normal(0, 1, n)
        windows.append((t, y, kind))

    t, y, m = _pack([(w[0], w[1]) for w in windows])
    res = gaussfit.gaussian_fit_batch(t, y, m)

    agree = total = 0
    for i, (ti, yi, kind) in enumerate(windows):
        if kind == 2:
            continue
        try:
            params = golden.peakutils_gaussian_fit(ti, yi, center_only=False)
            want = params[2] < 10.0
        except RuntimeError:
            want = False
        got = bool(res.converged[i]) and float(res.dev[i]) < 10.0
        total += 1
        agree += int(got == want)
    assert agree == total, f"decision agreement {agree}/{total}"


def test_f32_envelope_including_noise_windows():
    # The FULL f32 decision envelope, pure-noise windows included — the
    # bound behind the "99% incl. noise" claim.  On degenerate windows
    # scipy's accept/reject is path-chaotic (it rejects by exhausting
    # maxfev, a property of the f64 iterate path that f32 arithmetic cannot
    # reproduce; a full-f64 fit replicates 119/120, and ftol/xtol sweeps
    # 3.45e-4→3e-7 and perturbed-restart consensus both fail to separate
    # the flip class).  This test pins the
    # measured envelope on a fixed probe so regressions are loud:
    # seed-2024 mixed probe = 112/120 overall, 1 false-reject, with the
    # realistic (non-noise) rows at 75/80.
    rng = np.random.default_rng(2024)
    fps, n_windows = 10.0, 120
    wins, kinds = [], []
    for trial in range(n_windows):
        n = int(rng.integers(4, 21))
        t0 = rng.uniform(0, 12)
        t = t0 + np.arange(n) / fps
        kind = trial % 3
        if kind == 0:
            sig = rng.uniform(0.1, 1.2)
            c = t0 + n / (2 * fps)
            y = rng.uniform(0.2, 3) * np.exp(
                -((t - c) ** 2) / (2 * sig ** 2)) + rng.normal(0, 0.05, n)
        elif kind == 1:
            y = np.sin(2 * np.pi * rng.uniform(0.2, 0.45) * t) \
                + rng.normal(0, 0.1, n)
        else:
            y = rng.normal(0, 1, n)
        wins.append((t, y))
        kinds.append(kind)

    T = np.zeros((n_windows, PAD), np.float32)
    Y = np.zeros((n_windows, PAD), np.float32)
    M = np.zeros((n_windows, PAD), bool)
    for i, (t, y) in enumerate(wins):
        T[i, :len(t)] = t
        Y[i, :len(y)] = y
        M[i, :len(t)] = True
    res = gaussfit.gaussian_fit_batch(
        jnp.asarray(T), jnp.asarray(Y), jnp.asarray(M))

    agree = fr = 0
    for i, (t, y) in enumerate(wins):
        try:
            params = golden.peakutils_gaussian_fit(t, y, center_only=False)
            want = params[2] < 10.0
        except RuntimeError:
            want = False
        got = bool(res.converged[i]) and float(res.dev[i]) < 10.0
        agree += int(got == want)
        fr += int(want and not got)
    assert agree >= 110, f"f32 envelope regressed: {agree}/120 agreement"
    assert fr <= 2, f"f32 false-rejects regressed: {fr}"


def test_insufficient_points_rejected():
    # curve_fit raises for fewer points than parameters; our analog is
    # converged=False.
    t, y, m = _pack([(np.array([0.0, 0.1]), np.array([1.0, 2.0]))])
    res = gaussfit.gaussian_fit_batch(t, y, m)
    assert not bool(res.converged[0])


def test_center_accuracy_on_noisy_peaks():
    rng = np.random.default_rng(7)
    windows = []
    centers = []
    for _ in range(6):
        fps = 10.0
        t0 = rng.uniform(0, 5)
        t = t0 + np.arange(20) / fps
        c = t0 + 1.0
        y = golden.peakutils_gaussian(t, 1.0, c, 0.4) \
            + 0.05 * rng.standard_normal(len(t))
        windows.append((t, y))
        centers.append(c)
    t, y, m = _pack(windows)
    res = gaussfit.gaussian_fit_batch(t, y, m)
    for i, c in enumerate(centers):
        assert bool(res.converged[i])
        np.testing.assert_allclose(float(res.center[i]), c, atol=0.15)
