"""End-to-end BPM decision envelope, pinned.

The per-window gaussfit agreement numbers (93-97%) are not the quantity the
±0.5 BPM bar cares about — what matters is how far the DEVICE-f32 BPM
trajectory can drift from the scipy-f64 golden chain across whole traces.
This test runs a reduced version of ``bench.py --bpm-corpus``
(``respmon_tpu/utils/parity.py``): for a spread of BPM/noise/fps/fault regimes, every sliding ring window of
every trace goes through BOTH chains and the |ΔBPM| distribution is
asserted.

Reference: base.py:312-352 (``measure()`` runs on the full ring every
frame); the golden chain is tests/golden/reference_numpy.measure_bpm.
"""

import os

import numpy as np

import jax.numpy as jnp

from respmon_tpu.config import MeasureConfig
from respmon_tpu.ops import filters
from respmon_tpu.pipeline import bpm as bpm_mod
from respmon_tpu.utils.parity import bpm_corpus, corpus_traces

from tests.golden import reference_numpy as golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_f64_refine_drops_wild_extrapolated_peak():
    # Pin the hybrid mechanism on a known flip window (corpus trace 70,
    # step 166): the f32 LM "converges" to a wild Gaussian (center ~13
    # window-spans outside, |ampl| ~19x the data) on a window where
    # scipy's f64 lmdif exhausts maxfev and the reference DROPS the peak.
    # Without refinement the device accepts the extra peak (BPM 18 vs the
    # oracle's 12); with it, the f64 re-fit rejects and the accepted-peak
    # sets match.
    import dataclasses

    tr = corpus_traces(120)[70]
    y, t, fps = tr["y"], tr["t"], tr["fps"]
    cfg_on = MeasureConfig()
    cfg_off = dataclasses.replace(cfg_on, f64_refine=False)
    n = cfg_on.buffer_length
    c = 166
    m = min(c, n)
    D = np.zeros(n, np.float32)
    T = np.zeros(n, np.float32)
    D[n - m:] = y[c - m:c]
    T[n - m:] = t[c - m:c]
    coeffs = filters.design_butter_lowpass(0.5, fps, cfg_on.filter_order)
    min_dist = max(int(np.floor(fps / 1.0)), 1)

    r_off = bpm_mod.estimate_bpm_jit(jnp.asarray(D), jnp.asarray(T),
                                     jnp.asarray(m), coeffs, min_dist,
                                     cfg_off)
    r_on = bpm_mod.estimate_bpm_jit(jnp.asarray(D), jnp.asarray(T),
                                    jnp.asarray(m), coeffs, min_dist,
                                    cfg_on)
    ob, _, orc_idx, _ = golden.measure_bpm(y[c - m:c], t[c - m:c], fps)

    acc_on = sorted((np.asarray(r_on.cand_idx)[np.asarray(r_on.accept_mask)]
                     - (n - m)).tolist())
    acc_off = sorted((np.asarray(r_off.cand_idx)
                      [np.asarray(r_off.accept_mask)] - (n - m)).tolist())
    assert acc_on == sorted(orc_idx), (acc_on, orc_idx)
    assert len(acc_off) == len(acc_on) + 1, (acc_off, acc_on)
    assert abs(float(r_on.bpm) - ob) < 1e-3


def test_f64_refine_works_with_global_x64_disabled():
    # Production runs with jax_enable_x64 OFF; the refinement gets
    # true f64 via ``jax.enable_x64`` INSIDE the trace.  The conftest
    # enables x64 globally, so this must run in a subprocess with the
    # production configuration — it pins that the mixed-mode trace (a) is
    # actually f64 inside (drops the wild peak like the x64-on path) and
    # (b) lowers without the i64-index MLIR pitfalls (ops/gaussfit.py
    # explicit-i32 index math).
    import subprocess
    import sys

    code = r"""
import jax
jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64
import numpy as np, jax.numpy as jnp
from respmon_tpu.config import MeasureConfig
from respmon_tpu.ops import filters
from respmon_tpu.pipeline import bpm as bpm_mod
from respmon_tpu.utils.parity import corpus_traces
tr = corpus_traces(120)[70]
y, t, fps = tr["y"], tr["t"], tr["fps"]
cfg = MeasureConfig()
n = cfg.buffer_length
c = 166; m = min(c, n)
D = np.zeros(n, np.float32); T = np.zeros(n, np.float32)
D[n-m:] = y[c-m:c]; T[n-m:] = t[c-m:c]
coeffs = filters.design_butter_lowpass(0.5, fps, cfg.filter_order)
r = bpm_mod.estimate_bpm_jit(jnp.asarray(D), jnp.asarray(T),
                             jnp.asarray(m), coeffs,
                             max(int(np.floor(fps)), 1), cfg)
acc = sorted((np.asarray(r.cand_idx)[np.asarray(r.accept_mask)]
              - (n - m)).tolist())
assert acc == [3, 56, 103], acc   # wild idx-20 peak dropped (oracle set)
print("X64OFF_REFINE_OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert "X64OFF_REFINE_OK" in out.stdout, (out.stdout, out.stderr[-2000:])


def test_bpm_corpus_device_f32_tracks_scipy_f64():
    # A spread of the full corpus (every 7th trace covers all kinds, most
    # BPM/noise combos, and all three fps values) at step stride 2: ~1300
    # window comparisons.
    traces = corpus_traces(120)[::7]
    cfg = MeasureConfig()
    res = bpm_corpus(traces, lambda y, t, fps: golden.measure_bpm(
        y, t, fps)[0], cfg, stride=2)
    deltas, n_steps, n_mismatch = res.deltas, res.n_steps, res.n_mismatch

    assert len(deltas) > 400, "corpus produced too few comparable steps"
    # Where BOTH chains produce a BPM, the f32 device trajectory stays
    # within the ±0.5 BPM bar of the f64 golden chain at the 99th
    # percentile, and the bulk is numerically tight.
    assert float(np.percentile(deltas, 50)) <= 0.01, \
        f"median delta {np.percentile(deltas, 50)}"
    assert float(np.percentile(deltas, 99)) <= 0.5, \
        f"p99 delta {np.percentile(deltas, 99)}"
    # has-BPM decisions agree on effectively every step (the full
    # 120-trace corpus, ``bench.py --bpm-corpus``, measures the same rate
    # on a device).
    assert n_mismatch / n_steps <= 0.02, \
        f"has_bpm mismatch rate {n_mismatch / n_steps:.3f}"
