"""The parity probes (respmon_tpu/utils/parity.py) on the CPU backend, where
the suite pins what they must find on any device."""

import numpy as np
import pytest

from respmon_tpu.utils import parity

from tests.golden import reference_numpy as golden


def test_u8_widen_is_bit_exact():
    assert parity.u8_widen_mismatches().size == 0


def test_gaussfit_agreement_counts_and_envelope():
    ar, an, nr, nn = parity.gaussfit_agreement()
    assert (nr, nn) == (80, 40)
    # tests/test_gaussfit.py's float32 envelope on realistic windows.
    assert round(ar * nr) >= 75
    assert 0.0 <= an <= 1.0


@pytest.mark.parametrize("i,kind,fps", [(0, "clean", 5.01), (1, "drift", 5.01),
                                        (3, "step", 5.01), (38, "spike", 7.68),
                                        (70, "spike", 10.0)])
def test_corpus_traces_regimes(i, kind, fps):
    tr = parity.corpus_traces(120)[i]
    assert (tr["kind"], tr["fps"]) == (kind, fps)
    assert tr["y"].shape == tr["t"].shape == (192,)
    np.testing.assert_allclose(np.diff(tr["t"]), 1.0 / fps)


def test_corpus_traces_are_deterministic():
    a, b = parity.corpus_traces(5), parity.corpus_traces(5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["y"], y["y"])


def test_bpm_corpus_counts_and_summary():
    traces = parity.corpus_traces(4)
    res = parity.bpm_corpus(traces, lambda y, t, fps: golden.measure_bpm(
        y, t, fps)[0], stride=16)
    assert res.n_steps == 4 * len(range(13, 193, 16))
    assert res.deltas.size == len(res.kinds) > 0
    assert res.per_trace_max.shape == (4,)
    st = parity.corpus_summary(res)
    assert st["n_traces"] == 4 and st["n_steps"] == res.n_steps
    assert st["n_both_have_bpm"] == res.deltas.size
    assert st["has_bpm_mismatch_rate"] == round(res.n_mismatch
                                                / res.n_steps, 5)
    assert set(st["per_kind_max"]) <= {"clean", "drift", "spike", "step"}


def test_bpm_corpus_sees_a_wrong_reference():
    # A reference that never finds a BPM disagrees wherever the device
    # finds one: every such step is a has-BPM mismatch, none a delta.
    traces = parity.corpus_traces(2)
    res = parity.bpm_corpus(traces, lambda y, t, fps: None, stride=32)
    assert res.deltas.size == 0
    assert res.n_mismatch > 0
