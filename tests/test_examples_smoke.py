"""Smoke-run every example script (SURVEY §4: the reference's prototypes
were its de-facto validation suite; their analogs must keep executing).

Each demo runs in a subprocess with tiny arguments on the CPU platform —
this catches import/API rot that unit tests of the underlying ops cannot
(the demos exercise the public composition surface).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"

CASES = [
    ("filter_explorer.py", ["--fps", "10"]),
    ("flow_demo.py", ["--frames", "90"]),
    ("gaussian_explorer.py", []),
    ("locating_demo.py", ["--frames", "36"]),
    ("multiaxis_demo.py", ["--samples", "60"]),
    ("multistream_demo.py", ["--streams", "2", "--frames", "70"]),
    ("multistream_demo.py", ["--streams", "2", "--frames", "70",
                             "--feeder"]),
    ("signal_measurement_demo.py", []),
    ("temporal_analysis_demo.py", ["--frames", "64"]),
    ("wavelet_demo.py", ["--iterations", "2"]),
]


def test_all_examples_are_covered():
    scripts = {p.name for p in EXAMPLES.glob("*.py")}
    assert scripts == {name for name, _ in CASES}, \
        "examples/ and the smoke matrix drifted"


@pytest.mark.parametrize("script,args", CASES,
                         ids=[name + ("[feeder]" if "--feeder" in a else "")
                              for name, a in CASES])
def test_example_runs(script, args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + env.get("PYTHONPATH", "").split(os.pathsep))
    env.setdefault("MPLBACKEND", "Agg")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / script)] + args,
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, \
        f"{script} failed:\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert proc.stdout.strip(), f"{script} printed nothing"
