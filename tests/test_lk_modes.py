"""The LK window sampling modes are fixed defaults, the same on every
backend: no module picks a code path by backend name."""

import dataclasses
import os

import numpy as np
import pytest

from respmon_tpu.config import MonitorConfig
from respmon_tpu.pipeline import motion

PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "respmon_tpu")


@pytest.mark.parametrize("role", ["lk_sample", "lk_prev_sample",
                                  "clip_lk_sample", "clip_prev_sample"])
def test_spec_samples_with_slices(role):
    cfg = MonitorConfig(motion_extraction_method="flow")
    spec = motion.MeasureSpec.for_roi(cfg, 1080, 1920, 220, 180, 10.0)
    assert getattr(spec, role) == "slices"
    assert {f.name for f in dataclasses.fields(spec)} >= {role}


def test_no_backend_name_branches():
    needle = "default_backend" + "("
    hits = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as fh:
                    if needle in fh.read():
                        hits.append(os.path.relpath(path, PKG))
    assert hits == []


def test_fleet_calibrate_installs_slices():
    from respmon_tpu.config import CalibrationConfig
    from respmon_tpu.io.synthetic import breathing_clip
    from respmon_tpu.parallel import streams

    cfg = MonitorConfig(motion_extraction_method="flow",
                        calibration=CalibrationConfig(
                            buffer_length=32, pyramid_levels=4,
                            skip_levels_at_top=1))
    clips = np.stack([breathing_clip(num_frames=32, height=60, width=80,
                                     fps=10.0, patch_center=(30, 40),
                                     patch_size=(16, 20), amplitude=0.25,
                                     seed=i) for i in range(2)])
    mon = streams.MultiStreamMonitor(cfg, None, (60, 80), 10.0)
    mon.calibrate(clips)
    assert (mon.spec.lk_sample, mon.spec.lk_prev_sample,
            mon.spec.clip_lk_sample, mon.spec.clip_prev_sample) == \
        ("slices",) * 4
