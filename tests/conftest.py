"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices and x64
enabled: multi-device tests fake a mesh with
``--xla_force_host_platform_device_count`` (SURVEY.md §4), and x64 lets
parity tests compare bit-closely against scipy/cv2 float64 oracles (device
code is dtype-polymorphic; production runs float32).

``RESPMON_TEST_GPU=1`` lifts that pin so the ``gpu``-marked tests run on
the card in float32 (see README, Testing).  Those tests decide inside a
fixture whether a GPU is present and skip otherwise.
"""

import os

import jax

if os.environ.get("RESPMON_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_enable_x64", True)
    assert jax.devices()[0].platform == "cpu", \
        "tests must run on the virtual CPU mesh unless RESPMON_TEST_GPU=1"
