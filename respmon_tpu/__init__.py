"""respmon_tpu — a JAX respiration-monitoring framework.

Re-implements the full capability surface of the reference ``respmon`` project
(webcam Eulerian-magnification ROI calibration, per-frame motion extraction via
pixel averaging or Lucas-Kanade optical flow + PCA projection, Butterworth
lowpass + Gaussian-fit-filtered peak-to-peak BPM estimation, and the
calibrate→measure→error→recalibrate state machine) as pure functional stages
over batched on-device buffers.

Architecture (see SURVEY.md §7):
  - ``ops``      — device kernels: pyramids, temporal FFT bandpass, IIR filters,
                   peak detection, Gaussian LM fits, connected components,
                   Shi-Tomasi corners, pyramidal Lucas-Kanade, 2x2 PCA.
  - ``pipeline`` — fused jitted stages: ``evm_heatmap``, ``locate``,
                   ``measure_step``, ``estimate_bpm``, whole-clip ``lax.scan``.
  - ``runtime``  — host state machine, ring buffers, frame feeder, recorder,
                   ``RespiratoryMonitor``-compatible facade.
  - ``parallel`` — mesh/sharding utilities: stream-axis data parallelism,
                   spatial halo sharding for large frames.
  - ``io``       — capture (OpenCV host-side), synthetic known-BPM generators.
  - ``viz``      — optional pyqtgraph UI (gated import) + headless fallback.
  - ``utils``    — Benchmarker-style profiling, bounding-box helpers.
"""

from respmon_tpu.version import __version__

__all__ = ["__version__"]
