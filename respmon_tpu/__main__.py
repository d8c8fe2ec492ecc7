"""CLI entry point (reference main.py equivalent).

``python -m respmon_tpu [target]`` runs the monitor on a webcam index or a
recorded clip, mirroring reference main.py:5-10 (timestamped INFO logging,
flow mode, calibration image saved), with flags for everything the reference
hardcodes or comments out (main.py:12-25's recorded-clip matrix).
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="respmon_tpu",
        description="Real-time camera respiration monitor")
    p.add_argument("target", nargs="?", default="0",
                   help="webcam index or video path (default: 0)")
    p.add_argument("--method", choices=("average", "flow"), default="flow")
    p.add_argument("--fps-limit", type=float, default=10.0)
    p.add_argument("--error-reset-delay", type=float, default=10.0)
    p.add_argument("--no-save", action="store_true",
                   help="disable AVI/npy session recording")
    p.add_argument("--no-viz", action="store_true",
                   help="headless (no pyqtgraph window)")
    p.add_argument("--no-sync", action="store_true",
                   help="process faster than real time (recorded clips)")
    p.add_argument("--calibration-image", action="store_true", default=True)
    p.add_argument("--skip-calibration", type=int, nargs=4,
                   metavar=("X", "Y", "W", "H"),
                   help="pin a known ROI and skip EVM calibration")
    p.add_argument("--fast", action="store_true",
                   help="offline fast path for recorded clips: decode the "
                        "whole file, then calibrate + measure in two device "
                        "calls (lax.scan) instead of streaming frame-by-"
                        "frame")
    p.add_argument("--fps", type=float, default=None,
                   help="override/declare the clip frame rate")
    p.add_argument("--verbose", action="store_true",
                   help="per-stage EVM timing logs during calibration "
                        "(reference transforms.py verbose=True)")
    p.add_argument("--uint8-ingest", action="store_true",
                   help="camera-native uint8 ingest: gray bytes ship to "
                        "the device untouched (4x less upload) and widen "
                        "there bit-exactly; results are bit-identical to "
                        "float ingest")
    args = p.parse_args(argv)

    logging.basicConfig(format="%(asctime)s :: %(message)s",
                        level=logging.INFO)

    from respmon_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    target = int(args.target) if args.target.isdigit() else args.target

    if args.fast:
        if isinstance(target, int):
            p.error("--fast requires a recorded clip path, not a live "
                    "camera (the whole file is decoded upfront)")
        if args.skip_calibration:
            p.error("--fast does not support --skip-calibration; use the "
                    "streaming mode for pinned-ROI runs")

        import numpy as np

        from respmon_tpu.config import MonitorConfig
        from respmon_tpu.io.capture import OpenCVCapture
        from respmon_tpu.pipeline.scan import process_clip_auto

        cap = OpenCVCapture(target)
        fps = args.fps or cap.fps
        if fps != fps:  # NaN: container carried no rate
            p.error("--fast needs a known fps (pass --fps)")
        fps = min(float(fps), args.fps_limit)  # mirror detect_fps limiting
        frames = []
        while True:
            f = cap.next_frame()
            if f is None:
                break
            frames.append(f)
        cap.release()
        clip = np.stack(frames).astype(np.float32)
        cfg = MonitorConfig(motion_extraction_method=args.method)
        res = process_clip_auto(clip, fps, cfg,
                                error_reset_delay=args.error_reset_delay)
        if not any(ep.result.found for ep in res.episodes):
            logging.error("calibration found no ROI")
            return 1
        for ep in res.episodes:
            if ep.result.found:
                logging.info("episode@{0}: ROI {1}".format(
                    ep.start_frame, ep.result.roi))
            if ep.result.error_frame is not None:
                logging.warning(
                    "tracking lost at clip frame {0}; recalibrated from "
                    "the loss point (streaming-monitor error cycle)".format(
                        ep.start_frame + cfg.calibration.buffer_length + 2
                        + ep.result.error_frame))
        if res.exhausted:
            logging.warning("gave up after {0} episodes (max_episodes); "
                            "clip tail unprocessed".format(
                                len(res.episodes)))
        logging.info("Final BPM estimate: {0}".format(res.final_bpm))
        return 0

    from respmon_tpu.runtime import RespiratoryMonitor

    mon = RespiratoryMonitor(
        capture_target=target,
        save_calibration_image=args.calibration_image,
        visualize=None if args.no_viz else "pyqtgraph",
        fps_limit=args.fps_limit,
        error_reset_delay=args.error_reset_delay,
        save_all_data=not args.no_save,
        motion_extraction_method=args.method,
        auto_run=False,
        sync_fps=not args.no_sync,
        verbose_evm=args.verbose,
        native_uint8=args.uint8_ingest)
    if args.skip_calibration:
        mon.fps = mon.fps if mon.fps == mon.fps else args.fps_limit
        mon.skip_calibration(*args.skip_calibration)
    mon.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
