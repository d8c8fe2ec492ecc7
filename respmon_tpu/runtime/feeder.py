"""Double-buffered host→device frame feeder.

The reference's loop blocks on ``cap.read()`` every frame (base.py:416-421).
The design decouples capture from compute: a host capture thread decodes
frames into the native SPSC ring (C++ drop-oldest semantics, so a slow
device step never backs up the camera), while the consumer pulls the
freshest frame, uploads it with ``jax.device_put``, and overlaps the next
capture with the device step.  Dropped-frame counts are surfaced for
observability.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from respmon_tpu.io.capture import CaptureSource
from respmon_tpu.io.native import FrameRing


class FrameFeeder:
    def __init__(self, capture: CaptureSource, capacity: int = 4,
                 fps_limit: Optional[float] = None,
                 lossless: bool = False, dtype=np.float32) -> None:
        self.capture = capture
        # dtype: ring slot dtype.  uint8 carries camera-native frames at
        # 4x less ring memory/H2D payload; the device converts
        # (uint8_to_float is one fused op on the device side).
        self.dtype = np.dtype(dtype)
        self.ring = FrameRing(capacity,
                              (capture.height, capture.width),
                              dtype=self.dtype)
        self.fps_limit = fps_limit
        # Lossless mode (file/array replay): the capture thread applies
        # backpressure — it waits while the ring is full instead of
        # overwriting the oldest unread frame.  Matches the reference's
        # blocking ``cap.read()`` frame accounting for clips while still
        # prefetching/decoding ahead of the device step.  Live cameras
        # keep drop-oldest semantics (freshest frame wins).
        self.lossless = bool(lossless)
        self._stop = threading.Event()
        self._ended = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.frames_captured = 0

    def start(self) -> "FrameFeeder":
        self._thread = threading.Thread(target=self._capture_loop,
                                        name="frame-feeder", daemon=True)
        self._thread.start()
        return self

    def _capture_loop(self) -> None:
        interval = 1.0 / self.fps_limit if self.fps_limit else 0.0
        while not self._stop.is_set():
            t0 = time.time()
            frame = self.capture.next_frame()
            if frame is None:
                break
            if self.lossless:
                # SPSC: only the consumer shrinks the ring, so a sub-capacity
                # observation here cannot be invalidated before the push.
                while len(self.ring) >= self.ring.capacity:
                    if self._stop.is_set():
                        self._ended.set()
                        return
                    time.sleep(0.0005)
            self.ring.push(np.asarray(frame, self.dtype))
            self.frames_captured += 1
            if interval:
                remaining = interval - (time.time() - t0)
                if remaining > 0:
                    time.sleep(remaining)
        self._ended.set()

    def next_frame(self, latest: bool = True, timeout: float = 5.0):
        """Block until a frame is available (or the stream ends).

        Returns (frame, seq) or (None, -1) at end of stream.
        """
        deadline = time.time() + timeout
        while True:
            frame, seq = (self.ring.pop_latest() if latest
                          else self.ring.pop())
            if frame is not None:
                return frame, seq
            if self._ended.is_set() and len(self.ring) == 0:
                return None, -1
            if time.time() > deadline:
                return None, -1
            time.sleep(0.0005)

    @property
    def ended(self) -> bool:
        return self._ended.is_set() and len(self.ring) == 0

    @property
    def dropped(self) -> int:
        """Cumulative frames captured but never delivered to the consumer."""
        return self.ring.dropped

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
