"""Host feeder / native ring tests — the bounded-queue handoff the
design introduces (SURVEY.md §5 'race detection' note) plus native-kernel
parity."""

import threading
import time

import numpy as np
import pytest

from respmon_tpu.io.capture import ArrayCapture
from respmon_tpu.io.native import FrameRing, bgr_to_gray_f32, load_native
from respmon_tpu.runtime.feeder import FrameFeeder


def test_native_library_builds():
    # The toolchain is present in CI; the framework still works without it
    # (numpy fallback), but here we assert the native path exists.
    lib = load_native()
    assert lib is not None, "native library failed to build/load"


def test_bgr_to_gray_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    got = bgr_to_gray_f32(bgr)
    # Bit-exact: cv2's shift-15 fixed-point formula, then the CANONICAL
    # byte->[0,1] chain (f64 multiply, f32 cast — io/capture.py:52-53,
    # the same values uint8_to_float produces on device).
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    want = (gray.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_ring_fifo_and_latest():
    ring = FrameRing(4, (2, 2))
    for i in range(3):
        ring.push(np.full((2, 2), float(i)))
    f, seq = ring.pop()
    assert seq == 0 and f[0, 0] == 0.0
    f, seq = ring.pop_latest()
    assert seq == 2 and f[0, 0] == 2.0
    assert len(ring) == 0
    f, seq = ring.pop()
    assert f is None and seq == -1


def test_ring_drop_oldest_when_full():
    ring = FrameRing(2, (1,))
    for i in range(5):
        ring.push(np.asarray([float(i)]))
    f, seq = ring.pop()
    assert seq == 3 and f[0] == 3.0
    f, seq = ring.pop()
    assert seq == 4 and f[0] == 4.0


@pytest.mark.parametrize("backend", ["auto", "numpy"])
@pytest.mark.parametrize("dtype,shape", [
    (np.uint8, (3, 5)),     # 15 bytes: exercises the non-multiple-of-4 pad
    (np.uint8, (4, 4)),
    (np.float64, (2, 3)),
])
def test_ring_arbitrary_dtype_roundtrip(backend, dtype, shape, monkeypatch):
    """Frames of any dtype ride the float slots as raw bytes (uint8 camera
    frames take 4x less ring memory/H2D payload than float32)."""
    if backend == "numpy":
        import respmon_tpu.io.native as native_mod
        monkeypatch.setattr(native_mod, "load_native", lambda: None)
    rng = np.random.default_rng(0)
    ring = FrameRing(3, shape, dtype=dtype)
    frames = [(rng.random(shape) * 200).astype(dtype) for _ in range(3)]
    for f in frames:
        ring.push(f)
    for i in range(3):
        f, seq = ring.pop()
        assert seq == i
        assert f.dtype == np.dtype(dtype) and f.shape == shape
        np.testing.assert_array_equal(f, frames[i])


def test_feeder_uint8_dtype_end_to_end():
    frames = (np.arange(12, dtype=np.uint8).reshape(3, 2, 2) * 10)
    feeder = FrameFeeder(ArrayCapture(frames.astype(np.float32)),
                         capacity=4, lossless=True, dtype=np.uint8).start()
    got = []
    while True:
        f, _ = feeder.next_frame(latest=False)
        if f is None:
            break
        assert f.dtype == np.uint8
        got.append(f)
    feeder.stop()
    np.testing.assert_array_equal(np.stack(got), frames)


@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_ring_dropped_counts(backend, monkeypatch):
    if backend == "numpy":
        import respmon_tpu.io.native as native_mod
        monkeypatch.setattr(native_mod, "load_native", lambda: None)
    ring = FrameRing(2, (1,))
    assert ring.dropped == 0
    for i in range(5):
        ring.push(np.asarray([float(i)]))
    # pushes 2,3,4 each overwrote an unread slot
    assert ring.dropped == 3
    f, seq = ring.pop_latest()  # delivers 4, skips unread 3
    assert seq == 4
    assert ring.dropped == 4
    ring.push(np.asarray([5.0]))
    f, seq = ring.pop()  # FIFO delivery drops nothing
    assert seq == 5
    assert ring.dropped == 4


def test_ring_concurrent_producer_consumer():
    # SPSC stress: every consumed frame's content must match its sequence
    # stamp (no torn frames), sequences strictly increase.
    ring = FrameRing(8, (64,))
    n = 3000
    errors = []
    consumed = []

    def producer():
        for i in range(n):
            ring.push(np.full(64, float(i), np.float32))

    def consumer():
        last = -1
        idle = 0
        while idle < 2000:
            f, seq = ring.pop()
            if f is None:
                idle += 1
                time.sleep(0.0001)
                continue
            idle = 0
            if not np.all(f == float(seq)):
                errors.append(("torn", seq))
            if seq <= last:
                errors.append(("order", seq, last))
            last = seq
            consumed.append(seq)

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tc.start()
    tp.start()
    tp.join()
    tc.join()
    assert not errors, errors[:5]
    assert len(consumed) > 0
    assert consumed[-1] == n - 1  # the final frame always arrives
    # Conservation: every pushed frame is delivered, counted dropped, or
    # still resident (every tail step is a pop or a counted drop).
    assert len(consumed) + ring.dropped + len(ring) == n


@pytest.mark.parametrize("cap", [2, 8])
def test_ring_concurrent_pop_latest(cap):
    # pop_latest under lapping pressure: frames must be untorn, sequences
    # strictly increasing, and accounting must conserve.
    ring = FrameRing(cap, (64,))
    n = 10000
    errors = []
    consumed = []
    done = threading.Event()

    def producer():
        for i in range(n):
            ring.push(np.full(64, float(i), np.float32))
        done.set()

    def consumer():
        last = -1
        while True:
            f, seq = ring.pop_latest()
            if f is None:
                # Only stop once the producer has finished AND the ring is
                # drained (a plain idle counter flakes under GIL
                # starvation on 1-core CI).
                if done.is_set():
                    f, seq = ring.pop_latest()
                    if f is None:
                        break
                else:
                    continue
            if not np.all(f == float(seq)):
                errors.append(("torn", seq))
            if seq <= last:
                errors.append(("order", seq, last))
            last = seq
            consumed.append(seq)

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tc.start()
    tp.start()
    tp.join()
    tc.join()
    assert not errors, errors[:5]
    assert consumed and consumed[-1] == n - 1
    assert len(consumed) + ring.dropped + len(ring) == n


def test_feeder_end_to_end():
    frames = np.stack([np.full((4, 6), float(i), np.float32)
                       for i in range(20)])
    feeder = FrameFeeder(ArrayCapture(frames, fps=1000.0)).start()
    seen = []
    while True:
        f, seq = feeder.next_frame(latest=False, timeout=2.0)
        if f is None:
            break
        assert np.all(f == f[0, 0])
        seen.append(int(f[0, 0]))
    feeder.stop()
    assert seen, "no frames delivered"
    assert seen == sorted(seen)
    assert seen[-1] == 19
