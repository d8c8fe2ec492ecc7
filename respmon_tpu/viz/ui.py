"""Monitor UI backends.

The reference renders a pyqtgraph window (base.py:174-225): a raw-signal plot
with peak scatter + confidence-interval fill + fitted curve, an ROI image
view, a BPM plot, a bold 24-pt BPM text item, and uses the window title as a
status line (base.py:255-297).  Here the same surface is behind a small
interface with two backends:

  - ``PyqtgraphUI``: faithful recreation (requires pyqtgraph; import is
    gated so headless deployments don't need Qt).
  - ``HeadlessUI``: records the same calls (title, image, series) into plain
    attributes — used by tests and server deployments, and doubling as an
    observability hook.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def overlay_keypoints(display_frame: np.ndarray, key_points) -> np.ndarray:
    """Draw the flow tracker's points onto a uint8 crop (reference
    base.py:272-277): per point a radius-2 filled white circle is drawn
    into a cumulative mask that is saturating-added to the frame — net
    effect, pixels inside any circle become 255.  Uses cv2's rasterization
    when available (exact reference parity); a radius-2 disc otherwise."""
    if key_points is None or len(key_points) == 0:
        return display_frame
    out = display_frame.copy()
    try:
        import cv2

        mask = np.zeros_like(display_frame)
        for new in key_points:
            a, b = new.ravel()
            mask = cv2.circle(mask, (int(round(float(a))),
                                     int(round(float(b)))), 2,
                              (255, 255, 255), -1)
            out = cv2.add(out, mask)
    except ImportError:  # pragma: no cover - cv2 always present in CI
        h, w = display_frame.shape[:2]
        yy, xx = np.ogrid[:h, :w]
        hit = np.zeros((h, w), bool)
        for new in key_points:
            a, b = new.ravel()
            a, b = int(round(float(a))), int(round(float(b)))
            hit |= (yy - b) ** 2 + (xx - a) ** 2 <= 4
        out[hit] = 255
    return out


class HeadlessUI:
    """No-op backend that retains the last values pushed to it."""

    def __init__(self) -> None:
        self.title: str = ""
        self.image = None
        self.raw_signal = ([], [])
        self.peaks = ([], [])
        self.frequency = ([], [])
        self.keypoints = None
        self.bpm_text: str = "??? BPM"
        self.autoscale: bool = False

    def set_window_title(self, title: str) -> None:
        self.title = title

    def set_image(self, img) -> None:
        self.image = img

    def set_plot_autoscale(self, enabled: bool, axes: str = "xy") -> None:
        self.autoscale = enabled

    def set_plot_x_range(self, low: float, high: float) -> None:
        pass

    def set_raw_signal(self, t, y) -> None:
        self.raw_signal = (t, y)

    def set_peaks(self, t, y) -> None:
        self.peaks = (t, y)

    def set_frequency(self, t, f) -> None:
        self.frequency = (t, f)

    def set_keypoints(self, pts) -> None:
        """Record the flow-mode tracked points drawn onto the crop
        (reference base.py:272-277); observability for headless runs."""
        self.keypoints = pts

    def set_bpm_text(self, text: str) -> None:
        self.bpm_text = text

    def clear_plots(self) -> None:
        self.raw_signal = ([], [])
        self.peaks = ([], [])
        self.frequency = ([], [])
        self.keypoints = None
        self.bpm_text = "??? BPM"

    def process_events(self) -> None:
        pass

    def close(self) -> None:
        pass


class PyqtgraphUI:
    """pyqtgraph window mirroring the reference layout (base.py:174-225)."""

    def __init__(self, fig_size: Optional[tuple] = None) -> None:
        import pyqtgraph as pg

        self._pg = pg
        # pg.mkQApp is version-proof: QtGui.QApplication moved to QtWidgets
        # in Qt6 and modern pyqtgraph no longer re-exports it from QtGui.
        self._app = pg.mkQApp()
        win = pg.GraphicsLayoutWidget(title="Respiration Monitor")
        win.resize(*(fig_size or (1500, 900)))
        pg.setConfigOptions(antialias=True)

        left = win.addPlot(title="Raw Signal")
        left.showGrid(x=True, y=True)
        left.enableAutoRange("xy", False)
        self._raw = left.plot(pen="y")
        self._peaks = left.plot(pen=None, symbolBrush=(255, 0, 0),
                                symbolPen=None)
        self._ci_top = left.plot(pen="w")
        self._ci_bot = left.plot(pen="w")
        left.addItem(pg.FillBetweenItem(self._ci_top, self._ci_bot,
                                        (255, 0, 0, 100)))
        self._fitted = left.plot(pen="g")

        view = win.addViewBox()
        view.setAspectLocked(True)
        self._image = pg.ImageItem(border="w")
        view.addItem(self._image)

        right = win.addPlot(title="Frequency Plot (bpm)")
        right.showGrid(x=True, y=True)
        right.enableAutoRange("xy", False)
        self._freq = right.plot()

        text = pg.TextItem(text="??? BPM", anchor=(-0.1, 1.2),
                           color=(255, 255, 255, 255), border=(0, 0, 0, 255),
                           fill=(0, 0, 0, 127))
        font = pg.QtGui.QFont()
        font.setBold(True)
        font.setPointSize(24)
        text.setFont(font)
        view.addItem(text)
        text.setPos(0, 0)
        self._bpm_text = text
        self._plots = [left, right]
        self._win = win
        win.show()

    def set_window_title(self, title: str) -> None:
        self._win.setWindowTitle(title)

    def set_image(self, img) -> None:
        self._image.setImage(img)

    def set_plot_autoscale(self, enabled: bool, axes: str = "xy") -> None:
        for p in self._plots:
            p.enableAutoRange(axes, enabled)

    def set_plot_x_range(self, low: float, high: float) -> None:
        for p in self._plots:
            p.setXRange(low, high, padding=0)

    def set_raw_signal(self, t, y) -> None:
        self._raw.setData(t, y)

    def set_peaks(self, t, y) -> None:
        self._peaks.setData(t, y)

    def set_frequency(self, t, f) -> None:
        self._freq.setData(t, f)

    def set_keypoints(self, pts) -> None:
        """No-op: the monitor draws keypoint circles into the crop before
        set_image (reference base.py:272-277); kept for contract parity."""

    def set_bpm_text(self, text: str) -> None:
        self._bpm_text.setText(text)

    def clear_plots(self) -> None:
        for item in (self._raw, self._freq, self._peaks, self._ci_top,
                     self._ci_bot, self._fitted):
            item.clear()
        self._bpm_text.setText("??? BPM")

    def process_events(self) -> None:
        self._app.processEvents()

    def close(self) -> None:
        self._win.close()


def make_ui(visualize: Optional[str], fig_size=None):
    """Backend factory; falls back to headless when pyqtgraph is missing."""
    if visualize == "pyqtgraph":
        try:
            return PyqtgraphUI(fig_size)
        except Exception:  # pragma: no cover - headless environments
            import logging

            logging.getLogger(__name__).warning(
                "pyqtgraph unavailable; falling back to headless UI")
            return HeadlessUI()
    return HeadlessUI()
