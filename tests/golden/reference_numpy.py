"""Host-side oracle of the reference pipeline's numerical behavior.

This module is the test-time ground truth: a from-scratch numpy/cv2/scipy
model of every stage of the reference monitor, written against the semantics
documented in SURVEY.md (with reference file:line citations inline).  It is
used to validate the JAX kernels; it is NOT part of the shipped framework.

peakutils is not installed in this environment, so its entry points used by
the reference (``indexes`` at base.py:314, ``gaussian_fit``/``gaussian`` at
base.py:327-328) are provided two ways: the VENDORED actual peakutils
sources (tests/golden/vendor/peakutils.py — what the golden pipeline below
runs) and an independent re-derivation from the published semantics
(``rederived_*`` below, cross-checked against the vendored copy in
tests/test_peaks.py).
"""

from __future__ import annotations

import numpy as np

from .vendor import peakutils as vendored_peakutils


# ---------------------------------------------------------------------------
# peakutils oracle — the vendored actual sources are authoritative; the
# re-derivations document the semantics independently.
# ---------------------------------------------------------------------------

def peakutils_indexes(y, thres=0.3, min_dist=1):
    """peakutils.indexes (reference call: base.py:314) — vendored source."""
    return vendored_peakutils.indexes(np.asarray(y, dtype=float),
                                      thres=thres, min_dist=min_dist)


def peakutils_gaussian(x, ampl, center, dev):
    return vendored_peakutils.gaussian(x, ampl, center, dev)


def peakutils_gaussian_fit(x, y, center_only=True):
    """peakutils.gaussian_fit (reference call: base.py:327) — vendored
    source.  Raises RuntimeError on non-convergence like curve_fit."""
    return vendored_peakutils.gaussian_fit(np.asarray(x, dtype=float),
                                           np.asarray(y, dtype=float),
                                           center_only=center_only)


def rederived_indexes(y, thres=0.3, min_dist=1):
    """Independent re-derivation of peakutils.indexes semantics."""
    y = np.asarray(y, dtype=float)
    thres = thres * (np.max(y) - np.min(y)) + np.min(y)
    min_dist = int(min_dist)

    dy = np.diff(y)
    zeros, = np.where(dy == 0)
    if len(zeros) == len(y) - 1:
        return np.array([], dtype=int)

    if len(zeros):
        # Split zero indices into consecutive runs (plateaus).
        splits = np.where(np.diff(zeros) != 1)[0] + 1
        plateaus = np.split(zeros, splits)
        if plateaus and plateaus[0][0] == 0:
            dy[plateaus[0]] = dy[plateaus[0][-1] + 1]
            plateaus = plateaus[1:]
        if plateaus and plateaus[-1][-1] == len(dy) - 1:
            dy[plateaus[-1]] = dy[plateaus[-1][0] - 1]
            plateaus = plateaus[:-1]
        for run in plateaus:
            med = np.median(run)
            dy[run[run < med]] = dy[run[0] - 1]
            dy[run[run >= med]] = dy[run[-1] + 1]

    cand = np.where((np.hstack([dy, 0.0]) < 0.0)
                    & (np.hstack([0.0, dy]) > 0.0)
                    & (y > thres))[0]

    if cand.size > 1 and min_dist > 1:
        keep_order = cand[np.argsort(y[cand], kind="stable")][::-1]
        suppressed = np.ones(y.size, dtype=bool)
        suppressed[cand] = False
        for p in keep_order:
            if not suppressed[p]:
                lo = max(0, p - min_dist)
                suppressed[lo:p + min_dist + 1] = True
                suppressed[p] = False
        cand = np.arange(y.size)[~suppressed]
    return cand


def rederived_gaussian(x, ampl, center, dev):
    return ampl * np.exp(-((x - center) ** 2) / (2.0 * dev ** 2))


def rederived_gaussian_fit(x, y, center_only=True):
    """Independent re-derivation of peakutils.gaussian_fit: scipy curve_fit
    with the peakutils initial guess."""
    from scipy.optimize import curve_fit

    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    p0 = [np.max(y), x[0], (x[1] - x[0]) * 5.0]
    params, _ = curve_fit(rederived_gaussian, x, y, p0)
    return params[1] if center_only else params


def detect_peaks_oracle(x, mph=None, mpd=1, threshold=0.0, edge="rising",
                        valley=False):
    """Oracle for the vendored Marcos Duarte detect_peaks
    (reference prototypes/detect_peaks.py semantics)."""
    x = np.atleast_1d(x).astype("float64")
    if x.size < 3:
        return np.array([], dtype=int)
    if valley:
        x = -x
    dx = x[1:] - x[:-1]
    indnan = np.where(np.isnan(x))[0]
    if indnan.size:
        x[indnan] = np.inf
        dx[np.where(np.isnan(dx))[0]] = np.inf
    ine, ire, ife = np.array([[], [], []], dtype=int)
    if not edge:
        ine = np.where((np.hstack((dx, 0)) < 0)
                       & (np.hstack((0, dx)) > 0))[0]
    else:
        if edge.lower() in ("rising", "both"):
            ire = np.where((np.hstack((dx, 0)) <= 0)
                           & (np.hstack((0, dx)) > 0))[0]
        if edge.lower() in ("falling", "both"):
            ife = np.where((np.hstack((dx, 0)) < 0)
                           & (np.hstack((0, dx)) >= 0))[0]
    ind = np.unique(np.hstack((ine, ire, ife)))
    if ind.size and indnan.size:
        ind = ind[np.isin(ind, np.unique(np.hstack(
            (indnan, indnan - 1, indnan + 1))), invert=True)]
    if ind.size and ind[0] == 0:
        ind = ind[1:]
    if ind.size and ind[-1] == x.size - 1:
        ind = ind[:-1]
    if ind.size and mph is not None:
        ind = ind[x[ind] > mph]
    if ind.size and threshold > 0:
        dx2 = np.min(np.vstack([x[ind] - x[ind - 1],
                                x[ind] - x[ind + 1]]), axis=0)
        ind = np.delete(ind, np.where(dx2 < threshold)[0])
    if ind.size and mpd > 1:
        ind = ind[np.argsort(x[ind])][::-1]
        idel = np.zeros(ind.size, dtype=bool)
        for i in range(ind.size):
            if not idel[i]:
                idel = idel | ((ind >= ind[i] - mpd)
                               & (ind <= ind[i] + mpd))
                idel[i] = False
        ind = np.sort(ind[~idel])
    return ind


# ---------------------------------------------------------------------------
# Signal-stage oracle (reference base.py:312-352)
# ---------------------------------------------------------------------------

def butter_lowpass_filter(data, cutoff, fs, order=5):
    """Oracle for reference transforms.py:58-69 (filtfilt lowpass)."""
    from scipy.signal import butter, filtfilt

    b, a = butter(order, cutoff / (0.5 * fs), btype="low", analog=False)
    return filtfilt(b, a, np.asarray(data, dtype=float))


def find_peaks(filtered, t, width, gaussian_cutoff=10.0):
    """Oracle for reference base.py:312-338.

    Returns (accepted_indices, fits).  A candidate's fit window is
    ``[idx-w, idx+w)`` with ``w`` clamped at the edges exactly like the
    reference (including its clamp-with-already-reduced-w quirk at
    base.py:320-323); non-converging fits are dropped; acceptance requires the
    signed dev parameter < gaussian_cutoff.
    """
    t = np.asarray(t, dtype=float)
    filtered = np.asarray(filtered, dtype=float)
    indices = peakutils_indexes(filtered, min_dist=width)

    accepted = []
    fits = []
    for idx in indices:
        w = width
        if idx - width < 0:
            w = idx
        if idx + w > len(t):
            w = len(t) - idx
        ti = t[idx - w: idx + w]
        datai = filtered[idx - w: idx + w]
        try:
            params = peakutils_gaussian_fit(ti, datai, center_only=False)
            yfit = np.array([peakutils_gaussian(x, *params) for x in ti])
            ssr = np.sum((yfit - datai) ** 2.0)
            sst = np.sum((yfit - datai) ** 2.0)
            fits.append(1 - (ssr / sst) if sst else np.nan)
            if params[2] < gaussian_cutoff:
                accepted.append(int(idx))
        except RuntimeError:
            pass
        except TypeError:
            # curve_fit raises TypeError on windows with < 3 points (a
            # candidate at idx <= 1 after the edge clamp).  The reference
            # catches only RuntimeError (base.py:336-337), so it would
            # CRASH here; the rebuild's device path drops such windows
            # (gaussfit nvalid >= 3 gate -> converged=False), and this
            # oracle follows the rebuild's sane extension so whole-trace
            # corpus comparisons don't die on inputs the reference never
            # survived.
            pass
    return accepted, fits


def measure_bpm(data, t, fps, freq_max=1.0, filter_order=3,
                gaussian_cutoff=10.0):
    """Oracle for one reference ``measure()`` call (base.py:340-352).

    Returns (bpm or None, filtered, peak_indices, peak_times).
    """
    filtered = butter_lowpass_filter(data, freq_max * 0.5, fps, filter_order)
    width = int(np.floor(fps / freq_max))
    peak_indices, _ = find_peaks(filtered, t, width, gaussian_cutoff)
    peak_times = np.take(np.asarray(t, dtype=float), peak_indices)
    diffs = np.diff(peak_times)
    if len(diffs) > 0:
        return 60.0 / np.mean(diffs), filtered, peak_indices, peak_times
    return None, filtered, peak_indices, peak_times


# ---------------------------------------------------------------------------
# Vision-stage oracle (cv2-backed; reference pyramid.py / transforms.py)
# ---------------------------------------------------------------------------

def gaussian_pyramid(image, levels):
    """Oracle for reference pyramid.py:9-17."""
    import cv2

    out = [np.asarray(image, dtype=float)]
    for _ in range(1, levels):
        out.append(cv2.pyrDown(out[-1]))
    return out


def laplacian_pyramid(image, levels):
    """Oracle for reference pyramid.py:20-28."""
    import cv2

    gauss = gaussian_pyramid(image, levels)
    lap = [gauss[i] - cv2.pyrUp(gauss[i + 1],
                                dstsize=(gauss[i].shape[1], gauss[i].shape[0]))
           for i in range(levels - 1)]
    lap.append(gauss[-1])
    return lap


def laplacian_video_pyramid(video, levels):
    """Oracle for reference pyramid.py:31-48: list of (T, h_i, w_i) arrays."""
    per_frame = [laplacian_pyramid(f, levels) for f in video]
    return [np.stack([pf[lvl] for pf in per_frame])
            for lvl in range(levels)]


def collapse_laplacian_video_pyramid(pyramid):
    """Oracle for reference pyramid.py:51-69 (pyrUp-and-add chain per frame)."""
    import cv2

    T = pyramid[0].shape[0]
    out = np.empty_like(pyramid[0])
    for i in range(T):
        img = pyramid[-1][i]
        for lvl in range(len(pyramid) - 2, -1, -1):
            size = (pyramid[lvl].shape[2], pyramid[lvl].shape[1])
            img = cv2.pyrUp(img, dstsize=size) + pyramid[lvl][i]
        out[i] = img
    return out


def temporal_bandpass_fft(data, fps, freq_min, freq_max, amplification):
    """Oracle for reference transforms.py:82-102 — including the packed-rfft
    bin-indexing quirk and the complex-ifft-of-a-real-packed-array step."""
    import scipy.fftpack

    data = np.asarray(data, dtype=float)
    fft = scipy.fftpack.rfft(data, axis=0)
    frequencies = scipy.fftpack.fftfreq(data.shape[0], d=1.0 / fps)
    bound_low = (np.abs(frequencies - freq_min)).argmin()
    bound_high = (np.abs(frequencies - freq_max)).argmin()
    fft[bound_high:-bound_high] = 0
    if bound_low != 0:
        fft[:bound_low] = 0
        fft[-bound_low:] = 0
    result = np.real(scipy.fftpack.ifft(fft, axis=0))
    return result * amplification


def eulerian_magnification_bandpass(vid, fps, freq_min, freq_max,
                                    amplification, pyramid_levels=4,
                                    skip_levels_at_top=2, threshold=0.7):
    """Oracle for reference transforms.py:144-198: bandpass the mid pyramid
    levels, collapse the bandpassed pyramid, then suppress-top windowing."""
    pyr = laplacian_video_pyramid(vid, pyramid_levels)
    band = [np.zeros_like(lvl) for lvl in pyr]
    for i in range(len(pyr)):
        if i < skip_levels_at_top or i >= len(pyr) - 1:
            continue
        band[i] = temporal_bandpass_fft(pyr[i], fps, freq_min, freq_max,
                                        amplification)
    raw = collapse_laplacian_video_pyramid(band)

    lo, hi = raw.min(), raw.max()
    top = hi - (hi - lo) * threshold
    masked = raw.copy()
    masked[raw >= top] = lo
    return masked, raw


def locate(vid, fps, freq_min=0.1, freq_max=1.0, amplification=500,
           pyramid_levels=9, skip_levels_at_top=4, temporal_threshold=0.7,
           threshold=20):
    """Oracle for reference base.py:547-601 (heatmap -> threshold -> largest
    external contour -> bounding rect; None when no contours)."""
    import cv2

    masked, _ = eulerian_magnification_bandpass(
        vid, fps, freq_min, freq_max, amplification,
        pyramid_levels=pyramid_levels, skip_levels_at_top=skip_levels_at_top,
        threshold=temporal_threshold)
    avg_frame = np.average(masked, axis=0)
    rng = avg_frame.max() - avg_frame.min()
    avg_norm = (avg_frame - avg_frame.min()) / rng
    heat_u8 = np.empty(avg_norm.shape, dtype=np.uint8)
    heat_u8[:] = avg_norm * 255  # reference float_to_uint8 wrap semantics

    _, thresh = cv2.threshold(heat_u8, threshold, 255, cv2.THRESH_BINARY)
    found = cv2.findContours(thresh, cv2.RETR_EXTERNAL,
                             cv2.CHAIN_APPROX_SIMPLE)
    contours = found[0] if len(found) == 2 else found[1]
    if len(contours) <= 0:
        return None
    c = max(contours, key=cv2.contourArea)
    return cv2.boundingRect(c)
