"""Temporal bandpass with the reference's exact packed-rfft semantics — as a
single matmul.

The reference (transforms.py:82-102) does, per pixel along the T axis:

  1. ``scipy.fftpack.rfft`` — the *packed* real FFT layout
     ``[c0.re, c1.re, c1.im, c2.re, c2.im, ..., (c_{n/2}.re)]``.
  2. Zeroes packed slots by indices derived from ``fftfreq`` argmin — a
     units quirk (spectrum bin indices applied to the packed layout) that
     defines the effective passband, reproduced verbatim:
         bound_low  = argmin |fftfreq - freq_min|
         bound_high = argmin |fftfreq - freq_max|
         fft[bound_high:-bound_high] = 0
         if bound_low != 0: fft[:bound_low] = 0; fft[-bound_low:] = 0
  3. ``scipy.fftpack.ifft`` of the still-*real* packed array (complex IDFT of
     a real vector), takes the real part, multiplies by amplification.

Every step is linear in the T axis with static coefficients, so the whole
chain collapses into one real (T, T) operator built on host in float64:

    M[m, t] = amp / T * sum_k mask[k] * P[k, t] * cos(2*pi*k*m / T)

with the packing matrix P (P[0]=cos(0·), P[2j-1]=cos(2πjt/T),
P[2j]=-sin(2πjt/T), and for even T, P[T-1]=cos(πt)).  On device the bandpass
is then ``M @ X`` over flattened pixels (one (T,T)x(T,HW) matmul per
pyramid level instead of per-pixel FFTs), and
bit-faithful to the reference since the operator itself is exact.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=64)
def packed_bandpass_mask(n: int, fps: float, freq_min: float,
                         freq_max: float) -> tuple:
    """The reference's packed-slot zeroing mask (transforms.py:88-94)."""
    frequencies = np.fft.fftfreq(n, d=1.0 / fps)
    bound_low = int(np.abs(frequencies - freq_min).argmin())
    bound_high = int(np.abs(frequencies - freq_max).argmin())
    # Plain-slicing statements mirror the reference exactly (including the
    # no-op when bound_high == 0).
    mask = np.ones(n)
    mask[bound_high:-bound_high] = 0
    if bound_low != 0:
        mask[:bound_low] = 0
        mask[-bound_low:] = 0
    return tuple(mask.tolist())


@lru_cache(maxsize=64)
def packed_bandpass_operator(n: int, fps: float, freq_min: float,
                             freq_max: float,
                             amplification: float) -> np.ndarray:
    """(T, T) float64 operator equal to amp * Re(ifft(mask * packed_rfft(x)))."""
    t = np.arange(n)
    k = np.arange(n)

    # Packing matrix P: packed_rfft(x) = P @ x.
    P = np.zeros((n, n))
    P[0] = 1.0  # c0.re = sum(x)
    half = (n - 1) // 2
    for j in range(1, half + 1):
        P[2 * j - 1] = np.cos(2.0 * np.pi * j * t / n)
        P[2 * j] = -np.sin(2.0 * np.pi * j * t / n)
    if n % 2 == 0:
        P[n - 1] = np.cos(np.pi * t)  # Nyquist bin, real

    mask = np.asarray(packed_bandpass_mask(n, fps, freq_min, freq_max))
    # Re(ifft(v)) for real v: C[m, k] = cos(2*pi*k*m/n) / n.
    C = np.cos(2.0 * np.pi * np.outer(t, k) / n) / n
    return amplification * (C @ (mask[:, None] * P))


def temporal_bandpass_fft(vid: jnp.ndarray, fps: float, freq_min: float,
                          freq_max: float,
                          amplification: float) -> jnp.ndarray:
    """Apply the packed-rfft bandpass along axis 0 of ``vid`` (T, ...).

    Replaces reference transforms.py:82-102 with one matmul.
    """
    n = vid.shape[0]
    op = packed_bandpass_operator(n, float(fps), float(freq_min),
                                  float(freq_max), float(amplification))
    M = jnp.asarray(op, dtype=vid.dtype)
    flat = vid.reshape(n, -1)
    # HIGHEST precision: a reduced default (bf16, or TF32 on a GPU) shifts
    # heatmap values enough to move bbox edges on marginal pixels.
    out = jnp.dot(M, flat, preferred_element_type=flat.dtype,
                  precision=jax.lax.Precision.HIGHEST)
    return out.reshape(vid.shape)


def temporal_bandpass_iir(vid: jnp.ndarray, fps: float, freq_min: float,
                          freq_max: float, amplification: float,
                          order: int = 6, sos: bool = True) -> jnp.ndarray:
    """The reference's IIR alternative (transforms.py:72-79): order-6
    Butterworth bandpass along T, then amplification.

    Defaults to a second-order-sections cascade: the transfer-function form
    the reference uses is float64-only (it overflows to inf in float32 —
    the narrowband poles sit at radius ~0.99), while SOS is stable in
    single precision.  ``sos=False`` reproduces the reference's
    exact (b, a) filtering for float64 parity tests."""
    from respmon_tpu.ops import filters

    if sos:
        coeffs = filters.design_butter_bandpass_sos(
            freq_min, freq_max, float(fps), order=order)
        return filters.sosfilt(coeffs, vid) * amplification
    ba = filters.design_butter_bandpass(freq_min, freq_max, float(fps),
                                        order=order)
    return filters.lfilter(ba, vid) * amplification
