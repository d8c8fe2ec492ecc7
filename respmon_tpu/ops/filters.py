"""Butterworth IIR filtering on device, scipy-parity.

The reference uses scipy's native filters (transforms.py:38-79):
  - ``butter_lowpass_filter`` (order 3 at the call site, base.py:342) via
    zero-phase ``filtfilt`` — feeds BPM estimation, so parity matters for the
    ±0.5 BPM target.
  - ``butter_bandpass_filter`` (order 6, ``lfilter``) — the IIR alternative to
    the FFT temporal bandpass (transforms.py:72-79).

Design: coefficients are designed on host at trace time with scipy
(static given fps), closed over by jitted kernels; the causal IIR runs as a
``lax.scan`` linear recurrence; ``filtfilt`` reproduces scipy's odd-extension
padding and ``lfilter_zi`` initial conditions exactly.

Masked variable-length support: the monitor filters a growing deque each frame
(13..128 samples).  To keep shapes static under jit we store signals
right-aligned in a fixed buffer and exploit the ``lfilter_zi`` steady-state
property: with initial state ``zi * x0``, a constant prefix of ``x0`` produces
a constant output, so prepending copies of the first sample leaves the real
outputs bit-identical to filtering the unpadded signal.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class FilterCoeffs:
    """Hashable IIR filter coefficients (normalized, a[0] == 1)."""

    b: Tuple[float, ...]
    a: Tuple[float, ...]
    zi: Tuple[float, ...]  # scipy.signal.lfilter_zi steady-state

    @property
    def order(self) -> int:
        return len(self.a) - 1

    @property
    def padlen(self) -> int:
        """scipy.filtfilt default padlen = 3 * max(len(a), len(b))."""
        return 3 * max(len(self.a), len(self.b))


def design_butter_lowpass(cutoff: float, fs: float, order: int) -> FilterCoeffs:
    """Host-side Butterworth lowpass design (reference transforms.py:58-63)."""
    from scipy.signal import butter, lfilter_zi

    b, a = butter(order, cutoff / (0.5 * fs), btype="low", analog=False)
    zi = lfilter_zi(b, a)
    return FilterCoeffs(b=tuple(b.tolist()), a=tuple(a.tolist()),
                        zi=tuple(zi.tolist()))


def design_butter_bandpass(lowcut: float, highcut: float, fs: float,
                           order: int = 5) -> FilterCoeffs:
    """Host-side Butterworth bandpass design (reference transforms.py:38-44)."""
    from scipy.signal import butter, lfilter_zi

    nyq = 0.5 * fs
    b, a = butter(order, [lowcut / nyq, highcut / nyq], btype="band",
                  output="ba")
    zi = lfilter_zi(b, a)
    return FilterCoeffs(b=tuple(b.tolist()), a=tuple(a.tolist()),
                        zi=tuple(zi.tolist()))


@dataclasses.dataclass(frozen=True)
class SOSCoeffs:
    """Second-order-sections cascade (hashable).  sections[i] is the scipy
    layout (b0, b1, b2, a0, a1, a2) with a0 == 1."""

    sections: Tuple[Tuple[float, ...], ...]


def design_butter_bandpass_sos(lowcut: float, highcut: float, fs: float,
                               order: int = 6) -> SOSCoeffs:
    """Bandpass design as second-order sections.  A transfer-function
    order-6 narrowband Butterworth (the reference's IIR alternative,
    transforms.py:74) has poles at radius ~0.99 and diverges to inf in
    float32; the SOS cascade is stable in single precision — the required
    form for the float32 compute path."""
    from scipy.signal import butter

    nyq = 0.5 * fs
    sos = butter(order, [lowcut / nyq, highcut / nyq], btype="band",
                 output="sos")
    return SOSCoeffs(sections=tuple(tuple(row.tolist()) for row in sos))


def sosfilt(coeffs: SOSCoeffs, x: jnp.ndarray) -> jnp.ndarray:
    """Causal SOS filtering along axis 0 (scipy.signal.sosfilt parity),
    as a cascade of biquad ``lax.scan`` recurrences."""
    dtype = x.dtype
    trailing = x.shape[1:]
    y = x
    for section in coeffs.sections:
        b0, b1, b2, _, a1, a2 = (jnp.asarray(v, dtype) for v in section)

        def step(d, xn, b0=b0, b1=b1, b2=b2, a1=a1, a2=a2):
            d1, d2 = d
            yn = b0 * xn + d1
            d1_new = b1 * xn + d2 - a1 * yn
            d2_new = b2 * xn - a2 * yn
            return (d1_new, d2_new), yn

        zeros = jnp.zeros(trailing, dtype=dtype)
        _, y = jax.lax.scan(step, (zeros, zeros), y)
    return y


def lfilter(coeffs: FilterCoeffs, x: jnp.ndarray,
            zi: jnp.ndarray | None = None) -> jnp.ndarray:
    """Causal IIR along the leading axis via ``lax.scan`` (direct form II
    transposed), matching ``scipy.signal.lfilter``.

    ``x`` may be (T,) or (T, ...) — the recurrence runs along axis 0 and
    broadcasts over trailing axes (replaces reference transforms.py:49,54).
    """
    dtype = x.dtype
    b = jnp.asarray(coeffs.b, dtype=dtype)
    a = jnp.asarray(coeffs.a, dtype=dtype)
    order = coeffs.order
    trailing = x.shape[1:]

    if zi is None:
        d0 = jnp.zeros((order,) + trailing, dtype=dtype)
    else:
        d0 = jnp.broadcast_to(zi.astype(dtype), (order,) + trailing)

    def step(d, xn):
        yn = b[0] * xn + d[0]
        shifted = jnp.concatenate(
            [d[1:], jnp.zeros((1,) + trailing, dtype=dtype)], axis=0)
        bx = b[1:].reshape((order,) + (1,) * len(trailing)) * xn
        ay = a[1:].reshape((order,) + (1,) * len(trailing)) * yn
        return shifted + bx - ay, yn

    _, y = jax.lax.scan(step, d0, x)
    return y


def lfilter_assoc(coeffs: FilterCoeffs, x: jnp.ndarray,
                  zi: jnp.ndarray | None = None) -> jnp.ndarray:
    """``lfilter`` via parallel prefix (``lax.associative_scan``).

    The DF2T recurrence is affine: d_{k+1} = A d_k + c x_k with constant A
    (companion form) and y_k = b0 x_k + d_k[0].  Composing affine maps is
    associative, so the state sequence computes in O(log T) parallel levels
    of small (order x order) matmuls instead of T sequential steps
    (identical math, regrouped rounding).  1-D input only; batch via vmap.

    The prefix runs as Hillis-Steele doubling with CONTIGUOUS pad+slice
    shifts rather than ``lax.associative_scan``, whose lowering emits
    stride-2 interleaved slices and far larger compiles at scale (same
    finding as ops/ccl.py).
    """
    dtype = x.dtype
    p = coeffs.order
    n = x.shape[0]
    b = jnp.asarray(coeffs.b, dtype)
    a = jnp.asarray(coeffs.a, dtype)

    # Companion transition: d_new[i] = -a[i+1] d[0] + d[i+1] + c[i] x.
    A = jnp.zeros((p, p), dtype).at[:, 0].set(-a[1:])
    A = A.at[jnp.arange(p - 1), jnp.arange(1, p)].set(1.0)
    c = b[1:] - a[1:] * b[0]

    v = c[None, :] * x[:, None]                     # (T, p)
    M = jnp.broadcast_to(A, (n, p, p))

    eye = jnp.broadcast_to(jnp.eye(p, dtype=dtype), (1, p, p))
    zero = jnp.zeros((1, p), dtype)
    d = 1
    while d < n:
        # Earlier prefix shifted forward by d; identity fill at the front.
        ms = jnp.concatenate([jnp.broadcast_to(eye, (d, p, p)), M[:-d]],
                             axis=0)
        vs = jnp.concatenate([jnp.broadcast_to(zero, (d, p)), v[:-d]],
                             axis=0)
        hi_p = jax.lax.Precision.HIGHEST  # default may be TF32 on a GPU
        M, v = (jnp.einsum("tij,tjk->tik", M, ms, precision=hi_p),
                jnp.einsum("tij,tj->ti", M, vs, precision=hi_p) + v)
        d *= 2
    prefM, prefV = M, v
    d0 = jnp.zeros((p,), dtype) if zi is None else zi.astype(dtype)
    d_incl = jnp.einsum("tij,j->ti", prefM, d0,
                        precision=jax.lax.Precision.HIGHEST) + prefV
    d_at = jnp.concatenate([d0[None], d_incl[:-1]], axis=0)
    return b[0] * x + d_at[:, 0]


def _odd_ext_masked(x_padded: jnp.ndarray, count: jnp.ndarray,
                    padlen: int) -> jnp.ndarray:
    """Build scipy-filtfilt's odd extension for a right-aligned masked signal.

    ``x_padded`` is (N,) with the valid signal occupying ``[N-count, N)``.
    Returns (N + 2*padlen,) where the real extension (front odd-ext, signal,
    back odd-ext) is right-aligned ending at index N + padlen, i.e. the back
    extension occupies the final ``padlen`` slots; everything before the real
    front extension is filled with its first value (harmless constant prefix
    under steady-state initial conditions).
    """
    n = x_padded.shape[0]
    p = padlen
    m = n + 2 * p
    dtype = x_padded.dtype
    start = n - count                       # index of x[0]

    x0 = x_padded[start]                    # dynamic gather (first sample)
    xlast = x_padded[n - 1]                 # newest sample (static)

    # Front odd extension: f[j] = 2*x0 - x[p - j], j = 0..p-1.
    j = jnp.arange(p)
    front = 2.0 * x0 - jnp.take(x_padded, start + (p - j), mode="clip")
    # Back odd extension: g[j] = 2*x[-1] - x[c-2-j] = 2*x[-1] - x_padded[N-2-j].
    back = 2.0 * xlast - x_padded[n - 2 - j]

    ext = jnp.zeros((m,), dtype=dtype)
    # Real signal occupies ext[m - p - count : m - p); writing the whole
    # padded buffer at the static slot [p : m - p) covers it (its garbage
    # prefix is overwritten / masked below).
    ext = jax.lax.dynamic_update_slice(ext, x_padded, (p,))
    # Front extension immediately before the signal (dynamic position).
    front_pos = m - count - 2 * p
    ext = jax.lax.dynamic_update_slice(ext, front.astype(dtype), (front_pos,))
    # Back extension at the static tail.
    ext = jax.lax.dynamic_update_slice(ext, back.astype(dtype), (m - p,))
    # Constant prefix = front[0] before the real front extension.
    idx = jnp.arange(m)
    ext = jnp.where(idx < front_pos, front[0].astype(dtype), ext)
    return ext


@partial(jax.jit, static_argnames=("coeffs", "associative"))
def filtfilt_masked(coeffs: FilterCoeffs, x_padded: jnp.ndarray,
                    count: jnp.ndarray,
                    associative: bool = True) -> jnp.ndarray:
    """Zero-phase forward-backward IIR matching ``scipy.signal.filtfilt``
    (method='pad', padtype='odd', default padlen) on a right-aligned masked
    signal (reference transforms.py:66-69 / base.py:342).

    Returns (N,) right-aligned: positions ``[N-count, N)`` hold the filtered
    signal; positions before are unspecified.  Requires ``count > padlen``
    (guaranteed by the monitor: measurement starts at >12 samples and
    padlen = 12 for the order-3 call site; asserted by callers for others).
    """
    n = x_padded.shape[0]
    p = coeffs.padlen
    count = jnp.asarray(count)
    ext = _odd_ext_masked(x_padded, count, p)
    zi = jnp.asarray(coeffs.zi, dtype=x_padded.dtype)
    iir = lfilter_assoc if associative else lfilter

    # Forward pass: init state zi * ext[0]; constant prefix is steady-state.
    y1 = iir(coeffs, ext, zi=zi * ext[0])
    # Backward pass over the reversed signal; its first element is the last
    # real extension value (the back extension ends at the buffer tail).
    y1r = y1[::-1]
    y2r = iir(coeffs, y1r, zi=zi * y1r[0])
    y2 = y2r[::-1]
    # Strip padlen from both ends of the real extension; as a right-aligned
    # (N,) window this is the static slice [p : p + N] of the (N + 2p) array.
    return jax.lax.dynamic_slice(y2, (p,), (n,))


def filtfilt(coeffs: FilterCoeffs, x: jnp.ndarray) -> jnp.ndarray:
    """Full-length zero-phase filter (scipy-parity) for static-length signals."""
    return filtfilt_masked(coeffs, x, jnp.asarray(x.shape[0]))
