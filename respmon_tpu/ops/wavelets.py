"""Daubechies wavelet smoothing (reference C15: transforms.py:121-141).

The reference's experimental ``wavelet_filter`` runs ``iterations`` levels of
db4 DWT (pywt, smooth-padding mode) and reconstructs from the deepest
approximation only — a lowpass smoother.  pywt is not a baked-in dependency
here, so the transform is implemented directly in JAX: analysis/synthesis
filter banks with the standard db4 coefficients, linear-extrapolation
("smooth") signal extension, and pywt's length conventions
(out = floor((n + L - 1) / 2), reconstruction trims L - 2).

Off the production path (like the reference's), but part of the component
inventory; tested for perfect reconstruction and lowpass behavior.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Standard db4 analysis lowpass (pywt Wavelet('db4').dec_lo).
_DB4_DEC_LO = np.array([
    -0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
    -0.18703481171888114, -0.02798376941698385, 0.6308807679295904,
    0.7148465705525415, 0.23037781330885523])


def _filters(dec_lo: np.ndarray):
    L = len(dec_lo)
    dec_hi = np.array([(-1) ** k * dec_lo[L - 1 - k] for k in range(L)])
    rec_lo = dec_lo[::-1].copy()
    rec_hi = dec_hi[::-1].copy()
    return dec_lo, dec_hi, rec_lo, rec_hi


def _smooth_ext(x: jnp.ndarray, pad: int) -> jnp.ndarray:
    """pywt Modes.smooth: linear extrapolation from the edge slope."""
    k = jnp.arange(1, pad + 1, dtype=x.dtype)
    left_slope = x[0] - x[1]
    right_slope = x[-1] - x[-2]
    left = x[0] + k[::-1] * left_slope
    right = x[-1] + k * right_slope
    return jnp.concatenate([left, x, right])


def dwt_db4(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-level db4 DWT with smooth extension.

    Returns (cA, cD), each of length floor((n + L - 1) / 2).
    """
    dec_lo, dec_hi, _, _ = _filters(_DB4_DEC_LO)
    L = len(dec_lo)
    n = x.shape[0]
    ext = _smooth_ext(x, L - 1)
    m = ext.shape[0]

    lo = jnp.asarray(dec_lo[::-1], x.dtype)   # correlate == conv w/ flipped
    hi = jnp.asarray(dec_hi[::-1], x.dtype)
    out_full = m - L + 1
    idx = jnp.arange(out_full)[:, None] + jnp.arange(L)[None, :]
    windows = ext[idx]
    hi_p = jax.lax.Precision.HIGHEST  # default may be TF32 on a GPU
    a_full = jnp.dot(windows, lo, precision=hi_p)
    d_full = jnp.dot(windows, hi, precision=hi_p)
    # pywt keeps outputs at odd phases: positions 1, 3, 5, ... of the full
    # convolution over the extended signal.
    n_out = (n + L - 1) // 2
    a = a_full[1::2][:n_out]
    d = d_full[1::2][:n_out]
    return a, d


def idwt_db4(cA: jnp.ndarray, cD: jnp.ndarray | None,
             out_len: int) -> jnp.ndarray:
    """Single-level inverse db4 DWT (cD=None means zero details)."""
    _, _, rec_lo, rec_hi = _filters(_DB4_DEC_LO)
    L = len(rec_lo)
    if cD is None:
        cD = jnp.zeros_like(cA)
    # Upsample (zero-stuff) then filter; sum both branches; trim L-2 from
    # both ends (pywt convention).
    def up(c):
        u = jnp.zeros((2 * c.shape[0],), c.dtype)
        return u.at[::2].set(c)

    ua = up(cA)
    ud = up(cD)
    m = ua.shape[0]
    pad = L - 1
    uap = jnp.concatenate([jnp.zeros(pad, ua.dtype), ua,
                           jnp.zeros(pad, ua.dtype)])
    udp = jnp.concatenate([jnp.zeros(pad, ud.dtype), ud,
                           jnp.zeros(pad, ud.dtype)])
    idx = jnp.arange(m + pad)[:, None] + jnp.arange(L)[None, :]
    wa = uap[idx]
    wd = udp[idx]
    lo = jnp.asarray(rec_lo[::-1], cA.dtype)
    hi = jnp.asarray(rec_hi[::-1], cA.dtype)
    hi_p = jax.lax.Precision.HIGHEST
    full = jnp.dot(wa, lo, precision=hi_p) + jnp.dot(wd, hi, precision=hi_p)
    rec = full[L - 2:]
    return rec[:out_len]


def wavelet_decompose(x: jnp.ndarray, iterations: int = 5):
    """Iterated analysis: returns (approximations, details) per level
    (reference transforms.py:126-134)."""
    ca: List[jnp.ndarray] = []
    cd: List[jnp.ndarray] = []
    a = x
    for _ in range(iterations):
        a, d = dwt_db4(a)
        ca.append(a)
        cd.append(d)
    return ca, cd


def wavelet_filter(x: jnp.ndarray, iterations: int = 5) -> jnp.ndarray:
    """db4 smoothing: keep only the deepest approximation and reconstruct
    (reference transforms.py:126-141 ``rec_a[-1]``)."""
    lengths = [x.shape[0]]
    a = x
    ca, _ = wavelet_decompose(x, iterations)
    for lvl in range(iterations - 1):
        lengths.append(ca[lvl].shape[0])
    rec = ca[-1]
    for lvl in range(iterations - 1, -1, -1):
        rec = idwt_db4(rec, None, lengths[lvl])
    return rec
