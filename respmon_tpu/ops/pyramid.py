"""Gaussian/Laplacian pyramids with cv2.pyrDown/pyrUp numerics.

The reference builds 9-level Laplacian video pyramids through OpenCV
(reference pyramid.py:9-69; kernels cv2.pyrDown/cv2.pyrUp at pyramid.py:14,
25, 55).  OpenCV's pyramid kernels are:

  - pyrDown: separable 5-tap binomial blur [1,4,6,4,1]/16 with
    BORDER_REFLECT_101, then stride-2 subsample; output size ceil(n/2).
  - pyrUp: zero-stuffed 2x upsample convolved with the same kernel scaled x2
    per axis.  Per axis this reduces to two phases on source samples s:
        even output 2i   -> (s[i-1] + 6 s[i] + s[i+1]) / 8
        odd  output 2i+1 -> (s[i] + s[i+1]) / 2
    with reflect-101 indexing of s; ``dstsize`` may be odd (trailing odd
    phase dropped), which the reference relies on for its odd tiny levels.

Design: both ops are expressed as static strided-slice weighted
sums over the last two axes (XLA fuses these into a handful of vector ops and
they vmap/batch over (T, streams) for free).  Shapes are static at every
pyramid level, so the whole 9-level video pyramid traces into one jitted
program.  The video pyramid is a tuple-of-arrays pytree, one (T, h_i, w_i)
array per level, matching the reference's per-level stacking
(pyramid.py:31-48) without its mutate-in-place collapse quirk.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _reflect101_indices(n: int, pad: int) -> np.ndarray:
    """Static source indices for BORDER_REFLECT_101 padding of a length-n
    axis (edge sample not repeated; periodic for tiny n, matching OpenCV)."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    m = np.mod(idx, period)
    return np.where(m < n, m, period - m)


def _reflect_pad(x: jnp.ndarray, axis: int, pad: int) -> jnp.ndarray:
    """BORDER_REFLECT_101 padding along one axis (single fused gather)."""
    idx = _reflect101_indices(x.shape[axis], pad)
    return jnp.take(x, jnp.asarray(idx), axis=axis)


def _down_axis(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """5-tap blur + stride-2 subsample along ``axis`` (cv2.pyrDown, 1 axis)."""
    n = x.shape[axis]
    out_n = (n + 1) // 2
    xp = _reflect_pad(x, axis, 2)
    acc = None
    for k, w in enumerate(_K5):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(k, k + 2 * out_n, 2)
        term = xp[tuple(sl)] * w
        acc = term if acc is None else acc + term
    return acc


def _up_axis(x: jnp.ndarray, axis: int, dst: int) -> jnp.ndarray:
    """Dual-phase 2x upsample along ``axis`` (cv2.pyrUp, 1 axis).

    OpenCV's pyrUp reflects on the *zero-stuffed destination grid*, which in
    source-sample terms means reflect-101 at the front (s[-1] -> s[1]) but
    *replicate* at the back (s[n] -> s[n-1]) — verified against cv2 by
    extracting its 1D operator matrices (see tests/test_pyramid.py).
    """
    n = x.shape[axis]
    front_idx = 1 if n > 1 else 0
    back_idx = n - 1
    idx = np.concatenate([[front_idx], np.arange(n), [back_idx]])
    xp = jnp.take(x, jnp.asarray(idx), axis=axis)

    def sl(a, b):
        s = [slice(None)] * x.ndim
        s[axis] = slice(a, b)
        return xp[tuple(s)]

    even = (sl(0, -2) + 6.0 * sl(1, -1) + sl(2, None)) * (1.0 / 8.0)
    odd = (sl(1, -1) + sl(2, None)) * 0.5
    inter = jnp.stack([even, odd], axis=axis + 1)
    new_shape = list(x.shape)
    new_shape[axis] = 2 * x.shape[axis]
    inter = inter.reshape(new_shape)
    out_sl = [slice(None)] * x.ndim
    out_sl[axis] = slice(0, dst)
    return inter[tuple(out_sl)]


def pyr_down(x: jnp.ndarray) -> jnp.ndarray:
    """cv2.pyrDown over the last two axes; leading axes batch."""
    return _down_axis(_down_axis(x, x.ndim - 2), x.ndim - 1)


def pyr_up(x: jnp.ndarray, dst_hw: Tuple[int, int]) -> jnp.ndarray:
    """cv2.pyrUp with explicit dstsize (h, w) over the last two axes."""
    h, w = dst_hw
    return _up_axis(_up_axis(x, x.ndim - 2, h), x.ndim - 1, w)


def pyramid_shapes(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    """Static per-level (h, w) shapes of a Gaussian pyramid."""
    shapes = [(h, w)]
    for _ in range(1, levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes


def gaussian_pyramid(x: jnp.ndarray, levels: int) -> Tuple[jnp.ndarray, ...]:
    """Repeated pyrDown (reference pyramid.py:9-17); batches over leading axes."""
    out = [x]
    for _ in range(1, levels):
        out.append(pyr_down(out[-1]))
    return tuple(out)


def laplacian_pyramid(x: jnp.ndarray, levels: int) -> Tuple[jnp.ndarray, ...]:
    """Laplacian pyramid: gauss[i] - pyrUp(gauss[i+1], dstsize=gauss[i]) with
    the Gaussian top as the last level (reference pyramid.py:20-28).

    Works on single images (H, W) or batched video (T, H, W) alike — the
    reference's per-frame loop (pyramid.py:35-48) becomes one batched trace.
    """
    gauss = gaussian_pyramid(x, levels)
    lap = []
    for i in range(levels - 1):
        dst = gauss[i].shape[-2:]
        lap.append(gauss[i] - pyr_up(gauss[i + 1], dst))
    lap.append(gauss[-1])
    return tuple(lap)


def collapse_laplacian_pyramid(
        pyramid: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Iterative pyrUp-and-add from the top (reference pyramid.py:51-69),
    without mutating inputs; batches over leading axes."""
    img = pyramid[-1]
    for lvl in range(len(pyramid) - 2, -1, -1):
        img = pyr_up(img, pyramid[lvl].shape[-2:]) + pyramid[lvl]
    return img
