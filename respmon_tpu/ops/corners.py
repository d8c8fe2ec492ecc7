"""Shi-Tomasi corner detection (cv2.goodFeaturesToTrack semantics).

The reference seeds its optical-flow tracker with
``cv2.goodFeaturesToTrack(img, maxCorners=100, qualityLevel=0.3,
minDistance=7, blockSize=7)`` (base.py:91-94, 365-366).  OpenCV's algorithm:

  1. ``cornerMinEigenVal``: Sobel-3 gradients (BORDER_REFLECT_101), per-pixel
     2x2 structure tensor summed over a blockSize box (unnormalized), then
     the min eigenvalue ``(a+c) - sqrt((a-c)^2 + b^2)`` with a=0.5*Sxx,
     b=Sxy, c=0.5*Syy.  (OpenCV folds a constant 1/(2^(ksize-1)*block*255)
     into the gradients; selection below is scale-invariant so we omit it.)
  2. Threshold at ``qualityLevel * max(eig)`` (strictly-greater survives).
  3. 3x3 dilation non-max suppression (plateau ties all survive), excluding
     the 1-pixel image border.
  4. Process candidates by descending response; keep one if no kept corner
     lies strictly within ``minDistance`` (Euclidean); stop at maxCorners.

Design: the response map is a fused stencil (separable Sobel + box
sum); the greedy selection is a bounded ``fori_loop`` of argmax+mask rounds
into a fixed (max_corners, 2) masked point buffer — static shapes end to end.
Tie-breaking inside a round picks the smallest flat index (cv2's unstable
sort leaves tie order unspecified).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from respmon_tpu.ops.pyramid import _reflect_pad


class CornerSet(NamedTuple):
    pts: jnp.ndarray    # (max_corners, 2) float32, (x, y)
    valid: jnp.ndarray  # (max_corners,) bool
    count: jnp.ndarray  # int32


def _conv1d(x: jnp.ndarray, axis: int, taps) -> jnp.ndarray:
    """Small odd-length 1D stencil along ``axis`` with REFLECT_101 border."""
    r = len(taps) // 2
    xp = _reflect_pad(x, axis, r)
    n = x.shape[axis]
    acc = None
    for k, w in enumerate(taps):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(k, k + n)
        term = xp[tuple(sl)] * w
        acc = term if acc is None else acc + term
    return acc


def _box_sum(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Unnormalized box filter (cv2.boxFilter normalize=False), reflect-101."""
    ones = (1.0,) * size
    return _conv1d(_conv1d(x, x.ndim - 2, ones), x.ndim - 1, ones)


def min_eigenval_map(img: jnp.ndarray, block_size: int = 7,
                     remap=None) -> jnp.ndarray:
    """cv2.cornerMinEigenVal response map (unscaled).

    ``remap=(rows, cols)`` restricts the computation to a virtual subimage:
    the index maps reflect out-of-ROI positions back inside (REFLECT_101 at
    the ROI edges).  cv2 pads per stage — the image for the Sobel pass AND
    the gradient maps for the box pass — so the remap is applied both to
    the image and to the gradients (reflecting only the image would bake
    sign-flipped x-gradients into the box sums at the right/left ROI edge).
    """
    def rmap(x):
        return x if remap is None else x[remap[0]][:, remap[1]]

    img = rmap(img)
    ix = _conv1d(_conv1d(img, img.ndim - 1, (-1.0, 0.0, 1.0)),
                 img.ndim - 2, (1.0, 2.0, 1.0))
    iy = _conv1d(_conv1d(img, img.ndim - 2, (-1.0, 0.0, 1.0)),
                 img.ndim - 1, (1.0, 2.0, 1.0))
    ix = rmap(ix)
    iy = rmap(iy)
    sxx = _box_sum(ix * ix, block_size)
    syy = _box_sum(iy * iy, block_size)
    sxy = _box_sum(ix * iy, block_size)
    a = 0.5 * sxx
    c = 0.5 * syy
    return (a + c) - jnp.sqrt((a - c) * (a - c) + sxy * sxy)


def _reflect101_idx(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """BORDER_REFLECT_101 index map for offsets ``i`` into a length-``n``
    axis (n dynamic).  The mod-period formula IS cv2's iterated reflection,
    so it is exact even when the stencil radius exceeds n."""
    period = jnp.maximum(2 * n - 2, 1)
    m = jnp.abs(i) % period
    idx = jnp.where(m < n, m, period - m)
    return jnp.where(n <= 1, 0, idx)


def _dilate3(x: jnp.ndarray) -> jnp.ndarray:
    h, w = x.shape[-2:]
    p = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)],
                constant_values=-jnp.inf)
    stack = [p[..., i:i + h, j:j + w] for i in range(3) for j in range(3)]
    return jnp.max(jnp.stack(stack), axis=0)


@partial(jax.jit, static_argnames=("max_corners", "quality_level",
                                   "min_distance", "block_size"))
def good_features_to_track(img: jnp.ndarray, max_corners: int = 100,
                           quality_level: float = 0.3,
                           min_distance: float = 7.0,
                           block_size: int = 7,
                           roi_mask: jnp.ndarray | None = None) -> CornerSet:
    """Masked fixed-size corner set on a single (H, W) float image.

    ``roi_mask`` optionally restricts detection to a rectangular ROI inside
    a bucketed window (production path: pipeline/motion.py crops a padded
    window and the real ROI may sit at an offset inside it).  cv2 operates
    on the exact cropped subimage (base.py:365-366), so for parity the
    window's out-of-ROI pixels are remapped to the ROI's REFLECT_101
    virtual border before the response stencil, and the ROI's own 1-pixel
    border is excluded — the resulting corner set equals
    ``cv2.goodFeaturesToTrack(frame[y:y+h, x:x+w], ...)`` shifted by the
    ROI offset (tests/test_corners_lk.py).
    """
    h, w = img.shape
    if roi_mask is not None:
        row_any = jnp.any(roi_mask, axis=1)
        col_any = jnp.any(roi_mask, axis=0)
        dy = jnp.argmax(row_any).astype(jnp.int32)
        dx = jnp.argmax(col_any).astype(jnp.int32)
        rh = jnp.sum(row_any).astype(jnp.int32)
        rw = jnp.sum(col_any).astype(jnp.int32)
        rr = jnp.clip(_reflect101_idx(jnp.arange(h) - dy, rh) + dy, 0, h - 1)
        cc = jnp.clip(_reflect101_idx(jnp.arange(w) - dx, rw) + dx, 0, w - 1)
        eig = min_eigenval_map(img, block_size, remap=(rr, cc))
    else:
        eig = min_eigenval_map(img, block_size)
    if roi_mask is not None:
        eig = jnp.where(roi_mask, eig, -jnp.inf)

    rows2 = jnp.arange(h)[:, None]
    cols2 = jnp.arange(w)[None, :]
    if roi_mask is not None:
        # cv2's border exclusion applies to the subimage extent.
        interior = ((rows2 >= dy + 1) & (rows2 < dy + rh - 1) &
                    (cols2 >= dx + 1) & (cols2 < dx + rw - 1))
    else:
        interior = ((rows2 >= 1) & (rows2 < h - 1) &
                    (cols2 >= 1) & (cols2 < w - 1))

    maxval = jnp.max(jnp.where(jnp.isfinite(eig), eig, -jnp.inf))
    thresh = quality_level * maxval
    cand = (eig > thresh) & (eig == _dilate3(eig)) & interior

    ridx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cidx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    flat_idx = ridx * w + cidx
    neg = jnp.asarray(-jnp.inf, eig.dtype)
    score = jnp.where(cand, eig, neg)

    def body(i, carry):
        score, pts, valid = carry
        best = jnp.max(score)
        has = best > neg
        # Tie-break: smallest flat index among maxima.
        pick = jnp.min(jnp.where(score == best, flat_idx, h * w))
        py = pick // w
        px = pick % w
        # Suppress strictly-closer-than-min_distance candidates (cv2 uses
        # dx*dx + dy*dy < minDistance^2).
        d2 = ((ridx - py).astype(eig.dtype) ** 2 +
              (cidx - px).astype(eig.dtype) ** 2)
        score = jnp.where(has & (d2 < min_distance * min_distance), neg, score)
        pts = pts.at[i].set(jnp.where(
            has, jnp.stack([px, py]).astype(jnp.float32), pts[i]))
        valid = valid.at[i].set(has)
        return score, pts, valid

    pts0 = jnp.zeros((max_corners, 2), jnp.float32)
    valid0 = jnp.zeros((max_corners,), bool)
    _, pts, valid = jax.lax.fori_loop(0, max_corners, body,
                                      (score, pts0, valid0))
    return CornerSet(pts=pts, valid=valid,
                     count=jnp.sum(valid).astype(jnp.int32))
