"""Vectorized min-distance peak detection with peakutils.indexes semantics.

The reference calls ``peakutils.indexes(filtered_data, min_dist=width)``
(base.py:314) with the default relative threshold 0.3.  peakutils semantics
reproduced here exactly:

  1. ``thres`` is relative: ``thres*(max-min)+min``.
  2. First differences; zero-runs (plateaus) are filled by propagating the
     left neighbor's nonzero diff into the left half (< median index) and the
     right neighbor's into the right half; edge plateaus take the only
     available side.  A totally flat signal yields no peaks.
  3. Candidates: ``dy[i-1] > 0 and dy[i] < 0 and y[i] > thres``.
  4. If ``min_dist > 1`` and >1 candidates: greedy suppression processing
     candidates by descending height (ties: higher index first, matching
     ``argsort(...)[::-1]`` on a stable sort); each kept peak suppresses all
     candidates within ``min_dist``.

Formulation: everything is computed as fixed-shape masked tensor
ops on a right-aligned signal buffer; the greedy suppression is a bounded
``fori_loop`` of argmax+mask steps (<= max_peaks iterations).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _fill_plateaus(dy: jnp.ndarray) -> jnp.ndarray:
    """Replace zero-runs in ``dy`` with neighboring nonzero values per
    peakutils' plateau rule (left half <- left value, right half <- right
    value, median index goes right; edge plateaus use the available side)."""
    m = dy.shape[0]
    idx = jnp.arange(m)
    nz = dy != 0

    # Forward fill: value and index of the last nonzero diff at or before i.
    def fwd(carry, x):
        val, pos = carry
        d, i, isnz = x
        val = jnp.where(isnz, d, val)
        pos = jnp.where(isnz, i, pos)
        return (val, pos), (val, pos)

    (_, _), (lval, lpos) = jax.lax.scan(
        fwd, (jnp.asarray(0.0, dy.dtype), jnp.asarray(-1)), (dy, idx, nz))

    # Backward fill: first nonzero diff at or after i.
    (_, _), (rval_r, rpos_r) = jax.lax.scan(
        fwd, (jnp.asarray(0.0, dy.dtype), jnp.asarray(m)),
        (dy[::-1], idx[::-1], nz[::-1]))
    rval = rval_r[::-1]
    rpos = rpos_r[::-1]

    # Plateau containing a zero position i spans [lpos+1, rpos-1];
    # median = (l + r) / 2 (np.median of consecutive ints).
    left_edge = lpos < 0        # no nonzero to the left
    right_edge = rpos >= m      # no nonzero to the right
    median = (lpos + 1 + rpos - 1) / 2.0
    use_right = (idx >= median) | left_edge
    fill = jnp.where(use_right & ~right_edge, rval, lval)
    return jnp.where(nz, dy, fill)


def peak_indexes_masked(y: jnp.ndarray, count: jnp.ndarray, min_dist: int,
                        thres: float = 0.3, max_peaks: int = 32):
    """peakutils.indexes on a right-aligned masked signal.

    Args:
      y: (N,) buffer; valid samples at ``[N-count, N)``.
      count: number of valid samples (traced).
      min_dist: static minimum peak distance (samples).
      thres: relative threshold (peakutils default 0.3).
      max_peaks: static cap on returned peaks.

    Returns:
      (indices, mask): (max_peaks,) int32 global buffer indices in ascending
      order and a validity mask.  Indices are positions in the (N,) buffer.
    """
    n = y.shape[0]
    idx = jnp.arange(n)
    start = n - count
    valid = idx >= start

    big_neg = jnp.asarray(-jnp.inf, y.dtype)
    ymax = jnp.max(jnp.where(valid, y, big_neg))
    ymin = jnp.min(jnp.where(valid, y, -big_neg))
    threshold = thres * (ymax - ymin) + ymin

    # Replace invalid prefix with the first valid sample so that dy there is
    # zero; peakutils' left-edge-plateau rule makes the artificial extension
    # behave identically to the standalone array (see module docstring).
    y_first = y[start]
    y_ext = jnp.where(valid, y, y_first)

    dy = jnp.diff(y_ext)
    flat = jnp.all(jnp.where(idx[:-1] >= start, dy == 0, True))
    dy = _fill_plateaus(dy)

    # Candidate at i: dy[i-1] > 0, dy[i] < 0, y[i] > thres (peakutils'
    # hstack([dy,0]) / hstack([0,dy]) construction).
    dy_l = jnp.concatenate([jnp.zeros((1,), dy.dtype), dy])   # dy[i-1]
    dy_r = jnp.concatenate([dy, jnp.zeros((1,), dy.dtype)])   # dy[i]
    cand = (dy_l > 0) & (dy_r < 0) & (y_ext > threshold) & valid & ~flat

    if min_dist > 1:
        # Greedy suppression by descending height; ties -> higher index wins
        # (peakutils reverses a stable ascending argsort).
        score = jnp.where(cand, y_ext, big_neg)

        def body(_, carry):
            score, kept = carry
            best = jnp.max(score)
            # Among ties at `best`, pick the highest index.
            at_best = score == best
            pick = jnp.max(jnp.where(at_best, idx, -1))
            has = best > big_neg
            window = (jnp.abs(idx - pick) <= min_dist)
            score = jnp.where(has & window, big_neg, score)
            kept = kept | (has & (idx == pick))
            return score, kept

        # At spacing min_dist+1 at most ceil(n/(min_dist+1)) peaks survive.
        n_iters = min(max_peaks, n // (min_dist + 1) + 1)
        _, kept = jax.lax.fori_loop(
            0, n_iters, body, (score, jnp.zeros((n,), bool)))
        # peakutils skips suppression entirely for <=1 candidates, but the
        # greedy loop is a no-op there anyway.
        num_cand = jnp.sum(cand)
        kept = jnp.where(num_cand <= 1, cand, kept)
    else:
        kept = cand

    # Compact kept indices (ascending) into a fixed (max_peaks,) buffer.
    order = jnp.cumsum(kept) - 1                  # rank among kept
    slot = jnp.where(kept, order, max_peaks)      # out-of-range -> dropped
    indices = jnp.full((max_peaks + 1,), -1, jnp.int32)
    indices = indices.at[slot].set(idx.astype(jnp.int32), mode="drop")
    indices = indices[:max_peaks]
    mask = indices >= 0
    return indices, mask


@partial(jax.jit, static_argnames=("min_dist", "thres", "max_peaks"))
def peak_indexes(y: jnp.ndarray, min_dist: int, thres: float = 0.3,
                 max_peaks: int = 32):
    """peakutils.indexes for a full static-length signal."""
    return peak_indexes_masked(y, jnp.asarray(y.shape[0]), min_dist,
                               thres=thres, max_peaks=max_peaks)
