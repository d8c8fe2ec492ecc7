"""Alternative peak detector with the Marcos Duarte ``detect_peaks``
semantics (reference prototypes/detect_peaks.py — vendored there as an
unused alternative to peakutils).

Semantics reproduced (for the valley-less default path and options the
reference's prototype exposes):
  - NaN-adjacent candidates are discarded; NaN samples never peak.
  - A peak is a sample strictly greater than its left neighbor and
    >= / > its right neighbor depending on edge mode:
      edge=None: strict both sides;
      'rising' adds plateau left edges, 'falling' plateau right edges,
      'both' adds either.
  - First/last samples never peak.
  - ``mph``: minimum peak height; ``threshold``: minimum excess over both
    neighbors; ``mpd``: greedy min-distance keeping taller peaks first
    (ties: later index first); ``valley=True`` inverts the signal.

Design: fixed-shape masked comparisons + the same bounded
argmax-suppression loop pattern as ``ops.peaks``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("mph", "mpd", "threshold", "edge",
                                   "valley", "max_peaks"))
def detect_peaks(x: jnp.ndarray, mph: float | None = None, mpd: int = 1,
                 threshold: float = 0.0, edge: str | None = "rising",
                 valley: bool = False, max_peaks: int = 64):
    """Returns (indices, mask): fixed-size ascending peak positions."""
    n = x.shape[0]
    idx = jnp.arange(n)
    x = jnp.where(valley, -x, x)

    isnan = jnp.isnan(x)
    xs = jnp.where(isnan, jnp.inf, x)

    dx_r = jnp.concatenate([xs[1:] - xs[:-1],
                            jnp.asarray([jnp.nan], xs.dtype)])  # x[i+1]-x[i]
    dx_l = jnp.concatenate([jnp.asarray([jnp.nan], xs.dtype),
                            xs[1:] - xs[:-1]])                  # x[i]-x[i-1]

    strict = (dx_l > 0) & (dx_r < 0)
    rising = (dx_l > 0) & (dx_r <= 0)
    falling = (dx_l >= 0) & (dx_r < 0)
    if edge is None:
        cand = strict
    elif edge == "rising":
        cand = rising
    elif edge == "falling":
        cand = falling
    else:  # 'both'
        cand = rising | falling

    # NaN handling: NaN samples and their neighbors are excluded.
    nan_adjacent = isnan \
        | jnp.concatenate([isnan[1:], jnp.asarray([False])]) \
        | jnp.concatenate([jnp.asarray([False]), isnan[:-1]])
    cand = cand & ~nan_adjacent
    # First and last sample never peak.
    cand = cand & (idx > 0) & (idx < n - 1)

    if mph is not None:
        cand = cand & (x > mph)

    if threshold > 0:
        left = jnp.concatenate([jnp.asarray([jnp.inf], xs.dtype), xs[:-1]])
        right = jnp.concatenate([xs[1:], jnp.asarray([jnp.inf], xs.dtype)])
        excess = jnp.minimum(x - left, x - right)
        cand = cand & (excess >= threshold)

    if mpd > 1:
        neg = jnp.asarray(-jnp.inf, x.dtype)
        score = jnp.where(cand, x, neg)

        def body(_, carry):
            score, kept = carry
            best = jnp.max(score)
            has = best > neg
            # Ties: later index wins (argsort-stable-reversed, like the
            # vendored implementation).
            pick = jnp.max(jnp.where(score == best, idx, -1))
            window = jnp.abs(idx - pick) <= mpd
            score = jnp.where(has & window, neg, score)
            kept = kept | (has & (idx == pick))
            return score, kept

        iters = min(max_peaks, n // (mpd + 1) + 1)
        _, kept = jax.lax.fori_loop(0, iters, body,
                                    (score, jnp.zeros((n,), bool)))
    else:
        kept = cand

    order = jnp.cumsum(kept) - 1
    slot = jnp.where(kept, order, max_peaks)
    out = jnp.full((max_peaks + 1,), -1, jnp.int32)
    out = out.at[slot].set(idx.astype(jnp.int32), mode="drop")[:max_peaks]
    return out, out >= 0
