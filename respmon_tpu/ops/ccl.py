"""On-device connected-component labeling and largest-region bounding box.

Replaces the reference's ROI extraction (base.py:566-575): binary threshold →
``cv2.findContours(RETR_EXTERNAL)`` → ``max(contours, key=contourArea)`` →
``cv2.boundingRect``.  Only the largest component's bounding box is ever used,
so exact contour topology is unnecessary (SURVEY.md §2.1).

Design: iterative min-label propagation over the 8-neighborhood
(findContours extracts 8-connected white regions) accelerated with pointer
jumping — each pixel holds the smallest flat index reachable in its component;
a ``while_loop`` runs neighbor-min + label-gather rounds to a fixed point in
O(log diameter) rounds.  Component areas come from a one-hot segment-sum and
the bbox from masked row/column reductions.

Area semantics: ``cv2.contourArea`` is the Green's-theorem *polygon* area of
the outer (Suzuki) contour traced through pixel centers — NOT the pixel
count.  That area decomposes exactly over the dual lattice (the unit cells
between 2x2 pixel-center quads): a cell with all 4 pixels in the (hole-
filled) component lies fully inside the contour (+1), a cell with exactly 3
is cut diagonally by the 8-connected contour (+1/2), and cells with <= 2
contribute 0 (thin runs traced out-and-back enclose nothing).  Holes are
filled first because ``RETR_EXTERNAL`` only sees outer contours, so cv2's
area *includes* enclosed holes (and components nested inside another
component's hole are never candidates).  This reproduces cv2's ranking
exactly, including the thin-structure and donut cases where the naive
pixel-count or Pick estimates flip the winner (tests/test_ccl.py).
Tie-break: labels are each component's smallest flat index, so ``argmax``
prefers the raster-first component — matching ``max(contours, key=...)``
over findContours' scan order.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class BBoxResult(NamedTuple):
    x: jnp.ndarray        # int32
    y: jnp.ndarray        # int32
    w: jnp.ndarray        # int32
    h: jnp.ndarray        # int32
    found: jnp.ndarray    # bool
    area: jnp.ndarray     # float — cv2-style polygon-area estimate


def _neighbor_min(lab: jnp.ndarray, big: int) -> jnp.ndarray:
    """Min label over the 8-neighborhood (out-of-image = big)."""
    h, w = lab.shape
    p = jnp.pad(lab, 1, constant_values=big)
    stack = jnp.stack([
        p[0:h, 0:w], p[0:h, 1:w + 1], p[0:h, 2:w + 2],
        p[1:h + 1, 0:w], p[1:h + 1, 2:w + 2],
        p[2:h + 2, 0:w], p[2:h + 2, 1:w + 1], p[2:h + 2, 2:w + 2],
    ])
    return jnp.minimum(lab, jnp.min(stack, axis=0))


def _neighbor_min4(lab: jnp.ndarray, big: int) -> jnp.ndarray:
    """Min label over the 4-neighborhood (out-of-image = big)."""
    h, w = lab.shape
    p = jnp.pad(lab, 1, constant_values=big)
    stack = jnp.stack([
        p[0:h, 1:w + 1], p[2:h + 2, 1:w + 1],
        p[1:h + 1, 0:w], p[1:h + 1, 2:w + 2],
    ])
    return jnp.minimum(lab, jnp.min(stack, axis=0))


def _shifted(x: jnp.ndarray, d: int, axis: int, fill, front: bool) \
        -> jnp.ndarray:
    """Contiguous shift by ``d`` along ``axis``: front=True gives
    out[i] = x[i-d] (filled at the start), else out[i] = x[i+d]."""
    pad = [(0, 0)] * x.ndim
    sl = [slice(None)] * x.ndim
    if front:
        pad[axis] = (d, 0)
        sl[axis] = slice(0, x.shape[axis])
    else:
        pad[axis] = (0, d)
        sl[axis] = slice(d, d + x.shape[axis])
    return jnp.pad(x, pad, constant_values=fill)[tuple(sl)]


def _segmented_min_scan(lab: jnp.ndarray, fg: jnp.ndarray, axis: int,
                        big: int) -> jnp.ndarray:
    """Min-propagate labels along ``axis`` within contiguous foreground
    runs, both directions: a whole run equalizes in O(log n) parallel
    steps with zero gathers (gathers on megapixel images are the CCL
    bottleneck otherwise).

    Hillis-Steele doubling with CONTIGUOUS shifts: at step d the carry
    (m, blocked) absorbs the carry from d elements behind unless a
    background boundary intervened.  ``lax.associative_scan`` computes the
    same thing but lowers to stride-2 interleaved slices, which cost more
    and dominate compile time."""
    n = lab.shape[axis]
    m0 = jnp.where(fg, lab, big)
    b0 = ~fg
    out = None
    for front in (True, False):
        m, b = m0, b0
        d = 1
        while d < n:
            ms = _shifted(m, d, axis, big, front)
            bs = _shifted(b, d, axis, True, front)
            m = jnp.where(b, m, jnp.minimum(m, ms))
            b = b | bs
            d *= 2
        out = m if out is None else jnp.minimum(out, m)
    return jnp.where(fg, out, big)


@jax.jit
def label_components(fg: jnp.ndarray) -> jnp.ndarray:
    """8-connected component labels: each foreground pixel gets the smallest
    flat index in its component; background gets H*W.  fg is (H, W) bool.

    Fixed-point of sweeps, each: 8-neighborhood min (shift-based) then
    segmented min-scans along rows and columns.  The scans propagate labels
    across entire runs at once, so convergence takes a handful of sweeps on
    real masks (vs O(image diameter) for pure neighbor propagation, or
    megapixel gathers for pointer jumping)."""
    h, w = fg.shape
    big = h * w
    idx = jnp.arange(big, dtype=jnp.int32).reshape(h, w)
    lab = jnp.where(fg, idx, big)

    def body(state):
        lab, _ = state
        new = _neighbor_min(lab, big)
        new = jnp.where(fg, new, big)
        new = _segmented_min_scan(new, fg, 1, big)
        new = _segmented_min_scan(new, fg, 0, big)
        return new, jnp.any(new != lab)

    def cond(state):
        return state[1]

    lab, _ = jax.lax.while_loop(cond, body, (lab, jnp.asarray(True)))
    return lab


@jax.jit
def outside_mask(bg: jnp.ndarray) -> jnp.ndarray:
    """Background pixels 4-connected to the image border.

    8-connected foreground implies 4-connected background (a diagonal fg
    pinch seals the contour), so hole detection must flood with 4-conn
    moves.  Same sweep structure as label_components but propagating a
    single 0 = outside / 1 = unknown flag (fg pixels are barriers)."""
    h, w = bg.shape
    border = jnp.zeros((h, w), bool)
    border = border.at[0, :].set(True).at[h - 1, :].set(True)
    border = border.at[:, 0].set(True).at[:, w - 1].set(True)
    val = jnp.where(bg, jnp.where(border, 0, 1), 2)

    def body(state):
        v, _ = state
        nv = _neighbor_min4(v, 2)
        nv = jnp.where(bg, nv, 2)
        nv = _segmented_min_scan(nv, bg, 1, 2)
        nv = _segmented_min_scan(nv, bg, 0, 2)
        return nv, jnp.any(nv != v)

    val, _ = jax.lax.while_loop(lambda s: s[1], body,
                                (val, jnp.asarray(True)))
    return bg & (val == 0)


@jax.jit
def fill_holes(fg: jnp.ndarray) -> jnp.ndarray:
    """fg with enclosed background regions filled (RETR_EXTERNAL's view:
    only outer contours exist, so holes — and anything nested inside them —
    belong to the enclosing component)."""
    return fg | ~outside_mask(~fg)


@jax.jit
def largest_component_bbox(fg: jnp.ndarray) -> BBoxResult:
    """Bounding box (x, y, w, h) of the component with the largest
    cv2.contourArea-equivalent outer-contour area, cv2-convention
    (x: column, y: row, inclusive extent).  See module docstring for the
    exact-area construction (hole fill + per-dual-cell decomposition)."""
    h, w = fg.shape
    big = h * w
    filled = fill_holes(fg)
    lab = label_components(filled)
    flat = lab.reshape(-1)

    npix = jax.ops.segment_sum(filled.reshape(-1).astype(jnp.float32),
                               flat, num_segments=big + 1)

    # Marching-squares decomposition of the Suzuki outer-contour area:
    # per 2x2 pixel-center quad, 4 filled -> 1, 3 filled -> 1/2, else 0.
    fi = filled.astype(jnp.int32)
    q = fi[:-1, :-1] + fi[:-1, 1:] + fi[1:, :-1] + fi[1:, 1:]
    cell = jnp.where(q == 4, 1.0, jnp.where(q == 3, 0.5, 0.0))
    # With >= 3 filled pixels the quad is single-component; background
    # labels are `big`, so the min is the owning component's label.
    cl = jnp.minimum(jnp.minimum(lab[:-1, :-1], lab[:-1, 1:]),
                     jnp.minimum(lab[1:, :-1], lab[1:, 1:]))
    areas = jax.ops.segment_sum(cell.reshape(-1), cl.reshape(-1),
                                num_segments=big + 1)
    areas = areas.at[big].set(-jnp.inf)             # background
    areas = jnp.where(npix > 0, areas, -jnp.inf)    # non-existent labels
    best = jnp.argmax(areas)

    sel = (lab == best) & filled
    rows = jnp.any(sel, axis=1)
    cols = jnp.any(sel, axis=0)
    ridx = jnp.arange(h)
    cidx = jnp.arange(w)
    y0 = jnp.min(jnp.where(rows, ridx, h))
    y1 = jnp.max(jnp.where(rows, ridx, -1))
    x0 = jnp.min(jnp.where(cols, cidx, w))
    x1 = jnp.max(jnp.where(cols, cidx, -1))

    found = jnp.any(fg)
    return BBoxResult(
        x=x0.astype(jnp.int32), y=y0.astype(jnp.int32),
        w=(x1 - x0 + 1).astype(jnp.int32), h=(y1 - y0 + 1).astype(jnp.int32),
        found=found, area=areas[best])
