"""Closed-form 2x2 PCA projection for the flow motion signal.

The reference (base.py:396-405) runs, every frame, over the full motion
buffer: ``cov = np.cov(coords)`` (ddof=1) → ``np.linalg.eig`` → column-sort by
eigenvalue descending → ``evec1, evec2 = eig_vecs[:, sort_indices]`` — note
this unpacks the *rows* of the column-sorted eigenvector matrix, so the
projection vector is ``[e1_x, e2_x]`` (x-components of both eigenvectors),
a reference quirk reproduced here — then projects the whole buffer and takes
the last element.

Design: closed-form symmetric 2x2 eigendecomposition (no LAPACK),
masked mean/covariance over a fixed ring buffer, all fused into the jitted
measure step.  Sign convention: LAPACK dgeev's eigenvector signs are
phase-arbitrary (verified empirically: no component-sign rule reproduces
them), so we fix signs by making each eigenvector's largest-|.| component
positive; projected signals can therefore differ from numpy by a global sign,
which leaves peak-to-peak BPM unchanged (documented divergence).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# The default matmul precision may be reduced (TF32 on a GPU); the eigenvector (and thus the
# projection sign/scale) is parity-load-bearing, so force full f32.
_HI = jax.lax.Precision.HIGHEST


def masked_cov2(xy: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """np.cov (rowvar per-coordinate, ddof=1) of masked (N, 2) samples."""
    w = mask.astype(xy.dtype)
    n = jnp.sum(w)
    mean = jnp.sum(xy * w[:, None], axis=0) / jnp.maximum(n, 1.0)
    d = (xy - mean) * w[:, None]
    cov = jnp.matmul(d.T, d, precision=_HI) / jnp.maximum(n - 1.0, 1.0)
    return cov


def eigh2_desc(cov: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Symmetric 2x2 eigendecomposition, eigenvalues descending.

    Returns (vals (2,), vecs (2,2) with eigenvectors as columns), each
    column's largest-|.| component made positive.
    """
    a, b, c = cov[0, 0], cov[0, 1], cov[1, 1]
    half_tr = 0.5 * (a + c)
    disc = jnp.sqrt(0.25 * (a - c) ** 2 + b * b)
    lam1 = half_tr + disc
    lam2 = half_tr - disc

    def unit_vec(lam):
        # [b, lam-a] is an eigenvector when b != 0; fall back to the axis
        # basis for (near-)diagonal matrices.
        v = jnp.stack([b, lam - a])
        nrm = jnp.sqrt(jnp.sum(v * v))
        diag_vec = jnp.where(
            (lam - a) * (lam - a) <= (lam - c) * (lam - c),
            jnp.asarray([1.0, 0.0], cov.dtype),
            jnp.asarray([0.0, 1.0], cov.dtype))
        v = jnp.where(nrm > 1e-30 * (jnp.abs(a) + jnp.abs(c) + 1e-300),
                      v / jnp.maximum(nrm, 1e-300), diag_vec)
        # Deterministic sign: largest-|.| component positive.
        pick = jnp.where(jnp.abs(v[0]) >= jnp.abs(v[1]), v[0], v[1])
        return v * jnp.where(pick < 0, -1.0, 1.0)

    v1 = unit_vec(lam1)
    v2 = unit_vec(lam2)
    vals = jnp.stack([lam1, lam2])
    vecs = jnp.stack([v1, v2], axis=1)
    return vals, vecs


def pca_project_last(motion_xy: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """The reference's per-frame PCA step (base.py:396-405): covariance of
    the masked motion buffer, first-eigenvector row-quirk projection of the
    *newest* sample.

    motion_xy: (N, 2) right-aligned ring buffer; mask: validity.  Returns the
    projected value for the last (newest) sample.
    """
    cov = masked_cov2(motion_xy, mask)
    _, vecs = eigh2_desc(cov)
    evec1_row = vecs[0, :]   # row 0 of the column-sorted matrix (the quirk)
    return jnp.dot(motion_xy[-1], evec1_row, precision=_HI)
