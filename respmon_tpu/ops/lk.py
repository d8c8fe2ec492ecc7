"""Pyramidal Lucas-Kanade sparse optical flow (cv2.calcOpticalFlowPyrLK
semantics).

The reference tracks Shi-Tomasi corners with ``cv2.calcOpticalFlowPyrLK(prev,
next, pts, None, winSize=(15,15), maxLevel=2, criteria=(EPS|COUNT, 10, 0.03))``
(base.py:96-98, 371-372).  OpenCV's algorithm, reproduced:

  - 3-level image pyramids (pyrDown), Scharr derivatives of the prev level
    (smooth [3,10,3], diff [-1,0,1]; replicate border), derivative samples
    outside the image read as zero (cv2 pads derivatives BORDER_CONSTANT).
  - Per point, coarse-to-fine: at each level gather the 15x15 window around
    the point by bilinear interpolation (reflect-101 image border), form the
    2x2 normal matrix G from the prev window gradients, then Newton-iterate
    ``nextPt += -G^{-1} sum((J-I) * grad)`` up to 10 times or until
    ``||delta||^2 <= 0.03^2`` (cv2 squares epsilon), with cv2's oscillation
    damper (averaging back half a step when successive deltas cancel).
  - Status drops to 0 at level 0 when the window leaves the image, when
    ``det(G) < FLT_EPSILON``, or when the normalized min eigenvalue of G is
    below ``minEigThreshold=1e-4`` (cv2 units: gradients are Scharr x32 and
    accumulators scaled 2^-20, i.e. true-gradient G / 1024, then / winArea).

Design: windows are never gathered pixel-by-pixel.  Each level's
padded images are expanded ONCE into an im2col patch matrix of
(win+1)x(win+1) support windows (``conv_general_dilated_patches``); a
bilinear window at any float position is then ONE CONTIGUOUS ROW of that
matrix — a flat ``jnp.take`` row gather — plus in-register corner slicing,
and the per-iteration update is pure batched VPU arithmetic over the
(points, win*win) block.  The Newton iterations run as one early-exit
``while_loop`` over the whole point set with masked convergence (no
per-point control flow; bit-identical to running all iterations).  Images are expected on the
uint8 [0,255] value scale (the reference converts crops with float_to_uint8
before LK, base.py:364-371), which the minEig threshold depends on.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from respmon_tpu.ops.pyramid import _reflect101_indices, pyr_down


class FlowResult(NamedTuple):
    pts: jnp.ndarray     # (N, 2) float32 tracked positions (x, y)
    status: jnp.ndarray  # (N,) bool


def _scharr_derivs(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """True-gradient Scharr derivatives (cv2 calcScharrDeriv / 32),
    replicate border."""
    p = jnp.pad(img, 1, mode="edge")
    h, w = img.shape
    sm = (3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0)
    df = (-0.5, 0.0, 0.5)

    def conv(a, taps_y, taps_x):
        acc = None
        for i, wy in enumerate(taps_y):
            for j, wx in enumerate(taps_x):
                c = wy * wx
                if c == 0.0:
                    continue
                term = a[i:i + h, j:j + w] * c
                acc = term if acc is None else acc + term
        return acc

    dx = conv(p, sm, df)
    dy = conv(p, df, sm)
    return dx, dy


def _pad_for_windows(img: jnp.ndarray, win: int, border: str) -> jnp.ndarray:
    """Pre-pad so any window with integer base in [-win-1, dim-1] is in
    bounds.  border: 'reflect101' (cv2 image pyramids) or 'zero' (cv2
    derivative padding)."""
    pad = win + 2
    if border == "reflect101":
        ry = jnp.asarray(_reflect101_indices(img.shape[0], pad))
        rx = jnp.asarray(_reflect101_indices(img.shape[1], pad))
        return img[ry][:, rx]
    return jnp.pad(img, pad)


class _LevelPatches(NamedTuple):
    """Per-level sampling structures.

    Only the *next* image is re-sampled inside the Newton loop.  The
    sampling modes for it (``mode``):

    - ``"patches"``: ``next`` is an im2col matrix of (win+1)^2 support
      windows; a bilinear window is ONE contiguous row gather.  Fastest
      per iteration,
      but materializing the matrix costs ~(win*win)x the image in HBM
      traffic and footprint — right for the whole-clip scan path where it
      is hoisted out of the scan, ruinous for large crops batched over many
      streams (64 x 256x448 crops OOM a 16 GB chip).
    - ``"slices"``: ``next`` is just the padded (Hp, Wp) image; each point
      takes one contiguous (win+1, win+1) dynamic slice per iteration.
      O(points) instead of O(pixels) memory — the single-stream live mode.
    - ``"patches16"``: like ``"patches"`` but the matrix is stored bf16
      (f32 upcast after the gather) — halves the footprint/traffic that
      OOMs f32 at fleet scale; the former fleet throughput mode.
    - ``"onehot"``: ``next`` is the padded (Hp, Wp) image; each iteration
      extracts every point's (win+1)^2 support grid with one-hot
      matmuls (``SelY @ img @ SelX^T`` — each dot row has exactly ONE
      nonzero, so the product is the exact pixel, bit-identical to a
      dynamic slice; run as exact multi-term bf16 passes where the
      level's pixel mantissas allow, else ``Precision.HIGHEST`` — see
      ``_window_onehot``) — with no build cost (patches16 builds a
      matrix per fleet step).

    prev/dx/dy windows are sampled once per level via padded dynamic slices
    in every mode (cheaper than building three more patch matrices)."""

    prev_stack: jnp.ndarray  # (3, Hp, Wp): padded image, dx, dy stacked so
                             # one slice per point fetches all three windows
    next: jnp.ndarray        # (R, (win+1)^2) matrix | (Hp, Wp) image
    wprime: int              # patch-grid width (static; unused in slices)
    hw: Tuple[int, int]      # unpadded level shape (static)
    mode: str = "patches"    # next-window sampling mode (static)
    # prev-window sampling (once per level, image+dx+dy): "slices" = one
    # (3, win+1, win+1) dynamic slice per point; "onehot" = one-hot
    # matmul extraction (no per-point gathers — see _window_onehot3).
    prev_mode: str = "slices"
    # Number of exact bf16 split terms for the onehot next-window
    # contractions (0 = f32 HIGHEST).  Level L of a uint8-scale pyramid
    # needs L+1 terms; 3 terms reassemble ANY f32 exactly (bf16x3), so
    # min(level+1, 3) is always bit-identical (see _window_onehot).
    bf16_exact: int = 0
    # Same for the prev-window (image+dx+dy) onehot extraction: the
    # Scharr channels need one more term than the image, so min(L+2, 3)
    # (see _window_onehot3).
    prev_bf16: int = 0


def _patch_matrix(img_pad: jnp.ndarray, win: int,
                  dtype=None) -> Tuple[jnp.ndarray, int]:
    """All win x win patches of a padded image as rows: (R, win*win).

    ``conv_general_dilated_patches`` runs as a convolution at the default
    precision, which may be reduced (TF32 on a GPU), so even ``dtype=None``
    (f32 storage) may round non-integer pixels of downsampled levels —
    level 0 (uint8-scale integers) is exact either way.  The BPM chain's
    parity-load-bearing decisions sit downstream of the (already-quantized)
    motion samples, so this costs sample-level noise, not decision parity.
    No default path uses this mode.

    ``dtype`` stores the matrix narrower (bf16 halves the dominant HBM
    footprint/traffic; uint8-scale level-0 pixels are integers <= 255 and
    thus EXACT in bf16 — only downsampled levels round)."""
    p = jax.lax.conv_general_dilated_patches(
        img_pad[None, None], filter_shape=(win, win),
        window_strides=(1, 1), padding="VALID")
    _, c, hp, wp = p.shape
    m = p[0].reshape(c, hp * wp).T
    return (m if dtype is None else m.astype(dtype)), wp


def _window_slices3(stack: jnp.ndarray, pad: int, by, bx, fy, fx,
                    win: int):
    """Three (N, win*win) bilinear windows (image, dx, dy) via ONE vmapped
    contiguous dynamic slice per point over the channel-stacked array."""

    def one(by1, bx1, fy1, fx1):
        zero = jnp.zeros((), by1.dtype)
        grid = jax.lax.dynamic_slice(
            stack, (zero, by1 + pad, bx1 + pad), (3, win + 1, win + 1))
        out = (grid[:, :-1, :-1] * (1 - fy1) * (1 - fx1)
               + grid[:, :-1, 1:] * (1 - fy1) * fx1
               + grid[:, 1:, :-1] * fy1 * (1 - fx1)
               + grid[:, 1:, 1:] * fy1 * fx1)
        return out.reshape(3, -1)

    w3 = jax.vmap(one)(by, bx, fy, fx)        # (N, 3, win*win)
    return w3[:, 0], w3[:, 1], w3[:, 2]


def _window_onehot3(stack: jnp.ndarray, pad: int, by, bx, fy, fx,
                    win: int, bf16_exact: int = 0):
    """Three (N, win*win) bilinear windows (image, dx, dy) via one-hot
    matmul extraction of the (3, Hp, Wp) channel stack — the
    zero-workspace alternative to ``_window_slices3`` that replaces
    per-point 2D dynamic-slice gathers with contractions.  Bases are
    clamped exactly as
    ``dynamic_slice`` clamps its start, and each selector row has exactly
    one nonzero, so the extracted grid holds the exact f32 pixels and the
    bilinear combine is the same expression as ``_window_slices3`` —
    NOTE, however, that bit-level equality with the slice path is NOT
    guaranteed: XLA fuses the elementwise bilinear differently downstream
    of a matmul than of a per-point gather, which was measured to move
    results by 1 ulp.  Callers that advertise bit-parity with the slice
    path (the live fleet modes) must keep prev sampling on slices; the
    whole-clip scan uses this consistently in both of ITS compared paths.

    ``bf16_exact``: number of exact bf16 split terms (0 = f32 HIGHEST;
    any split count is bitwise-equal to the HIGHEST path — both extract
    exact pixels into the same bilinear expression — verified L0-L2) —
    the same Dekker-peel trick as ``_window_onehot``, applied to all
    three channels.  At pyramid level L of a uint8-scale input the image
    needs L+1 terms and the x32-scaled Scharr derivatives (dyadics
    q/2^(8L+5), |q| < 2^(8L+13)) need L+2, so callers pass
    ``min(L+2, 3)`` — and 3 terms reassemble ANY f32 exactly, covering
    every level unconditionally."""
    s = win + 1
    _, hp, wp = stack.shape
    byc = jnp.clip(by + pad, 0, hp - s)
    bxc = jnp.clip(bx + pad, 0, wp - s)
    ky = byc[:, None] + jnp.arange(s)[None, :]
    kx = bxc[:, None] + jnp.arange(s)[None, :]
    dtype = stack.dtype
    if bf16_exact:
        bt = jnp.bfloat16
        sely = (ky[:, :, None] == jnp.arange(hp)[None, None, :]).astype(bt)
        selx = (kx[:, :, None] == jnp.arange(wp)[None, None, :]).astype(bt)
        terms = []
        rem = stack
        for _ in range(bf16_exact - 1):
            h16 = rem.astype(bt)
            terms.append(h16)
            rem = rem - h16.astype(dtype)
        terms.append(rem.astype(bt))
        grid = None
        for term in terms:
            tmp = jnp.einsum("nsh,chw->ncsw", sely, term,
                             preferred_element_type=bt)  # exact term vals
            g = jnp.einsum("ncsw,nqw->ncsq", tmp, selx,
                           preferred_element_type=dtype)
            grid = g if grid is None else grid + g       # (N, 3, s, s)
    else:
        sely = (ky[:, :, None] == jnp.arange(hp)[None, None, :]).astype(
            dtype)
        selx = (kx[:, :, None] == jnp.arange(wp)[None, None, :]).astype(
            dtype)
        tmp = jnp.einsum("nsh,chw->ncsw", sely, stack,
                         precision=jax.lax.Precision.HIGHEST)
        grid = jnp.einsum("ncsw,nqw->ncsq", tmp, selx,
                          precision=jax.lax.Precision.HIGHEST)  # (N,3,s,s)
    fy1 = fy[:, None, None, None]
    fx1 = fx[:, None, None, None]
    out = (grid[:, :, :-1, :-1] * (1 - fy1) * (1 - fx1)
           + grid[:, :, :-1, 1:] * (1 - fy1) * fx1
           + grid[:, :, 1:, :-1] * fy1 * (1 - fx1)
           + grid[:, :, 1:, 1:] * fy1 * fx1)
    out = out.reshape(out.shape[0], 3, win * win)
    return out[:, 0], out[:, 1], out[:, 2]


def _window_slices1(img_pad: jnp.ndarray, pad: int, by, bx, fy, fx,
                    win: int) -> jnp.ndarray:
    """Bilinear (N, win*win) windows of one padded image via a contiguous
    (win+1, win+1) dynamic slice per point — bit-identical arithmetic to
    ``_window_rows`` (same pixels, same weight/add order) without the
    patch-matrix footprint."""

    def one(by1, bx1, fy1, fx1):
        grid = jax.lax.dynamic_slice(
            img_pad, (by1 + pad, bx1 + pad), (win + 1, win + 1))
        out = (grid[:-1, :-1] * (1 - fy1) * (1 - fx1)
               + grid[:-1, 1:] * (1 - fy1) * fx1
               + grid[1:, :-1] * fy1 * (1 - fx1)
               + grid[1:, 1:] * fy1 * fx1)
        return out.reshape(-1)

    return jax.vmap(one)(by, bx, fy, fx)


def _window_onehot(img_pad: jnp.ndarray, pad: int, by, bx, fy, fx,
                   win: int, bf16_exact: int = 0) -> jnp.ndarray:
    """Bilinear (N, win*win) windows via one-hot matmul extraction.

    Builds (N, win+1, Hp) / (N, win+1, Wp) one-hot selectors from the
    integer bases and contracts them against the padded image.  Every
    selector row has exactly one nonzero (bases are pre-clipped so all
    indices are in range), so at ``Precision.HIGHEST`` each dot returns the
    exact f32 pixel — bit-identical to ``_window_slices1`` (same pixels,
    then the same ``_bilin_win`` weight/add order).  Unlike im2col
    row-takes (which need a multi-GB prebuilt matrix), this needs no
    workspace.

    ``bf16_exact``: number of bf16 TERMS (0 = off) — run the contractions
    as single-pass bf16 dots instead of multi-pass f32 HIGHEST, splitting
    the image into ``bf16_exact`` exact bf16 addends first.  Still
    bit-identical when every pixel's mantissa fits ``8 * bf16_exact``
    bits: one-hot rows are exact 0/1 in bf16, the dot accumulates in f32,
    a dot whose only nonzero product is ``1.0 * term`` returns that term
    exactly, and the Dekker-style split ``hi = bf16(x); lo = x - hi``
    peels exactly 8 mantissa bits per term, so the per-term row extracts
    hold bf16-exact values and their f32 sum reassembles the exact pixel.
    Pyramid level L of a uint8-scale input needs L+1 terms: level-0 pixels
    are integers 0..255 (8 bits; reflect-101 padding reflects those same
    integers), and each OpenCV pyrDown divides by 16 per separable pass,
    so level-L pixels are dyadics m / 2^(8L) with m < 2^24 — exact at
    every intermediate f32 step, mantissa width 8(L+1)."""
    s = win + 1
    hp, wp = img_pad.shape
    ky = (by + pad)[:, None] + jnp.arange(s)[None, :]          # (N, s)
    kx = (bx + pad)[:, None] + jnp.arange(s)[None, :]
    if bf16_exact:
        bt = jnp.bfloat16
        f32 = img_pad.dtype
        sely = (ky[:, :, None] == jnp.arange(hp)[None, None, :]).astype(bt)
        selx = (kx[:, :, None] == jnp.arange(wp)[None, None, :]).astype(bt)
        terms = []
        rem = img_pad
        for _ in range(bf16_exact - 1):
            h16 = rem.astype(bt)
            terms.append(h16)
            rem = rem - h16.astype(f32)
        terms.append(rem.astype(bt))
        grid = None
        for term in terms:
            t = jnp.einsum("nsh,hw->nsw", sely, term,
                           preferred_element_type=bt)  # exact term values
            g = jnp.einsum("nsw,nqw->nsq", t, selx,
                           preferred_element_type=f32)  # (N, s, s)
            grid = g if grid is None else grid + g
    else:
        sely = (ky[:, :, None] == jnp.arange(hp)[None, None, :]).astype(
            img_pad.dtype)                                      # (N, s, Hp)
        selx = (kx[:, :, None] == jnp.arange(wp)[None, None, :]).astype(
            img_pad.dtype)                                      # (N, s, Wp)
        t = jnp.einsum("nsh,hw->nsw", sely, img_pad,
                       precision=jax.lax.Precision.HIGHEST)
        grid = jnp.einsum("nsw,nqw->nsq", t, selx,
                          precision=jax.lax.Precision.HIGHEST)  # (N, s, s)
    out = _bilin_win(grid, fy, fx, win)
    return out.reshape(grid.shape[0], win * win)


def _window_rows(patches: jnp.ndarray, wprime: int, pad: int,
                 by: jnp.ndarray, bx: jnp.ndarray, fy, fx,
                 win: int) -> jnp.ndarray:
    """Bilinear (N, win*win) windows: ONE patch row per point.

    The matrix stores (win+1)x(win+1) support windows (one row holds all
    four corner win x win subwindows), so a bilinear sample is a single
    row-take plus in-register slicing — one take instead of four.  Same
    pixels, same weight/add order as
    the 4-corner formulation (bit-identical).  by/bx are integer window
    bases in unpadded coordinates."""
    s = win + 1
    hlim = patches.shape[0] // wprime - 1
    ry = jnp.clip(by + pad, 0, hlim)
    rx = jnp.clip(bx + pad, 0, wprime - 1)
    # Row-takes come back in the matrix dtype; combine in the weight dtype
    # (f32) so a narrow-stored matrix only rounds the stored pixels, not
    # the bilinear arithmetic.
    g = jnp.take(patches, ry * wprime + rx, axis=0).astype(fy.dtype)
    g = g.reshape(-1, s, s)
    out = _bilin_win(g, fy, fx, win)
    return out.reshape(g.shape[0], win * win)


def _bilin_win(w16: jnp.ndarray, fy, fx, win: int) -> jnp.ndarray:
    """4-corner bilinear (N, win, win) from (N, win+1, win+1) integer
    support — the same pixel/weight/add order as the classic 4-row
    formulation."""
    fy = fy[:, None, None]
    fx = fx[:, None, None]
    return (w16[:, :win, :win] * (1 - fy) * (1 - fx)
            + w16[:, :win, 1:] * (1 - fy) * fx
            + w16[:, 1:, :win] * fy * (1 - fx)
            + w16[:, 1:, 1:] * fy * fx)


def _track_level(lp: _LevelPatches, prev_pts, next_pts, status, level, win,
                 max_iters, eps2, min_eig_thresh, dtype):
    """One pyramid level for ALL points at once (batched Newton loop)."""
    h, w = lp.hw
    half = (win - 1) * 0.5
    pad = win + 2

    ip = jnp.floor(prev_pts - half)
    fx = (prev_pts[:, 0] - half) - ip[:, 0]
    fy = (prev_pts[:, 1] - half) - ip[:, 1]
    bx = ip[:, 0].astype(jnp.int32)
    by = ip[:, 1].astype(jnp.int32)

    out_prev = (bx < -win) | (bx >= w) | (by < -win) | (by >= h)

    if lp.prev_mode == "onehot":
        iw, ixw, iyw = _window_onehot3(lp.prev_stack, pad, by, bx, fy, fx,
                                       win, bf16_exact=lp.prev_bf16)
    elif lp.prev_mode == "onehot1":
        # Per-channel single-image one-hot extraction (see _window_onehot):
        # pixels come back exact per channel, but the downstream bilinear
        # combine is NOT guaranteed bitwise against "slices" (XLA fuses
        # elementwise work differently after a matmul than after a gather
        # — measured ulp-class drift on CPU too).  It replaces the
        # per-point (3, win+1, win+1) gathers with contractions; tests pin
        # status-decision parity and sub-cv2-tolerance point drift
        # (tests/test_parallel.py).
        # Clip bases into the selector's valid range.  This differs from
        # dynamic_slice's clamp only for by/bx >= h/w — points already
        # flagged out_prev below, whose windows never reach the output.
        h_img, w_img = lp.hw
        byc = jnp.clip(by, -pad, h_img - 1)
        bxc = jnp.clip(bx, -pad, w_img - 1)
        # Image mantissas need min(L+1, 3) terms, Scharr channels
        # min(L+2, 3) (see _window_onehot3's derivation); prev_bf16
        # carries the Scharr count.
        img_terms = min(level + 1, 3) if lp.prev_bf16 else 0
        iw = _window_onehot(lp.prev_stack[0], pad, byc, bxc, fy, fx, win,
                            bf16_exact=img_terms)
        ixw = _window_onehot(lp.prev_stack[1], pad, byc, bxc, fy, fx, win,
                             bf16_exact=lp.prev_bf16)
        iyw = _window_onehot(lp.prev_stack[2], pad, byc, bxc, fy, fx, win,
                             bf16_exact=lp.prev_bf16)
    else:
        iw, ixw, iyw = _window_slices3(lp.prev_stack, pad, by, bx, fy, fx,
                                       win)

    a11 = jnp.sum(ixw * ixw, axis=1)
    a12 = jnp.sum(ixw * iyw, axis=1)
    a22 = jnp.sum(iyw * iyw, axis=1)
    # cv2-scale checks: accumulators correspond to (32 g)^2 / 2^20.
    sa11, sa12, sa22 = a11 / 1024.0, a12 / 1024.0, a22 / 1024.0
    det_s = sa11 * sa22 - sa12 * sa12
    min_eig = (sa22 + sa11
               - jnp.sqrt((sa11 - sa22) ** 2 + 4.0 * sa12 ** 2)) \
        / (2.0 * win * win)
    bad_g = (min_eig < min_eig_thresh) | (det_s < 1.19209290e-07)

    det = a11 * a22 - a12 * a12
    inv_det = jnp.where(jnp.abs(det) > 0, 1.0 / det, 0.0)

    def iter_body(j, carry):
        pts, prev_delta, done, lost = carry
        jp = jnp.floor(pts - half)
        jfx = (pts[:, 0] - half) - jp[:, 0]
        jfy = (pts[:, 1] - half) - jp[:, 1]
        jbx = jp[:, 0].astype(jnp.int32)
        jby = jp[:, 1].astype(jnp.int32)
        out_next = (jbx < -win) | (jbx >= w) | (jby < -win) | (jby >= h)

        if lp.mode == "slices":
            jbyc = jnp.clip(jby, -pad, h - 1)
            jbxc = jnp.clip(jbx, -pad, w - 1)
            jw = _window_slices1(lp.next, pad, jbyc, jbxc, jfy, jfx, win)
        elif lp.mode == "onehot":
            # Same clipping as slices (dynamic_slice clamps its start; the
            # explicit clip reproduces that), so the two modes read the
            # same pixels and are bit-identical.
            jbyc = jnp.clip(jby, -pad, h - 1)
            jbxc = jnp.clip(jbx, -pad, w - 1)
            jw = _window_onehot(lp.next, pad, jbyc, jbxc, jfy, jfx, win,
                                bf16_exact=lp.bf16_exact)
        else:
            jw = _window_rows(lp.next, lp.wprime, pad, jby, jbx, jfy,
                              jfx, win)
        diff = jw - iw
        b1 = jnp.sum(diff * ixw, axis=1)
        b2 = jnp.sum(diff * iyw, axis=1)
        # delta = -G^{-1} b (cv2's closed form).
        dxs = (a12 * b2 - a22 * b1) * inv_det
        dys = (a12 * b1 - a11 * b2) * inv_det
        delta = jnp.stack([dxs, dys], axis=1).astype(dtype)

        new_pts = pts + delta
        small = jnp.sum(delta * delta, axis=1) <= eps2
        # cv2 oscillation damper: successive deltas cancel -> half step back.
        osc = (j > 0) & (jnp.abs(delta[:, 0] + prev_delta[:, 0]) < 0.01) \
            & (jnp.abs(delta[:, 1] + prev_delta[:, 1]) < 0.01)
        new_pts = jnp.where(osc[:, None], new_pts - delta * 0.5, new_pts)

        active = ~(done | lost)
        pts = jnp.where((active & ~out_next)[:, None], new_pts, pts)
        done = done | small | osc | out_next
        lost = lost | (active & out_next)
        return pts, delta, done, lost

    n = prev_pts.shape[0]
    skip = out_prev | bad_g
    init = (jnp.asarray(0, jnp.int32), next_pts, jnp.zeros((n, 2), dtype),
            skip, jnp.zeros((n,), bool))

    def w_cond(carry):
        j, _, _, done, lost = carry
        # Early exit once every point converged/lost — the body freezes
        # finished points anyway, so this is bit-identical to running all
        # max_iters (typical small inter-frame motion converges in 2-4).
        return (j < max_iters) & jnp.any(~(done | lost))

    def w_body(carry):
        j, pts, prev_delta, done, lost = carry
        pts, prev_delta, done, lost = iter_body(
            j, (pts, prev_delta, done, lost))
        return j + 1, pts, prev_delta, done, lost

    _, pts_fin, _, _, lost = jax.lax.while_loop(w_cond, w_body, init)

    # Status drops only at level 0 (cv2 `if level == 0` convention).
    is_level0 = level == 0
    new_status = status & ~(is_level0 & (out_prev | bad_g | lost))
    return pts_fin, new_status


class LKFrameInputs(NamedTuple):
    """Everything LK needs about ONE frame, precomputable and batchable.

    ``stacks``: per-level (3, Hp, Wp) padded (image, dx, dy) — used when
    this frame plays the *prev* role.  ``patches``: per-level (R, win*win)
    im2col matrices — used when this frame plays the *next* role in
    ``"patches"`` sampling mode.  ``images``: per-level (Hp, Wp) padded
    images — the *next* role in ``"slices"`` mode.  The clip fast path
    vmaps ``precompute_frame_inputs`` over all frames up front so the
    sequential scan carries no pyramid/derivative work at all.
    """

    stacks: Tuple[jnp.ndarray, ...]
    patches: Tuple[jnp.ndarray, ...]
    images: Tuple[jnp.ndarray, ...] = ()


def level_geometry(h: int, w: int, win: int, max_level: int):
    """Static per-level (shape, wprime) for images of (h, w)."""
    shapes = [(h, w)]
    for _ in range(max_level):
        hh, ww = shapes[-1]
        shapes.append(((hh + 1) // 2, (ww + 1) // 2))
    # patch-grid width for the (win+1)^2-filter matrices
    wprimes = [ww + 2 * (win + 2) - win for _, ww in shapes]
    return shapes, wprimes


def precompute_frame_inputs(img: jnp.ndarray, win: int = 15,
                            max_level: int = 2, with_stacks: bool = True,
                            with_patches: bool = True,
                            with_images: bool = False,
                            patch_dtype=None) -> LKFrameInputs:
    """Pyramid + Scharr + padding + patch extraction for one frame.

    ``with_stacks``/``with_patches``/``with_images`` select the prev-role /
    patches-mode next-role / slices-mode next-role structures for callers
    that only need some.  ``patch_dtype`` optionally narrows the stored
    patch matrices (see _patch_matrix)."""
    pyr = [img]
    for _ in range(max_level):
        pyr.append(pyr_down(pyr[-1]))
    stacks = []
    patches = []
    images = []
    for p in pyr:
        padded = _pad_for_windows(p, win, "reflect101") \
            if (with_stacks or with_patches or with_images) else None
        if with_stacks:
            dxm, dym = _scharr_derivs(p)
            stacks.append(jnp.stack([
                padded,
                _pad_for_windows(dxm, win, "zero"),
                _pad_for_windows(dym, win, "zero")]))
        if with_patches:
            # (win+1)^2 filter: one row holds a full bilinear support
            # window (see _window_rows).  Measured-and-rejected: storing
            # the level-0 matrix as uint8 (exact for its integer pixels,
            # half the bf16 traffic) ran ~1 ms SLOWER at 64-stream scale —
            # the u8->f32 convert on the gather path outweighs the build-
            # traffic saving.
            patch, _ = _patch_matrix(padded, win + 1, dtype=patch_dtype)
            patches.append(patch)
        if with_images:
            images.append(padded)
    return LKFrameInputs(stacks=tuple(stacks), patches=tuple(patches),
                         images=tuple(images))


def lk_track_precomputed(prev: LKFrameInputs, nxt: LKFrameInputs,
                         pts: jnp.ndarray, valid: jnp.ndarray,
                         shapes, wprimes, win: int = 15, max_level: int = 2,
                         max_iters: int = 10, eps: float = 0.03,
                         min_eig_thresh: float = 1e-4,
                         sample: str = "patches",
                         prev_sample: str = "slices",
                         bf16_split: bool = True) -> FlowResult:
    """LK tracking from precomputed frame inputs (see LKFrameInputs).

    ``shapes``/``wprimes`` come from ``level_geometry`` (static);
    ``sample`` picks the next-window mode and ``prev_sample`` the
    prev-window mode (see _LevelPatches).  Next-window modes are
    bit-identical to each other; prev modes are not all bitwise —
    ``"slices"`` is the bitwise reference, ``"onehot"``/``"onehot1"``
    drift at the ulp level under different XLA fusion (see
    _window_onehot3 / the onehot1 branch in _track_level).

    ``bf16_split`` (onehot mode only): extract next windows with exact
    multi-term bf16 dots instead of multi-pass f32 HIGHEST — level L uses
    min(L+1, 3) terms, bit-identical as long as the input images honor
    this module's documented uint8-[0,255]-scale contract (levels 0-1;
    the 3-term split at level 2+ reassembles ANY f32 exactly, so it holds
    unconditionally; see _window_onehot).  Set False for callers feeding
    non-integer-scale floats."""
    dtype = prev.stacks[0].dtype
    eps2 = jnp.asarray(min(max(eps, 0.0), 10.0) ** 2, dtype)

    pts = pts.astype(dtype)
    next_pts = pts / (2.0 ** (max_level + 1))
    status = valid
    for level in range(max_level, -1, -1):
        lp = _LevelPatches(prev_stack=prev.stacks[level],
                           next=(nxt.images[level]
                                 if sample in ("slices", "onehot")
                                 else nxt.patches[level]),
                           wprime=wprimes[level], hw=shapes[level],
                           mode=sample, prev_mode=prev_sample,
                           bf16_exact=(min(level + 1, 3)
                                       if bf16_split and sample == "onehot"
                                       else 0),
                           prev_bf16=(min(level + 2, 3)
                                      if bf16_split
                                      and prev_sample in ("onehot",
                                                          "onehot1")
                                      else 0))
        prev_pts = pts / (2.0 ** level)
        next_pts = next_pts * 2.0
        next_pts, status = _track_level(
            lp, prev_pts, next_pts, status, level, win, max_iters, eps2,
            min_eig_thresh, dtype)

    return FlowResult(pts=next_pts.astype(jnp.float32),
                      status=status & valid)


@partial(jax.jit, static_argnames=("win", "max_level", "max_iters", "eps",
                                   "min_eig_thresh", "sample",
                                   "prev_sample", "bf16_split"))
def calc_optical_flow_pyr_lk(prev_img: jnp.ndarray, next_img: jnp.ndarray,
                             pts: jnp.ndarray, valid: jnp.ndarray,
                             win: int = 15, max_level: int = 2,
                             max_iters: int = 10, eps: float = 0.03,
                             min_eig_thresh: float = 1e-4,
                             sample: str = "slices",
                             prev_sample: str = "slices",
                             bf16_split: bool = True) -> FlowResult:
    """Track masked points from prev_img to next_img ((H, W), [0,255] scale).

    Returns tracked positions and per-point status; invalid inputs stay
    invalid.  Mirrors the reference call site base.py:371-372.  (Live-path
    wrapper; the whole-clip scan uses the precomputed-inputs variant.)

    ``sample`` selects the next-window sampling:

    - ``"slices"`` (default): per-point dynamic slices.  O(points) memory,
      bit-identical to patches mode (same pixels, same FP order).  The
      fastest mode on the GPU for the fleet step and the whole-clip scan.
    - ``"onehot"``: one-hot matmul window extraction (see _window_onehot;
      exact multi-term bf16 split per level).  Bit-identical to slices,
      O(points) memory, no build cost.
    - ``"patches16"``: bf16 im2col patch matrix + f32 upcast after the
      row gather; the matrix is rebuilt per step and pixels round to bf16
      on downsampled levels (level 0 is exact — uint8-scale integers).
    - ``"patches"``: f32 im2col — exact, 2x the build traffic/footprint of
      patches16."""
    h, w = prev_img.shape
    shapes, wprimes = level_geometry(h, w, win, max_level)
    prev = precompute_frame_inputs(prev_img, win, max_level,
                                   with_patches=False)
    nxt = precompute_frame_inputs(
        next_img, win, max_level, with_stacks=False,
        with_patches=sample in ("patches", "patches16"),
        with_images=sample in ("slices", "onehot"),
        patch_dtype=jnp.bfloat16 if sample == "patches16" else None)
    return lk_track_precomputed(prev, nxt, pts, valid, tuple(shapes),
                                tuple(wprimes), win, max_level, max_iters,
                                eps, min_eig_thresh, sample=sample,
                                prev_sample=prev_sample,
                                bf16_split=bf16_split)
