"""Spatial tensor parallelism: width-sharded EVM with halo exchange.

For single very large frames (e.g. 4K monitoring, or 1080p calibration
buffers too big for one device's memory) the frame's W axis is sharded
across neighbouring devices (SURVEY.md §2.2 "TP" row).  The 5-tap pyrDown/pyrUp stencils
then need 1-2 pixel halos from each neighbor: implemented with
``shard_map`` + ``lax.ppermute`` ring exchanges, with the global border semantics (REFLECT_101 for pyrDown; cv2
pyrUp's asymmetric reflect-front/replicate-back) reconstructed at the
outer edges so the sharded result is bit-identical to the single-device
kernels.

``locate_wsharded`` runs the WHOLE EVM calibration W-sharded: the
O(T·H·W) stages (Laplacian video pyramid, packed-rfft temporal bandpass,
collapse, suppress-top masked mean) execute on W-shards for as long as
per-level widths stay shardable; the tiny deep levels are all-gathered
once (a few MB) and continue replicated; and the O(H·W) finish
(normalize → threshold → CCL bbox) runs replicated on every chip from one
all-gathered heatmap.  This is the idiomatic SPMD shape: shard while the
tensor is big, replicate when collectives would cost more than the
compute.  Results are bit-identical to ``evm.locate`` (all cross-shard
reductions are min/max/concat — no FP reassociation).

Constraints: the local width per shard must be even and >= 4 at every
sharded level so output phases align across shards (global output 2j maps
to local output j); narrower levels are where sharding stops.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from respmon_tpu.config import CalibrationConfig
from respmon_tpu.ops.fft_bandpass import packed_bandpass_operator
from respmon_tpu.ops.dtype import uint8_to_float
from respmon_tpu.ops.pyramid import (_K5, _down_axis, _up_axis, pyr_down,
                                     pyr_up, pyramid_shapes)


def _local_down_w(xp: jnp.ndarray) -> jnp.ndarray:
    """Stride-2 5-tap conv along the last axis of an already-halo-padded
    block (width Wl + 4) producing Wl // 2 outputs."""
    wl = xp.shape[-1] - 4
    out_n = wl // 2
    acc = None
    for k, w in enumerate(_K5):
        term = xp[..., k:k + 2 * out_n:2] * w
        acc = term if acc is None else acc + term
    return acc


@lru_cache(maxsize=64)
def _make_pyr_down_w_sharded(mesh: Mesh, axis: str, ndim: int,
                             n_shards: int):
    """Build (once per (mesh, axis, ndim)) the jitted shard_map pyrDown —
    cached so repeat calls reuse the compiled program instead of re-tracing
    a fresh closure every invocation."""
    in_spec = P(*([None] * (ndim - 1) + [axis]))
    out_spec = in_spec

    def local(xl):
        return _down_w_sharded(xl, axis, n_shards)

    return jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=(in_spec,),
                      out_specs=out_spec))


def _halo_w(xl: jnp.ndarray, k: int, axis: str, n: int,
            front: jnp.ndarray, back: jnp.ndarray) -> jnp.ndarray:
    """Concat k neighbor columns on each side of a W-local block via ring
    ppermute, substituting the given global-border columns at the ends."""
    idx = jax.lax.axis_index(axis)
    left = jax.lax.ppermute(xl[..., -k:], axis,
                            [(i, (i + 1) % n) for i in range(n)])
    right = jax.lax.ppermute(xl[..., :k], axis,
                             [(i, (i - 1) % n) for i in range(n)])
    left = jnp.where(idx == 0, front, left)
    right = jnp.where(idx == n - 1, back, right)
    return jnp.concatenate([left, xl, right], axis=-1)


def _local_up_w(xp: jnp.ndarray) -> jnp.ndarray:
    """Dual-phase 2x upsample along the last axis of a halo-1-padded block
    (width wl + 2) -> (..., 2*wl); same arithmetic as pyramid._up_axis."""
    even = (xp[..., :-2] + 6.0 * xp[..., 1:-1] + xp[..., 2:]) * (1.0 / 8.0)
    odd = (xp[..., 1:-1] + xp[..., 2:]) * 0.5
    inter = jnp.stack([even, odd], axis=-1)
    return inter.reshape(xp.shape[:-1] + (2 * (xp.shape[-1] - 2),))


def _down_w_sharded(x: jnp.ndarray, axis: str, n: int) -> jnp.ndarray:
    """Sharded cv2 pyrDown (rows local, W halo-exchanged); local width must
    be even >= 4."""
    xp = _halo_w(x, 2, axis, n, x[..., 2:0:-1], x[..., -2:-4:-1])
    return _local_down_w(_down_axis(xp, x.ndim - 2))


def _up_w_sharded(x: jnp.ndarray, dst_h: int, axis: str, n: int) \
        -> jnp.ndarray:
    """Sharded cv2 pyrUp to (dst_h, 2*local_w) (rows local with dstsize
    trimming, W halo-exchanged; cv2's asymmetric border: reflect-101 front,
    replicate back)."""
    r = _up_axis(x, x.ndim - 2, dst_h)
    rp = _halo_w(r, 1, axis, n, r[..., 1:2], r[..., -1:])
    return _local_up_w(rp)


def _up_w_from_replicated(g: jnp.ndarray, dst_h: int, axis: str,
                          n: int) -> jnp.ndarray:
    """pyrUp from a REPLICATED source to a W-sharded output: each shard
    slices its source window (with halo) out of the full array — no
    communication."""
    wl = g.shape[-1] // n
    r = _up_axis(g, g.ndim - 2, dst_h)
    # Build the halo'd full row: [front reflect, data, back replicate].
    rp_full = jnp.concatenate([r[..., 1:2], r, r[..., -1:]], axis=-1)
    idx = jax.lax.axis_index(axis)
    start = (jnp.zeros((), idx.dtype),) * (g.ndim - 1) + (idx * wl,)
    rp = jax.lax.dynamic_slice(rp_full, start,
                               r.shape[:-1] + (wl + 2,))
    return _local_up_w(rp)


def pyr_down_w_sharded(x: jnp.ndarray, mesh: Mesh,
                       axis: str = "space") -> jnp.ndarray:
    """cv2-exact pyrDown of (..., H, W) with W sharded over ``mesh[axis]``.

    Requires W % (2 * mesh.shape[axis]) == 0.
    """
    n_shards = mesh.shape[axis]
    w = x.shape[-1]
    assert w % (2 * n_shards) == 0, \
        f"width {w} must be divisible by 2*{n_shards}"
    fn = _make_pyr_down_w_sharded(mesh, axis, x.ndim, n_shards)
    x = jax.device_put(
        x, NamedSharding(mesh, P(*([None] * (x.ndim - 1) + [axis]))))
    return fn(x)


@lru_cache(maxsize=16)
def make_wsharded_locate(mesh: Mesh, fps: float, cfg: CalibrationConfig,
                         t_len: int, h: int, w: int, axis: str = "space"):
    """Compile a W-sharded ``evm.locate`` over ``mesh[axis]``.

    The sharded depth is chosen statically: levels stay W-sharded while
    the per-shard width is even and >= 4; the first narrower level is
    all-gathered (a few MB of deep-pyramid frames) and the rest runs
    replicated.  Output LocateResult fields are replicated and
    bit-identical to single-device ``evm.locate`` (reference
    base.py:547-601 semantics; see module docstring).
    """
    from respmon_tpu.pipeline import evm

    n = mesh.shape[axis]
    assert w % n == 0, (w, n)
    first = cfg.skip_levels_at_top
    last = cfg.pyramid_levels - 2
    shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
    assert cfg.temporal_filter == "fft", \
        "W-sharded locate supports the fft temporal filter"

    def shardable(lvl):
        wl = shapes[lvl][1]
        return wl % n == 0 and (wl // n) % 2 == 0 and wl // n >= 4

    # Levels [0, split) are W-sharded; [split, last+1] replicated.
    split = 0
    while split <= last and shardable(split):
        split += 1
    assert split >= 1, \
        f"width {w} over {n} shards leaves no shardable level"

    op = packed_bandpass_operator(t_len, float(fps), float(cfg.freq_min),
                                  float(cfg.freq_max),
                                  float(cfg.amplification))

    def bandpass(lvl_vid):
        flat = lvl_vid.reshape(t_len, -1)
        out = jnp.dot(jnp.asarray(op, lvl_vid.dtype), flat,
                      preferred_element_type=lvl_vid.dtype,
                      precision=jax.lax.Precision.HIGHEST)
        return out.reshape(lvl_vid.shape)

    def local(vid_local):
        # Camera-native uint8 buffers widen per-shard on device (bit-equal
        # to the host chain, ops/dtype.uint8_to_float) — the upload stays u8.
        if vid_local.dtype == jnp.uint8:
            vid_local = uint8_to_float(vid_local)
        # --- sharded Gaussian chain [0, split], then gather level `split`.
        gauss = [vid_local]
        for lvl in range(1, split + 1):
            gauss.append(_down_w_sharded(gauss[-1], axis, n))
        g_rep = jax.lax.all_gather(gauss[split], axis, axis=2, tiled=True)

        # --- replicated Gaussian tail (split, last+1].
        gauss_rep = {split: g_rep}
        for lvl in range(split + 1, last + 2):
            gauss_rep[lvl] = pyr_down(gauss_rep[lvl - 1])

        # --- bandpassed Laplacian band levels [first, last].  A level's
        # lap is sharded iff the level itself is; the pyrUp source one
        # level down may be sharded, or replicated at the split boundary.
        band = {}
        for lvl in range(first, last + 1):
            if lvl <= split - 1:
                if lvl + 1 <= split - 1:
                    up = _up_w_sharded(gauss[lvl + 1], shapes[lvl][0],
                                       axis, n)
                else:
                    up = _up_w_from_replicated(gauss_rep[lvl + 1],
                                               shapes[lvl][0], axis, n)
                band[lvl] = bandpass(gauss[lvl] - up)
            else:
                up = pyr_up(gauss_rep[lvl + 1], shapes[lvl])
                band[lvl] = bandpass(gauss_rep[lvl] - up)

        # --- collapse: replicated from the deepest level up to `split`,
        # then resharded and halo-pyrUp'd to level 0.  (Shared by the full
        # (T,...) masked pass and the single-frame raw-mean pass.)
        def collapse(levels, t):
            img = jnp.zeros((t,) + shapes[last + 1], vid_local.dtype)
            for lvl in range(last, split - 1, -1):
                img = pyr_up(img, shapes[lvl])
                if lvl in levels:
                    img = img + levels[lvl]
            # boundary: replicated (level `split`) -> sharded (split-1)
            img = _up_w_from_replicated(img, shapes[split - 1][0], axis, n)
            if split - 1 in levels:
                img = img + levels[split - 1]
            for lvl in range(split - 2, -1, -1):
                img = _up_w_sharded(img, shapes[lvl][0], axis, n)
                if lvl in levels:
                    img = img + levels[lvl]
            return img

        img = collapse(band, t_len)

        # --- suppress-top + heatmaps (global extrema via pmin/pmax; means
        # are per-pixel local).
        lo = jax.lax.pmin(jnp.min(img), axis)
        hi = jax.lax.pmax(jnp.max(img), axis)
        top = hi - (hi - lo) * cfg.temporal_threshold
        avg = jnp.mean(jnp.where(img >= top, lo, img), axis=0)

        # Raw heatmap as collapse-of-mean — the SAME formulation (and FP
        # ordering) as evm.locate: per-level T-means are purely local, and
        # the sharded pyrUp chain is bit-identical to pyr_up, so
        # raw_heat_u8 exactly matches the single-device result (the
        # mean-of-collapse alternative differs at ULP level, which the
        # wrap-mod-256 uint8 conversion can amplify to ±255).
        mean_band = {i: jnp.mean(lvl, axis=0, keepdims=True)
                     for i, lvl in band.items()}
        raw_avg = collapse(mean_band, 1)[0]

        avg_full = jax.lax.all_gather(avg, axis, axis=1, tiled=True)
        raw_full = jax.lax.all_gather(raw_avg, axis, axis=1, tiled=True)
        return evm._finish_locate(avg_full, raw_full, cfg)

    in_spec = P(None, None, axis)
    out_spec = P()   # replicated: every shard computes identical results
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(in_spec,),
                                 out_specs=out_spec, check_vma=False))


def locate_wsharded(vid, mesh: Mesh, fps: float, cfg: CalibrationConfig,
                    axis: str = "space"):
    """W-sharded EVM calibration of a (T, H, W) buffer (see module doc)."""
    t_len, h, w = vid.shape
    fn = make_wsharded_locate(mesh, float(fps), cfg, t_len, h, w, axis)
    vid = jax.device_put(jnp.asarray(vid),
                         NamedSharding(mesh, P(None, None, axis)))
    return fn(vid)
