"""Sequence parallelism: the EVM calibration buffer sharded along T.

Long calibration buffers (the reference supports arbitrary
``calibration_buffer_target_length``; BASELINE config 3 uses 300 frames —
at 4K that is ~10 GB of f32 frames, past a single device's comfortable
memory headroom next to the measurement state) shard naturally along the time
axis: every stage of the EVM chain except the temporal bandpass is
per-frame.

Layout and collectives:

- frames (T, H, W) sharded T across ``mesh[axis]``; the Laplacian band
  pyramid is computed locally per frame (zero communication),
- the packed-rfft bandpass (a static (T, T) operator — ops/fft_bandpass.py)
  becomes a distributed matmul: each device multiplies the FULL-T operator
  columns belonging to its local frames and ``psum_scatter``s the partial
  results back to a T-sharded layout (the classic sequence-parallel
  reduce-scatter),
- the collapse is again per-frame local,
- the suppress-top window needs the global min/max (two ``pmin``/``pmax``
  scalars) and the heatmap is a T-mean (one ``psum`` of an (H, W) partial
  sum),
- the threshold + largest-component bbox then run replicated on every
  device (identical inputs -> identical results; the image is tiny
  relative to the video).

The result matches the single-device ``evm.locate`` on the gathered buffer
(same operator, same stencils; reductions reassociate across shards so
parity is to float tolerance, not bitwise).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from respmon_tpu.config import CalibrationConfig
from respmon_tpu.ops.dtype import uint8_to_float
from respmon_tpu.ops.fft_bandpass import packed_bandpass_operator
from respmon_tpu.ops.pyramid import pyr_up, pyramid_shapes
from respmon_tpu.pipeline import evm


def _bandpass_tsharded(lvl_local: jnp.ndarray, op_full: jnp.ndarray,
                       axis: str, n_shards: int) -> jnp.ndarray:
    """Distributed (T, T) @ (T, hw) with both operands/results T-sharded.

    ``lvl_local``: (T/n, h, w) local frames.  ``op_full``: (T, T) static
    operator (a traced constant).  Each device computes the full-T partial
    product against its own input columns, then a reduce-scatter returns
    rows to their owners.
    """
    t_local = lvl_local.shape[0]
    idx = jax.lax.axis_index(axis)
    cols = jax.lax.dynamic_slice_in_dim(op_full, idx * t_local, t_local,
                                        axis=1)
    flat = lvl_local.reshape(t_local, -1)
    partial_out = jnp.dot(cols, flat, preferred_element_type=flat.dtype,
                          precision=jax.lax.Precision.HIGHEST)  # (T, hw)
    out_local = jax.lax.psum_scatter(partial_out, axis,
                                     scatter_dimension=0, tiled=True)
    return out_local.reshape(lvl_local.shape)


@lru_cache(maxsize=16)
def make_tsharded_locate(mesh: Mesh, fps: float, cfg: CalibrationConfig,
                         t_total: int, axis: str = "time"):
    """Compile a T-sharded ``evm.locate`` over ``mesh[axis]``.

    Returns a jitted fn of a (T_pad, H, W) buffer (placed T-sharded), where
    ``T_pad = ceil(t_total / n) * n`` — ``t_total`` not divisible by the
    mesh axis is handled by zero-padding the tail shard and masking it out
    of every temporal reduction (the packed bandpass operator is built for
    the TRUE ``t_total`` and zero-extended, so pad frames contribute
    nothing to any output row).  Output LocateResult fields are replicated.
    """
    n = mesh.shape[axis]
    t_pad = -(-t_total // n) * n
    first = cfg.skip_levels_at_top
    last = cfg.pyramid_levels - 2

    def local(vid_local):
        # Camera-native uint8 buffers widen per-shard on device (bit-equal
        # to the host chain, ops/dtype.uint8_to_float) — the upload stays u8.
        if vid_local.dtype == jnp.uint8:
            vid_local = uint8_to_float(vid_local)
        t_local, h, w = vid_local.shape
        shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
        idx = jax.lax.axis_index(axis)
        # Per-local-frame validity: global index < true T.  Pad frames are
        # zero-filled, stay exactly zero through the (linear) pyramid /
        # bandpass / collapse chain, and are excluded from min/max/means.
        valid = idx * t_local + jnp.arange(t_local) < t_total

        band_lap = evm._band_laplacian_levels(vid_local, cfg)

        assert cfg.temporal_filter == "fft", \
            "T-sharded locate supports the fft temporal filter"
        band = {}
        for i, lvl in band_lap.items():
            op_true = packed_bandpass_operator(
                t_total, float(fps), float(cfg.freq_min),
                float(cfg.freq_max), float(cfg.amplification))
            op = jnp.zeros((t_pad, t_pad), vid_local.dtype)
            op = op.at[:t_total, :t_total].set(
                jnp.asarray(op_true, vid_local.dtype))
            band[i] = _bandpass_tsharded(lvl, op, axis, n)

        img = jnp.zeros((t_local,) + shapes[last + 1], vid_local.dtype)
        for lvl in range(last, -1, -1):
            img = pyr_up(img, shapes[lvl])
            if lvl in band:
                img = img + band[lvl]

        vmask = valid[:, None, None]
        big = jnp.asarray(jnp.inf, img.dtype)
        lo = jax.lax.pmin(jnp.min(jnp.where(vmask, img, big)), axis)
        hi = jax.lax.pmax(jnp.max(jnp.where(vmask, img, -big)), axis)
        top = hi - (hi - lo) * cfg.temporal_threshold
        masked = jnp.where(img >= top, lo, img)

        # T-means across shards: local partial sums + psum; the finish
        # (normalize -> threshold -> CCL bbox) is the shared single-device
        # code so the sharded paths cannot drift from evm.locate.
        avg = jax.lax.psum(
            jnp.sum(jnp.where(vmask, masked, 0), axis=0), axis) / t_total
        raw_avg = jax.lax.psum(
            jnp.sum(jnp.where(vmask, img, 0), axis=0), axis) / t_total
        return evm._finish_locate(avg, raw_avg, cfg)

    in_spec = P(axis, None, None)
    out_spec = P()  # replicated: every shard computes identical results
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(in_spec,),
                                 out_specs=out_spec, check_vma=False))


def locate_tsharded(vid, mesh: Mesh, fps: float, cfg: CalibrationConfig,
                    axis: str = "time") -> evm.LocateResult:
    """T-sharded EVM calibration of a (T, H, W) buffer (see module doc).

    Any ``T >= 1`` works: buffers whose length is not divisible by the mesh
    axis are zero-padded to the next multiple and the pad frames are masked
    out of the temporal statistics (BASELINE config 3's 300-frame buffer on
    an 8-device mesh pads to 304; reference base.py:81,119 treats buffer
    length as a free parameter)."""
    t_total = vid.shape[0]
    n = mesh.shape[axis]
    t_pad = -(-t_total // n) * n
    fn = make_tsharded_locate(mesh, float(fps), cfg, t_total, axis)
    vid = jnp.asarray(vid)
    if t_pad != t_total:
        pad = jnp.zeros((t_pad - t_total,) + vid.shape[1:], vid.dtype)
        vid = jnp.concatenate([vid, pad], axis=0)
    vid = jax.device_put(vid, NamedSharding(mesh, P(axis, None, None)))
    return fn(vid)
