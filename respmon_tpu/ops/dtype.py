"""dtype conversion helpers matching the reference's converters.

The reference converters (transforms.py:16-35) have one load-bearing quirk:
``float_to_uint8`` writes ``img * 255`` into a uint8 ndarray, which in numpy
truncates toward zero and wraps modulo 256 instead of clipping.  Downstream
code relies on this (e.g. normalized heatmaps hit exactly 255 at the max).
We reproduce the wrap semantics explicitly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def uint8_to_float(img: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """uint8 [0,255] -> float [0,1] (reference transforms.py:20-23),
    bit-exact to the host reference chain on every byte.

    The reference computes ``img * (1./255)`` under numpy promotion (a
    float64 multiply); the host capture path casts that to f32.  For f32
    output the bit-exact image of that chain is the correctly-rounded
    quotient b/255 — but neither a plain f32 reciprocal multiply (1 ULP
    off on 126 of the 256 bytes) nor a literal ``x / 255.0`` (XLA's
    algebraic simplifier rewrites constant division into exactly that
    reciprocal multiply under jit) computes it.  Instead: one
    Newton/Markstein correction of the reciprocal multiply,
    ``q + (x - q*255) * r``, exhaustively correctly-rounded in plain f32,
    with ``q`` behind ``lax.optimization_barrier`` so the simplifier
    cannot collapse ``q*255`` back to ``x`` (which zeroes the residual
    and silently degrades to the multiply — caught on the device by
    ``utils/parity.u8_widen_mismatches``).  float64 output reproduces the
    reference multiply verbatim.
    """
    if jnp.dtype(dtype) == jnp.float64:
        return img.astype(jnp.float64) * (1.0 / 255.0)
    x = img.astype(dtype)
    r = jnp.asarray(1.0 / 255.0, dtype)
    q = jax.lax.optimization_barrier(x * r)
    return q + (x - q * jnp.asarray(255.0, dtype)) * r


def ingest_frames(frames, dtype) -> jnp.ndarray:
    """Stage a frame batch for device ingest: camera-native uint8 ships as
    bytes (widened on device by the consuming kernel), anything else casts
    to the pipeline compute ``dtype`` host-side.

    The u8 ingest contract is float32 compute (the production dtype;
    ``uint8_to_float``'s f32 path is the bit-exact image of the reference
    conversion chain) — requesting a different compute dtype with u8
    frames raises instead of silently downgrading.
    """
    if np.dtype(getattr(frames, "dtype", np.float32)) == np.uint8:
        if jnp.dtype(dtype) != jnp.float32:
            raise ValueError(
                "uint8 frame ingest implies float32 compute; convert "
                f"host-side for dtype={jnp.dtype(dtype).name} "
                "(ops/dtype.uint8_to_float)")
        return jnp.asarray(frames)
    return jnp.asarray(frames, dtype)


def float_to_uint8(img: jnp.ndarray) -> jnp.ndarray:
    """float [0,1] -> uint8, with numpy-style trunc-and-wrap out-of-range
    semantics (reference transforms.py:26-29 stores into a uint8 ndarray,
    which wraps mod 256 rather than saturating)."""
    scaled = jnp.trunc(img.astype(jnp.float32) * 255.0)
    wrapped = jnp.mod(scaled.astype(jnp.int32), 256)
    return wrapped.astype(jnp.uint8)


def float_to_int8(img: jnp.ndarray) -> jnp.ndarray:
    """Reference transforms.py:32-35 — note it also stores into *uint8*."""
    scaled = jnp.trunc(img.astype(jnp.float32) * 255.0) - 127.0
    wrapped = jnp.mod(scaled.astype(jnp.int32), 256)
    return wrapped.astype(jnp.uint8)


def normalize(data: jnp.ndarray) -> jnp.ndarray:
    """Min-max normalize (reference ``nomrmalize`` [sic], transforms.py:16-17)."""
    lo = jnp.min(data)
    hi = jnp.max(data)
    return (data - lo) / (hi - lo)


def bgr_to_gray(frame: jnp.ndarray) -> jnp.ndarray:
    """BGR uint8 HxWx3 -> grayscale, cv2.cvtColor COLOR_BGR2GRAY semantics
    (reference base.py:230), bit-exact: cv2 uses the fixed-point BT.601
    formula y = (9798 R + 19235 G + 3735 B + 2^14) >> 15 (coefficients sum
    to 2^15; verified exhaustively over all 2^24 BGR values against this
    cv2 build) — same integer arithmetic as the native path
    (native/resp_native.cpp bgr_u8_to_gray_f32)."""
    f = frame.astype(jnp.int32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = (9798 * r + 19235 * g + 3735 * b + 16384) >> 15
    return y.astype(jnp.uint8)
