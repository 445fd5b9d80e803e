"""RGB spectra as `[..., 3]` arrays.

The reference's CudaSpectrum is a float3 RGB (cuda_render/util/common.cu.h:16-23);
here a spectrum is just the trailing-3 axis of a batched array, so shading math
is ordinary fused elementwise work.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array

# pbrt RGBSpectrum::y() luminance weights (used by the reference for the
# NaN/negative/infinite sanity guards and Russian roulette).
# Kept as a HOST numpy array: an eager jnp device constant closed over by jit
# would be embedded as a literal in every graph that uses it.
_Y_WEIGHT = np.array([0.212671, 0.715160, 0.072169], dtype=np.float32)


def black(shape=(), dtype=jnp.float32) -> Array:
    return jnp.zeros(tuple(shape) + (3,), dtype=dtype)


def is_black(s: Array) -> Array:
    """True where all three channels are exactly zero
    (reference: util/util.cu.h:18-20 isBlack)."""
    return jnp.all(s == 0.0, axis=-1)


def luminance(s: Array) -> Array:
    """pbrt RGBSpectrum::y()."""
    return jnp.sum(s * _Y_WEIGHT, axis=-1)


def sanitize(s: Array) -> Array:
    """Zero out NaN / negative-luminance / infinite samples before film splat,
    mirroring the reference's guards (photonmappingrenderer.cpp:254-268,
    simplerender.cpp:79-93)."""
    y = luminance(s)
    bad = jnp.isnan(y) | jnp.isinf(y) | (y < -1e-5) | jnp.any(jnp.isnan(s) | jnp.isinf(s), axis=-1)
    return jnp.where(jnp.expand_dims(bad, -1), 0.0, s)
