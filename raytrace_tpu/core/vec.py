"""Batched 3-vector math on `[..., 3]` arrays.

The reference carries its vector math in OptiX float3 helpers and pbrt types
(reference: cuda_render/util/util.cu.h, util/util.cpp). Here every op is a
pure function over stacked arrays so it vmaps/shards/differentiates freely, in
place of per-thread float3 arithmetic.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def dot(a: Array, b: Array) -> Array:
    """Batched dot product over the trailing axis."""
    return jnp.sum(a * b, axis=-1)


def absdot(a: Array, b: Array) -> Array:
    """|a·b| (reference: util/util.cu.h:14-16 AbsDot)."""
    return jnp.abs(dot(a, b))


def cross(a: Array, b: Array) -> Array:
    # Hand-rolled instead of jnp.cross: keeps everything in fused
    # elementwise ops and avoids jnp.cross's generalized moveaxis machinery.
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length_squared(v: Array) -> Array:
    return dot(v, v)


def length(v: Array) -> Array:
    return jnp.sqrt(length_squared(v))


def distance_squared(p1: Array, p2: Array) -> Array:
    """(reference: util/util.cu.h:8-12 DistanceSquared)."""
    return length_squared(p2 - p1)


def normalize(v: Array, eps: float = 1e-20) -> Array:
    """Normalize over the trailing axis; zero vectors stay finite."""
    return v * jnp.expand_dims(jnp.reciprocal(jnp.sqrt(length_squared(v) + eps)), -1)


def faceforward(n: Array, v: Array) -> Array:
    """Flip n so it lies in the same hemisphere as v."""
    return jnp.where(jnp.expand_dims(dot(n, v), -1) < 0.0, -n, n)


def world_to_local(v: Array, nn: Array, sn: Array, tn: Array) -> Array:
    """World → shading frame (reference: util/material/cudamaterial.cu.h:57-60).

    The frame follows the reference exactly: nn = normalized shading normal,
    sn = normalized dpdu (NOT re-orthogonalized), tn = cross(nn, sn).
    """
    return jnp.stack([dot(v, sn), dot(v, tn), dot(v, nn)], axis=-1)


def local_to_world(v: Array, nn: Array, sn: Array, tn: Array) -> Array:
    """Shading frame → world (reference: util/material/cudamaterial.cu.h:61-66)."""
    return (
        sn * v[..., 0:1] + tn * v[..., 1:2] + nn * v[..., 2:3]
    )


def shading_frame(ns: Array, dpdu: Array) -> tuple[Array, Array, Array]:
    """Build the (nn, sn, tn) shading frame the reference uses
    (cudamaterial.cu.h:85-88: nn=normalize(ns), sn=normalize(dpdu), tn=nn×sn)."""
    nn = normalize(ns)
    sn = normalize(dpdu)
    tn = cross(nn, sn)
    return nn, sn, tn


def coordinate_system(v1: Array) -> tuple[Array, Array]:
    """Build an arbitrary orthonormal basis around unit v1 (pbrt-style;
    reference uses the same fallback for degenerate triangle UVs,
    cudatrianglemesh.cu:50-60)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = jnp.abs(x) > jnp.abs(y)
    inv_len_a = jnp.reciprocal(jnp.sqrt(x * x + z * z + 1e-20))
    a = jnp.stack([-z * inv_len_a, jnp.zeros_like(x), x * inv_len_a], axis=-1)
    inv_len_b = jnp.reciprocal(jnp.sqrt(y * y + z * z + 1e-20))
    b = jnp.stack([jnp.zeros_like(x), z * inv_len_b, -y * inv_len_b], axis=-1)
    v2 = jnp.where(jnp.expand_dims(use_x, -1), a, b)
    return v2, cross(v1, v2)


# The transforms below are broadcast-multiply-sums rather than einsums: a
# float32 dot on the GPU may run in TF32 (~3 significant digits), which is
# enough error in a ray origin to exceed scene_epsilon. These stay exact f32
# and fuse with their neighbours.

def transform_point(m: Array, p: Array) -> Array:
    """Apply `[..., 3, 4]` affine transform rows to `[..., 3]` points."""
    return transform_vector(m, p) + m[..., :3, 3]


def transform_vector(m: Array, v: Array) -> Array:
    """Apply the linear part of a `[..., 3, 4]` affine transform to vectors."""
    return jnp.sum(m[..., :3, :3] * v[..., None, :], axis=-1)


def transform_normal(m_inv: Array, n: Array) -> Array:
    """Transform a normal with the inverse-transpose: given w2o (the inverse of
    o2w), normals map by (w2o)^T (pbrt convention; the reference leans on
    OptiX's rtTransformNormal for the same)."""
    return jnp.sum(m_inv[..., :3, :3] * n[..., :, None], axis=-2)
