"""Monte-Carlo sampling primitives, batched and branch-free.

Reimplements (bit-for-bit in exact arithmetic) the sampling routines the
reference clones from pbrt:
  - ConcentricSampleDisk            (reference: util/util.cu.h:23-65)
  - CosineSampleHemisphere          (reference: util/material/cudamaterial.cu.h:50-55)
  - UniformSampleSphere / pdf       (reference: util/light/cudalight.cu.h:66-77)
  - Permuted-Halton radical inverse (reference: photon_mapping/photontracing.cu:15-43;
                                     permutation tables from pbrt's PermutedHalton(5, RNG),
                                     photonmappingrenderer.cpp:200-217)
  - stratified 2D sample arrays     (pbrt StratifiedSampler; uploaded by the
                                     reference as bRandom2D, pbrtcamera.cpp:78-109)

The CUDA versions branch per thread; these are jnp.where ladders so the whole
wavefront stays branch-free elementwise work.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)

# Halton bases used by the reference photon tracer (photontracing.cu:15).
HALTON_BASES = (2, 3, 5, 7, 11, 13)


def concentric_sample_disk(u1: Array, u2: Array) -> tuple[Array, Array]:
    """pbrt's region-based concentric square→disk map, branch-free.

    Matches the reference (util/util.cu.h:23-65) including the degenerate
    origin case.
    """
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0

    # Region selection (the four 45° wedges of the square).
    r1 = (sx >= -sy) & (sx > sy)    # +x wedge
    r2 = (sx >= -sy) & ~(sx > sy)   # +y wedge
    r3 = ~(sx >= -sy) & (sx <= sy)  # -x wedge
    # r4 = else                      # -y wedge

    r = jnp.where(r1, sx, jnp.where(r2, sy, jnp.where(r3, -sx, -sy)))
    safe_r = jnp.where(r == 0.0, 1.0, r)
    theta = jnp.where(
        r1,
        jnp.where(sy > 0.0, sy / safe_r, 8.0 + sy / safe_r),
        jnp.where(
            r2,
            2.0 - sx / safe_r,
            jnp.where(r3, 4.0 - sy / safe_r, 6.0 + sx / safe_r),
        ),
    )
    theta = theta * (math.pi / 4.0)
    degenerate = (sx == 0.0) & (sy == 0.0)
    dx = jnp.where(degenerate, 0.0, r * jnp.cos(theta))
    dy = jnp.where(degenerate, 0.0, r * jnp.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1: Array, u2: Array) -> Array:
    """Cosine-weighted hemisphere direction in the local (+z) frame
    (reference: cudamaterial.cu.h:50-55)."""
    dx, dy = concentric_sample_disk(u1, u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - dx * dx - dy * dy))
    return jnp.stack([dx, dy, z], axis=-1)


def uniform_sample_sphere(u1: Array, u2: Array) -> Array:
    """Uniform direction on the unit sphere (reference: cudalight.cu.h:66-74)."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * math.pi * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sphere_pdf() -> float:
    return INV_FOURPI


def stratified_2d(key: Array, nx: int, ny: int, jitter: bool = True) -> Array:
    """`[nx*ny, 2]` stratified samples over [0,1)² (pbrt StratifiedSample2D)."""
    ix, iy = jnp.meshgrid(jnp.arange(nx), jnp.arange(ny), indexing="ij")
    base = jnp.stack([ix, iy], axis=-1).reshape(-1, 2).astype(jnp.float32)
    if jitter:
        j = jax.random.uniform(key, (nx * ny, 2), dtype=jnp.float32)
    else:
        j = 0.5
    inv = jnp.array([1.0 / nx, 1.0 / ny], dtype=jnp.float32)
    return (base + j) * inv


# ---------------------------------------------------------------------------
# Permuted Halton (pbrt PermutedHalton; device half in photontracing.cu:19-43)
# ---------------------------------------------------------------------------

def halton_permutations(key: Array, n_dims: int = 5) -> tuple[Array, ...]:
    """Per-base digit permutations, one `[base]` int32 array per dimension.

    pbrt's PermutedHalton(5, RNG) draws an independent random permutation of
    {0..b-1} for each base b (photonmappingrenderer.cpp:200,216 re-seeds per
    photon pass). Returned as a tuple so each small table stays its own array.
    """
    perms = []
    for i in range(n_dims):
        b = HALTON_BASES[i]
        key, sub = jax.random.split(key)
        perms.append(jax.random.permutation(sub, jnp.arange(b, dtype=jnp.int32)))
    return tuple(perms)


def _digits_needed(base: int, max_bits: int = 32) -> int:
    return int(math.ceil(max_bits / math.log2(base)))


def permuted_radical_inverse(n: Array, base: int, perm: Array) -> Array:
    """Permuted radical inverse of uint indices `n` in `base`
    (reference: photontracing.cu:19-31). `perm` is the `[base]` digit table.

    NOTE the reference quirk: the digit loop applies perm to every digit and
    terminates when n reaches 0 — trailing digits (all perm[0]) contribute
    nothing only because the loop stops; we replicate the mathematical value
    by summing perm[digit] for exactly the digits of n, padding with perm[0]
    for higher digits (pbrt's PermutedHalton does include the perm[0] tail as
    a geometric series; the reference kernel drops it — we follow the
    reference and drop it, masking digits beyond the significant ones).
    """
    n = n.astype(jnp.uint32)
    inv_base = np.float32(1.0 / base)
    val = jnp.zeros(n.shape, dtype=jnp.float32)
    inv_bi = jnp.full(n.shape, inv_base, dtype=jnp.float32)
    rem = n
    for _ in range(_digits_needed(base)):
        digit = (rem % base).astype(jnp.int32)
        active = rem > 0
        d = perm[digit].astype(jnp.float32)
        val = val + jnp.where(active, d * inv_bi, 0.0)
        inv_bi = inv_bi * inv_base
        rem = rem // base
    return val


def halton_sample_4d(n: Array, perms: tuple[Array, ...]) -> Array:
    """`[..., 4]` permuted-Halton points at indices n, bases (2,3,5,7) —
    the light/direction sample of the photon tracer (photontracing.cu:34-43,
    used at :83-92: (LU1, LU2, U1, U2))."""
    dims = [permuted_radical_inverse(n, HALTON_BASES[i], perms[i]) for i in range(4)]
    return jnp.stack(dims, axis=-1)
