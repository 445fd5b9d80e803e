"""Spatially-hashed photon grid: device-side build + radius search.

The reference copies the photon buffer to the host, builds a pbrt kd-tree on
the CPU, and copies it back (photonmappingrenderer.cpp:141-180 — "correct is
concern, performance not"), then range-searches it per pixel with an explicit
40-deep traversal stack (gathering.cu:25-96). The replacement here is a
sort-based hash grid, built and queried entirely on device:

  build: cell = floor(p / cell_size); key = spatial-hash(cell); photons sorted
         by key (invalid photons sort to the end past a sentinel key).
  query: for each of the 27 neighbor cells of the query point, binary-search
         the sorted key span and scan up to K photons, masked by an exact
         cell-coordinate match (which also makes hash collisions and
         duplicate-bucket neighbors harmless) and the dist² < r² test —
         the same exact-in-radius semantics as the reference's kd-tree walk
         (gathering.cu:40-42).

Cell size must be ≥ the search radius; PPM radii only shrink from the initial
radius (gathering.cu:116-122), so cell_size = initial radius keeps the
27-neighborhood sufficient for every pass.
"""
from __future__ import annotations

import itertools
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from raytrace_tpu.core import struct, vec

# large primes for the 3D spatial hash (Teschner et al.)
_HP = (73856093, 19349663, 83492791)


@struct.dataclass
class PhotonMap:
    """Flat photon storage (reference: CudaPhoton, photonmapping.h:32-40,
    minus the kd-tree bitfields — validity is an explicit mask instead of the
    hasLeftChild bit hack)."""
    p: Array  # [P, 3] position
    alpha: Array  # [P, 3] flux
    wi: Array  # [P, 3] incident direction
    valid: Array  # [P] bool


@struct.dataclass
class PhotonGrid:
    p: Array  # [P, 3] sorted by hash key
    alpha: Array  # [P, 3]
    wi: Array  # [P, 3]
    cell: Array  # [P, 3] int32 cell coords (sorted order)
    key: Array  # [P] uint32 sorted hash keys (invalid = sentinel 0xffffffff)
    cell_size: Array  # scalar f32
    n_valid: Array  # scalar int32


def _hash_cells(cell: Array) -> Array:
    """[..., 3] int32 cell coords → uint32 hash in [0, 2^31)."""
    h = (
        (cell[..., 0] * _HP[0])
        ^ (cell[..., 1] * _HP[1])
        ^ (cell[..., 2] * _HP[2])
    )
    return (h.astype(jnp.uint32)) & jnp.uint32(0x7FFFFFFF)


def build_photon_grid(photons: PhotonMap, cell_size) -> PhotonGrid:
    cell_size = jnp.asarray(cell_size, jnp.float32)
    cell = jnp.floor(photons.p / cell_size).astype(jnp.int32)
    key = _hash_cells(cell)
    key = jnp.where(photons.valid, key, jnp.uint32(0xFFFFFFFF))
    order = jnp.argsort(key)
    return PhotonGrid(
        p=photons.p[order],
        alpha=photons.alpha[order],
        wi=photons.wi[order],
        cell=cell[order],
        key=key[order],
        cell_size=cell_size,
        n_valid=jnp.sum(photons.valid).astype(jnp.int32),
    )


@partial(jax.jit, static_argnames=("max_per_cell",))
def gather_radius(
    grid: PhotonGrid,
    q_p: Array,
    radius2: Array,
    q_ns: Array,
    q_wo: Array,
    q_kd_over_pi: Array,
    max_per_cell: int = 32,
) -> tuple[Array, Array]:
    """Radius search + photon shading in one pass.

    For every query point, accumulates
        Σ |n_s · wi_photon| · (kd/π) · alpha_photon   over dist² < radius²
    (reference: gathering.cu:17-23 processPhoton — its Epanechnikov kernel()
    is defined but unused, so contributions are unweighted) and counts M.

    Args:
      q_p: [N, 3] query points; radius2: [N]; q_ns: [N, 3] shading normals;
      q_wo: [N, 3] outgoing dirs (unused by Lambert but kept for parity);
      q_kd_over_pi: [N, 3] the Lambert BSDF value f = kd/π at each query.
      max_per_cell: static per-cell scan budget (masked; exact as long as no
        cell holds more photons — checked by tests / the overflow counter).

    Returns (L [N, 3], M [N] photon counts).
    """
    n = q_p.shape[0]
    p_total = grid.p.shape[0]
    cell_q = jnp.floor(q_p / grid.cell_size).astype(jnp.int32)

    acc = jnp.zeros((n, 3), jnp.float32)
    m = jnp.zeros((n,), jnp.int32)

    for off in itertools.product((-1, 0, 1), repeat=3):
        c = cell_q + jnp.asarray(off, jnp.int32)
        k = _hash_cells(c)
        lo = jnp.searchsorted(grid.key, k, side="left")
        hi = jnp.searchsorted(grid.key, k, side="right")

        def body(j, carry):
            acc, m = carry
            idx = jnp.clip(lo + j, 0, p_total - 1)
            in_span = (lo + j) < hi
            same_cell = jnp.all(grid.cell[idx] == c, axis=-1)
            d2 = vec.distance_squared(grid.p[idx], q_p)
            ok = in_span & same_cell & (d2 < radius2)
            contrib = (
                vec.absdot(q_ns, grid.wi[idx])[:, None]
                * q_kd_over_pi
                * grid.alpha[idx]
            )
            acc = acc + jnp.where(ok[:, None], contrib, 0.0)
            m = m + ok.astype(jnp.int32)
            return acc, m

        acc, m = jax.lax.fori_loop(0, max_per_cell, body, (acc, m))
    return acc, m


@partial(jax.jit, static_argnames=("chunk",))
def gather_radius_dense(
    photons: PhotonMap,
    q_p: Array,
    radius2: Array,
    q_ns: Array,
    q_kd_over_pi: Array,
    chunk: int = 2048,
) -> tuple[Array, Array]:
    """EXACT all-pairs radius search, streamed over photon chunks with
    lax.scan so the [N, chunk] transient stays bounded. Same contract as
    gather_radius, but with no per-cell budget — the correctness oracle for
    both the hash-grid path (which truncates at max_per_cell) and the
    row-span gather, and the gather used when config.exact_gather is set.

    Differentiable in alpha/kd (the weight matmul is linear in both)."""
    n = q_p.shape[0]
    p_total = photons.p.shape[0]
    chunk = min(chunk, p_total)
    pad = -p_total % chunk
    pad_to = lambda x: jnp.concatenate(
        [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]
    ) if pad else x
    n_chunks = (p_total + pad) // chunk
    resh = lambda x: pad_to(x).reshape(n_chunks, chunk, *x.shape[1:])
    pp, pa, pw = resh(photons.p), resh(photons.alpha), resh(photons.wi)
    pv = resh(photons.valid)

    def body(carry, xs):
        acc, m = carry
        cp, ca, cw, cv = xs
        d2 = jnp.sum((q_p[:, None, :] - cp[None, :, :]) ** 2, axis=-1)
        ok = (d2 < radius2[:, None]) & cv[None, :]
        w = vec.absdot(q_ns[:, None, :], cw[None, :, :])  # [N, chunk]
        wm = jnp.where(ok, w, 0.0)
        # full f32: a GPU dot may otherwise run in TF32
        acc = acc + jnp.matmul(wm, ca, precision=jax.lax.Precision.HIGHEST)
        m = m + jnp.sum(ok, axis=1, dtype=jnp.int32)
        return (acc, m), None

    (acc, m), _ = jax.lax.scan(
        body,
        (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n,), jnp.int32)),
        (pp, pa, pw, pv),
    )
    return q_kd_over_pi * acc, m


# ---------------------------------------------------------------------------
# Morton (z-order) keys — the row-span gather (ops/rowspan_gather.py) sorts
# its queries by them, so consecutive queries, and hence each query tile, are
# spatially coherent. Unlike the Teschner hash above, Morton codes are
# injective over the clipped 1024³ cell box.
# ---------------------------------------------------------------------------

def _expand_bits10(v: Array) -> Array:
    """Spread the low 10 bits of uint32 v so consecutive bits land 3 apart."""
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def morton3(cell: Array) -> Array:
    """[..., 3] int32 cell coords in [0, 1024) → uint32 z-order key < 2^30."""
    c = cell.astype(jnp.uint32)
    return (
        (_expand_bits10(c[..., 0]) << 2)
        | (_expand_bits10(c[..., 1]) << 1)
        | _expand_bits10(c[..., 2])
    )


def max_cell_occupancy(grid: PhotonGrid) -> Array:
    """Largest per-key run in the sorted grid — if this exceeds the gather's
    max_per_cell budget, gathering truncates (observability hook; the
    reference's analogue is its per-pass valid-photon Info log,
    photonmappingrenderer.cpp:164)."""
    key = grid.key
    sentinel = jnp.uint32(0xFFFFFFFF)
    valid = key != sentinel
    same = (key[1:] == key[:-1]) & valid[1:]

    def body(carry, xs):
        run, best = carry
        s, v = xs
        run = jnp.where(s, run + 1, jnp.where(v, 1, 0))
        return (run, jnp.maximum(best, run)), None

    init_run = jnp.where(valid[0], jnp.int32(1), jnp.int32(0))
    (_, best), _ = jax.lax.scan(
        body, (init_run, init_run), (same, valid[1:])
    )
    return best
