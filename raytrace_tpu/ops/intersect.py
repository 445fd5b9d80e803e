"""Wavefront ray–scene intersection.

The reference dispatches per-shape OptiX intersection programs through a BVH
(cudatrianglemesh.cu, cudasphere.cu, cudadisk.cu behind Sbvh acceleration,
cudarender.cpp:44-50). Here each shape family is intersected as a
dense batched pass — rays × primitive-chunks streamed through a `lax.scan` so
the transient [rays, chunk] matrices stay small — then combines the per-family
winners and computes hit attributes only for the winning primitive (deferred,
one gather per ray). An optional BVH front-end (ops/bvh.py) culls the
triangle set for large scenes.

Closest-hit and any-hit variants mirror the reference's RayTracing vs Shadow
ray types (photonmapping.h:28).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from raytrace_tpu.core import struct, vec
from raytrace_tpu.scene.scene import Scene

# Python float, NOT jnp.float32: an eager device-array constant captured by
# jit embeds a literal in every graph that closes over it.
BIG = 1e30


@struct.dataclass
class Intersection:
    """Full hit frame (reference attributes aGeometryNormal/aShadingNormal/
    aUv/aDpdu/aDpdv, util/shape/cudashape.cu.h:7-11, plus the bookkeeping the
    renderers need)."""
    valid: Array  # [N] bool
    t: Array  # [N]
    p: Array  # [N, 3]
    ng: Array  # [N, 3] geometric normal (normalized)
    ns: Array  # [N, 3] shading normal (normalized)
    dpdu: Array  # [N, 3] (unnormalized; shading frame normalizes)
    dpdv: Array  # [N, 3]
    uv: Array  # [N, 2]
    mat: Array  # [N] int32
    light: Array  # [N] int32
    # [] int32: intersections dropped by a traversal budget. Every
    # traversal is exact, so it is 0; renderers still sum it into their aux
    # dicts, which callers assert on.
    pair_overflow: Array = None


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _chunk_scan(n_prims: int, chunk: int):
    # never pad a tiny primitive set up to a huge chunk — clamp the chunk to
    # the next power of two above the primitive count
    chunk = min(chunk, _pow2_ceil(n_prims))
    n_chunks = max(1, math.ceil(n_prims / chunk))
    pad = n_chunks * chunk - n_prims
    return chunk, n_chunks, pad


# ---------------------------------------------------------------------------
# Triangles (Möller–Trumbore; reference uses OptiX intersect_triangle,
# cudatrianglemesh.cu:24, same branchless algorithm)
# ---------------------------------------------------------------------------

def _tri_hit_batch(o, d, v0, v1, v2, tmin, tmax):
    """Intersect rays [N,3] against triangles [C,3]: returns t,beta,gamma [N,C]."""
    e1 = v1 - v0  # [C,3]
    e2 = v2 - v0
    # pvec = d × e2 : [N,C,3]
    pvec = vec.cross(d[:, None, :], e2[None, :, :])
    det = vec.dot(e1[None, :, :], pvec)  # [N,C]
    inv_det = jnp.where(det != 0.0, 1.0 / det, 0.0)
    tvec = o[:, None, :] - v0[None, :, :]  # [N,C,3]
    beta = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1[None, :, :])
    gamma = vec.dot(d[:, None, :], qvec) * inv_det
    t = vec.dot(e2[None, :, :], qvec) * inv_det
    ok = (
        (det != 0.0)
        & (beta >= 0.0)
        & (gamma >= 0.0)
        & (beta + gamma <= 1.0)
        & (t > tmin[:, None])
        & (t < tmax[:, None])
    )
    return jnp.where(ok, t, BIG), beta, gamma


def intersect_triangles(scene: Scene, o, d, tmin, tmax, chunk: int = 256):
    """Closest triangle hit: returns (t [N], idx [N], beta [N], gamma [N])."""
    tris = scene.tris
    n_tris = tris.count
    chunk, n_chunks, pad = _chunk_scan(n_tris, chunk)
    padder = lambda x: jnp.concatenate(
        [x, jnp.full((pad,) + x.shape[1:], 1e30, x.dtype)]
    ).reshape(n_chunks, chunk, *x.shape[1:]) if pad else x.reshape(
        n_chunks, chunk, *x.shape[1:]
    )
    v0c, v1c, v2c = padder(tris.v0), padder(tris.v1), padder(tris.v2)
    n = o.shape[0]

    def body(carry, xs):
        best_t, best_i, best_b, best_g = carry
        ci, v0, v1, v2 = xs
        t, beta, gamma = _tri_hit_batch(o, d, v0, v1, v2, tmin, tmax)
        j = jnp.argmin(t, axis=1)  # [N]
        rows = jnp.arange(n)
        tj = t[rows, j]
        better = tj < best_t
        best_i = jnp.where(better, ci * chunk + j, best_i)
        best_b = jnp.where(better, beta[rows, j], best_b)
        best_g = jnp.where(better, gamma[rows, j], best_g)
        best_t = jnp.minimum(best_t, tj)
        return (best_t, best_i, best_b, best_g), None

    init = (
        jnp.full((n,), BIG),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,)),
        jnp.zeros((n,)),
    )
    (t, i, b, g), _ = jax.lax.scan(
        body, init, (jnp.arange(n_chunks, dtype=jnp.int32), v0c, v1c, v2c)
    )
    return t, i, b, g


def triangle_attributes(scene: Scene, idx, beta, gamma, o, d, t):
    """Hit frame for winning triangles (reference: cudatrianglemesh.cu:26-77)."""
    tris = scene.tris
    g = lambda a: a[idx]
    v0, v1, v2 = g(tris.v0), g(tris.v1), g(tris.v2)
    uv0, uv1, uv2 = g(tris.uv0), g(tris.uv1), g(tris.uv2)
    ngu = vec.cross(v1 - v0, v2 - v0)
    ng = vec.normalize(ngu)

    du1 = uv0[:, 0] - uv2[:, 0]
    du2 = uv1[:, 0] - uv2[:, 0]
    dv1 = uv0[:, 1] - uv2[:, 1]
    dv2 = uv1[:, 1] - uv2[:, 1]
    dp1 = v0 - v2
    dp2 = v1 - v2
    det = du1 * dv2 - dv1 * du2
    inv_det = jnp.where(det != 0.0, 1.0 / det, 0.0)[:, None]
    dpdu = (dv2[:, None] * dp1 - dv1[:, None] * dp2) * inv_det
    dpdv = (-du2[:, None] * dp1 + du1[:, None] * dp2) * inv_det
    # degenerate-UV fallback (reference: cudatrianglemesh.cu:50-60)
    fb_u, fb_v = vec.coordinate_system(ng)
    degen = (det == 0.0)[:, None]
    dpdu = jnp.where(degen, fb_u, dpdu)
    dpdv = jnp.where(degen, fb_v, dpdv)

    b1 = beta[:, None]
    b2 = gamma[:, None]
    b0 = 1.0 - b1 - b2
    uv = b0 * uv0 + b1 * uv1 + b2 * uv2
    ns_interp = vec.normalize(b1 * g(tris.n1) + b2 * g(tris.n2) + b0 * g(tris.n0))
    ns = jnp.where(g(tris.has_normals)[:, None], ns_interp, ng)
    p = o + d * t[:, None]
    return p, ng, ns, dpdu, dpdv, uv, g(tris.mat), g(tris.light)


# ---------------------------------------------------------------------------
# Spheres (object-space quadratic; reference: cudasphere.cu:7-72)
# ---------------------------------------------------------------------------

def _sphere_hit_batch(o, d, w2o, radius, tmin, tmax):
    """Rays [N,3] vs spheres [C]: closest valid t [N,C]."""
    # object-space ray per sphere: [N,C,3]
    oo = vec.transform_point(w2o[None], o[:, None, :])
    od = vec.transform_vector(w2o[None], d[:, None, :])
    a = vec.dot(od, od)  # [N,C]
    b = 2.0 * vec.dot(od, oo)
    c = vec.dot(oo, oo) - (radius * radius)[None, :]
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (radius > 0.0)[None, :]  # radius 0 = padding
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    safe = lambda x, y: jnp.where(y != 0.0, x / jnp.where(y == 0.0, 1.0, y), BIG)
    t0 = safe(q, a)
    t1 = safe(c, q)
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    in_range = lambda t: ok & (t > tmin[:, None]) & (t < tmax[:, None])
    t = jnp.where(in_range(tlo), tlo, jnp.where(in_range(thi), thi, BIG))
    return t


def _sphere_hit_one(o, d, w2o_c, radius_c, tmin, tmax):
    """One sphere vs rays [N,3] on flat [N]/[N,3] arrays only (scenes with
    few spheres unroll over them instead of building [N,C,3] batches)."""
    oo = vec.transform_point(w2o_c, o)
    od = vec.transform_vector(w2o_c, d)
    a = jnp.sum(od * od, axis=-1)
    b = 2.0 * jnp.sum(od * oo, axis=-1)
    c = jnp.sum(oo * oo, axis=-1) - radius_c * radius_c
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (radius_c > 0.0)
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    safe = lambda x, y: jnp.where(y != 0.0, x / jnp.where(y == 0.0, 1.0, y), BIG)
    t0 = safe(q, a)
    t1 = safe(c, q)
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    in_range = lambda t: ok & (t > tmin) & (t < tmax)
    return jnp.where(in_range(tlo), tlo, jnp.where(in_range(thi), thi, BIG))


def intersect_spheres(scene: Scene, o, d, tmin, tmax, chunk: int = 64):
    sph = scene.spheres
    n_s = sph.count
    if n_s <= 8:
        best_t = jnp.full((o.shape[0],), BIG)
        best_i = jnp.zeros((o.shape[0],), jnp.int32)
        for c in range(n_s):
            t = _sphere_hit_one(o, d, sph.w2o[c], sph.radius[c], tmin, tmax)
            better = t < best_t
            best_i = jnp.where(better, c, best_i)
            best_t = jnp.minimum(best_t, t)
        return best_t, best_i
    chunk, n_chunks, pad = _chunk_scan(n_s, chunk)
    def padder(x, fill):
        if pad:
            x = jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)])
        return x.reshape(n_chunks, chunk, *x.shape[1:])
    w2o = padder(sph.w2o, 0.0)
    radius = padder(sph.radius, 0.0)
    n = o.shape[0]

    def body(carry, xs):
        best_t, best_i = carry
        ci, w2o_c, r_c = xs
        t = _sphere_hit_batch(o, d, w2o_c, r_c, tmin, tmax)
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(n)
        tj = t[rows, j]
        better = tj < best_t
        best_i = jnp.where(better, ci * chunk + j, best_i)
        best_t = jnp.minimum(best_t, tj)
        return (best_t, best_i), None

    init = (jnp.full((n,), BIG), jnp.zeros((n,), jnp.int32))
    (t, i), _ = jax.lax.scan(
        body, init, (jnp.arange(n_chunks, dtype=jnp.int32), w2o, radius)
    )
    return t, i


def sphere_attributes(scene: Scene, idx, o, d, t):
    """Hit frame for winning spheres (reference: cudasphere.cu:33-72 for the
    object-space frame; normals/dpdu transformed back to world like OptiX's
    rtTransformNormal in raytracing.cu:109-117)."""
    sph = scene.spheres
    w2o = sph.w2o[idx]
    o2w = sph.o2w[idx]
    radius = sph.radius[idx]
    oo = vec.transform_point(w2o, o)
    od = vec.transform_vector(w2o, d)
    phit = oo + od * t[:, None]
    # avoid the pole singularity exactly like the reference (cudasphere.cu:36)
    degen = (phit[:, 0] == 0.0) & (phit[:, 1] == 0.0)
    phit = phit.at[:, 0].set(jnp.where(degen, 1e-5 * radius, phit[:, 0]))
    phi = jnp.arctan2(phit[:, 1], phit[:, 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    u = phi / (2.0 * math.pi)
    theta = jnp.arccos(jnp.clip(phit[:, 2] / jnp.maximum(radius, 1e-20), -1.0, 1.0))
    v = theta / math.pi
    n_obj = phit / jnp.maximum(radius, 1e-20)[:, None]
    dpdu_obj = jnp.stack(
        [-n_obj[:, 1], n_obj[:, 0], jnp.zeros_like(u)], axis=-1
    )
    dpdv_obj = vec.cross(n_obj, dpdu_obj)
    # normals transform by inverse-transpose (w2o is the inverse of o2w)
    ng = vec.normalize(vec.transform_normal(w2o, n_obj))
    if sph.flip is not None:
        # pbrt ReverseOrientation: normals flip, partials don't
        ng = jnp.where(sph.flip[idx][:, None], -ng, ng)
    dpdu = vec.transform_vector(o2w, dpdu_obj)
    dpdv = vec.transform_vector(o2w, dpdv_obj)
    p = o + d * t[:, None]
    uv = jnp.stack([u, v], axis=-1)
    return p, ng, ng, dpdu, dpdv, uv, sph.mat[idx], sph.light[idx]


# ---------------------------------------------------------------------------
# Disks (world-frame plane test; reference: cudadisk.cu:18-50)
# ---------------------------------------------------------------------------

def _disk_hit_batch(scene_disks, o, d, tmin, tmax):
    dk = scene_disks
    # thit = (moffset - z·o) / (z·d) : [N,D]
    zdotd = vec.dot(d[:, None, :], dk.z[None, :, :])
    zdoto = vec.dot(o[:, None, :], dk.z[None, :, :])
    thit = (dk.moffset[None, :] - zdoto) / jnp.where(zdotd == 0.0, 1e-20, zdotd)
    phit = o[:, None, :] + thit[..., None] * d[:, None, :]  # [N,D,3]
    local = phit - dk.o[None, :, :]
    lx = vec.dot(local, dk.x[None, :, :]) * dk.inv_r2[None, :, 0]
    ly = vec.dot(local, dk.y[None, :, :]) * dk.inv_r2[None, :, 1]
    dist2 = lx * lx + ly * ly
    phi = jnp.arctan2(ly, lx)
    phi = jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    inner = dk.inner_radius[None, :]
    ok = (
        (thit > tmin[:, None])
        & (thit < tmax[:, None])
        & (dist2 <= 1.0)
        & (dist2 >= inner * inner)
        & (phi <= dk.phi_max[None, :])
    )
    return jnp.where(ok, thit, BIG), lx, ly, dist2, phi


def _disk_hit_one(dk, c, o, d, tmin, tmax):
    """One disk vs rays [N,3] on flat arrays (see _sphere_hit_one)."""
    zdotd = vec.dot(d, dk.z[c])
    zdoto = vec.dot(o, dk.z[c])
    thit = (dk.moffset[c] - zdoto) / jnp.where(zdotd == 0.0, 1e-20, zdotd)
    phit = o + thit[:, None] * d
    local = phit - dk.o[c]
    lx = vec.dot(local, dk.x[c]) * dk.inv_r2[c, 0]
    ly = vec.dot(local, dk.y[c]) * dk.inv_r2[c, 1]
    dist2 = lx * lx + ly * ly
    phi = jnp.arctan2(ly, lx)
    phi = jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    inner = dk.inner_radius[c]
    ok = (
        (thit > tmin)
        & (thit < tmax)
        & (dist2 <= 1.0)
        & (dist2 >= inner * inner)
        & (phi <= dk.phi_max[c])
    )
    return jnp.where(ok, thit, BIG)


def intersect_disks(scene: Scene, o, d, tmin, tmax):
    dk = scene.disks
    if dk.count <= 8:
        best_t = jnp.full((o.shape[0],), BIG)
        best_i = jnp.zeros((o.shape[0],), jnp.int32)
        for c in range(dk.count):
            t = _disk_hit_one(dk, c, o, d, tmin, tmax)
            better = t < best_t
            best_i = jnp.where(better, c, best_i)
            best_t = jnp.minimum(best_t, t)
        return best_t, best_i
    t, _, _, _, _ = _disk_hit_batch(scene.disks, o, d, tmin, tmax)
    i = jnp.argmin(t, axis=1)
    rows = jnp.arange(o.shape[0])
    return t[rows, i], i.astype(jnp.int32)


def disk_attributes(scene: Scene, idx, o, d, t):
    """(reference: cudadisk.cu:33-50)"""
    dk = scene.disks
    g = lambda a: a[idx]
    phit = o + d * t[:, None]
    local = phit - g(dk.o)
    lx = vec.dot(local, g(dk.x)) * g(dk.inv_r2)[:, 0]
    ly = vec.dot(local, g(dk.y)) * g(dk.inv_r2)[:, 1]
    dist2 = lx * lx + ly * ly
    phi = jnp.arctan2(ly, lx)
    phi = jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    inner = g(dk.inner_radius)
    one_minus_v = (jnp.sqrt(jnp.maximum(dist2, 0.0)) - inner) / jnp.maximum(
        1.0 - inner, 1e-20
    )
    uv = jnp.stack([phi / jnp.maximum(g(dk.phi_max), 1e-20), 1.0 - one_minus_v], -1)
    ng = g(dk.z)
    dpdu = -ly[:, None] * g(dk.x) + lx[:, None] * g(dk.y)
    dpdv = -lx[:, None] * g(dk.x) - ly[:, None] * g(dk.y)
    return phit, ng, ng, dpdu, dpdv, uv, g(dk.mat), g(dk.light)


# ---------------------------------------------------------------------------
# Combined closest-hit / any-hit
# ---------------------------------------------------------------------------

def _closest_triangles(scene: Scene, o, d, tmin, tmax, tri_chunk: int):
    """Acceleration dispatch: BVH traversal when the scene carries one,
    the dense jnp scan otherwise. Returns (t, idx, beta, gamma)."""
    if scene.bvh is not None:
        from raytrace_tpu.ops import bvh as bvh_ops

        return bvh_ops.intersect_triangles_bvh(
            scene.bvh, scene.tris, o, d, tmin, tmax
        )
    return intersect_triangles(scene, o, d, tmin, tmax, tri_chunk)


def debug_warn_nonzero(value, message: str):
    """Emit an in-jit warning when a counter is nonzero — used for the
    gather job budget and the hash grid's per-cell budget, whose overflow
    would otherwise only be visible to callers that inspect the returned
    count."""
    jax.lax.cond(
        value > 0,
        lambda v: jax.debug.print(message, v),
        lambda v: None,
        value,
    )


def _occluded_triangles(scene: Scene, o, d, tmin, tmax, tri_chunk: int):
    """Any-hit within (tmin, tmax) → occluded [N] bool."""
    if scene.bvh is not None:
        from raytrace_tpu.ops import bvh as bvh_ops

        return bvh_ops.occluded_triangles_bvh(
            scene.bvh, scene.tris, o, d, tmin, tmax
        )
    t_tri, _, _, _ = intersect_triangles(scene, o, d, tmin, tmax, tri_chunk)
    return t_tri < BIG


@partial(jax.jit, static_argnames=("tri_chunk",))
def intersect(scene: Scene, o, d, tmin, tmax,
              tri_chunk: int = 256) -> Intersection:
    """Closest hit across all shape families.

    EMPTY shape families are skipped at trace time (family counts are
    static shapes): a triangle-only scene — the BASELINE 4M-tri configs —
    pays zero sphere/disk intersection or attribute math, and a
    single-family scene skips the cross-family select entirely."""
    n = o.shape[0]
    ovf = jnp.int32(0)
    cands = []  # (t [N], attrs thunk) per NON-EMPTY family
    if scene.tris.count:
        t_tri, i_tri, beta, gamma = _closest_triangles(
            scene, o, d, tmin, tmax, tri_chunk)
        cands.append((t_tri, lambda: triangle_attributes(
            scene, i_tri, beta, gamma, o, d, t_tri)))
    if scene.spheres.count:
        t_sph, i_sph = intersect_spheres(scene, o, d, tmin, tmax)
        cands.append((t_sph, lambda: sphere_attributes(
            scene, i_sph, o, d, t_sph)))
    if scene.disks.count:
        t_dsk, i_dsk = intersect_disks(scene, o, d, tmin, tmax)
        cands.append((t_dsk, lambda: disk_attributes(
            scene, i_dsk, o, d, t_dsk)))

    if not cands:  # no geometry at all: every ray misses
        z3 = jnp.zeros((n, 3), jnp.float32)
        return Intersection(
            valid=jnp.zeros((n,), bool), t=jnp.full((n,), BIG), p=z3,
            ng=z3, ns=z3, dpdu=z3, dpdv=z3,
            uv=jnp.zeros((n, 2), jnp.float32),
            mat=jnp.full((n,), -1, jnp.int32),
            light=jnp.full((n,), -1, jnp.int32), pair_overflow=ovf,
        )

    if len(cands) == 1:
        t = cands[0][0]
        valid = t < BIG
        attrs = cands[0][1]()
        p, ng, ns, dpdu, dpdv, uv, mat, light = attrs
    else:
        ts = [c[0] for c in cands]
        t = ts[0]
        for tf in ts[1:]:
            t = jnp.minimum(t, tf)
        valid = t < BIG
        attrs = [c[1]() for c in cands]
        # family select as [N]/[N,·] where-chains (first family winning
        # ties, like an argmin over families)
        wins = [tf <= t for tf in ts[:-1]]  # last family is the fallback

        def pick(k):
            out = attrs[-1][k]
            for f in range(len(cands) - 2, -1, -1):
                m = wins[f]
                a = attrs[f][k]
                out = jnp.where(m[:, None] if a.ndim == 2 else m, a, out)
            return out

        p, ng, ns, dpdu, dpdv, uv = (pick(k) for k in range(6))
        mat = pick(6)
        light = pick(7)
    return Intersection(
        valid=valid,
        t=jnp.where(valid, t, BIG),
        p=p,
        ng=ng,
        ns=ns,
        dpdu=dpdu,
        dpdv=dpdv,
        uv=uv,
        mat=jnp.where(valid, mat, -1),
        light=jnp.where(valid, light, -1),
        pair_overflow=ovf,
    )


@partial(jax.jit, static_argnames=("tri_chunk",))
def occluded_aux(scene: Scene, o, d, tmin, tmax,
                 tri_chunk: int = 256) -> tuple[Array, Array]:
    """Any-hit within (tmin, tmax) — the shadow ray type (reference:
    raytracing.cu:143-147 shadow_any_hit) → (occluded, pair_overflow).
    Empty shape families are skipped (static counts)."""
    occ = jnp.zeros((o.shape[0],), bool)
    ovf = jnp.int32(0)
    if scene.tris.count:
        occ = occ | _occluded_triangles(scene, o, d, tmin, tmax, tri_chunk)
    if scene.spheres.count:
        t_sph, _ = intersect_spheres(scene, o, d, tmin, tmax)
        occ = occ | (t_sph < BIG)
    if scene.disks.count:
        t_dsk, _ = intersect_disks(scene, o, d, tmin, tmax)
        occ = occ | (t_dsk < BIG)
    return occ, ovf


def occluded(scene: Scene, o, d, tmin, tmax, tri_chunk: int = 256) -> Array:
    return occluded_aux(scene, o, d, tmin, tmax, tri_chunk)[0]
