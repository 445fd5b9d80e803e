"""Flattened BVH over the triangle soup + wavefront traversal.

The reference delegates acceleration to OptiX's opaque "Sbvh"/"Bvh" builders
(cudarender.cpp:44-50) and traverses inside rtTrace. This design builds the BVH on the host (median-split on the numpy path; binned SAH via the
C++ builder in csrc/ when available) into a pbrt-style depth-first flat array
(left child = node+1, explicit right-child index), reorders the triangle
arrays so every leaf covers a contiguous primitive range, and traverses it as
a masked wavefront: every ray in the batch carries a short explicit stack (the
same shape as the reference's gather-pass kd traversal stack, gathering.cu:9)
and the whole batch steps through `lax.while_loop` together — node AABB tests
and leaf triangle tests are dense vector ops over the ray batch.

Traversal is intersection bookkeeping and runs under stop_gradient; the
winning primitive is re-intersected outside the loop with plain jnp ops so
reverse-mode AD sees exactly the same differentiable surface as the
brute-force path (SURVEY.md §7: hit-finding in stop_gradient).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from raytrace_tpu.core import struct

BIG = 1e30


@struct.dataclass
class FlatBVH:
    """pbrt-style flattened BVH (LinearBVHNode layout): depth-first order,
    left child at node+1, right child explicit — augmented with skip links
    ("ropes") so traversal needs NO per-ray stack: on a missed/finished
    subtree the ray jumps straight to `skip[node]` (the next node in DFS
    order outside the subtree). Stackless traversal keeps the wavefront
    loop free of scatters — a per-ray stack costs two scatter updates per
    iteration over a [rays, depth] array.

    `packed` carries the whole per-node record as one [Nn, 8] f32 row
    (bmin, bmax, bitcast skip, bitcast first|count<<28) so each traversal
    step issues a single gather instead of five."""
    bmin: Array  # [Nn, 3]
    bmax: Array  # [Nn, 3]
    right: Array  # [Nn] int32 right-child node index (interior nodes)
    first: Array  # [Nn] int32 first primitive (leaf nodes; prims contiguous)
    count: Array  # [Nn] int32 primitive count (0 = interior)
    axis: Array  # [Nn] int32 split axis (interior nodes)
    skip: Array  # [Nn] int32 DFS skip link (== Nn for "done")
    packed: Array  # [Nn, 8] f32 fused node record (see above)
    # static metadata (not traced): sizes the traversal stack / leaf loop
    max_depth: int = struct.field(pytree_node=False, default=32)
    leaf_size: int = struct.field(pytree_node=False, default=4)


def compute_skip_links(right: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Skip link per node: the next node in DFS pre-order NOT in the node's
    subtree (n_nodes for the last). Derivable in one forward pass because
    the layout is pre-order: when an interior node is visited its own skip
    is already known, and it hands skip[left]=right-child,
    skip[right]=its own skip."""
    n = right.shape[0]
    skip = np.empty(n, np.int32)
    skip[0] = n
    interior = count == 0
    for i in range(n):
        if interior[i]:
            skip[i + 1] = right[i]
            skip[right[i]] = skip[i]
    return skip


def _pack_nodes(bmin, bmax, skip, first, count) -> np.ndarray:
    packed = np.empty((bmin.shape[0], 8), np.float32)
    packed[:, 0:3] = bmin
    packed[:, 3:6] = bmax
    packed[:, 6] = skip.astype(np.int32).view(np.float32)
    fc = first.astype(np.uint32) | (count.astype(np.uint32) << 28)
    packed[:, 7] = fc.view(np.float32)
    return packed


def build_bvh(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = 4
) -> tuple[dict, np.ndarray]:
    """Median-split BVH build on the host (numpy reference builder).

    Splits at the centroid median along the largest-extent axis, forcing a
    half split when centroids are degenerate, so leaves never exceed
    `leaf_size`. Returns (flat node arrays, primitive permutation). The C++
    binned-SAH builder (csrc/bvh_builder.cc) emits the same layout.
    """
    T = v0.shape[0]
    bbmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    bbmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    cent = (0.5 * (bbmin + bbmax)).astype(np.float64)

    n_bmin, n_bmax = [], []
    n_right, n_first, n_count, n_axis = [], [], [], []
    perm: list[np.ndarray] = []
    perm_n = 0
    max_depth = 0

    # iterative DFS with explicit frames so deep trees never hit the Python
    # recursion limit; 'post' frames patch the right-child index once the
    # left subtree has been emitted
    stack: list[tuple] = [("build", np.arange(T, dtype=np.int64), 1)]
    while stack:
        frame = stack.pop()
        if frame[0] == "patch":
            n_right[frame[1]] = len(n_bmin)
            continue
        _, idx, depth = frame
        max_depth = max(max_depth, depth)
        node_id = len(n_bmin)
        n_bmin.append(bbmin[idx].min(axis=0))
        n_bmax.append(bbmax[idx].max(axis=0))
        if len(idx) <= leaf_size:
            n_right.append(0)
            n_first.append(perm_n)
            n_count.append(len(idx))
            n_axis.append(0)
            perm.append(idx)
            perm_n += len(idx)
            continue
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        mid = len(idx) // 2
        left, right = idx[order[:mid]], idx[order[mid:]]
        n_right.append(-1)  # patched after the left subtree is emitted
        n_first.append(0)
        n_count.append(0)
        n_axis.append(axis)
        # DFS pre-order: left subtree next, then patch, then right subtree
        stack.append(("build", right, depth + 1))
        stack.append(("patch", node_id))
        stack.append(("build", left, depth + 1))

    arrays = dict(
        bmin=np.asarray(n_bmin, np.float32),
        bmax=np.asarray(n_bmax, np.float32),
        right=np.asarray(n_right, np.int32),
        first=np.asarray(n_first, np.int32),
        count=np.asarray(n_count, np.int32),
        axis=np.asarray(n_axis, np.int32),
        max_depth=int(max_depth),
        leaf_size=int(leaf_size),
    )
    return arrays, np.concatenate(perm) if perm else np.arange(0, dtype=np.int64)


def build_bvh_native(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = 4
) -> tuple[dict, np.ndarray]:
    """Build via the C++ binned-SAH builder (csrc/bvh_builder.cc) when the
    shared library is available — the host-side native runtime piece playing
    the reference's CPU acceleration-structure build (the reference builds
    its photon kd-tree on the CPU too, photonmappingrenderer.cpp:141-180) —
    falling back to the numpy median-split builder otherwise."""
    try:
        from raytrace_tpu.ops import bvh_native

        return bvh_native.build_bvh_sah(v0, v1, v2, leaf_size=leaf_size)
    except (ImportError, OSError):
        return build_bvh(v0, v1, v2, leaf_size=leaf_size)


def bvh_from_arrays(arrays: dict) -> FlatBVH:
    right = np.asarray(arrays["right"], np.int32)
    count = np.asarray(arrays["count"], np.int32)
    first = np.asarray(arrays["first"], np.int32)
    bmin = np.asarray(arrays["bmin"], np.float32)
    bmax = np.asarray(arrays["bmax"], np.float32)
    skip = compute_skip_links(right, count)
    return FlatBVH(
        bmin=jnp.asarray(bmin),
        bmax=jnp.asarray(bmax),
        right=jnp.asarray(right),
        first=jnp.asarray(first),
        count=jnp.asarray(count),
        axis=jnp.asarray(arrays["axis"]),
        skip=jnp.asarray(skip),
        packed=jnp.asarray(_pack_nodes(bmin, bmax, skip, first, count)),
        max_depth=int(arrays["max_depth"]),
        leaf_size=int(arrays["leaf_size"]),
    )


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def _tri_hit_leaf(o, d, v0, v1, v2, tmin, tlimit):
    """Rays [N,3] vs their own leaf triangles [N,L,3] (Möller–Trumbore, same
    math as ops/intersect._tri_hit_batch but ray-aligned)."""
    e1 = v1 - v0
    e2 = v2 - v0
    dN = d[:, None, :]
    pvec = jnp.cross(dN, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(det != 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0)
    tvec = o[:, None, :] - v0
    beta = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    gamma = jnp.sum(dN * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = (
        (det != 0.0)
        & (beta >= 0.0)
        & (gamma >= 0.0)
        & (beta + gamma <= 1.0)
        & (t > tmin[:, None])
        & (t < tlimit[:, None])
    )
    return jnp.where(ok, t, BIG)


# rays are traversed in chunks so finished chunks retire early instead of
# running lockstep with the globally slowest ray (lax.map serializes chunks,
# each with its own while_loop trip count)
TRAVERSE_CHUNK = 1 << 15


def _traverse(bvh: FlatBVH, tris, o, d, tmin, tmax, any_hit: bool):
    """Stackless wavefront traversal over the skip-linked BVH →
    (best_t [N], best_idx [N], trips [chunks]): trips counts the while-loop
    iterations of each TRAVERSE_CHUNK-ray chunk (the slowest ray's node
    visits — each iteration is one device round trip of the loop).

    Every ray walks the DFS order: descend (node+1) when the box is hit and
    the node is interior, otherwise jump the rope (skip[node]); a ray
    retires when its node index reaches n_nodes. One gather of the packed
    node record + one leaf-triangle gather per step, no scatters — the
    previous per-ray-stack version spent its time on two [rays, depth]
    scatter updates per step.

    All inputs pass through stop_gradient; gradients are restored by
    re-intersecting the winner (intersect_triangles_bvh).
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    tmin = jax.lax.stop_gradient(tmin)
    tmax = jax.lax.stop_gradient(tmax)
    tris = jax.lax.stop_gradient(tris)

    n = o.shape[0]
    # triangle vertices fused to one [T, 9] row → a single leaf gather
    tv = jnp.concatenate([tris.v0, tris.v1, tris.v2], axis=-1)

    def run(args):
        return _traverse_chunk(bvh, tv, *args, any_hit=any_hit)

    if n > TRAVERSE_CHUNK and n % TRAVERSE_CHUNK == 0:
        c = TRAVERSE_CHUNK
        resh = lambda x: x.reshape(n // c, c, *x.shape[1:])
        best_t, best_i, trips = jax.lax.map(
            run, (resh(o), resh(d), resh(tmin), resh(tmax))
        )
        return best_t.reshape(n), best_i.reshape(n), trips
    best_t, best_i, trips = run((o, d, tmin, tmax))
    return best_t, best_i, trips[None]


def _traverse_chunk(bvh: FlatBVH, tv, o, d, tmin, tmax, *, any_hit: bool):
    n = o.shape[0]
    L = bvh.leaf_size
    n_nodes = bvh.packed.shape[0]
    rows = jnp.arange(n)
    leaf_lane = jnp.arange(L, dtype=jnp.int32)
    inv_d = 1.0 / jnp.where(d == 0.0, 1e-30, d)

    node = jnp.zeros((n,), jnp.int32)
    best_t = jnp.minimum(jnp.full((n,), BIG, jnp.float32), tmax)
    best_i = jnp.zeros((n,), jnp.int32)

    def cond(state):
        node, *_ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_t, best_i, trips = state
        active = node < n_nodes
        nd = jnp.minimum(node, n_nodes - 1)
        rec = bvh.packed[nd]  # [N, 8] — ONE gather for the whole node
        bmin = rec[:, 0:3]
        bmax = rec[:, 3:6]
        skip = jax.lax.bitcast_convert_type(rec[:, 6], jnp.int32)
        fc = jax.lax.bitcast_convert_type(rec[:, 7], jnp.uint32)
        first = (fc & jnp.uint32((1 << 28) - 1)).astype(jnp.int32)
        cnt = (fc >> 28).astype(jnp.int32)

        t0 = (bmin - o) * inv_d
        t1 = (bmax - o) * inv_d
        tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = active & (tnear <= tfar) & (tfar > tmin) & (tnear < best_t)

        is_leaf = cnt > 0
        do_leaf = box_hit & is_leaf

        # --- leaf: test up to L contiguous primitives (one fused gather) ----
        pidx = first[:, None] + leaf_lane[None, :]  # [N, L]
        pidx = jnp.clip(pidx, 0, tv.shape[0] - 1)
        tri = tv[pidx]  # [N, L, 9]
        t = _tri_hit_leaf(
            o, d, tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], tmin, best_t
        )
        lane_ok = leaf_lane[None, :] < cnt[:, None]
        t = jnp.where(lane_ok & do_leaf[:, None], t, BIG)
        j = jnp.argmin(t, axis=1)
        tj = t[rows, j]
        better = tj < best_t
        best_i = jnp.where(better, pidx[rows, j], best_i)
        best_t = jnp.where(better, tj, best_t)

        # --- advance: descend or jump the rope ------------------------------
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, nd + 1, skip)
        node = jnp.where(active, nxt, node)
        if any_hit:
            # shadow rays stop at the first hit (reference shadow_any_hit
            # terminates the ray, raytracing.cu:143-147)
            node = jnp.where(best_t < tmax, n_nodes, node)
        return node, best_t, best_i, trips + 1

    _, best_t, best_i, trips = jax.lax.while_loop(
        cond, body, (node, best_t, best_i, jnp.int32(0))
    )
    return best_t, best_i, trips


def reintersect_winner(tris, idx, o, d, found):
    """Re-intersect the winning primitive with differentiable jnp ops →
    (t, beta, gamma). Traversal/kernels find `idx` under stop_gradient; this
    restores the differentiable surface (SURVEY.md §7: hit-finding in
    stop_gradient, shading smooth given hit points)."""
    v0, v1, v2 = tris.v0[idx], tris.v1[idx], tris.v2[idx]
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(det != 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0)
    tvec = o - v0
    beta = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    gamma = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det

    t = jnp.where(found, t, BIG)
    beta = jnp.where(found, beta, 0.0)
    gamma = jnp.where(found, gamma, 0.0)
    return t, beta, gamma


def intersect_triangles_bvh(bvh: FlatBVH, tris, o, d, tmin, tmax):
    """Closest-hit through the BVH → (t, idx, beta, gamma), same contract as
    ops/intersect.intersect_triangles. The winner is re-intersected with
    differentiable jnp ops so AD matches the brute-force path."""
    best_t, idx, _ = _traverse(bvh, tris, o, d, tmin, tmax, any_hit=False)
    found = best_t < jnp.minimum(BIG, tmax)
    t, beta, gamma = reintersect_winner(tris, idx, o, d, found)
    return t, idx, beta, gamma


def occluded_triangles_bvh(bvh: FlatBVH, tris, o, d, tmin, tmax) -> Array:
    """Any-hit through the BVH (shadow ray type)."""
    best_t, _, _ = _traverse(bvh, tris, o, d, tmin, tmax, any_hit=True)
    return best_t < jnp.minimum(BIG, tmax)
