"""BVH build + traversal vs the brute-force intersection path.

The BVH must be a pure accelerator: closest-hit t/attributes and any-hit
results identical (up to f32 tie-breaking) to the dense scan it replaces
(SURVEY.md §7 hard part 1 — 'performance is the risk, not correctness')."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytrace_tpu.ops import bvh as bvh_ops
from raytrace_tpu.ops import intersect as ii
from raytrace_tpu.scene import presets, transform as tr
from raytrace_tpu.scene.builder import SceneBuilder


def random_soup_scene(n_tris=800, seed=3, use_bvh=True):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (n_tris, 3))
    offs = rng.normal(size=(n_tris, 3, 3)) * 0.35
    verts = (centers[:, None, :] + offs).reshape(-1, 3)
    idx = np.arange(3 * n_tris).reshape(-1, 3)
    b = SceneBuilder()
    m = b.matte((0.5, 0.5, 0.5))
    b.triangle_mesh(verts, idx, material=m)
    b.point_light((0, 0, 10), (100.0, 100.0, 100.0))
    return b.build(use_bvh=use_bvh)


def random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_build_invariants():
    scene = random_soup_scene(n_tris=500)
    bvh = scene.bvh
    assert bvh is not None
    count = np.asarray(bvh.count)
    first = np.asarray(bvh.first)
    right = np.asarray(bvh.right)
    leaves = count > 0
    # every leaf within bounds and ≤ leaf_size
    assert count.max() <= bvh.leaf_size
    assert (first[leaves] + count[leaves] <= scene.tris.count).all()
    # leaves tile the primitive range exactly once
    covered = np.zeros(scene.tris.count, bool)
    for f, c in zip(first[leaves], count[leaves]):
        assert not covered[f:f + c].any()
        covered[f:f + c] = True
    assert covered.all()
    # interior right children point forward (DFS layout)
    interior = ~leaves
    assert (right[interior] > np.nonzero(interior)[0]).all()
    # node AABBs contain their leaf triangles
    bmin = np.asarray(bvh.bmin)
    bmax = np.asarray(bvh.bmax)
    v0 = np.asarray(scene.tris.v0)
    for ni in np.nonzero(leaves)[0][:50]:
        f, c = first[ni], count[ni]
        assert (v0[f:f + c] >= bmin[ni] - 1e-4).all()
        assert (v0[f:f + c] <= bmax[ni] + 1e-4).all()


def test_bvh_matches_brute_force_closest_hit():
    scene_b = random_soup_scene(use_bvh=True)
    scene_f = random_soup_scene(use_bvh=False)
    o, d = random_rays(512, seed=11)
    tmin = jnp.full((512,), 1e-3)
    tmax = jnp.full((512,), 1e30)
    t_b, _, _, _ = bvh_ops.intersect_triangles_bvh(
        scene_b.bvh, scene_b.tris, o, d, tmin, tmax
    )
    t_f, _, _, _ = ii.intersect_triangles(scene_f, o, d, tmin, tmax)
    np.testing.assert_allclose(np.asarray(t_b), np.asarray(t_f), rtol=1e-4)

    # full Intersection records agree (attributes computed from same winner)
    hit_b = ii.intersect(scene_b, o, d, tmin, tmax)
    hit_f = ii.intersect(scene_f, o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(hit_b.valid), np.asarray(hit_f.valid))
    v = np.asarray(hit_b.valid)
    np.testing.assert_allclose(
        np.asarray(hit_b.p)[v], np.asarray(hit_f.p)[v], atol=1e-3
    )
    # normals match up to triangle-tie direction
    dots = np.abs(np.sum(np.asarray(hit_b.ns)[v] * np.asarray(hit_f.ns)[v], -1))
    assert (dots > 1.0 - 1e-3).all()


def test_bvh_matches_brute_force_any_hit():
    scene_b = random_soup_scene(use_bvh=True, seed=5)
    scene_f = random_soup_scene(use_bvh=False, seed=5)
    o, d = random_rays(512, seed=13)
    tmin = jnp.full((512,), 1e-3)
    tmax = jnp.full((512,), 4.0)
    occ_b = np.asarray(ii.occluded(scene_b, o, d, tmin, tmax))
    occ_f = np.asarray(ii.occluded(scene_f, o, d, tmin, tmax))
    np.testing.assert_array_equal(occ_b, occ_f)


def test_auto_bvh_threshold():
    b = SceneBuilder()
    v, i = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]]), np.array([[0, 1, 2]])
    b.triangle_mesh(v, i)
    assert b.build().bvh is None  # tiny scene stays brute-force
    scene = presets.triangle_field(n_triangles=2048, size=16)[0]
    assert scene.bvh is not None  # big scene gets the tree automatically


def test_native_sah_builder_matches_numpy_builder():
    """The C++ binned-SAH builder and the numpy median-split builder may
    produce different trees, but traversal through either must return the
    same closest hits."""
    bvh_native = pytest.importorskip("raytrace_tpu.ops.bvh_native")
    rng = np.random.default_rng(21)
    c = rng.uniform(-4, 4, (1500, 3))
    off = rng.normal(size=(1500, 3, 3)) * 0.3
    v = (c[:, None, :] + off).astype(np.float32)

    from raytrace_tpu.core import struct

    @struct.dataclass
    class MiniTris:
        v0: jnp.ndarray
        v1: jnp.ndarray
        v2: jnp.ndarray

    o, d = random_rays(256, seed=17)
    tmin = jnp.full((256,), 1e-3)
    tmax = jnp.full((256,), 1e30)

    results = []
    for build in (bvh_ops.build_bvh, bvh_native.build_bvh_sah):
        arrays, perm = build(v[:, 0], v[:, 1], v[:, 2], leaf_size=4)
        assert sorted(perm.tolist()) == list(range(1500))
        assert arrays["count"].max() <= 4
        tris = MiniTris(
            v0=jnp.asarray(v[perm, 0]),
            v1=jnp.asarray(v[perm, 1]),
            v2=jnp.asarray(v[perm, 2]),
        )
        t, _, _, _ = bvh_ops.intersect_triangles_bvh(
            bvh_ops.bvh_from_arrays(arrays), tris, o, d, tmin, tmax
        )
        results.append(np.asarray(t))
    np.testing.assert_allclose(results[0], results[1], rtol=1e-5)


def test_bvh_render_matches_brute_force():
    """End-to-end: the simple renderer produces the same image through the
    BVH as through the dense scan."""
    from raytrace_tpu.core.config import RenderConfig
    from raytrace_tpu.renderers.simple import render_simple

    def mesh_scene(use_bvh):
        b = SceneBuilder()
        m = b.matte((0.7, 0.6, 0.5))
        rng = np.random.default_rng(0)
        g = 24
        xs = np.linspace(-3, 3, g + 1)
        gx, gy = np.meshgrid(xs, xs, indexing="ij")
        gz = 0.3 * np.sin(gx) * np.cos(gy)
        verts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
        vid = np.arange((g + 1) ** 2).reshape(g + 1, g + 1)
        a, b_, c, dd = (vid[:-1, :-1].ravel(), vid[1:, :-1].ravel(),
                        vid[1:, 1:].ravel(), vid[:-1, 1:].ravel())
        idx = np.concatenate([np.stack([a, b_, c], -1), np.stack([a, c, dd], -1)])
        b.triangle_mesh(verts, idx, material=m)
        b.point_light((0, 0, 6), (80.0, 80.0, 80.0))
        c2w = tr.look_at((0, -5, 4), (0, 0, 0), (0, 0, 1))
        from raytrace_tpu.scene.camera import PerspectiveCamera
        cam = PerspectiveCamera.make(c2w, 50.0, 32, 32)
        return b.build(use_bvh=use_bvh), cam

    cfg = RenderConfig(width=32, height=32, spp=1, scene_epsilon=1e-3)
    key = jax.random.PRNGKey(0)
    scene_b, cam = mesh_scene(True)
    scene_f, _ = mesh_scene(False)
    img_b = np.asarray(render_simple(scene_b, cam, cfg, key, jitter=False))
    img_f = np.asarray(render_simple(scene_f, cam, cfg, key, jitter=False))
    np.testing.assert_allclose(img_b, img_f, atol=1e-4)
