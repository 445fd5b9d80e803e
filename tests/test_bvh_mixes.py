"""BVH triangle path through ops/intersect.intersect / occluded against a
numpy all-pairs oracle, over the ray mixes a renderer produces: incoherent
bounce rays, tmin/tmax windows, origins on the geometry, all-miss, coherent
camera-like rays and a mixed bounce population."""
import jax
import numpy as np
import pytest

from raytrace_tpu.ops import intersect as ii
from raytrace_tpu.scene.builder import SceneBuilder

BIG = ii.BIG


def _brute(v0, v1, v2, o, d, tmin, tmax):
    """Closest-hit oracle (numpy, all pairs) → (t, index)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pv = np.cross(d[:, None, :], e2[None, :, :])
    det = np.sum(e1[None] * pv, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(det != 0, 1.0 / np.where(det == 0, 1.0, det), 0.0)
        tv = o[:, None, :] - v0[None, :, :]
        b = np.sum(tv * pv, -1) * inv
        qv = np.cross(tv, e1[None, :, :])
        g = np.sum(d[:, None, :] * qv, -1) * inv
        t = np.sum(e2[None] * qv, -1) * inv
    ok = ((det != 0) & (b >= 0) & (g >= 0) & (b + g <= 1)
          & (t > tmin[:, None]) & (t < tmax[:, None]))
    t = np.where(ok, t, BIG)
    return t.min(1), t.argmin(1)


def _soup_scene(n, rng, spread=4.0, size=0.5):
    c = (rng.random((n, 3)) * 2 - 1) * spread
    tri = c[:, None, :] + (rng.random((n, 3, 3)) - 0.5) * size
    b = SceneBuilder()
    b.triangle_mesh(tri.reshape(-1, 3), np.arange(3 * n).reshape(-1, 3),
                    material=b.matte((0.5, 0.5, 0.5)))
    b.point_light((0, 0, 10), (100.0, 100.0, 100.0))
    return b.build(use_bvh=True)


def _field_scene(n):
    g = int(np.ceil(np.sqrt(n / 2)))
    xs = np.linspace(-5, 5, g + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = 0.5 * np.sin(gx) * np.cos(gy)
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    vid = np.arange((g + 1) ** 2).reshape(g + 1, g + 1)
    a, b_, c, d = (vid[:-1, :-1].ravel(), vid[1:, :-1].ravel(),
                   vid[1:, 1:].ravel(), vid[:-1, 1:].ravel())
    idx = np.concatenate([np.stack([a, b_, c], -1),
                          np.stack([a, c, d], -1)])[:n]
    b = SceneBuilder()
    b.triangle_mesh(verts, idx, material=b.matte((0.5, 0.5, 0.5)))
    b.point_light((0, 0, 9), (90.0, 90.0, 90.0))
    return b.build(use_bvh=True)


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _mix(name):
    """→ (scene, o, d, tmin, tmax) for one ray mix."""
    rng = np.random.default_rng(sorted(_MIXES).index(name))
    return _MIXES[name](rng)


def _incoherent(rng):
    scene = _soup_scene(700, rng)
    o = ((rng.random((300, 3)) * 2 - 1) * 6).astype(np.float32)
    d = _unit(rng.standard_normal((300, 3)))
    return scene, o, d, np.full(300, 1e-3), np.full(300, BIG)


def _windows(rng):
    scene = _soup_scene(400, rng)
    o = ((rng.random((200, 3)) * 2 - 1) * 6).astype(np.float32)
    d = _unit(rng.standard_normal((200, 3)))
    tmin = 0.5 + rng.random(200) * 2
    return scene, o, d, tmin, tmin + rng.random(200) * 6


def _inside(rng):
    scene = _soup_scene(500, rng, spread=2.0, size=1.5)
    t = scene.tris
    pick = rng.integers(0, 500, size=200)
    o = ((np.asarray(t.v0)[pick] + np.asarray(t.v1)[pick]
          + np.asarray(t.v2)[pick]) / 3).astype(np.float32)
    d = _unit(rng.standard_normal((200, 3)))
    return scene, o, d, np.full(200, 1e-3), np.full(200, BIG)


def _all_miss(rng):
    scene = _soup_scene(300, rng)
    o = np.full((64, 3), 50.0, np.float32)
    d = np.tile(np.array([[1.0, 0, 0]], np.float32), (64, 1))
    return scene, o, d, np.full(64, 1e-3), np.full(64, BIG)


def _camera_like(rng):
    scene = _field_scene(4000)
    n = 300
    o = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                  np.full(n, 6.0)], -1).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return scene, o, _unit(d), np.full(n, 1e-3), np.full(n, BIG)


def _bounce_population(rng):
    scene = _soup_scene(1500, rng)
    n = 1024
    o1 = ((rng.random((n // 2, 3)) * 2 - 1) * 6).astype(np.float32)
    d1 = _unit(rng.standard_normal((n // 2, 3)))
    o2 = np.tile(np.array([[0.0, 0, 8.0]], np.float32), (n // 2, 1))
    d2 = rng.standard_normal((n // 2, 3))
    d2[:, 2] = -np.abs(d2[:, 2]) - 0.2
    o = np.concatenate([o1, o2])
    d = np.concatenate([d1, _unit(d2)])
    return scene, o, d, np.full(n, 1e-3), np.full(n, BIG)


_MIXES = {
    "incoherent": _incoherent,
    "tmin_tmax_windows": _windows,
    "origins_inside_geometry": _inside,
    "all_miss": _all_miss,
    "camera_like": _camera_like,
    "bounce_population": _bounce_population,
}


def _oracle(scene, o, d, tmin, tmax):
    t = scene.tris
    return _brute(np.asarray(t.v0), np.asarray(t.v1), np.asarray(t.v2),
                  o, d, tmin, tmax)


@pytest.mark.parametrize("mix", sorted(_MIXES))
def test_bvh_closest_hit_matches_brute_force(mix):
    scene, o, d, tmin, tmax = _mix(mix)
    assert scene.bvh is not None
    tmin, tmax = tmin.astype(np.float32), tmax.astype(np.float32)
    hit = ii.intersect(scene, o, d, tmin, tmax)
    t_ref, i_ref = _oracle(scene, o, d, tmin, tmax)
    found = t_ref < BIG
    np.testing.assert_array_equal(np.asarray(hit.valid), found)
    np.testing.assert_allclose(np.asarray(hit.t)[found], t_ref[found],
                               rtol=2e-5, atol=1e-5)
    assert int(hit.pair_overflow) == 0
    if mix == "all_miss":
        assert not found.any()
    else:
        assert found.any()
    # the winning triangle's own distance reproduces the oracle's
    if found.any():
        _, i_bvh, _, _ = ii._closest_triangles(scene, o, d, tmin, tmax, 256)
        same = np.asarray(i_bvh)[found] == i_ref[found]
        assert same.mean() >= 0.99


@pytest.mark.parametrize("mix", sorted(_MIXES))
def test_bvh_any_hit_matches_brute_force(mix):
    scene, o, d, tmin, tmax = _mix(mix)
    tmin, tmax = tmin.astype(np.float32), tmax.astype(np.float32)
    occ = ii.occluded(scene, o, d, tmin, tmax)
    t_ref, _ = _oracle(scene, o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(occ), t_ref < BIG)


def test_builder_attaches_bvh_and_renders_like_brute_force():
    """Scenes from 512 triangles up get a BVH by default, and the BVH path
    renders the same image as the brute-force scan."""
    from raytrace_tpu.core.config import RenderConfig
    from raytrace_tpu.renderers.simple import render_simple
    from raytrace_tpu.scene import presets

    scene, camera = presets.triangle_field(n_triangles=2048, size=32)
    assert scene.bvh is not None
    config = RenderConfig(width=32, height=32, spp=1, scene_epsilon=1e-3)
    img_bvh = render_simple(scene, camera, config, jax.random.PRNGKey(0),
                            jitter=False)
    img_scan = render_simple(scene.replace(bvh=None), camera, config,
                             jax.random.PRNGKey(0), jitter=False)
    assert np.isfinite(np.asarray(img_bvh)).all()
    assert float(np.asarray(img_bvh).max()) > 0.0
    np.testing.assert_allclose(np.asarray(img_bvh), np.asarray(img_scan),
                               rtol=1e-5, atol=1e-6)
