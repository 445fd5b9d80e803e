"""GPU smoke test of the main path, run from the root of a checkout:

    python chip_smoke.py               # one GPU: phases (a)-(f)
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

Phases on one GPU, all at the headline size (presets.headline: Cornell box
with a glass ball, 512×512, 1 spp, 2^18 photon paths, 8 bounces):
  (a) JAX runs on a GPU (else: exit 1, no result line);
  (b) the row-span gather's Triton kernels against the plain jax.numpy
      version on the first wave's real photon map (~1M photon slots ×
      262k queries): forward S/M, the alpha VJP, and a capacity-overflow
      case whose `covered` flags must agree;
  (c) render_photon: finite image, zero gather/pair overflow; one wave's
      gather on a 128×128 crop against the exact all-pairs gather;
  (d) loss_and_grad: finite loss, nonzero d/dkd and d/dintensity;
  (e) a 1M-triangle BVH scene through render_photon, and 4096 rays
      against a brute-force closest hit;
  (f) per-phase compile and steady-state times (informational).
--four-cards runs render_photon_sharded over a one-axis 4-GPU mesh
against the same render on one GPU, and one train_step_sharded step.

The last line of stdout is one JSON object with "ok" and the device; the
line before it is the card's name and power limit from nvidia-smi. Any
failed check exits non-zero without that line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def timed(label, times, fn, *args):
    """Run fn twice: the first call (compile + run) and a steady call."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t2 = time.perf_counter()
    times[label] = dict(first_s=round(t1 - t0, 3), steady_s=round(t2 - t1, 4))
    print(f"  {label}: first {t1 - t0:.2f} s, steady {t2 - t1:.4f} s",
          flush=True)
    return out


def close(a, b, rtol, atol_frac):
    """|a-b| ≤ rtol·|b| + atol_frac·max|b| everywhere; returns (ok, worst)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tol = rtol * np.abs(b) + atol_frac * max(np.abs(b).max(), 1e-30)
    return bool(np.all(np.abs(a - b) <= tol)), float(
        (np.abs(a - b) / np.maximum(tol, 1e-300)).max())


def phase_b_gather(times):
    """(b) Triton kernels vs the jnp job blocks on the headline wave."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace_tpu.ops import rowspan_gather as rg
    from raytrace_tpu.renderers import common
    from raytrace_tpu.renderers import photon as ph
    from raytrace_tpu.scene import presets

    print("(b) row-span kernels vs the plain version", flush=True)
    scene, camera, config = presets.headline()
    ls = common.static_light_samples(scene, config)
    _, rec, _, state, k_photon, _ = ph._ppm_setup(
        scene, camera, jax.random.PRNGKey(0), config, ls, True)
    photons = jax.jit(
        lambda s, k: ph.trace_photons(s, config, k, 0))(scene, k_photon)
    cell = ph.gather_cell_size(rec, state)
    q_r2 = jnp.where(rec.hit, state.radius2, 0.0)
    budget, rounds = ph.rowspan_capacity(config, photons.p.shape[0])
    build = jax.jit(functools.partial(
        rg.build_jobs, chunk=rg.ROWSPAN_CHUNK, capacity=budget * rounds,
        r_max=config.gather_r_max))
    alpha, geo, q, jobs, _, ovf, _ = build(
        photons.p, photons.alpha, photons.wi, photons.valid, cell, rec.p,
        q_r2, rec.ns)
    print(f"  {photons.p.shape[0]} photon slots "
          f"({int(jnp.sum(photons.valid))} valid) x {rec.p.shape[0]} "
          f"queries, {int(jobs[4])} jobs", flush=True)
    check(int(ovf) == 0, "headline job list fits its capacity")

    cot = jax.random.normal(jax.random.PRNGKey(1), (4, q.shape[1]))
    outs = {}
    for impl in ("pallas", "xla"):
        cfg = rg.KernelConfig(impl=impl)
        fwd = jax.jit(lambda a, cfg=cfg: rg.flux_sums(cfg, a, geo, q, jobs))
        vjp = jax.jit(jax.grad(
            lambda a, cfg=cfg: jnp.sum(rg.flux_sums(cfg, a, geo, q, jobs)
                                       * cot)))
        outs[impl] = (np.asarray(timed(f"gather_fwd_{impl}", times, fwd,
                                       alpha)),
                      np.asarray(timed(f"gather_vjp_{impl}", times, vjp,
                                       alpha)))
    (s_k, g_k), (s_x, g_x) = outs["pallas"], outs["xla"]
    # f32 sums taken in another order; compilers may contract the distance
    # test into FMAs differently, which can flip an in-radius decision for
    # a photon exactly on a query's radius: allow a few such queries
    m_diff = s_k[3] != s_x[3]
    print(f"  tolerance: S and dalpha |d| <= 1e-4|ref| + 1e-5 max|ref|; "
          f"M equal on >= 99.99% of queries (got {int(m_diff.sum())} off)",
          flush=True)
    check(m_diff.mean() <= 1e-4 and np.abs(s_k[3] - s_x[3]).max() <= 2,
          "M counts agree")
    same = ~m_diff
    ok, worst = close(s_k[:3][:, same], s_x[:3][:, same], 1e-4, 1e-5)
    check(ok, f"S agrees (worst |d|/tol {worst:.3g})")
    ok, worst = close(g_k, g_x, 1e-4, 1e-5)
    check(ok, f"alpha VJP agrees (worst |d|/tol {worst:.3g})")

    # capacity overflow: a small budget truncates the tile-major job list
    small = max(1, int(jobs[4]) // 3)
    res = {}
    for impl in ("pallas", "xla"):
        res[impl] = jax.block_until_ready(rg.gather_radius_rowspan(
            photons.p, photons.alpha, photons.wi, photons.valid, cell,
            rec.p, q_r2, rec.ns, jnp.ones_like(rec.p), impl=impl,
            job_budget=small, rounds=1, return_covered=True))
    (L_k, m_k, o_k, c_k), (L_x, m_x, o_x, c_x) = res["pallas"], res["xla"]
    c_k, c_x = np.asarray(c_k), np.asarray(c_x)
    check(int(o_k) > 0 and int(o_k) == int(o_x),
          f"overflow counted ({int(o_k)} jobs past capacity {small})")
    check(np.array_equal(c_k, c_x) and c_k.any() and (~c_k).any(),
          f"covered flags agree ({c_k.mean():.3f} of queries covered)")
    check(float(np.abs(np.asarray(L_k)[~c_k]).max()) == 0.0,
          "uncovered queries return zero")
    same = np.asarray(m_k) == np.asarray(m_x)
    ok, worst = close(np.asarray(L_k)[same], np.asarray(L_x)[same],
                      1e-4, 1e-5)
    check(ok, f"overflow-case L agrees (worst |d|/tol {worst:.3g})")


def phase_c_render(times):
    """(c) render_photon at the headline config + crop vs exact gather."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace_tpu.renderers import common
    from raytrace_tpu.renderers import photon as ph
    from raytrace_tpu.scene import presets

    print("(c) render_photon at the headline config", flush=True)
    scene, camera, config = presets.headline()
    key = jax.random.PRNGKey(0)
    img, aux = timed("render_photon", times, lambda k: ph.render_photon(
        scene, camera, config, k, return_aux=True), key)
    img = np.asarray(img)
    size = config.width
    check(img.shape == (size, size, 3) and np.isfinite(img).all(),
          f"finite [{size}, {size}, 3] image")
    check(img.max() > 0.0, f"image not black (mean {img.mean():.4g})")
    check(int(aux["gather_overflow"]) == 0, "gather_overflow == 0")
    check(int(aux["pair_overflow"]) == 0, "pair_overflow == 0")

    # one wave's gather over a central size/4 crop (128×128 at 512):
    # row-span vs exact all-pairs
    ls = common.static_light_samples(scene, config)
    xy, rec, _, state, k_photon, _ = ph._ppm_setup(
        scene, camera, key, config, ls, True)
    photons = jax.jit(
        lambda s, k: ph.trace_photons(s, config, k, 0))(scene, k_photon)
    gpass = jax.jit(ph.gathering_pass, static_argnames=("config",))
    s_rs, info = gpass(scene, rec, state, photons, config=config)
    check(int(info["gather_overflow"]) == 0, "wave gather_overflow == 0")
    xy = np.asarray(xy)
    lo, hi = 3 * size // 8, 5 * size // 8
    crop = np.nonzero((xy[:, 0] >= lo) & (xy[:, 0] < hi)
                      & (xy[:, 1] >= lo) & (xy[:, 1] < hi))[0]
    take = lambda t: jax.tree_util.tree_map(lambda a: a[crop], t)
    cfg_exact = dataclasses.replace(config, exact_gather=True)
    s_ex, _ = gpass(scene, take(rec), take(state), photons, config=cfg_exact)
    s_rs = take(s_rs)
    print("  tolerance: flux |d| <= 1e-4|exact| + 1e-5 max|exact|; counts "
          "and radii equal on >= 99.9% of crop pixels", flush=True)
    cnt_same = np.asarray(s_rs.photon_count) == np.asarray(s_ex.photon_count)
    check(cnt_same.mean() >= 0.999,
          f"photon counts agree ({int((~cnt_same).sum())} of {crop.size} "
          "pixels off)")
    ok, worst = close(np.asarray(s_rs.flux)[cnt_same],
                      np.asarray(s_ex.flux)[cnt_same], 1e-4, 1e-5)
    check(ok, f"crop flux agrees with the exact gather (worst |d|/tol "
          f"{worst:.3g})")
    ok, worst = close(np.asarray(s_rs.radius2)[cnt_same],
                      np.asarray(s_ex.radius2)[cnt_same], 1e-5, 0.0)
    check(ok, "crop radii agree")


def phase_d_grad(times):
    """(d) loss_and_grad at the headline config."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace_tpu.diff.render import extract_params, loss_and_grad
    from raytrace_tpu.renderers import common
    from raytrace_tpu.scene import presets

    print("(d) loss_and_grad at the headline config", flush=True)
    scene, camera, config = presets.headline(differentiable=True)
    ls = common.static_light_samples(scene, config)
    params = extract_params(scene)
    target = jnp.zeros((config.height, config.width, 3), jnp.float32)
    loss, g = timed("loss_and_grad", times, lambda k: loss_and_grad(
        params, target, scene, camera, config, k, ls, False),
        jax.random.PRNGKey(0))
    check(np.isfinite(float(loss)), f"finite loss ({float(loss):.5g})")
    for name in ("kd", "intensity"):
        v = np.asarray(getattr(g, name))
        check(np.isfinite(v).all() and np.abs(v).sum() > 0.0,
              f"finite nonzero d/d{name} (|g| sum {np.abs(v).sum():.4g})")


def phase_e_bvh(times):
    """(e) 1M-triangle BVH scene + sampled rays vs brute force."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace_tpu.core.config import RenderConfig
    from raytrace_tpu.ops import bvh as bvh_ops
    from raytrace_tpu.ops import intersect as isect
    from raytrace_tpu.renderers.photon import render_photon
    from raytrace_tpu.scene import presets
    from raytrace_tpu.scene.camera import generate_rays, pixel_samples

    print("(e) 1M-triangle BVH scene", flush=True)
    t0 = time.perf_counter()
    scene, camera = presets.triangle_field(n_triangles=1 << 20, size=512)
    times["triangle_field_build"] = dict(host_s=round(
        time.perf_counter() - t0, 3))
    check(scene.bvh is not None, f"BVH built over {scene.tris.count} tris")
    config = RenderConfig(
        width=512, height=512, spp=1, scene_epsilon=1e-3,
        photon_paths=1 << 18, photon_passes=1, max_photon_bounces=8,
        footprint_radius_scale=8.0, initial_radius2=0.04)
    img, aux = timed("render_photon_1Mtri", times, lambda k: render_photon(
        scene, camera, config, k, return_aux=True), jax.random.PRNGKey(0))
    check(np.isfinite(np.asarray(img)).all() and float(img.max()) > 0.0,
          "finite, non-black image")
    check(int(aux["gather_overflow"]) == 0, "gather_overflow == 0")
    check(int(aux["pair_overflow"]) == 0, "pair_overflow == 0")

    # 2048 camera rays + 2048 incoherent rays from above the terrain
    rng = np.random.default_rng(0)
    xy, lens = pixel_samples(jax.random.PRNGKey(3), 512, 512, 1)
    pick = jnp.asarray(rng.choice(512 * 512, 2048, replace=False))
    rays = generate_rays(camera, xy[pick], lens[pick], 1)
    o2 = rng.uniform([-10, -10, 1.0], [10, 10, 3.0], (2048, 3))
    d2 = rng.normal(size=(2048, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = jnp.concatenate([rays.o, jnp.asarray(o2, jnp.float32)])
    d = jnp.concatenate([rays.d, jnp.asarray(d2, jnp.float32)])
    tmin = jnp.full((4096,), 1e-3)
    tmax = jnp.full((4096,), 1e30)
    t_b, i_b, _, _ = timed(
        "bvh_closest_4096", times, jax.jit(bvh_ops.intersect_triangles_bvh),
        scene.bvh, scene.tris, o, d, tmin, tmax)
    t_r, i_r, _, _ = timed(
        "brute_force_4096", times, jax.jit(isect.intersect_triangles),
        scene, o, d, tmin, tmax)
    t_b, t_r = np.asarray(t_b), np.asarray(t_r)
    found = t_r < 1e29
    check(np.array_equal(t_b < 1e29, found),
          f"BVH hit/miss matches brute force ({int(found.sum())} hits)")
    print("  tolerance: hit t rtol 1e-5; the same triangle on >= 99% of "
          "hits (a ray through a shared edge may take either)", flush=True)
    check(np.allclose(t_b[found], t_r[found], rtol=1e-5, atol=0),
          "closest-hit distances agree")
    idx_same = (np.asarray(i_b) == np.asarray(i_r))[found]
    check(idx_same.mean() >= 0.99,
          f"same triangle on {idx_same.mean():.4f} of hits")
    occ = np.asarray(isect.occluded(scene, o, d, tmin, tmax))
    check(np.array_equal(occ, found), "any-hit agrees with brute force")


def four_cards():
    """Sharded render over 4 GPUs vs 1 GPU, and one sharded train step."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace_tpu.diff.render import extract_params
    from raytrace_tpu.parallel import sharded
    from raytrace_tpu.scene import presets

    times = {}
    devs = jax.devices()
    check(len(devs) == 4, f"four GPUs ({len(devs)} found)")
    scene, camera, config = presets.headline()
    key = jax.random.PRNGKey(0)
    img4 = np.asarray(timed(
        "render_photon_sharded_4", times, sharded.render_photon_sharded,
        scene, camera, config, key, sharded.make_mesh(devs)))
    img1 = np.asarray(timed(
        "render_photon_sharded_1", times, sharded.render_photon_sharded,
        scene, camera, config, key, sharded.make_mesh(devs[:1])))
    check(np.isfinite(img4).all() and img4.max() > 0.0, "finite 4-GPU image")
    # Both renders trace the same photon paths (every random draw is keyed
    # by global ids), but the two programs are compiled for different batch
    # shapes, and a last-bit f32 difference can flip a Russian-roulette or
    # in-radius decision for a few photons, which moves their pixels by a
    # photon's worth: bound the share of such pixels and the total change.
    d = np.abs(img4 - img1)
    tol = 1e-4 * np.abs(img1) + 1e-5 * np.abs(img1).max()
    frac_off = float((d > tol).mean())
    rel_l1 = float(d.sum() / max(np.abs(img1).sum(), 1e-30))
    print("  tolerance: |d| <= 1e-4|1-GPU| + 1e-5 max|1-GPU| on >= 99.9% of "
          f"pixel channels (got {frac_off:.2e} off, worst |d|/tol "
          f"{float((d / np.maximum(tol, 1e-30)).max()):.3g}); relative L1 "
          f"<= 1e-3 (got {rel_l1:.2e})", flush=True)
    check(frac_off <= 1e-3 and rel_l1 <= 1e-3,
          "4-GPU image matches the 1-GPU image")

    _, _, dconfig = presets.headline(differentiable=True)
    params = extract_params(scene)
    target = jnp.zeros((config.height, config.width, 3), jnp.float32)
    loss, new = timed("train_step_sharded_4", times,
                      sharded.train_step_sharded, params, target, scene,
                      camera, dconfig, key, sharded.make_mesh(devs))
    check(np.isfinite(float(loss)), f"finite sharded loss ({float(loss):.5g})")
    moved = float(jnp.abs(new.kd - params.kd).sum())
    check(all(np.isfinite(np.asarray(x)).all()
              for x in jax.tree_util.tree_leaves(new)) and moved > 0.0,
          f"psum'd gradient step moved kd (sum |dkd| {moved:.4g})")
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 4-GPU path")
    args = ap.parse_args()

    import jax

    from raytrace_tpu.utils import metrics

    print("(a) device", flush=True)
    dev = metrics.device_info()
    print(f"  {dev['platform']} {dev['kind']} x{dev['count']}", flush=True)
    if dev["platform"] != "gpu":
        print("FAIL: JAX found no GPU", file=sys.stderr)
        return 1
    try:
        if args.four_cards:
            times = four_cards()
        else:
            times = {}
            phase_b_gather(times)
            jax.clear_caches()
            phase_c_render(times)
            jax.clear_caches()
            phase_d_grad(times)
            jax.clear_caches()
            phase_e_bvh(times)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("(f) times " + json.dumps(times), flush=True)
    print(dev["card"] or "nvidia-smi: unavailable", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
