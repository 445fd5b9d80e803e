"""Per-pass GPU timing of the photon-mapping pipeline.

Times the full render, then the camera pass, direct lighting, photon trace
and gathering pass separately (each its own jitted program, steady state
after one warm call), so work goes to the real hot spot. --tris N renders
the N-triangle BVH field (presets.triangle_field) instead of the headline
Cornell box and also reports the BVH traversal's while-loop trip counts
for the camera rays (each trip is one round trip of the loop on the
device). Prints one JSON object.

Run: python tools/profile_ppm.py [--size 512] [--paths 262144]
     [--tris 1048576] [--iters 5]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytrace_tpu.core.config import RenderConfig  # noqa: E402
from raytrace_tpu.ops import bvh as bvh_ops  # noqa: E402
from raytrace_tpu.renderers import common  # noqa: E402
from raytrace_tpu.renderers import photon as ph  # noqa: E402
from raytrace_tpu.scene import presets  # noqa: E402
from raytrace_tpu.scene.camera import generate_rays, pixel_samples  # noqa: E402
from raytrace_tpu.utils import metrics  # noqa: E402


def bench(fn, *args, iters):
    """(output, first-call seconds, steady seconds per call)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(fn(*args))
    return out, first, (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--paths", type=int, default=1 << 18)
    ap.add_argument("--tris", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    out = dict(device=metrics.require_gpu(), size=args.size,
               paths=args.paths)
    if args.tris:
        t0 = time.perf_counter()
        scene, camera = presets.triangle_field(n_triangles=args.tris,
                                               size=args.size)
        out.update(tris=int(scene.tris.count),
                   build_s=time.perf_counter() - t0)
        config = RenderConfig(
            width=args.size, height=args.size, spp=1, scene_epsilon=1e-3,
            photon_paths=args.paths, photon_passes=1, max_photon_bounces=8,
            footprint_radius_scale=8.0, initial_radius2=0.04)
    else:
        scene, camera, config = presets.headline(args.size, args.paths)
    ls = common.static_light_samples(scene, config)
    key = jax.random.PRNGKey(0)
    k_pix, k_light, k_photon = jax.random.split(key, 3)
    xy, lens = pixel_samples(k_pix, args.size, args.size, 1)
    rays = generate_rays(camera, xy, lens, 1)
    passes = {}

    (_, aux), first, dt = bench(
        lambda sc, k: ph.render_photon(sc, camera, config, k,
                                       return_aux=True),
        scene, key, iters=args.iters)
    passes["full_render"] = (first, dt)
    out["gather_overflow"] = int(aux["gather_overflow"])
    out["valid_photons"] = int(aux["valid_photons"])

    cam = jax.jit(lambda sc, o, d, ry: common.camera_pass(
        sc, o, d, config, rays=ry))
    rec, *passes["camera_pass"] = bench(cam, scene, rays.o, rays.d, rays,
                                        iters=args.iters)
    dl = jax.jit(lambda sc, rec, k: common.direct_lighting(
        sc, rec, k, config, ls, include_emitted=True))
    _, *passes["direct_lighting"] = bench(dl, scene, rec, k_light,
                                          iters=args.iters)
    tp = jax.jit(lambda sc, k: ph.trace_photons(sc, config, k, 0))
    photons, *passes["photon_trace"] = bench(tp, scene, k_photon,
                                             iters=args.iters)
    n = rays.o.shape[0]
    state = ph.ProgressiveState(
        radius2=ph.initial_radius2(rec, config),
        photon_count=jnp.zeros((n,), jnp.float32),
        flux=jnp.zeros((n, 3), jnp.float32),
        emitted=jnp.zeros((n,), jnp.float32))
    gp = jax.jit(lambda sc, rec, st, pm: ph.gathering_pass(
        sc, rec, st, pm, config))
    _, *passes["gathering_pass"] = bench(gp, scene, rec, state, photons,
                                         iters=args.iters)
    if scene.bvh is not None:
        trav = jax.jit(lambda b, t, o, d: bvh_ops._traverse(
            b, t, o, d, jnp.full((n,), 1e-3), jnp.full((n,), 1e30),
            any_hit=False))
        (_, _, trips), *passes["bvh_camera_rays"] = bench(
            trav, scene.bvh, scene.tris, rays.o, rays.d, iters=args.iters)
        trips = [int(x) for x in trips]
        out["bvh_camera_trips_per_chunk"] = trips
        out["bvh_camera_s_per_trip"] = (passes["bvh_camera_rays"][1]
                                        / max(1, sum(trips)))
    out["passes"] = {k: dict(first_s=f, steady_s=s)
                     for k, (f, s) in passes.items()}
    out["rays_per_s_full"] = n / passes["full_render"][1]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
