"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: camera rays/sec through the full photon-mapping forward pipeline
(camera pass + direct lighting + photon trace + row-span gather + combine)
on one GPU at presets.headline (Cornell box with a glass ball, 512×512,
1 spp, 2^18 photon paths, 8 bounces) — the reference's whole 4-pass render
(photonmappingrenderer.cpp:31-45) expressed as work/second. The same line
carries:
  - grad_*: rays/s and photons/s through loss_and_grad (forward + backward,
    custom-VJP row-span gather) at the same config;
  - ppm_multiwave_*: sustained 8-wave progressive PPM (radius-shrinking
    steady state) with the per-wave radius trace;
  - ppm_4mtri_16mphotons_*: the 4M-triangle scene with 16M photon slots
    through the full PPM pipeline (BVH traversal + row-span gather);
  - triangle_field_*: the many-triangle direct-light benchmark;
  - scaling_*: sharded scaling efficiency when >1 GPU is visible;
  - device: platform, device_kind, device count and the card's name and
    power limit (nvidia-smi).

Every section runs in its own subprocess (one JAX process on the card at a
time). A section that finds no GPU fails; a failed headline is an error
(exit 1), never a retry at a smaller size.
Run `--size N --paths P` for a single in-process headline config,
`--tris` / `--grad` / `--combined` / `--scaling` for one section only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HEADLINE_TIMEOUT_S = 1500
GRAD_TIMEOUT_S = 1800
COMBINED_TIMEOUT_S = 1800
TRIS_TIMEOUT_S = 1800


def _device() -> dict:
    """The GPU this process measures on (raises when there is none)."""
    from raytrace_tpu.utils import metrics

    return metrics.require_gpu()


def run_once(size: int, photon_paths: int) -> dict:
    import numpy as np

    import jax

    from raytrace_tpu.renderers.photon import render_photon
    from raytrace_tpu.scene import presets

    device = _device()
    scene, camera, config = presets.headline(size, photon_paths)
    spp = config.spp

    def run(key):
        return render_photon(scene, camera, config, key)

    t0 = time.perf_counter()
    jax.block_until_ready(run(jax.random.PRNGKey(0)))
    compile_s = time.perf_counter() - t0

    # median of 10 per-frame times with the min/max band in the JSON
    n_iters = 10
    times = []
    for i in range(n_iters):
        t0 = time.perf_counter()
        jax.block_until_ready(run(jax.random.PRNGKey(i + 1)))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))

    camera_rays = size * size * spp
    photons = config.photon_paths * config.photon_passes
    rays_per_s = camera_rays / dt
    return {
        "metric": "camera_rays_per_sec_full_ppm_pipeline",
        "value": rays_per_s,
        "unit": "rays/s",
        "device": device,
        "extra": {
            "photons_per_sec": photons / dt,
            "frame_time_s": dt,
            "variance_band": {
                "n": n_iters,
                "frame_s_min": float(np.min(times)),
                "frame_s_median": dt,
                "frame_s_max": float(np.max(times)),
                "rays_per_s_min": camera_rays / float(np.max(times)),
                "rays_per_s_max": camera_rays / float(np.min(times)),
            },
            "compile_s": compile_s,
            "width": size, "height": size, "spp": spp,
            "photon_paths": photons,
        },
    }


def run_multiwave(size: int = 512, paths: int = 1 << 18,
                  passes: int = 8) -> dict:
    """Sustained MULTI-WAVE progressive photon mapping — the actual PPM
    operating mode (the reference's gathering.cu:104-126 exists to be
    iterated; it hard-codes passes=1 and so did this bench's headline).
    Measures steady-state photons/s across `passes` radius-shrinking waves
    plus the radius-convergence trace (shrinking radii tighten the rowspan
    grid wave over wave — gather_cell_size tracks the q90 live radius)."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    import dataclasses

    from raytrace_tpu.renderers import photon as ph
    from raytrace_tpu.scene import presets

    _device()
    scene, camera, config = presets.headline(size, paths)
    config = dataclasses.replace(config, photon_passes=passes)
    ls = ph.common.static_light_samples(scene, config)
    key = jax.random.PRNGKey(0)

    t0 = time.perf_counter()
    xy, rec, direct, state, k_photon, _ = ph._ppm_setup(
        scene, camera, key, config, ls, True)
    jax.block_until_ready(state.flux)
    # wave-by-wave (one compile — pass_idx is traced)
    radius_trace = []
    wave_times = []
    for p in range(passes):
        tw = time.perf_counter()
        state, info = ph._ppm_wave(
            scene, rec, state, k_photon, jnp.int32(p), config)
        jax.block_until_ready(state.flux)
        wave_times.append(time.perf_counter() - tw)
        radius_trace.append(float(jnp.mean(
            jnp.where(rec.hit, state.radius2, 0.0))))
    compile_s = wave_times[0]
    steady = wave_times[1:]
    dt = float(np.median(steady))
    return {
        "ppm_multiwave_photons_per_s": paths / dt,
        "ppm_multiwave_passes": passes,
        "ppm_multiwave_wave_s_median": dt,
        "ppm_multiwave_wave_s_first_compile": compile_s,
        "ppm_multiwave_wave_s": [round(t, 4) for t in wave_times],
        "ppm_multiwave_mean_radius2_trace": [
            round(r, 6) for r in radius_trace],
    }


def run_grad(size: int = 512, paths: int = 1 << 18) -> dict:
    """The literal BASELINE metric: rays/s + photons/s through loss_and_grad
    — forward AND backward, with the differentiable config (record-and-
    replay walks, custom-VJP row-span gather)."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytrace_tpu.diff.render import extract_params, loss_and_grad
    from raytrace_tpu.renderers import common
    from raytrace_tpu.scene import presets

    _device()
    scene, camera, config = presets.headline(size, paths,
                                             differentiable=True)
    ls = common.static_light_samples(scene, config)
    params = extract_params(scene)
    target = jnp.zeros((size, size, 3), jnp.float32)
    key = jax.random.PRNGKey(0)

    t0 = time.perf_counter()
    loss, g = loss_and_grad(params, target, scene, camera, config, key, ls,
                            False)
    jax.block_until_ready(g)
    compile_s = time.perf_counter() - t0
    assert float(jnp.abs(g.kd).sum()) > 0.0

    times = []
    for i in range(10):
        t0 = time.perf_counter()
        loss, g = loss_and_grad(
            params, target, scene, camera, config,
            jax.random.fold_in(key, i + 1), ls, False,
        )
        jax.block_until_ready(g)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    return {
        "grad_rays_per_s": size * size / dt,
        "grad_photons_per_s": paths / dt,
        "grad_frame_s": dt,
        "grad_frame_s_min": min(times),
        "grad_frame_s_max": max(times),
        "grad_compile_s": compile_s,
    }


def run_combined(n_tris: int = 1 << 22, paths: int = 1 << 22,
                 size: int = 512) -> dict:
    """BASELINE config[4] as ONE workload: the many-triangle scene with
    paths×4 = 16.8M photon slots through the FULL progressive-photon-mapping
    pipeline — BVH traversal for every camera/shadow/photon ray AND the
    row-span gather over the 16M-slot map in the same frame."""
    import jax

    from raytrace_tpu.core.config import RenderConfig
    from raytrace_tpu.renderers.photon import render_photon
    from raytrace_tpu.scene import presets

    _device()
    t0 = time.perf_counter()
    scene, camera = presets.triangle_field(n_triangles=n_tris, size=size)
    build_s = time.perf_counter() - t0
    config = RenderConfig(
        width=size, height=size, spp=1, scene_epsilon=1e-3,
        photon_paths=paths, photon_passes=1, max_photon_bounces=8,
        # tight radius cap: PPM's initial radius is a free per-pixel
        # parameter, and a loose cap inflates the typical gather tile's
        # chunk spans
        footprint_radius_scale=8.0, initial_radius2=0.04,
    )
    t0 = time.perf_counter()
    img, aux = render_photon(
        scene, camera, config, jax.random.PRNGKey(0), return_aux=True
    )
    jax.block_until_ready(img)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    img, aux = render_photon(
        scene, camera, config, jax.random.PRNGKey(1), return_aux=True
    )
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    return {
        "ppm_4mtri_16mphotons_rays_per_s": size * size / dt,
        "ppm_4mtri_16mphotons_photons_per_s": paths / dt,
        "ppm_4mtri_16mphotons_frame_s": dt,
        "ppm_4mtri_16mphotons_compile_s": compile_s,
        "ppm_4mtri_16mphotons_build_s": build_s,
        "ppm_4mtri_16mphotons_tris": int(scene.tris.count),
        "ppm_4mtri_16mphotons_slots": paths * config.max_photon_depth,
        "ppm_4mtri_16mphotons_valid_photons": int(aux["valid_photons"]),
        "ppm_4mtri_16mphotons_gather_overflow": int(aux["gather_overflow"]),
        "ppm_4mtri_16mphotons_pair_overflow": int(aux["pair_overflow"]),
    }


def run_combined_multiwave(n_tris: int = 1 << 22, paths: int = 1 << 22,
                           size: int = 512, passes: int = 4) -> dict:
    """BASELINE config[4] in its REAL operating mode: ≥4 radius-shrinking
    progressive waves over the 4M-triangle scene with 16M photon slots,
    with a mid-run checkpoint save + resume equality probe (the
    progressive update is the reference's whole point,
    gathering.cu:116-122)."""
    import os
    import tempfile

    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytrace_tpu.core.config import RenderConfig
    from raytrace_tpu.renderers import photon as ph
    from raytrace_tpu.scene import presets
    from raytrace_tpu.utils import checkpoint as ckpt

    _device()
    t0 = time.perf_counter()
    scene, camera = presets.triangle_field(n_triangles=n_tris, size=size)
    build_s = time.perf_counter() - t0
    config = RenderConfig(
        width=size, height=size, spp=1, scene_epsilon=1e-3,
        photon_paths=paths, photon_passes=passes, max_photon_bounces=8,
        footprint_radius_scale=8.0, initial_radius2=0.04,
    )
    ls = ph.common.static_light_samples(scene, config)
    key = jax.random.PRNGKey(0)
    xy, rec, direct, state, k_photon, _ = ph._ppm_setup(
        scene, camera, key, config, ls, True)
    jax.block_until_ready(state.flux)

    radius_trace = []
    wave_times = []
    ckpt_path = os.path.join(tempfile.gettempdir(), "bench_cfg4_ckpt.npz")
    p_mid = passes // 2 - 1
    state_after_resume_wave = None
    for p in range(passes):
        tw = time.perf_counter()
        state, info = ph._ppm_wave(
            scene, rec, state, k_photon, jnp.int32(p), config)
        jax.block_until_ready(state.flux)
        wave_times.append(time.perf_counter() - tw)
        radius_trace.append(float(jnp.mean(
            jnp.where(rec.hit, state.radius2, 0.0))))
        if p == p_mid:  # mid-run checkpoint
            ckpt.save_progressive(ckpt_path, jax.device_get(state), p + 1,
                                  key, emitted_photons=float(paths) * (p + 1))
        elif p == p_mid + 1:
            state_after_resume_wave = jax.device_get(state)
    # resume probe: reload the mid-run checkpoint, re-run the next wave —
    # waves are pure functions of (key, pass idx), so the resumed state
    # must match the in-memory one BIT-FOR-BIT
    st_l, next_p, _, _ = ckpt.load_progressive(ckpt_path)
    st_r, _ = ph._ppm_wave(scene, rec, st_l, k_photon, jnp.int32(next_p),
                           config)
    import numpy as _np
    resume_ok = bool(
        _np.array_equal(_np.asarray(st_r.flux),
                        state_after_resume_wave.flux)
        and _np.array_equal(_np.asarray(st_r.radius2),
                            state_after_resume_wave.radius2))
    compile_s = wave_times[0]
    steady = wave_times[1:]
    dt = float(np.median(steady))
    return {
        "ppm_4mtri_16mphotons_multiwave_passes": passes,
        "ppm_4mtri_16mphotons_multiwave_photons_per_s": paths / dt,
        "ppm_4mtri_16mphotons_multiwave_wave_s_median": dt,
        "ppm_4mtri_16mphotons_multiwave_wave_s": [
            round(t, 3) for t in wave_times],
        "ppm_4mtri_16mphotons_multiwave_radius2_trace": [
            round(r, 7) for r in radius_trace],
        "ppm_4mtri_16mphotons_multiwave_build_s": build_s,
        "ppm_4mtri_16mphotons_multiwave_resume_ok": resume_ok,
        "ppm_4mtri_16mphotons_multiwave_gather_overflow": int(
            info["gather_overflow"]),
    }


def run_triangle_field(n_tris: int = 1 << 20, size: int = 512) -> dict:
    """1M-triangle BVH benchmark (BASELINE config[4] scale axis): direct-
    light render through the stackless skip-link traversal — camera rays +
    one shadow ray each."""
    import jax

    from raytrace_tpu.core.config import RenderConfig
    from raytrace_tpu.renderers.simple import render_simple
    from raytrace_tpu.scene import presets

    _device()
    t0 = time.perf_counter()
    scene, camera = presets.triangle_field(n_triangles=n_tris, size=size)
    build_s = time.perf_counter() - t0
    config = RenderConfig(width=size, height=size, spp=1, scene_epsilon=1e-3)

    t0 = time.perf_counter()
    img = render_simple(scene, camera, config, jax.random.PRNGKey(0))
    jax.block_until_ready(img)
    compile_s = time.perf_counter() - t0

    n_iters = 3
    t0 = time.perf_counter()
    for i in range(n_iters):
        img = render_simple(scene, camera, config, jax.random.PRNGKey(i + 1))
        jax.block_until_ready(img)
    dt = (time.perf_counter() - t0) / n_iters
    rays = size * size  # camera rays; each also casts ~1 shadow ray
    return {
        "triangle_field_rays_per_s": rays / dt,
        "triangle_field_frame_s": dt,
        "triangle_field_tris": int(scene.tris.count),
        "triangle_field_build_s": build_s,
        "triangle_field_compile_s": compile_s,
    }


def run_scaling() -> dict:
    """Sharded scaling efficiency when >1 GPU is visible."""
    import jax

    _device()
    if len(jax.devices()) < 2:
        return {}
    from raytrace_tpu.core.config import RenderConfig
    from raytrace_tpu.parallel import multihost
    from raytrace_tpu.scene import presets

    n = len(jax.devices())
    size = 256
    scene, camera = presets.cornell_box(size=size, ball="glass")
    config = RenderConfig(
        width=size, height=size, spp=1, scene_epsilon=1e-3,
        photon_paths=1 << 16, photon_passes=1, max_photon_bounces=8,
    )
    rep = multihost.scaling_report(
        scene, camera, config, jax.random.PRNGKey(0), device_counts=(1, n))
    return {
        "scaling_devices": n,
        "scaling_efficiency": rep.get("efficiency"),
        "scaling_rays_per_s": {str(k): v for k, v in rep.items()
                               if isinstance(k, int)},
    }


def _sub(args: list[str], timeout: int):
    """Run this file in a subprocess → (its last JSON line or None, error)."""
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)] + args,
            capture_output=True, text=True, timeout=timeout,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except subprocess.TimeoutExpired:
        return None, f"{' '.join(args)}: timed out after {timeout} s"
    if out.returncode == 0:
        for line in reversed(out.stdout.strip().splitlines()):
            if line.startswith("{"):
                return json.loads(line), None
    return None, (f"{' '.join(args)}: exit {out.returncode}: "
                  + out.stderr.strip()[-2000:])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=0)
    ap.add_argument("--paths", type=int, default=0)
    ap.add_argument("--tris", action="store_true")
    ap.add_argument("--ntris", type=int, default=1 << 20)
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--multiwave", action="store_true")
    ap.add_argument("--combined", action="store_true")
    ap.add_argument("--combined-multiwave", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    args = ap.parse_args()

    if args.tris:
        print(json.dumps(run_triangle_field(n_tris=args.ntris)))
        return 0
    if args.grad:
        print(json.dumps(run_grad()))
        return 0
    if args.multiwave:
        print(json.dumps(run_multiwave()))
        return 0
    if args.combined:
        print(json.dumps(run_combined()))
        return 0
    if args.combined_multiwave:
        print(json.dumps(run_combined_multiwave()))
        return 0
    if args.scaling:
        print(json.dumps(run_scaling()))
        return 0
    if args.size:
        print(json.dumps(run_once(args.size, args.paths or (args.size ** 2))))
        return 0

    result, err = _sub(["--size", "512", "--paths", str(1 << 18)],
                       HEADLINE_TIMEOUT_S)
    if result is None:
        print(json.dumps({
            "metric": "camera_rays_per_sec_full_ppm_pipeline",
            "value": None, "unit": "rays/s", "error": err,
        }))
        return 1
    errors = []
    sections = [
        (["--grad"], GRAD_TIMEOUT_S),
        (["--multiwave"], GRAD_TIMEOUT_S),
        (["--combined"], COMBINED_TIMEOUT_S),
        (["--combined-multiwave"], COMBINED_TIMEOUT_S),
        (["--tris", "--ntris", str(1 << 22)], TRIS_TIMEOUT_S),
        (["--scaling"], TRIS_TIMEOUT_S),
    ]
    for sec_args, timeout in sections:
        sec, err = _sub(sec_args, timeout)
        if sec is None:
            errors.append(err)
        else:
            result["extra"].update(sec)
    if errors:
        result["extra"]["section_errors"] = errors
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
