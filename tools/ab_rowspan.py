"""Row-span gather A/B on the GPU: the Triton-route Pallas kernels against
the plain jax.numpy job blocks (ops/rowspan_gather.py), at the headline
config (presets.headline: Cornell box with a glass ball, 512×512, 1 spp,
2^18 photon paths, 8 bounces, footprint radii ×8).

  gather  the job blocks alone (rowspan_gather.flux_sums: the forward, and
          the alpha gradient, whose program runs the backward only — the
          primal is not needed) on the first wave's real photon map and
          camera records: the plain version at each --xla-batches size and
          every kernel configuration in --blocks (fwd q x p blocks, bwd q x p
          blocks, warps, stages), each checked against the plain version;
  e2e     render_photon and loss_and_grad compiled once with each
          implementation (the plain version at --e2e-xla-batch jobs per
          step) and timed in turns (xla, pallas, pallas, xla, ...).

Prints one JSON object per line; --out also appends them to a file.

Run: python tools/ab_rowspan.py [--reps 6] [--blocks 16x128x32x64x4x1,...]
     [--xla-batches 64,256] [--impls xla,pallas] [--skip-gather]
     [--skip-e2e] [--out chiprun_out/ab_rowspan.jsonl]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytrace_tpu.diff.render import extract_params, loss_and_grad  # noqa: E402
from raytrace_tpu.ops import rowspan_gather as rg  # noqa: E402
from raytrace_tpu.renderers import common  # noqa: E402
from raytrace_tpu.renderers import photon as ph  # noqa: E402
from raytrace_tpu.scene import presets  # noqa: E402
from raytrace_tpu.utils import metrics  # noqa: E402


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _time(fn, reps):
    """Median and all of `reps` timed calls (after one warm call)."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


def gather_inputs(size, paths):
    """Job list + row layouts of the first headline wave."""
    scene, camera, config = presets.headline(size, paths)
    ls = common.static_light_samples(scene, config)
    key = jax.random.PRNGKey(0)
    _, rec, _, state, k_photon, _ = ph._ppm_setup(
        scene, camera, key, config, ls, True)
    photons = jax.jit(
        lambda s, k: ph.trace_photons(s, config, k, 0))(scene, k_photon)
    cell = ph.gather_cell_size(rec, state)
    q_r2 = jnp.where(rec.hit, state.radius2, 0.0)
    job_budget, rounds = ph.rowspan_capacity(config, photons.p.shape[0])
    build = jax.jit(functools.partial(
        rg.build_jobs, chunk=rg.ROWSPAN_CHUNK,
        capacity=job_budget * rounds, r_max=config.gather_r_max))
    args = (photons.p, photons.alpha, photons.wi, photons.valid, cell,
            rec.p, q_r2, rec.ns)
    built = build(*args)
    t_build, _ = _time(lambda: build(*args), 3)
    alpha, geo, q, jobs, _, ovf, _ = built
    info = dict(slots=int(photons.p.shape[0]),
                valid_photons=int(jnp.sum(photons.valid)),
                queries=int(rec.p.shape[0]),
                jobs_executed=int(jobs[4]), capacity=job_budget * rounds,
                overflow=int(ovf), build_jobs_s=t_build)
    return (alpha, geo, q, jobs), info


def run_gather(args, out):
    (alpha, geo, q, jobs), info = gather_inputs(args.size, args.paths)
    _emit(out, dict(part="gather_inputs", **info))
    cot = jax.random.normal(jax.random.PRNGKey(1), (4, q.shape[1]))

    def make(cfg):
        fwd = jax.jit(lambda a: rg.flux_sums(cfg, a, geo, q, jobs))
        grad = jax.jit(jax.grad(
            lambda a: jnp.sum(rg.flux_sums(cfg, a, geo, q, jobs) * cot)))
        return fwd, grad

    ref_fwd, ref_grad = make(rg.KernelConfig(impl="xla"))
    s_ref = np.asarray(ref_fwd(alpha))
    g_ref = np.asarray(ref_grad(alpha))
    variants = [(f"xla_{b}", rg.KernelConfig(impl="xla", xla_job_batch=int(b)))
                for b in filter(None, args.xla_batches.split(","))]
    for b in filter(None, args.blocks.split(",")):
        qb, pb, bqb, bpb, nw, ns = (int(x) for x in b.split("x"))
        variants.append((f"pallas_{b}", rg.KernelConfig(
            impl="pallas", q_block=qb, p_block=pb, bwd_q_block=bqb,
            bwd_p_block=bpb, num_warps=nw, num_stages=ns)))
    for name, cfg in variants:
        rec = dict(part="gather", variant=name)
        try:
            fwd, grad = make(cfg)
            t0 = time.perf_counter()
            s = np.asarray(fwd(alpha))
            g = np.asarray(grad(alpha))
            rec["compile_s"] = time.perf_counter() - t0
            scale = np.abs(s_ref[:3]).max()
            rec["fwd_max_abs_err_S_over_max"] = float(
                np.abs(s[:3] - s_ref[:3]).max() / scale)
            rec["fwd_M_mismatches"] = int((s[3] != s_ref[3]).sum())
            rec["grad_max_abs_err_over_max"] = float(
                np.abs(g - g_ref).max() / np.abs(g_ref).max())
            rec["fwd_s"], rec["fwd_all_s"] = _time(lambda: fwd(alpha),
                                                   args.reps)
            rec["bwd_s"], rec["bwd_all_s"] = _time(
                lambda: grad(alpha), args.reps)
        except Exception as e:  # one variant's failure is reported, not fatal
            rec["error"] = f"{type(e).__name__}: {str(e)[:400]}"
        _emit(out, rec)


def _compile_with(impl, xla_batch, fn_jitted, *args):
    """Lower + compile fn_jitted with the render path's row-span impl (and
    the plain version's job batch) set."""
    prev = ph.ROWSPAN_IMPL, rg.DEFAULT_KERNEL
    ph.ROWSPAN_IMPL = impl
    rg.DEFAULT_KERNEL = rg.DEFAULT_KERNEL._replace(xla_job_batch=xla_batch)
    jax.clear_caches()
    try:
        t0 = time.perf_counter()
        compiled = fn_jitted.lower(*args).compile()
        return compiled, time.perf_counter() - t0
    finally:
        ph.ROWSPAN_IMPL, rg.DEFAULT_KERNEL = prev


def run_e2e(args, out):
    scene, camera, config = presets.headline(args.size, args.paths)
    ls = common.static_light_samples(scene, config)
    key = jax.random.PRNGKey(0)
    _, _, dconfig = presets.headline(args.size, args.paths,
                                     differentiable=True)
    params = extract_params(scene)
    target = jnp.zeros((args.size, args.size, 3), jnp.float32)

    progs = {}
    impls = args.impls.split(",")
    for impl in impls:
        try:
            render, c_r = _compile_with(
                impl, args.e2e_xla_batch, ph._render_photon, scene, camera,
                key, config, ls, True)
            grad, c_g = _compile_with(
                impl, args.e2e_xla_batch, loss_and_grad, params, target,
                scene, camera, dconfig, key, ls, False)
        except Exception as e:  # report and go on with the other impl
            _emit(out, dict(part="e2e_compile", impl=impl,
                            error=f"{type(e).__name__}: {str(e)[:600]}"))
            continue
        progs[impl] = (render, grad)
        img, aux = render(scene, camera, key)
        loss, g = grad(params, target, scene, camera, key)
        _emit(out, dict(
            part="e2e_compile", impl=impl, render_compile_s=c_r,
            grad_compile_s=c_g,
            image_finite=bool(jnp.isfinite(img).all()),
            image_mean=float(jnp.mean(img)),
            gather_overflow=int(aux["gather_overflow"]),
            pair_overflow=int(aux["pair_overflow"]),
            loss=float(loss), grad_kd_abs_sum=float(jnp.abs(g.kd).sum())))
    impls = list(progs)
    imgs = [progs[i][0](scene, camera, key)[0] for i in impls]
    _emit(out, dict(part="e2e_agreement",
                    image_max_abs_diff=float(jnp.abs(imgs[0] - imgs[-1]).max()),
                    image_max=float(jnp.abs(imgs[0]).max())))

    times = {(impl, kind): [] for impl in progs for kind in ("fwd", "grad")}
    order = impls + impls[::-1]
    for rep in range(args.reps):
        k = jax.random.fold_in(key, rep + 1)
        for impl in order:
            render, grad = progs[impl]
            t0 = time.perf_counter()
            jax.block_until_ready(render(scene, camera, k))
            times[(impl, "fwd")].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            jax.block_until_ready(grad(params, target, scene, camera, k))
            times[(impl, "grad")].append(time.perf_counter() - t0)
    for (impl, kind), ts in times.items():
        _emit(out, dict(part="e2e", impl=impl, kind=kind,
                        median_s=statistics.median(ts), all_s=ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--paths", type=int, default=1 << 18)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--blocks", default="8x128x128x32x4x1")
    ap.add_argument("--xla-batches", default="64")
    ap.add_argument("--e2e-xla-batch", type=int, default=4096,
                    help="job batch of the plain version in the e2e A/B")
    ap.add_argument("--impls", default="xla,pallas")
    ap.add_argument("--skip-gather", action="store_true")
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    dev = metrics.require_gpu()
    print(dev["card"], flush=True)
    _emit(args.out, dict(part="device", **dev))
    if not args.skip_gather:
        run_gather(args, args.out)
    if not args.skip_e2e:
        run_e2e(args, args.out)


if __name__ == "__main__":
    main()
