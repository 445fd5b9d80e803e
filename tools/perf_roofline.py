"""Speed-of-light accounting for the row-span gather at the headline config:
measured kernel time against the card's published fp32 and memory peaks,
and against what a plain fp32 FMA chain and a large copy reach on the same
card in the same process.

Run on a GPU: python tools/perf_roofline.py
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# device_kind → (fp32 TFLOP/s outside the tensor cores, device memory TB/s),
# dense rates at the full power limit (NVIDIA H100 data sheet)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67.0, 3.35),  # SXM5
    "NVIDIA H100 PCIe": (51.0, 2.0),
    "NVIDIA H100 NVL": (60.0, 3.9),
}
# f32 operations per (query, photon) pair of one job block: 3 sub + 3 mul
# + 2 add (dist²), compare, 3 mul + 2 add (n·wi), abs, select, 3 FMA (S)
# and 1 add (M)
FLOPS_PER_PAIR = 24


def _time(fn, *args, iters=10):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def fma_rate(n=1 << 24, k=512):
    """Achieved fp32 FMA rate: a k-deep chain over f32[n] in one program."""
    x = jnp.linspace(0.1, 1.1, n, dtype=jnp.float32)
    chain = jax.jit(lambda x: jax.lax.fori_loop(
        0, k, lambda _, y: y * jnp.float32(1.000001) + jnp.float32(1e-7), x,
        unroll=16))
    return 2.0 * n * k / _time(chain, x) / 1e12


def copy_rate(n=1 << 28):
    """Achieved device-memory bandwidth: read + write of f32[n]."""
    x = jnp.ones((n,), jnp.float32)
    return 2 * 4 * n / _time(jax.jit(lambda x: x * 2.0), x) / 1e12


def gather_stats():
    from ab_rowspan import gather_inputs
    from raytrace_tpu.ops import rowspan_gather as rg

    (alpha, geo, q, jobs), info = gather_inputs(512, 1 << 18)
    cot = jnp.ones((4, q.shape[1]), jnp.float32)
    n_jobs = info["jobs_executed"]
    flops = n_jobs * rg.TILE_Q * rg.ROWSPAN_CHUNK * FLOPS_PER_PAIR
    # compulsory bytes: every valid photon row and every query row once
    bytes_min = (info["valid_photons"] * 11 + q.shape[1] * 8) * 4
    out = dict(info)
    for impl in ("pallas", "xla"):
        cfg = rg.KernelConfig(impl=impl)
        fwd = jax.jit(lambda a: rg.flux_sums(cfg, a, geo, q, jobs))
        bwd = jax.jit(jax.grad(
            lambda a: jnp.sum(rg.flux_sums(cfg, a, geo, q, jobs) * cot)))
        out[f"{impl}_fwd_ms"] = _time(fwd, alpha) * 1e3
        out[f"{impl}_bwd_ms"] = _time(bwd, alpha) * 1e3
    return out, flops, bytes_min


def main():
    from raytrace_tpu.utils import metrics

    dev = metrics.require_gpu()
    if dev["kind"] not in PEAKS:
        raise SystemExit(f"no published peaks for {dev['kind']!r}: add them "
                         "to PEAKS with their source")
    peak_tflops, peak_tbps = PEAKS[dev["kind"]]
    out = dict(device=dev, peak_fp32_tflops=peak_tflops,
               peak_mem_tbps=peak_tbps)
    out["fma_tflops_achieved"] = fma_rate()
    out["copy_tbps_achieved"] = copy_rate()
    stats, flops, bytes_min = gather_stats()
    out.update(stats)
    out["gather_flops"] = flops
    out["gather_bytes_compulsory"] = bytes_min
    for key in ("pallas_fwd_ms", "pallas_bwd_ms", "xla_fwd_ms",
                "xla_bwd_ms"):
        t = stats[key] / 1e3
        bound = max(flops / (peak_tflops * 1e12), bytes_min / (peak_tbps * 1e12))
        out[key.replace("_ms", "_roofline_share")] = bound / t
        out[key.replace("_ms", "_share_of_fma_chain")] = (
            flops / t / 1e12 / out["fma_tflops_achieved"])
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
