"""Multi-host distribution: process initialization, hierarchical meshes, and
the scaling-efficiency report.

The reference is strictly single-GPU/single-process (SURVEY.md §2.6/§5.8);
BASELINE's north star is ≥80% rays/s scaling efficiency at 2 hosts. The
structure:

  - `jax.distributed.initialize` once per process (gated + idempotent here);
  - a ('hosts', 'chips') mesh whose inner axis holds one process's devices
    and whose outer axis crosses processes;
  - photon waves: each device traces a disjoint global path-id slice
    (parallel/sharded.py), then the photon map is all-gathered over both
    mesh axes, the process-local axis first;
  - the pixel-sample axis shards over the flattened mesh; parameter
    gradients psum over it in the backward sweep.

`scaling_report` measures per-device-count throughput over the same total
workload, normalized into an efficiency figure.
"""
from __future__ import annotations

import os
import time

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed for multi-host runs. Reads the standard
    env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)
    when args are omitted; silently a no-op for single-process runs (so the
    same entry point works on a laptop, one host, or several hosts).
    Returns True when a multi-process runtime was initialized."""
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def make_hierarchical_mesh(devices=None) -> Mesh:
    """('hosts', 'chips') mesh: the inner axis stays within a process/host,
    the outer axis crosses processes. Single-process: hosts axis = 1."""
    devices = list(devices if devices is not None else jax.devices())
    n_proc = max(1, jax.process_count())
    if len(devices) % n_proc != 0:
        # non-uniform device subset (e.g. a truncated list under a
        # multi-process run): a (hosts, chips) factorization doesn't exist,
        # so degrade to a flat single-host mesh instead of reshape-crashing
        return Mesh(np.asarray(devices).reshape(1, len(devices)),
                    ("hosts", "chips"))
    per_host = len(devices) // n_proc
    # group the 'hosts' axis by owning process so the inner axis stays
    # process-local
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    dm = np.asarray(devices).reshape(n_proc, per_host)
    return Mesh(dm, ("hosts", "chips"))


def flat_mesh_axis_order(mesh: Mesh) -> tuple[str, ...]:
    return mesh.axis_names


def scaling_report(
    scene,
    camera,
    config,
    key,
    device_counts=None,
    n_iters: int = 3,
) -> dict:
    """rays/s at several device counts over the SAME per-render workload →
    {count: rays_per_s}, plus 'efficiency': throughput(n_max) /
    (n_max * throughput(1)). On real multi-chip hardware this is the
    BASELINE scaling figure; on virtual CPU devices it validates the
    sharded program structure and measures parallel overhead."""
    from raytrace_tpu.parallel import sharded

    devices = jax.devices()
    if device_counts is None:
        device_counts = sorted({1, len(devices)})
    out = {}
    for n in device_counts:
        if n > len(devices):
            continue
        mesh = sharded.make_mesh(devices[:n])
        img = sharded.render_photon_sharded(
            scene, camera, config, key, mesh)
        jax.block_until_ready(img)  # compile
        t0 = time.perf_counter()
        for i in range(n_iters):
            img = sharded.render_photon_sharded(
                scene, camera, config, jax.random.fold_in(key, i), mesh)
        jax.block_until_ready(img)
        dt = (time.perf_counter() - t0) / n_iters
        out[n] = config.n_pixel_samples / dt
    counts = sorted(out)
    if len(counts) >= 2 and out[counts[0]] > 0:
        n_max = counts[-1]
        out["efficiency"] = out[n_max] / (n_max / counts[0] * out[counts[0]])
    return out
