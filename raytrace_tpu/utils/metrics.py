"""Observability: structured per-pass logging, throughput counters, and a
profiler hook.

The reference's only observability is pbrt Info/Warning logging of the
valid-photon count (photonmappingrenderer.cpp:164), rtPrintf on one debug
pixel (cudarender.cpp:31-33), and printf progress markers. Replacements here (SURVEY.md §5.1/§5.5):

  - `log_pass(...)`: one structured key=value line per render pass through
    the standard logging module (machine-greppable, no deps);
  - `Throughput`: wall-clock counter → rays/s, photons/s — the BASELINE
    metric units;
  - `trace(path)`: context manager around jax.profiler for device traces
    viewable in TensorBoard/Perfetto;
  - `device_info()` / `require_gpu()`: the device every measurement is
    reported against (a measurement never falls back to the CPU);
  - `device_debug_print`: jax.debug.print gated on one (x, y) debug pixel —
    the analogue of the reference's setPrintLaunchIndex single-pixel
    rtPrintf window.
"""
from __future__ import annotations

import contextlib
import logging
import subprocess
import time

import jax

logger = logging.getLogger("raytrace_tpu")


def log_pass(pass_name: str, **fields) -> None:
    """One structured line per pass: `pass=photon_trace wave=3 photons=...`"""
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    logger.info("pass=%s %s", pass_name, kv)


class Throughput:
    """Wall-clock throughput meter.

    with Throughput() as t: ...render...
    t.rate(n_rays) → rays/s
    """

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False

    def rate(self, count: float) -> float:
        return count / max(self.seconds, 1e-12)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block (device + host timelines)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_debug_print(fmt: str, x, y, px: int, py: int, *values) -> None:
    """In-kernel print limited to one debug pixel — the analogue of the
    reference's setPrintLaunchIndex(512, 512) rtPrintf window
    (cudarender.cpp:31-33).

    Call inside jitted code: x/y are the current sample's pixel coords
    (traced scalars), px/py the python-level debug pixel."""

    def emit(vals):
        jax.debug.print("[debug-pixel] " + fmt, *vals)

    def skip(vals):
        pass

    jax.lax.cond((x == px) & (y == py), emit, skip, values)


def card_info() -> str | None:
    """`name, power.limit` of the first GPU as nvidia-smi reports them
    (None when nvidia-smi is absent or fails). A card set below its maximum
    power limit runs slower under load, so every number is kept beside it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def device_info() -> dict:
    """The devices JAX runs on, as measurements report them."""
    devs = jax.devices()
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs), card=card_info())


def require_gpu() -> dict:
    """device_info(), raising when JAX found no GPU: a device measurement
    never falls back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {info['platform']} ({info['kind']})")
    return info
