"""raytrace_tpu — a differentiable photon-mapping renderer in JAX.

A from-scratch reimplementation of the capabilities of wjzhou/cuda-raytrace
(an OptiX 3.0 progressive photon mapper plugged into pbrt-v2): SoA scene
pytrees instead of an OptiX node graph, wavefront `lax` loops instead of
device-side recursion, a sorted photon grid instead of a CPU-built kd-tree,
and `shard_map` over a device mesh instead of a single GPU.

Layer map (mirrors SURVEY.md §1, reimagined):
  core/       geometry + spectrum + sampling + RNG + typed config
  scene/      scene pytree (SoA), python builder, pbrt-file ingestion, camera
  ops/        intersection (brute-force + BVH), photon grid + row-span gather
  shading/    BSDFs and lights (batched, differentiable)
  renderers/  "simple" direct-light renderer and the photon-mapping renderer
  parallel/   device-mesh sharding of rays and photon waves
  utils/      film, image IO, logging
"""

__version__ = "0.2.0"


def compile_cache_dir(environ) -> str | None:
    """Directory of the persistent XLA compilation cache for an environment
    mapping: $JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself),
    None when RAYTRACE_NO_COMPILE_CACHE=1, else the fixed directory
    .jax_cache/ at the root of the checkout."""
    import os

    if environ.get("RAYTRACE_NO_COMPILE_CACHE") == "1":
        return None
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def _enable_compile_cache() -> None:
    """Point JAX at compile_cache_dir(os.environ). A directory that cannot
    be created is an error, not a silent cold cache."""
    import os

    path = compile_cache_dir(os.environ)
    if path is None or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compile_cache()

from raytrace_tpu.scene.pbrt import load_pbrt, loads_pbrt  # noqa: F401,E402
