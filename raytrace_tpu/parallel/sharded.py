"""Multi-chip rendering over a jax.sharding.Mesh.

The reference is single-GPU/single-process with no communication backend at
all (SURVEY.md §2.6, §5.8). The scale-out here (BASELINE north star):

  - camera-ray tiles sharded per device (pixel-sample axis → 'chips');
  - photon waves traced independently per device, each covering a disjoint
    slice of the GLOBAL photon path-id space (Halton indices + per-path RNG
    keys are pure functions of the global id, so the union over any device
    count is the same photon set);
  - per-device photon maps `all_gather`ed, the gather structures built per
    device (replicated compute, no further communication during gather);
  - scene/material parameter gradients `psum`ed by shard_map's transpose in
    the backward sweep (train_step_sharded).

The mesh is one axis: every card of a host reaches every other at the same
rate, so no device order is preferred. Scene tables replicate (the
4M-triangle scene is ~200 MB per copy).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array
from jax.sharding import Mesh, PartitionSpec as P

from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.ops import photon_grid
from raytrace_tpu.renderers import common
from raytrace_tpu.renderers import photon as photon_renderer
from raytrace_tpu.scene.camera import PerspectiveCamera, generate_rays, pixel_samples
from raytrace_tpu.scene.scene import Scene
from raytrace_tpu.utils import film

AXIS = "chips"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (AXIS,))


def _radiance_shard(
    scene: Scene,
    camera: PerspectiveCamera,
    xy_s: Array,
    lens_s: Array,
    key: Array,
    config: RenderConfig,
    light_samples: tuple,
    n_chips: int,
    axes: tuple[str, ...] = (AXIS,),
):
    """Per-chip radiance for a shard of pixel samples. Runs inside shard_map.

    axes: the mesh axes the pixel-sample axis is sharded over, OUTERMOST
    first. A flat 1-D mesh passes ('chips',); the multi-process mesh passes
    ('hosts', 'chips') — photon maps are then all-gathered in two hops:
    within a process over the 'chips' axis first, so each process assembles
    its local wave once, then across processes over the 'hosts' axis. Every
    device ends with the full map and queries it locally (replicated
    compute, no communication during gather)."""
    # linear chip id over the (possibly hierarchical) mesh, outer-major —
    # matches the tiled all_gather concatenation order below
    chip = jax.lax.axis_index(axes[0])
    for ax in axes[1:]:
        chip = chip * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)
    k_light, k_photon = jax.random.split(jax.random.fold_in(key, 1), 2)

    rays = generate_rays(camera, xy_s, lens_s, config.spp)
    rec = common.camera_pass(scene, rays.o, rays.d, config, rays=rays)
    # GLOBAL pixel-sample ids: light-sample uniforms are a pure function of
    # them, so the N-chip render draws the same numbers as 1-chip
    n_local = xy_s.shape[0]
    sample_ids = (
        chip.astype(jnp.uint32) * jnp.uint32(n_local)
        + jnp.arange(n_local, dtype=jnp.uint32)
    )
    direct = common.direct_lighting(
        scene, rec, k_light, config, light_samples,
        include_emitted=True, sample_ids=sample_ids,
    )

    n_local = xy_s.shape[0]
    state = photon_renderer.ProgressiveState(
        radius2=photon_renderer.initial_radius2(rec, config),
        photon_count=jnp.zeros((n_local,), jnp.float32),
        flux=jnp.zeros((n_local, 3), jnp.float32),
        emitted=jnp.zeros((n_local,), jnp.float32),
    )

    paths_local = max(1, config.photon_paths // n_chips)
    cfg_local = dataclasses.replace(config, photon_paths=paths_local)

    def gather_two_hop(x):
        # innermost axis first (within a process), then outward: tiled
        # all_gathers concatenate outer-major, matching `chip` above
        for ax in reversed(axes):
            x = jax.lax.all_gather(x, ax, tiled=True)
        return x

    def trace_gathered(p):
        # disjoint global photon-id slice per chip
        photons_local = photon_renderer.trace_photons(
            scene, cfg_local, k_photon, p, path_offset=chip * paths_local
        )
        return jax.tree_util.tree_map(gather_two_hop, photons_local)

    # SOFTWARE-PIPELINED waves: wave p's body STARTS the all_gather of its
    # freshly traced map, then runs the gather pass on wave p−1's map — the
    # collective has no consumer inside the step, so XLA's async collectives
    # can hide the transfer under the next trace+gather compute instead of
    # serializing on it. Each map is still gathered exactly once against
    # exactly the state it would have met sequentially, so results are
    # identical.
    def wave(carry, p):
        state, prev_map = carry
        new_map = trace_gathered(p)
        state, _ = photon_renderer.gathering_pass(
            scene, rec, state, prev_map, config
        )
        return (state, new_map), None

    if config.photon_passes > 1:
        map0 = trace_gathered(jnp.int32(0))
        (state, last_map), _ = jax.lax.scan(
            wave, (state, map0), jnp.arange(1, config.photon_passes)
        )
        state, _ = photon_renderer.gathering_pass(
            scene, rec, state, last_map, config
        )
    else:
        state, _ = photon_renderer.gathering_pass(
            scene, rec, state, trace_gathered(jnp.int32(0)), config
        )

    emitting = jnp.float32(paths_local * n_chips * config.photon_passes)
    return photon_renderer.final_gathering(rec, direct, state, emitting)


def render_photon_sharded(
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    key: Array,
    mesh: Mesh,
    jitter: bool = True,
) -> Array:
    """Sharded progressive photon render → [H, W, 3] image."""
    light_samples = common.static_light_samples(scene, config)
    return _render_sharded_jit(
        scene, camera, key, config, light_samples, jitter, mesh
    )


@partial(
    jax.jit, static_argnames=("config", "light_samples", "jitter", "mesh")
)
def _render_sharded_jit(
    scene: Scene,
    camera: PerspectiveCamera,
    key: Array,
    config: RenderConfig,
    light_samples: tuple,
    jitter: bool,
    mesh: Mesh,
) -> Array:
    n_chips = mesh.devices.size
    axes = tuple(mesh.axis_names)  # 1-D ('chips',) or ('hosts', 'chips')
    k_pix, k_render = jax.random.split(key)
    xy, lens = pixel_samples(
        k_pix, config.width, config.height, config.spp, jitter=jitter
    )
    assert xy.shape[0] % n_chips == 0, (
        f"pixel samples ({xy.shape[0]}) must divide the chip count {n_chips}"
    )

    shard_fn = jax.shard_map(
        partial(
            _radiance_shard,
            config=config,
            light_samples=light_samples,
            n_chips=n_chips,
            axes=axes,
        ),
        mesh=mesh,
        in_specs=(P(), P(), P(axes), P(axes), P()),
        out_specs=P(axes),
        # check_vma=True was tried (round 3): it rejects every lax.scan /
        # while_loop in the renderer whose carry init is a fresh jnp.full
        # (unvarying) while the body output varies with the sharded rays —
        # fixing it needs jax.lax.pvary on every loop init across
        # ops/renderers for no semantic change. The correctness net is the
        # equality tests instead: N-chip == 1-chip images AND gradients
        # (test_sharded.py), hierarchical == 1-chip, and the real
        # 2-process run (test_multihost.py) — any future transpose/psum
        # regression trips those.
        check_vma=False,
    )
    L = shard_fn(scene, camera, xy, lens, k_render)
    return film.splat(xy, L, config.width, config.height,
                      config.pixel_filter, config.filter_radius)


def train_step_sharded(
    params,
    target: Array,
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    key: Array,
    mesh: Mesh,
    lr: float = 0.05,
):
    """One inverse-rendering SGD step, sharded: forward renders with rays and
    photons split over chips; shard_map's transpose psums the parameter
    gradients during the backward sweep."""
    from raytrace_tpu.diff.render import apply_params

    light_samples = common.static_light_samples(scene, config)
    return _train_step_jit(
        params, target, scene, camera, key, config, light_samples, mesh, lr
    )


@partial(
    jax.jit,
    static_argnames=("config", "light_samples", "mesh", "lr"),
)
def _train_step_jit(
    params,
    target: Array,
    scene: Scene,
    camera: PerspectiveCamera,
    key: Array,
    config: RenderConfig,
    light_samples: tuple,
    mesh: Mesh,
    lr: float,
):
    from raytrace_tpu.diff.render import apply_params

    def loss_fn(p):
        img = _render_sharded_jit.__wrapped__(
            apply_params(scene, p), camera, key, config, light_samples,
            False, mesh,
        )
        return jnp.mean((img - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return loss, new_params
