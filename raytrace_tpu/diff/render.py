"""Differentiable rendering: `render(params) → image` with gradients through
shading, photon transport, and gathering.

Nothing in the reference is differentiable (SURVEY.md §0); this is a
BASELINE.json requirement. The design (SURVEY.md §7):
  - hit-finding (intersection geometry) is non-differentiable bookkeeping —
    positions/normals pass through `stop_gradient`;
  - radiance is smooth in material albedo (kd), mirror reflectance (kr) and
    emitter power given fixed hit points — standard reverse-mode AD flows
    through direct lighting, photon alpha products, the hash-grid gather
    (index gathers are linear in the gathered values), and the film splat;
  - the PPM radius/count statistics are detached (they rescale both flux and
    its normalization — treating them as constants keeps the estimator's
    gradient unbiased in the same sense as the primal);
  - visibility/geometry gradients need edge-sampling reparameterization and
    are layered separately (BASELINE north star; see diff/edges.py when it
    lands).

Parameters are exposed as a small pytree over the scene tables so optimizers
(optax) can treat them like model weights.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from raytrace_tpu.core import struct
from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.renderers import photon as photon_renderer
from raytrace_tpu.scene.camera import PerspectiveCamera
from raytrace_tpu.scene.scene import Scene


@struct.dataclass
class SceneParams:
    """The differentiable knobs (BASELINE config[3]: albedo + emitter power)."""
    kd: Array  # [M, 3] matte albedo / mirror Kr
    intensity: Array  # [L, 3] light emission


def extract_params(scene: Scene) -> SceneParams:
    return SceneParams(kd=scene.materials.kd, intensity=scene.lights.intensity)


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    return scene.replace(
        materials=scene.materials.replace(kd=params.kd),
        lights=scene.lights.replace(intensity=params.intensity),
    )


def render_image_from_params(
    params: SceneParams,
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    key: Array,
    light_samples: tuple,
    jitter: bool = True,
) -> Array:
    """Differentiable photon render. `config.differentiable` must be True so
    the wavefront walks use bounded (transposable) loops."""
    scene = apply_params(scene, params)
    img, _ = photon_renderer._render_photon(
        scene, camera, key, config, light_samples, jitter
    )
    return img


@partial(jax.jit, static_argnames=("config", "light_samples", "jitter"))
def loss_and_grad(
    params: SceneParams,
    target: Array,
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    key: Array,
    light_samples: tuple,
    jitter: bool = True,
):
    """MSE image loss + gradient w.r.t. the scene parameters — the inner step
    of inverse rendering (BASELINE config[3])."""

    def loss_fn(p):
        img = render_image_from_params(
            p, scene, camera, config, key, light_samples, jitter
        )
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)
