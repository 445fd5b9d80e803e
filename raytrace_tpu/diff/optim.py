"""Inverse-rendering optimization (BASELINE config[3]: recover albedo /
emitter power from a target image).

The raw scene parameters live on very different scales (albedo kd ∈ (0, 1),
emitter intensity ~30) and are positively constrained, so naive SGD on
`SceneParams` needs hand-tuned per-parameter learning rates and can diverge.
The principled setup used here:

  - optimize in an unconstrained transformed space — kd through a logit
    (sigmoid keeps albedo in (0, 1)), intensity through a log (exp keeps
    emission positive and makes the step size relative, i.e. scale-free);
  - Adam (optax) on the transformed parameters, which normalizes away the
    remaining gradient-magnitude differences between parameter groups.

The reference has no differentiable or optimization path at all
(SURVEY.md §0); this subsystem is a BASELINE.json requirement.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax import Array

from raytrace_tpu.core import struct
from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.diff.render import SceneParams, render_image_from_params
from raytrace_tpu.renderers import common
from raytrace_tpu.scene.camera import PerspectiveCamera
from raytrace_tpu.scene.scene import Scene

_EPS = 1e-6


@struct.dataclass
class TransformedParams:
    """Unconstrained reparameterization of SceneParams."""
    kd_logit: Array       # kd = sigmoid(kd_logit) ∈ (0, 1)
    log_intensity: Array  # intensity = exp(log_intensity) > 0


def to_transformed(params: SceneParams) -> TransformedParams:
    kd = jnp.clip(params.kd, _EPS, 1.0 - _EPS)
    return TransformedParams(
        kd_logit=jnp.log(kd) - jnp.log1p(-kd),
        log_intensity=jnp.log(jnp.maximum(params.intensity, _EPS)),
    )


def from_transformed(t: TransformedParams) -> SceneParams:
    return SceneParams(
        kd=jax.nn.sigmoid(t.kd_logit),
        intensity=jnp.exp(t.log_intensity),
    )


@partial(
    jax.jit,
    static_argnames=("config", "light_samples", "jitter", "optimizer"),
)
def _fit_step(
    t_params: TransformedParams,
    opt_state,
    target: Array,
    scene: Scene,
    camera: PerspectiveCamera,
    key: Array,
    config: RenderConfig,
    light_samples: tuple,
    jitter: bool,
    optimizer,
):
    def loss_fn(tp):
        img = render_image_from_params(
            from_transformed(tp), scene, camera, config, key, light_samples,
            jitter,
        )
        return jnp.mean((img - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(t_params)
    updates, opt_state = optimizer.update(grads, opt_state, t_params)
    t_params = optax.apply_updates(t_params, updates)
    return t_params, opt_state, loss


def fit(
    params0: SceneParams,
    target: Array,
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    key: Array,
    steps: int = 20,
    lr: float = 0.1,
    jitter: bool = False,
    light_samples: tuple | None = None,
) -> tuple[SceneParams, list[float]]:
    """Gradient-descent recovery of scene parameters from a target image.

    Returns (recovered SceneParams, per-step loss history). One compile: the
    step function is jitted once and reused across iterations.
    """
    if light_samples is None:
        light_samples = common.static_light_samples(scene, config)
    optimizer = optax.adam(lr)
    t_params = to_transformed(params0)
    opt_state = optimizer.init(t_params)
    losses = []
    for _ in range(steps):
        t_params, opt_state, loss = _fit_step(
            t_params, opt_state, target, scene, camera, key, config,
            light_samples, jitter, optimizer,
        )
        losses.append(float(loss))
    return from_transformed(t_params), losses
