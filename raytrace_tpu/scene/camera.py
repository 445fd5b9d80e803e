"""Perspective camera with ray differentials, fully vectorized.

The reference generates every camera ray differential on the CPU inside a
per-sample loop and uploads them (util/camera/pbrtcamera.cpp:91-112 — a
flagged hot host loop, SURVEY.md §3.4). Here ray generation is a batched JAX
function: all W×H×spp rays materialize on-device in one fused elementwise
pass. The math is pbrt-v2's PerspectiveCamera::GenerateRayDifferential
(raster→camera via the inverse projection, differentials shifted one pixel,
ScaleDifferentials(1/sqrt(spp)) per pbrtcamera.cpp:99), including lens
sampling for depth of field.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from raytrace_tpu.core import struct, vec


@struct.dataclass
class RayDifferentials:
    """SoA batch of camera rays (reference: CudaRayDifferential,
    util/common.cu.h:7-14)."""
    o: Array  # [N, 3]
    d: Array  # [N, 3]
    rx_o: Array  # [N, 3]
    rx_d: Array  # [N, 3]
    ry_o: Array  # [N, 3]
    ry_d: Array  # [N, 3]


@struct.dataclass
class PerspectiveCamera:
    raster_to_camera: Array  # [4, 4]
    camera_to_world: Array  # [3, 4]
    dx_camera: Array  # [3]
    dy_camera: Array  # [3]
    lens_radius: Array  # scalar
    focal_distance: Array  # scalar
    width: int = struct.field(pytree_node=False, default=256)
    height: int = struct.field(pytree_node=False, default=256)

    @staticmethod
    def make(
        camera_to_world: np.ndarray,
        fov_deg: float,
        width: int,
        height: int,
        lens_radius: float = 0.0,
        focal_distance: float = 1e6,
        screen_window: Optional[tuple] = None,
    ) -> "PerspectiveCamera":
        """Build from a pbrt-style LookAt camera-to-world 4x4 and fov.

        Reproduces pbrt-v2's ProjectiveCamera raster→screen→camera chain so
        images line up pixel-for-pixel with the CPU oracle.
        """
        aspect = width / height
        if screen_window is None:
            if aspect > 1.0:
                screen = (-aspect, aspect, -1.0, 1.0)
            else:
                screen = (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)
        else:
            screen = screen_window
        x0, x1, y0, y1 = screen

        # pbrt Perspective(fov, n, f) projection
        n_, f_ = 1e-2, 1000.0
        persp = np.array(
            [
                [1, 0, 0, 0],
                [0, 1, 0, 0],
                [0, 0, f_ / (f_ - n_), -f_ * n_ / (f_ - n_)],
                [0, 0, 1, 0],
            ],
            dtype=np.float64,
        )
        inv_tan = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
        s = np.diag([inv_tan, inv_tan, 1.0, 1.0])
        camera_to_screen = s @ persp

        screen_to_raster = (
            np.diag([width, height, 1.0, 1.0])
            @ np.diag([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0, 1.0])
            @ np.array(
                [[1, 0, 0, -x0], [0, 1, 0, -y1], [0, 0, 1, 0], [0, 0, 0, 1.0]]
            )
        )
        raster_to_camera = np.linalg.inv(camera_to_screen) @ np.linalg.inv(
            screen_to_raster
        )

        def r2c(p):
            q = raster_to_camera @ np.array([p[0], p[1], p[2], 1.0])
            return q[:3] / q[3]

        dx_cam = r2c((1, 0, 0)) - r2c((0, 0, 0))
        dy_cam = r2c((0, 1, 0)) - r2c((0, 0, 0))

        return PerspectiveCamera(
            raster_to_camera=jnp.asarray(raster_to_camera, jnp.float32),
            camera_to_world=jnp.asarray(
                np.asarray(camera_to_world, np.float64)[:3, :4], jnp.float32
            ),
            dx_camera=jnp.asarray(dx_cam, jnp.float32),
            dy_camera=jnp.asarray(dy_cam, jnp.float32),
            lens_radius=jnp.float32(lens_radius),
            focal_distance=jnp.float32(focal_distance),
            width=width,
            height=height,
        )


def spp_grid(spp: int) -> tuple[int, int]:
    """Factor spp into an (sx, sy) grid the way the reference folds spp into
    the 2-D launch extent (pbrtcamera.cpp:38-50)."""
    sx, sy = spp, 1
    while sx > sy and (sx & 1) == 0:
        sx //= 2
        sy *= 2
    return sx, sy


def pixel_samples(
    key: Array, width: int, height: int, spp: int, jitter: bool = True
) -> tuple[Array, Array]:
    """Stratified raster-space sample positions.

    Returns (image_xy [N,2], lens_uv [N,2]) with N = width*height*spp, laid
    out pixel-major so reshaping to [H, W, spp] is trivial.
    """
    sx, sy = spp_grid(spp)
    px, py, si = jnp.meshgrid(
        jnp.arange(width), jnp.arange(height), jnp.arange(spp), indexing="xy"
    )
    # strata within the pixel
    kx, ky = si % sx, si // sx
    if jitter:
        k1, k2 = jax.random.split(key)
        j = jax.random.uniform(k1, px.shape + (2,), dtype=jnp.float32)
        lens = jax.random.uniform(k2, px.shape + (2,), dtype=jnp.float32)
    else:
        j = jnp.full(px.shape + (2,), 0.5, jnp.float32)
        lens = jnp.full(px.shape + (2,), 0.5, jnp.float32)
    ix = px + (kx + j[..., 0]) / sx
    iy = py + (ky + j[..., 1]) / sy
    xy = jnp.stack([ix, iy], axis=-1).reshape(-1, 2)
    return xy.astype(jnp.float32), lens.reshape(-1, 2)


def generate_rays(
    camera: PerspectiveCamera, image_xy: Array, lens_uv: Array, spp: int
) -> RayDifferentials:
    """pbrt GenerateRayDifferential for a batch of raster samples."""
    from raytrace_tpu.core.sampling import concentric_sample_disk

    n = image_xy.shape[0]
    p_ras = jnp.concatenate(
        [image_xy, jnp.zeros((n, 1), image_xy.dtype), jnp.ones((n, 1), image_xy.dtype)],
        axis=-1,
    )
    # exact f32 (a GPU dot may run in TF32): broadcast-multiply-sum
    p_cam_h = jnp.sum(p_ras[:, None, :] * camera.raster_to_camera[None],
                      axis=-1)
    p_cam = p_cam_h[:, :3] / p_cam_h[:, 3:4]

    o_cam = jnp.zeros((n, 3), jnp.float32)
    d_cam = vec.normalize(p_cam)
    rx_d_cam = vec.normalize(p_cam + camera.dx_camera)
    ry_d_cam = vec.normalize(p_cam + camera.dy_camera)
    rx_o_cam = o_cam
    ry_o_cam = o_cam

    # Depth of field (pbrt perspective.cpp lens sampling)
    def with_lens(o, d):
        lx, ly = concentric_sample_disk(lens_uv[:, 0], lens_uv[:, 1])
        lens_p = camera.lens_radius * jnp.stack([lx, ly, jnp.zeros_like(lx)], -1)
        ft = camera.focal_distance / jnp.maximum(d[:, 2:3], 1e-8)
        p_focus = o + d * ft
        o2 = o + lens_p
        return o2, vec.normalize(p_focus - o2)

    use_lens = camera.lens_radius > 0.0
    o_cam2, d_cam2 = with_lens(o_cam, d_cam)
    rx_o2, rx_d2 = with_lens(rx_o_cam, rx_d_cam)
    ry_o2, ry_d2 = with_lens(ry_o_cam, ry_d_cam)
    o_cam = jnp.where(use_lens, o_cam2, o_cam)
    d_cam = jnp.where(use_lens, d_cam2, d_cam)
    rx_d_cam = jnp.where(use_lens, rx_d2, rx_d_cam)
    ry_d_cam = jnp.where(use_lens, ry_d2, ry_d_cam)
    rx_o_cam = jnp.where(use_lens, rx_o2, rx_o_cam)
    ry_o_cam = jnp.where(use_lens, ry_o2, ry_o_cam)

    c2w = camera.camera_to_world

    def to_world_p(p):
        return vec.transform_point(c2w, p)

    def to_world_v(v):
        return vec.transform_vector(c2w, v)

    o = to_world_p(o_cam)
    d = to_world_v(d_cam)
    rx_o = to_world_p(rx_o_cam)
    ry_o = to_world_p(ry_o_cam)
    rx_d = to_world_v(rx_d_cam)
    ry_d = to_world_v(ry_d_cam)

    # ScaleDifferentials(1/sqrt(spp)) (reference: pbrtcamera.cpp:99)
    s = jnp.float32(1.0 / math.sqrt(spp))
    rx_o = o + (rx_o - o) * s
    ry_o = o + (ry_o - o) * s
    rx_d = d + (rx_d - d) * s
    ry_d = d + (ry_d - d) * s

    return RayDifferentials(o=o, d=d, rx_o=rx_o, rx_d=rx_d, ry_o=ry_o, ry_d=ry_d)
