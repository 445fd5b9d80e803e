"""Render the sphere+plane direct-lighting scene (BASELINE config[0]) and
write PNG/PFM output. Runs on JAX's default device (the GPU where there is
one); --cpu forces the CPU."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.renderers.simple import render_simple
from raytrace_tpu.scene import transform as tr
from raytrace_tpu.scene.builder import SceneBuilder
from raytrace_tpu.scene.camera import PerspectiveCamera
from raytrace_tpu.utils import image as img_util


def build_scene():
    b = SceneBuilder()
    m_floor = b.matte((0.7, 0.7, 0.7))
    m_ball = b.matte((0.6, 0.3, 0.2))
    verts = np.array([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                     np.float64)
    b.triangle_mesh(verts, [[0, 1, 2], [0, 2, 3]], material=m_floor)
    b.sphere(1.0, material=m_ball, object_to_world=tr.translate(0, 0, 1))
    b.point_light((3.0, -2.0, 5.0), (60.0, 60.0, 60.0))
    return b.build()


def main():
    print("devices:", jax.devices())
    scene = build_scene()
    c2w = tr.look_at((4.0, -4.0, 2.5), (0.0, 0.0, 1.0), (0.0, 0.0, 1.0))
    size = 256
    cam = PerspectiveCamera.make(c2w, 50.0, size, size)
    config = RenderConfig(width=size, height=size, spp=4, scene_epsilon=1e-3)

    t0 = time.perf_counter()
    img = render_simple(scene, cam, config, jax.random.PRNGKey(0))
    img = np.asarray(img)
    t1 = time.perf_counter()
    print(f"first render (incl. compile): {t1 - t0:.2f}s")

    t0 = time.perf_counter()
    img = np.asarray(render_simple(scene, cam, config, jax.random.PRNGKey(1)))
    t1 = time.perf_counter()
    rays = size * size * config.spp
    print(f"steady render: {t1 - t0:.3f}s  ({rays / (t1 - t0) / 1e6:.2f} Mrays/s primary)")

    img_util.write_png("/tmp/sphere_plane.png", img)
    img_util.write_pfm("/tmp/sphere_plane.pfm", img)
    print("wrote /tmp/sphere_plane.png  max=%.3f mean=%.4f" % (img.max(), img.mean()))


if __name__ == "__main__":
    main()
