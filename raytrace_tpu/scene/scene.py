"""The scene as a pytree of SoA arrays.

The reference mirrors the parsed pbrt scene into an OptiX two-level node graph
(Group/GeometryGroup/GeometryInstance/Transform, cudarender.cpp:38-75) with
per-shape PTX programs. Here the graph is replaced with flat arrays per shape
family — triangles pre-transformed to world space like the
reference mesh path (cudatrianglemesh.cpp:28-31), disks flattened to a world
frame like the reference disk path (cudadisk.cpp:23-43), spheres kept in
object space behind an affine o2w/w2o pair like the reference Transform node
(cudasphere.cpp:16-40).

Every family is padded to a static size so the intersection kernels see fixed
shapes; padding prims carry mat = -1 and can never hit (degenerate geometry).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from raytrace_tpu.core import struct

# Material types (reference: util/common.cu.h:61-63)
MATTE, MIRROR, GLASS = 0, 1, 2
# Light types (reference: util/common.cu.h:48 declares POINT, AREA and
# DIRECTION; DIRECTION is declared-but-unimplemented there — here it is a
# real distant light: constant radiance along one direction, photons shot
# from a world-bounding disk, pbrt DistantLight semantics)
LIGHT_POINT, LIGHT_AREA_DISK, LIGHT_DISTANT = 0, 1, 2


@struct.dataclass
class Triangles:
    """World-space triangle soup with optional shading normals and UVs.

    (reference: cudatrianglemesh.{cpp,cu} — vertices pre-transformed to world,
    default UVs (0,0),(1,0),(0,1) when absent, shading normal interpolated.)
    """
    v0: Array  # [T, 3]
    v1: Array  # [T, 3]
    v2: Array  # [T, 3]
    n0: Array  # [T, 3] shading normals (geometric normal where absent)
    n1: Array  # [T, 3]
    n2: Array  # [T, 3]
    uv0: Array  # [T, 2]
    uv1: Array  # [T, 2]
    uv2: Array  # [T, 2]
    has_normals: Array  # [T] bool
    mat: Array  # [T] int32 material index, -1 = padding
    light: Array  # [T] int32 area-light index, -1 = none

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@struct.dataclass
class Spheres:
    """Full spheres intersected in object space (reference: cudasphere.cu:27-72;
    the o2w/w2o pair plays the reference's OptiX Transform node)."""
    o2w: Array  # [S, 3, 4] affine object→world
    w2o: Array  # [S, 3, 4] affine world→object
    radius: Array  # [S]
    mat: Array  # [S] int32
    light: Array  # [S] int32
    # pbrt ReverseOrientation: flip ng/ns at the hit (partials unchanged,
    # like pbrt). None = legacy scenes, no flip.
    flip: Array = None  # [S] bool

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@struct.dataclass
class Disks:
    """Disks flattened to a world frame exactly like the reference host setup
    (cudadisk.cpp:23-43): o = world center, x/y = radius-scaled world axes,
    z = unit normal, moffset = z·o, inv_r2 = 1/|x|², 1/|y|²."""
    o: Array  # [D, 3]
    x: Array  # [D, 3]
    y: Array  # [D, 3]
    z: Array  # [D, 3]
    moffset: Array  # [D]
    inv_r2: Array  # [D, 2]
    inner_radius: Array  # [D] normalized (innerRadius/radius)
    phi_max: Array  # [D]
    mat: Array  # [D] int32
    light: Array  # [D] int32

    @property
    def count(self) -> int:
        return self.moffset.shape[0]


@struct.dataclass
class Materials:
    """Tagged material table (reference: util/material/cudamaterial.{h,cpp} —
    Matte/Mirror/Glass with a single constant spectrum parameter)."""
    mtype: Array  # [M] int32: MATTE | MIRROR | GLASS
    kd: Array  # [M, 3] matte albedo or mirror reflectance Kr
    eta: Array  # [M] glass IOR (reference hard-codes 1.5, cudamaterial.cu.h:118)
    # texture seam (the reference's placeholder evaluation point,
    # util/texture/cudatexture.cu.h:7-9, returns a constant — here a real
    # per-material hook): 0 = constant kd, 1 = checker (kd modulated by
    # TEX_CHECKER_LO on odd cells of a tex_scale × tex_scale uv grid)
    tex_type: Array = None  # [M] int32
    tex_scale: Array = None  # [M] f32


@struct.dataclass
class Lights:
    """Flattened light table (reference: CudaLightDevice, common.cu.h:47-59).

    DISTANT lights reuse the same fields: o = world-bounding-sphere center,
    p1/p2 = world-radius-scaled frame ⊥ the travel direction (the photon
    launch disk), normal = unit travel direction, area = π·world_radius²."""
    ltype: Array  # [L] int32: LIGHT_POINT | LIGHT_AREA_DISK | LIGHT_DISTANT
    o: Array  # [L, 3] position / disk center
    p1: Array  # [L, 3] disk axis 1 (radius-scaled)
    p2: Array  # [L, 3] disk axis 2
    normal: Array  # [L, 3]
    area: Array  # [L]
    intensity: Array  # [L, 3]
    n_samples: Array  # [L] int32 illumination samples per light

    @property
    def count(self) -> int:
        return self.ltype.shape[0]


@struct.dataclass
class Scene:
    tris: Triangles
    spheres: Spheres
    disks: Disks
    materials: Materials
    lights: Lights
    # Optional flattened BVH over `tris` (ops/bvh.py). When present, the
    # triangle arrays are stored in BVH leaf order and intersection goes
    # through wavefront traversal instead of the brute-force scan — the
    # stand-in for the reference's OptiX "Sbvh" acceleration
    # (cudarender.cpp:44-50). None = brute force (small scenes).
    bvh: object = None

    def with_materials(self, materials: Materials) -> "Scene":
        return self.replace(materials=materials)

    def with_lights(self, lights: Lights) -> "Scene":
        return self.replace(lights=lights)


def empty_triangles(n: int = 0) -> Triangles:
    """Empty (0-length) triangle family: intersect() skips zero-count
    families entirely (static shapes), so an absent family costs nothing —
    no padding primitive needed."""
    far = jnp.full((n, 3), 1e30, dtype=jnp.float32)
    z2 = jnp.zeros((n, 2), dtype=jnp.float32)
    up = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], jnp.float32), (max(n, 1), 1))[:n]
    return Triangles(
        v0=far, v1=far, v2=far, n0=up, n1=up, n2=up,
        uv0=z2, uv1=z2, uv2=z2,
        has_normals=jnp.zeros((n,), bool),
        mat=jnp.full((n,), -1, jnp.int32),
        light=jnp.full((n,), -1, jnp.int32),
    )


def empty_spheres() -> Spheres:
    """0-length sphere family — intersect() skips it statically."""
    eye = jnp.zeros((0, 3, 4), dtype=jnp.float32)
    return Spheres(
        o2w=eye, w2o=eye,
        radius=jnp.zeros((0,), jnp.float32),
        mat=jnp.zeros((0,), jnp.int32),
        light=jnp.zeros((0,), jnp.int32),
        flip=jnp.zeros((0,), bool),
    )


def empty_disks() -> Disks:
    """0-length disk family — intersect() skips it statically."""
    z3 = jnp.zeros((0, 3), dtype=jnp.float32)
    return Disks(
        o=z3, x=z3, y=z3, z=z3,
        moffset=jnp.zeros((0,), jnp.float32),
        inv_r2=jnp.zeros((0, 2), jnp.float32),
        inner_radius=jnp.zeros((0,), jnp.float32),
        phi_max=jnp.zeros((0,), jnp.float32),
        mat=jnp.zeros((0,), jnp.int32),
        light=jnp.zeros((0,), jnp.int32),
    )
