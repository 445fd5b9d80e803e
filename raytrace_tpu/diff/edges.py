"""Visibility (geometry) gradients via shadow-boundary edge sampling — the
first slice of the BASELINE north star's "reparameterized edge sampling".

Pathwise AD through the renderer sees no geometry gradients: visibility is a
step function of occluder position, so d(image)/d(occluder θ) is a boundary
integral that point-sampling misses (SURVEY.md §7 hard part 3). Following
the boundary-integral formulation of differentiable rendering (Li et al.
2018, "Differentiable Monte Carlo Ray Tracing through Edge Sampling" —
re-derived here for the point-light shadow case, no code reused):

    dI_pixel/dθ = ∮_{shadow boundary} ΔL(x) · (v(x)·n_s(x)) dl

where the shadow boundary on a receiver is the projection of the occluder's
silhouette edges from the light, ΔL is the radiance jump across it (the
direct contribution of the light on the lit side), v = dx/dθ is the boundary
velocity induced by the parameter, and n_s is the in-surface normal of the
boundary curve oriented toward the shadow side.

Scope of this slice (deliberate):
  - point lights (the delta light makes the boundary a sharp curve);
  - caller-supplied occluder edge list + edge velocity (silhouette
    extraction for closed meshes layers on later — for a flat occluder the
    silhouette IS its boundary edge loop);
  - matte receivers (ΔL = kd/π · cosθ_l · I/r²).

The estimator is validated against central differences of the full jittered
render in tests/test_edges.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from raytrace_tpu.core import vec
from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.ops import intersect as isect_ops
from raytrace_tpu.scene.camera import PerspectiveCamera
from raytrace_tpu.scene.scene import Scene
from raytrace_tpu.shading import material as mat_ops

BIG = isect_ops.BIG


def project_to_raster(camera: PerspectiveCamera, p: Array) -> Array:
    """World points [N, 3] → raster coordinates [N, 2] (the inverse of the
    camera's raster→camera→world ray chain, scene/camera.py)."""
    c2w = camera.camera_to_world  # [3, 4] affine
    r = c2w[:, :3]
    t = c2w[:, 3]
    # broadcast-multiply-sums keep these exact f32 (a GPU dot may use TF32)
    p_cam = jnp.sum((p - t)[:, :, None] * r[None], axis=1)  # R^T (p - t)
    c2r = jnp.linalg.inv(camera.raster_to_camera)
    ph = jnp.concatenate([p_cam, jnp.ones_like(p_cam[:, :1])], axis=-1)
    ph = jnp.sum(ph[:, None, :] * c2r[None], axis=-1)
    return ph[:, :2] / ph[:, 3:4]


@partial(jax.jit, static_argnames=("config", "samples_per_edge",
                                   "area_light"))
def shadow_boundary_image_grad(
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    edge_v0: Array,   # [E, 3] silhouette edge start points
    edge_v1: Array,   # [E, 3] silhouette edge end points
    edge_vel: Array,  # [3] rigid d(edge point)/dθ, [E, 3] per edge, or
                      # [E, 2, 3] per edge ENDPOINT (lerped along the edge
                      # — the exact velocity of a per-vertex deformation
                      # field; see jacobian_loss_and_grad)
    light_index: int = 0,
    samples_per_edge: int = 64,
    edge_mask: Array | None = None,  # [E] bool: which edges are silhouette
    occluder_aabb: tuple[Array, Array] | None = None,
    light_point: Array | None = None,  # [3] override (area-light sample)
    area_light: bool = False,  # ΔL uses the area-light measure (see below)
    weight: Array | float = 1.0,  # scales ΔL (1/N light samples)
) -> Array:
    """d(image)/dθ for an occluder translation, via shadow-boundary edge
    sampling → [H, W, 3] (the derivative of each pixel's area-averaged
    radiance). Deterministic: edges are sampled at stratified midpoints.

    edge_mask supports static-shape mesh silhouettes (silhouette_edges):
    masked-out edges contribute exactly zero.

    occluder_aabb=(lo, hi): when the occluder is IN VIEW, boundary points
    must be excluded in two cases the out-of-view geometry never hits —
      1. the projected boundary lands on the occluder ITSELF (its own
         terminator): the receiver then moves WITH the parameter, the
         relative boundary velocity is ~0, and the naive static-receiver
         formula produces a large spurious term. Points inside the
         (slightly inflated) AABB are dropped.
      2. the receiver point is hidden from the CAMERA (e.g. the shadow
         region directly behind the occluder): it contributes nothing to
         the image. A camera-visibility ray test drops these whenever an
         AABB is supplied (out-of-view callers can omit it and skip the
         extra intersection pass).
    """
    lp = (scene.lights.o[light_index] if light_point is None
          else light_point)
    E = edge_v0.shape[0]
    K = samples_per_edge
    ts = (jnp.arange(K, dtype=jnp.float32) + 0.5) / K

    e = (edge_v0[:, None, :] * (1.0 - ts)[None, :, None]
         + edge_v1[:, None, :] * ts[None, :, None]).reshape(E * K, 3)
    edot = jnp.broadcast_to(
        (edge_v1 - edge_v0)[:, None, :], (E, K, 3)).reshape(E * K, 3)
    n = e.shape[0]
    if edge_mask is None:
        sample_mask = jnp.ones((n,), bool)
    else:
        sample_mask = jnp.repeat(edge_mask, K)
    if jnp.ndim(edge_vel) == 3:
        # per-endpoint velocities [E, 2, 3] → lerped at each edge sample
        # (matches e = lerp(v0, v1, t): a vertex deformation field moves
        # the sample by exactly this interpolant)
        edge_vel = (
            edge_vel[:, 0, None, :] * (1.0 - ts)[None, :, None]
            + edge_vel[:, 1, None, :] * ts[None, :, None]
        ).reshape(E * K, 3)
    elif jnp.ndim(edge_vel) == 2:
        edge_vel = jnp.repeat(edge_vel, K, axis=0)  # [E*K, 3]

    # ---- project each edge sample from the light onto the receiver --------
    w = e - lp
    t_e = vec.length(w)
    w_hat = w / jnp.maximum(t_e, 1e-12)[:, None]
    eps = jnp.float32(config.scene_epsilon)
    hit = isect_ops.intersect(
        scene, jnp.broadcast_to(lp, (n, 3)), w_hat,
        t_e * (1.0 + 1e-4) + eps, jnp.full((n,), BIG),
    )
    x_b = hit.p
    n_r = vec.normalize(hit.ns)

    # ---- boundary velocity + curve direction on the receiver plane --------
    # x_b(θ) = lp + τ(θ)·(e(θ) - lp) constrained to the receiver plane:
    #   τ = n_r·(x_b - lp) / n_r·(e - lp)
    #   dx_b/dθ = τ [u - (n_r·u)/(n_r·(e-lp)) (e-lp)]     (u = edge velocity)
    # and the same with u → ė for the curve direction.
    denom = vec.dot(n_r, e - lp)
    safe_denom = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    tau = vec.dot(n_r, x_b - lp) / safe_denom
    u = jnp.broadcast_to(edge_vel, (n, 3))  # [3] rigid or [E*K, 3] per edge
    in_plane = lambda a: tau[:, None] * (
        a - (vec.dot(n_r, a) / safe_denom)[:, None] * (e - lp)
    )
    v_b = in_plane(u)
    m = in_plane(edot)
    m_len = vec.length(m)
    m_hat = m / jnp.maximum(m_len, 1e-12)[:, None]
    n_c = vec.normalize(vec.cross(n_r, m_hat))  # in-plane curve normal

    # ---- orient n_c toward the shadow side (probe both sides) -------------
    delta = 1e-3 * jnp.maximum(t_e, 1.0)
    probe = lambda x: isect_ops.occluded(
        scene, x, lp - x,
        jnp.full((n,), jnp.float32(config.shadow_epsilon)),
        jnp.full((n,), 1.0 - jnp.float32(config.shadow_epsilon)),
    )
    sh_plus = probe(x_b + delta[:, None] * n_c)
    sh_minus = probe(x_b - delta[:, None] * n_c)
    is_boundary = sh_plus != sh_minus  # exactly one side in shadow
    n_s = jnp.where(sh_plus[:, None], n_c, -n_c)  # points INTO the shadow

    # ---- radiance jump across the boundary (lit-side direct term) ---------
    wl = lp - x_b
    r2 = jnp.maximum(vec.length_squared(wl), 1e-12)
    wl_hat = wl / jnp.sqrt(r2)[:, None]
    f = mat_ops.f(scene.materials, hit.mat, wl_hat, wl_hat)
    cos_l = vec.absdot(n_r, wl_hat)
    intensity = scene.lights.intensity[light_index]
    if area_light:
        # one light-area sample y = light_point of an area light: the
        # estimator's per-sample direct term is f·cosθ_x·Le·cosθ_y·A/r²
        # (illumination-sampling measure of shading/light.sample_L_illum —
        # li = Le, pdf = r²/(cosθ_y·A)); `weight` carries the 1/N of the
        # light-sample average
        n_l = scene.lights.normal[light_index]
        cos_y = jnp.maximum(-vec.dot(
            jnp.broadcast_to(n_l, wl_hat.shape), wl_hat), 0.0)
        area = scene.lights.area[light_index]
        dL = f * (cos_l * cos_y * area / r2)[:, None] * intensity
    else:
        dL = f * (cos_l / r2)[:, None] * intensity  # [n, 3]
    dL = dL * weight

    # ---- move the integral to IMAGE space -----------------------------------
    # Pixels average radiance over unit raster area, so the boundary
    # integral must be taken in raster coordinates: push the curve tangent
    # (m), the boundary velocity (v_b) and the shadow-side normal (n_s)
    # through the projection Jacobian with exact JVPs.
    proj = lambda p: project_to_raster(camera, p)
    xy, jm = jax.jvp(proj, (x_b,), (m,))
    _, jv = jax.jvp(proj, (x_b,), (v_b,))
    _, jn = jax.jvp(proj, (x_b,), (n_s,))
    jm_len = jnp.sqrt(jnp.maximum(jnp.sum(jm * jm, -1), 1e-20))
    jm_hat = jm / jm_len[:, None]
    # in-image unit normal of the raster curve, oriented toward the shadow
    perp = jnp.stack([-jm_hat[:, 1], jm_hat[:, 0]], axis=-1)
    sgn = jnp.sign(jnp.sum(perp * jn, axis=-1))
    n_im = perp * sgn[:, None]

    # lit region grows where the boundary moves INTO the shadow
    speed_im = jnp.sum(jv * n_im, axis=-1)
    scale = speed_im * jm_len / K  # dl_image = |J·m| dt, dt = 1/K
    ok = hit.valid & is_boundary & (jnp.abs(denom) > 1e-9) & sample_mask
    if occluder_aabb is not None:
        lo, hi = occluder_aabb
        margin = 1e-3
        on_occluder = jnp.all(
            (x_b > lo[None, :] - margin) & (x_b < hi[None, :] + margin),
            axis=-1,
        )
        cam_o = camera.camera_to_world[:, 3]
        cam_hidden = isect_ops.occluded(
            scene, jnp.broadcast_to(cam_o, (n, 3)), x_b - cam_o,
            jnp.full((n,), jnp.float32(config.shadow_epsilon)),
            jnp.full((n,), 1.0 - jnp.float32(config.shadow_epsilon)),
        )
        ok = ok & ~on_occluder & ~cam_hidden
    contrib = jnp.where(ok[:, None], dL * scale[:, None], 0.0)

    # ---- splat into pixel derivative (pixel mean over unit raster area) ----
    px = jnp.floor(xy[:, 0]).astype(jnp.int32)
    py = jnp.floor(xy[:, 1]).astype(jnp.int32)
    in_view = (
        (px >= 0) & (px < config.width) & (py >= 0) & (py < config.height)
    )
    flat = jnp.clip(py, 0, config.height - 1) * config.width + jnp.clip(
        px, 0, config.width - 1
    )
    contrib = jnp.where(in_view[:, None], contrib, 0.0)
    dimg = jnp.zeros((config.height * config.width, 3), jnp.float32)
    dimg = dimg.at[flat].add(contrib)
    return dimg.reshape(config.height, config.width, 3)


def area_shadow_boundary_image_grad(
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    verts: Array,     # occluder mesh vertices (traced — moving occluder)
    faces,            # [F, 3] static topology
    edge_vel: Array,  # [3] rigid d(edge point)/dθ
    light_index: int = 0,
    samples_per_edge: int = 64,
    n_light_samples: int = 8,
    occluder_aabb: tuple[Array, Array] | None = None,
) -> Array:
    """PENUMBRA visibility gradient — d(image)/dθ for an occluder under a
    DISK AREA light (the reference's main emitter geometry,
    util/light/cudalight.cpp:26-59).

    The soft shadow is ∫_A V(x, y)·(direct term) dy; visibility V is a step
    in θ for each fixed light point y, so the θ-derivative is the AVERAGE
    over light points of the sharp-shadow boundary integral with the
    occluder silhouette extracted w.r.t. each y:

        dI/dθ = (1/N) Σ_j ∮_{silhouette(y_j) proj} ΔL_j (v·n) dl

    Light points are a stratified concentric-disk grid (deterministic).
    Validated against central differences of the soft-shadow render in
    tests/test_penumbra.py."""
    from raytrace_tpu.core.sampling import concentric_sample_disk

    # static edge topology on the host; per-light-point silhouette masks
    # under jit (verts may be traced — a moving occluder)
    edge_vid, edge_fid = mesh_edge_adjacency(np.asarray(faces))
    faces_j = jnp.asarray(np.asarray(faces), jnp.int32)
    edge_fid_j = jnp.asarray(edge_fid)
    verts = jnp.asarray(verts, jnp.float32)
    ev0 = verts[edge_vid[:, 0]]
    ev1 = verts[edge_vid[:, 1]]

    o = scene.lights.o[light_index]
    p1 = scene.lights.p1[light_index]
    p2 = scene.lights.p2[light_index]
    # gu × gv stratification with gu·gv == N (gu = largest divisor ≤ √N),
    # so every stratum is covered exactly once — a ceil(√N) grid with only
    # N cells filled leaves the top row partially covered and biases the
    # deterministic disk quadrature direction (ADVICE r4)
    N = n_light_samples
    gu = int(np.floor(np.sqrt(N)))
    while N % gu:
        gu -= 1
    gv = N // gu
    jj = jnp.arange(N, dtype=jnp.float32)
    u1 = ((jj % gu) + 0.5) / gu
    u2 = ((jj // gu) + 0.5) / gv
    dx, dy = concentric_sample_disk(u1, u2)
    ys = o[None, :] + dx[:, None] * p1[None, :] + dy[:, None] * p2[None, :]

    def one(dimg, y):
        mask = silhouette_mask(verts, faces_j, edge_fid_j, y)
        d = shadow_boundary_image_grad(
            scene, camera, config, ev0, ev1, edge_vel,
            light_index=light_index, samples_per_edge=samples_per_edge,
            edge_mask=mask, occluder_aabb=occluder_aabb,
            light_point=y, area_light=True, weight=1.0 / N,
        )
        return dimg + d, None

    init = jnp.zeros((config.height, config.width, 3), jnp.float32)
    dimg, _ = jax.lax.scan(one, init, ys)
    return dimg


def quad_boundary_edges(corners) -> tuple[Array, Array]:
    """The 4 boundary edges of a quad occluder (its silhouette w.r.t. any
    light not in its plane). corners: [4, 3] in loop order."""
    c = jnp.asarray(corners, jnp.float32)
    v0 = c
    v1 = jnp.roll(c, -1, axis=0)
    return v0, v1


# ---------------------------------------------------------------------------
# Silhouette extraction for triangle meshes (closed or open).
#
# The silhouette of a mesh w.r.t. a viewpoint (a point light for shadow
# boundaries, the camera origin for primary-visibility boundaries) is the set
# of edges whose two adjacent faces face OPPOSITE sides of the viewpoint —
# plus open-boundary edges whose single face is front-facing. Adjacency is
# static (host numpy, built once per topology); the facing test runs under
# jit so vertex positions may be traced (moving occluders).
# ---------------------------------------------------------------------------


def mesh_edge_adjacency(faces) -> tuple:
    """Static edge topology of a triangle mesh. faces: [F, 3] int.

    Returns (edge_vid [E, 2] int32, edge_fid [E, 2] int32) — unique
    undirected edges and their adjacent faces (second face −1 for open
    boundary edges). Non-manifold edges (>2 faces) keep the first two."""
    import numpy as np

    faces = np.asarray(faces, np.int64)
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    fid = np.tile(np.arange(len(faces)), 3)
    key = np.sort(e, axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    # grouped assignment of the first two face ids per unique edge, fully
    # vectorized (a Python loop over 3F half-edges is pathological at
    # mesh scale — 4M tris → 12M interpreter iterations)
    order = np.argsort(inv, kind="stable")
    inv_s, fid_s = inv[order], fid[order]
    first = np.concatenate([[True], inv_s[1:] != inv_s[:-1]])
    rank = np.arange(len(inv_s)) - np.maximum.accumulate(
        np.where(first, np.arange(len(inv_s)), -1)
    )
    edge_fid = np.full((len(uniq), 2), -1, np.int64)
    keep = rank < 2  # non-manifold edges (>2 faces) keep the first two
    edge_fid[inv_s[keep], rank[keep]] = fid_s[keep]
    return uniq.astype("int32"), edge_fid.astype("int32")


def silhouette_mask(
    verts: Array, faces: Array, edge_fid: Array, viewpoint: Array
) -> Array:
    """[E] bool: edge is on the silhouette w.r.t. `viewpoint` — its adjacent
    faces flip facing sign, or it is an open-boundary edge of a front-facing
    face. Runs under jit (verts may be traced)."""
    v0 = verts[faces[:, 0]]
    n_f = vec.cross(verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0)
    front = vec.dot(n_f, viewpoint[None, :] - v0) > 0.0  # [F]
    f0 = edge_fid[:, 0]
    f1 = edge_fid[:, 1]
    open_edge = f1 < 0
    fr0 = front[jnp.maximum(f0, 0)]
    fr1 = front[jnp.maximum(f1, 0)]
    return jnp.where(open_edge, fr0, fr0 != fr1)


def silhouette_edges_full(
    verts, faces, viewpoint
) -> tuple[Array, Array, Array, Array]:
    """→ (edge_v0 [E, 3], edge_v1 [E, 3], mask [E], front_normal [E, 3]).

    front_normal is the unit normal of each edge's FRONT-facing adjacent
    face (the surface a viewer at `viewpoint` sees at the silhouette) —
    what primary_boundary_image_grad shades instead of re-intersecting a
    grazing ray (which misses the edge ~half the time in float32).

    Static shape: ALL mesh edges are returned with a boolean silhouette
    mask, so the result jits cleanly for a moving mesh (the mask changes,
    the shapes don't)."""
    verts = jnp.asarray(verts, jnp.float32)
    faces_j = jnp.asarray(faces, jnp.int32)
    viewpoint = jnp.asarray(viewpoint, jnp.float32)
    edge_vid, edge_fid = mesh_edge_adjacency(faces)
    edge_fid_j = jnp.asarray(edge_fid)
    mask = silhouette_mask(verts, faces_j, edge_fid_j, viewpoint)

    v0f = verts[faces_j[:, 0]]
    n_f = vec.normalize(
        vec.cross(verts[faces_j[:, 1]] - v0f, verts[faces_j[:, 2]] - v0f)
    )
    front = vec.dot(n_f, viewpoint[None, :] - v0f) > 0.0
    f0 = jnp.maximum(edge_fid_j[:, 0], 0)
    f1 = jnp.maximum(edge_fid_j[:, 1], 0)
    pick0 = front[f0] | (edge_fid_j[:, 1] < 0)
    front_n = jnp.where(pick0[:, None], n_f[f0], n_f[f1])
    return verts[edge_vid[:, 0]], verts[edge_vid[:, 1]], mask, front_n


def silhouette_edges(verts, faces, viewpoint) -> tuple[Array, Array, Array]:
    """silhouette_edges_full without the front normals."""
    v0, v1, mask, _ = silhouette_edges_full(verts, faces, viewpoint)
    return v0, v1, mask


def translation_loss_and_grad(
    theta,
    direction,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Array,
    key,
    light_index: int = 0,
    samples_per_edge: int = 128,
    jitter: bool = True,
    render=None,
):
    """Geometry-parameter inverse rendering: MSE image loss + d(loss)/dθ for
    an occluder translated by θ·direction, where the image depends on θ ONLY
    through visibility (shadow boundaries) — the gradient pathwise AD returns
    zero for (SURVEY.md §7 hard part 3; diff/render.loss_and_grad covers the
    smooth material/emitter parameters, this covers the boundary term).

        dL/dθ = Σ_pixels ∂L/∂I · dI/dθ,   dI/dθ = shadow-boundary integral

    with the mesh silhouette extracted w.r.t. the light at the CURRENT θ
    (silhouette_edges — static shapes, so the render and the boundary
    estimator both jit across optimization steps).

    build_scene: verts → Scene (host callback; retraces only if topology
    changes). render: optional (scene, camera, config, key, jitter) → image;
    defaults to the simple renderer.

    Returns (loss [scalar], dloss_dtheta [scalar], image).
    """
    from raytrace_tpu.renderers.simple import render_simple

    render = render or (
        lambda s, c, cfg, k, j: render_simple(s, c, cfg, k, jitter=j)
    )
    direction = jnp.asarray(direction, jnp.float32)
    verts = jnp.asarray(base_verts, jnp.float32) + theta * direction
    scene = build_scene(verts)
    img = render(scene, camera, config, key, jitter)
    n_px = img.size
    loss = jnp.mean((img - target) ** 2)

    lp = scene.lights.o[light_index]
    v0, v1, mask = silhouette_edges(verts, faces, lp)
    dimg = shadow_boundary_image_grad(
        scene, camera, config, v0, v1, direction,
        light_index=light_index, samples_per_edge=samples_per_edge,
        edge_mask=mask,
    )
    dloss = jnp.sum(2.0 * (img - target) * dimg) / n_px
    return loss, dloss, img


def joint_loss_and_grad(
    params,
    theta,
    direction,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Array,
    key,
    light_index: int = 0,
    samples_per_edge: int = 128,
    n_light_samples: int = 8,
    jitter: bool = True,
    include_primary: bool = False,
    render=None,
):
    """ONE differentiable loss over material AND geometry parameters —
    pathwise AD for the smooth terms (albedo kd, emitter intensity) summed
    with the boundary visibility term for the occluder translation θ
    (VERDICT r3 #4: round 3 kept the boundary estimator in a parallel
    entry point and covered point lights only).

        L(params, θ) = mean‖render(params, θ) − target‖²
        ∂L/∂params   = pathwise reverse-mode AD (visibility fixed)
        ∂L/∂θ        = Σ_px 2(I−target)·dI/dθ,  dI/dθ = boundary integral
                       — PENUMBRA (area-disk light) or sharp (point light),
                       dispatched on the scene's light type, plus the
                       optional primary-visibility silhouette term.

    The pathwise θ-gradient through the renderer is ~0 by design (hit
    geometry passes through stop_gradient), so the boundary term IS the
    θ-gradient; conversely the boundary integrand's ΔL depends on params
    only through a lower-order product term that pathwise AD already
    captures in expectation — the two terms sum without double counting.

    build_scene: verts → Scene (host callback). render: optional
    (scene, camera, config, key, jitter) → image; defaults to the simple
    renderer (direct lighting — the estimator's scope).

    Returns (loss, g_params, g_theta, image).
    """
    import dataclasses

    from raytrace_tpu.diff.render import apply_params
    from raytrace_tpu.renderers.simple import render_simple
    from raytrace_tpu.scene.scene import LIGHT_AREA_DISK

    render = render or (
        lambda s, c, cfg, k, j: render_simple(s, c, cfg, k, jitter=j)
    )
    direction = jnp.asarray(direction, jnp.float32)
    verts = jnp.asarray(base_verts, jnp.float32) + theta * direction
    scene0 = build_scene(verts)

    # the pathwise term differentiates THROUGH the renderer — force the
    # differentiable config (record-and-replay walks; the simple path's
    # atten now feeds the image, and reverse-mode through the
    # non-differentiable early-exit while_loop is unsupported)
    cfg_ad = (config if config.differentiable
              else dataclasses.replace(config, differentiable=True))

    def loss_fn(p):
        scene = apply_params(scene0, p)
        img = render(scene, camera, cfg_ad, key, jitter)
        return jnp.mean((img - target) ** 2), img

    (loss, img), g_params = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    scene = apply_params(scene0, params)

    # ---- boundary term for θ, dispatched on the light type ---------------
    ltype = int(jax.device_get(scene.lights.ltype[light_index]))
    lo = jnp.min(verts, axis=0)
    hi = jnp.max(verts, axis=0)
    if ltype == LIGHT_AREA_DISK:
        dimg = area_shadow_boundary_image_grad(
            scene, camera, config, verts, faces, direction,
            light_index=light_index, samples_per_edge=samples_per_edge,
            n_light_samples=n_light_samples, occluder_aabb=(lo, hi),
        )
    else:
        lp = scene.lights.o[light_index]
        v0, v1, mask = silhouette_edges(verts, faces, lp)
        dimg = shadow_boundary_image_grad(
            scene, camera, config, v0, v1, direction,
            light_index=light_index, samples_per_edge=samples_per_edge,
            edge_mask=mask, occluder_aabb=(lo, hi),
        )
    if include_primary:
        cam_o = camera.camera_to_world[:, 3]
        v0c, v1c, maskc, fn = silhouette_edges_full(verts, faces, cam_o)
        dimg = dimg + primary_boundary_image_grad(
            scene, camera, config, v0c, v1c, direction,
            light_index=light_index, samples_per_edge=samples_per_edge,
            edge_mask=maskc, front_normal=fn,
        )
    g_theta = jnp.sum(2.0 * (img - target) * dimg) / img.size
    return loss, g_params, g_theta, img


def recover_translation(
    theta0,
    direction,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Array,
    key,
    steps: int = 24,
    lr: float = 0.5,
    **kw,
):
    """Gradient-descent recovery of an occluder translation from a target
    image using ONLY the boundary gradient — the demonstration BASELINE's
    north star asks for.

    The MSE of two shifted hard shadows grows ~|Δθ|, so the boundary
    gradient is signum-like (near-constant magnitude): fixed-step descent
    oscillates around the optimum. The loop therefore halves the step size
    whenever the loss stops improving (backtracking), which converges
    geometrically on |θ−θ*|. Returns (theta_hat, losses) with theta_hat the
    best-loss iterate."""
    theta = float(theta0)
    losses = []
    best_loss, best_theta, best_g = float("inf"), theta, 0.0
    for i in range(steps):
        loss, g, _ = translation_loss_and_grad(
            theta, direction, base_verts, faces, build_scene, camera,
            config, target, key, **kw,
        )
        loss, g = float(loss), float(g)
        losses.append(loss)
        if loss < best_loss:
            best_loss, best_theta, best_g = loss, theta, g
            theta = theta - lr * g
        else:
            lr *= 0.5  # overshoot: retry a shorter step from the best point
            theta = best_theta - lr * best_g
    return best_theta, losses


def jacobian_loss_and_grad(
    thetas,
    vel_fields,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Array,
    key,
    light_index: int = 0,
    samples_per_edge: int = 128,
    n_light_samples: int = 8,
    jitter: bool = True,
    render=None,
):
    """MULTI-DOF geometry gradients: the Jacobian-product API over a basis
    of per-vertex velocity fields (VERDICT r4 #5a — the estimator already
    took per-edge velocities; this exposes arbitrary vertex
    parameterizations: rigid translations, per-axis motion, blend shapes,
    per-vertex offsets).

        verts(θ) = base_verts + Σ_d θ_d · vel_fields[d]        θ ∈ R^D
        dL/dθ_d  = Σ_px 2(I−target)·dI/dθ_d
        dI/dθ_d  = boundary integral with the per-edge-ENDPOINT velocity
                   vel_fields[d][edge_vid] (lerped along each edge — exact
                   for a linear vertex field)

    thetas: [D]; vel_fields: [D, Vn, 3] (Vn = #occluder vertices).
    build_scene: verts → Scene. render: optional override, defaults to the
    simple renderer. Area-disk lights get the penumbra (light-area-sampled)
    boundary term, point lights the sharp one.

    Returns (loss, g_thetas [D], image).
    """
    from raytrace_tpu.renderers.simple import render_simple
    from raytrace_tpu.scene.scene import LIGHT_AREA_DISK

    render = render or (
        lambda s, c, cfg, k, j: render_simple(s, c, cfg, k, jitter=j)
    )
    thetas = jnp.asarray(thetas, jnp.float32)
    vel_fields = jnp.asarray(vel_fields, jnp.float32)  # [D, Vn, 3]
    verts = jnp.asarray(base_verts, jnp.float32) + jnp.sum(
        thetas[:, None, None] * vel_fields, axis=0)
    scene = build_scene(verts)
    img = render(scene, camera, config, key, jitter)
    loss = jnp.mean((img - target) ** 2)

    edge_vid, edge_fid = mesh_edge_adjacency(np.asarray(faces))
    edge_fid_j = jnp.asarray(edge_fid)
    faces_j = jnp.asarray(np.asarray(faces), jnp.int32)
    ev0 = verts[edge_vid[:, 0]]
    ev1 = verts[edge_vid[:, 1]]
    lo = jnp.min(verts, axis=0)
    hi = jnp.max(verts, axis=0)
    ltype = int(jax.device_get(scene.lights.ltype[light_index]))
    weights = 2.0 * (img - target) / img.size

    gs = []
    for d in range(vel_fields.shape[0]):
        vel_e = vel_fields[d][jnp.asarray(edge_vid)]  # [E, 2, 3]
        if ltype == LIGHT_AREA_DISK:
            dimg = _area_boundary_with_vel(
                scene, camera, config, verts, faces_j, edge_fid_j,
                ev0, ev1, vel_e, light_index, samples_per_edge,
                n_light_samples, (lo, hi),
            )
        else:
            lp = scene.lights.o[light_index]
            mask = silhouette_mask(verts, faces_j, edge_fid_j, lp)
            dimg = shadow_boundary_image_grad(
                scene, camera, config, ev0, ev1, vel_e,
                light_index=light_index,
                samples_per_edge=samples_per_edge, edge_mask=mask,
                occluder_aabb=(lo, hi),
            )
        gs.append(jnp.sum(weights * dimg))
    return loss, jnp.stack(gs), img


def _area_boundary_with_vel(
    scene, camera, config, verts, faces_j, edge_fid_j, ev0, ev1, vel_e,
    light_index, samples_per_edge, n_light_samples, occluder_aabb,
):
    """Penumbra boundary term for per-endpoint edge velocities: the
    stratified light-area quadrature of area_shadow_boundary_image_grad
    with an [E, 2, 3] velocity field."""
    from raytrace_tpu.core.sampling import concentric_sample_disk

    o = scene.lights.o[light_index]
    p1 = scene.lights.p1[light_index]
    p2 = scene.lights.p2[light_index]
    N = n_light_samples
    gu = int(np.floor(np.sqrt(N)))
    while N % gu:
        gu -= 1
    gv = N // gu
    jj = jnp.arange(N, dtype=jnp.float32)
    u1 = ((jj % gu) + 0.5) / gu
    u2 = ((jj // gu) + 0.5) / gv
    dx, dy = concentric_sample_disk(u1, u2)
    ys = o[None, :] + dx[:, None] * p1[None, :] + dy[:, None] * p2[None, :]

    def one(dimg, y):
        mask = silhouette_mask(verts, faces_j, edge_fid_j, y)
        d = shadow_boundary_image_grad(
            scene, camera, config, ev0, ev1, vel_e,
            light_index=light_index, samples_per_edge=samples_per_edge,
            edge_mask=mask, occluder_aabb=occluder_aabb,
            light_point=y, area_light=True, weight=1.0 / N,
        )
        return dimg + d, None

    init = jnp.zeros((config.height, config.width, 3), jnp.float32)
    dimg, _ = jax.lax.scan(one, init, ys)
    return dimg


def recover_dofs(
    thetas0,
    vel_fields,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Array,
    key,
    steps: int = 30,
    lr: float = 0.5,
    **kw,
):
    """Multi-DOF occluder recovery by backtracking gradient descent on the
    boundary gradient (the ≥2-DOF companion of recover_translation).
    Returns (thetas_hat [D], losses)."""
    thetas = np.asarray(thetas0, np.float64)
    losses = []
    best = (float("inf"), thetas.copy(), np.zeros_like(thetas))
    for _ in range(steps):
        loss, g, _ = jacobian_loss_and_grad(
            thetas, vel_fields, base_verts, faces, build_scene, camera,
            config, target, key, **kw,
        )
        loss = float(loss)
        g = np.asarray(g, np.float64)
        losses.append(loss)
        if loss < best[0]:
            best = (loss, thetas.copy(), g.copy())
            thetas = thetas - lr * g / max(1e-12, np.linalg.norm(g))
        else:
            lr *= 0.5
            thetas = best[1] - lr * best[2] / max(
                1e-12, np.linalg.norm(best[2]))
    return best[1], losses


@partial(jax.jit, static_argnames=("config", "samples_per_edge"))
def primary_boundary_image_grad(
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    edge_v0: Array,   # [E, 3] silhouette edges w.r.t. the CAMERA position
    edge_v1: Array,
    edge_vel: Array,  # [3] rigid d(edge point)/dθ, or [E, 3] per edge
    light_index: int = 0,
    samples_per_edge: int = 64,
    edge_mask: Array | None = None,
    front_normal: Array | None = None,  # [E, 3] from silhouette_edges_full
    front_mat: int = 0,                 # occluder material id for L_front
) -> Array:
    """PRIMARY-visibility boundary term: d(image)/dθ from the occluder's own
    silhouette sweeping across pixels (the in-view companion of
    shadow_boundary_image_grad; together they are the two visibility
    boundary families of Li et al. 2018 for a pinhole camera + point light).

        dI = (L_occluder − L_background) · (v_im · n_im) |J·ė| dt

    where v_im / n_im are the image-space edge velocity and the unit normal
    of the projected silhouette oriented toward the BACKGROUND side, and the
    two radiances are direct-lit matte shading of the silhouette point and
    of the surface the camera ray hits beyond it.

    Supply front_normal + front_mat (silhouette_edges_full) whenever
    possible: L_front is then shaded ANALYTICALLY at the edge point with
    the front face's normal. The fallback re-intersects a ray through the
    silhouette point, which grazes the edge and MISSES ~half the samples
    in float32 — a systematic underestimate, not just noise."""
    from raytrace_tpu.scene.camera import generate_rays
    from raytrace_tpu.shading import light as light_ops

    cam_o = camera.camera_to_world[:, 3]
    E = edge_v0.shape[0]
    K = samples_per_edge
    ts = (jnp.arange(K, dtype=jnp.float32) + 0.5) / K
    e = (edge_v0[:, None, :] * (1.0 - ts)[None, :, None]
         + edge_v1[:, None, :] * ts[None, :, None]).reshape(E * K, 3)
    edot = jnp.broadcast_to(
        (edge_v1 - edge_v0)[:, None, :], (E, K, 3)).reshape(E * K, 3)
    n = e.shape[0]
    sample_mask = (jnp.ones((n,), bool) if edge_mask is None
                   else jnp.repeat(edge_mask, K))
    if jnp.ndim(edge_vel) == 2:
        edge_vel = jnp.repeat(edge_vel, K, axis=0)
    u = jnp.broadcast_to(edge_vel, (n, 3))

    eps = jnp.float32(config.scene_epsilon)

    def shade(hit):
        """Direct-lit matte radiance at a hit (one light, no shadow ray at
        the silhouette point would double-count the boundary — shadow tests
        ARE evaluated so ΔL is the true local radiance difference)."""
        lp_ = scene.lights.o[light_index]
        wl = lp_ - hit.p
        r2 = jnp.maximum(vec.length_squared(wl), 1e-12)
        wl_hat = wl / jnp.sqrt(r2)[:, None]
        f = mat_ops.f(scene.materials, hit.mat, wl_hat, wl_hat)
        cos_l = vec.absdot(vec.normalize(hit.ns), wl_hat)
        li = scene.lights.intensity[light_index] / r2[:, None]
        shadowed = isect_ops.occluded(
            scene, hit.p, lp_ - hit.p,
            jnp.full((n,), jnp.float32(config.shadow_epsilon)),
            jnp.full((n,), 1.0 - jnp.float32(config.shadow_epsilon)),
        )
        L = f * cos_l[:, None] * li
        L = L + light_ops.light_L(scene.lights, hit.light, -wl_hat)
        return jnp.where((hit.valid & ~shadowed)[:, None], L, 0.0), hit.valid

    # front side: shade the silhouette point itself
    w = e - cam_o
    t_e = vec.length(w)
    w_hat = w / jnp.maximum(t_e, 1e-12)[:, None]
    o_b = jnp.broadcast_to(cam_o, (n, 3))
    if front_normal is not None:
        # analytic: point e on the front face with its known normal
        ns_f = jnp.repeat(front_normal, K, axis=0)
        lp_ = scene.lights.o[light_index]
        p_f = e + 1e-3 * ns_f  # lift off the surface for the shadow ray
        wl = lp_ - p_f
        r2 = jnp.maximum(vec.length_squared(wl), 1e-12)
        wl_hat = wl / jnp.sqrt(r2)[:, None]
        f_b = mat_ops.f(
            scene.materials, jnp.full((n,), front_mat, jnp.int32),
            wl_hat, wl_hat,
        )
        cos_l = vec.absdot(ns_f, wl_hat)
        li = scene.lights.intensity[light_index] / r2[:, None]
        shadowed = isect_ops.occluded(
            scene, p_f, lp_ - p_f,
            jnp.full((n,), jnp.float32(config.shadow_epsilon)),
            jnp.full((n,), 1.0 - jnp.float32(config.shadow_epsilon)),
        )
        L_f = jnp.where(~shadowed[:, None], f_b * cos_l[:, None] * li, 0.0)
        valid_f = jnp.ones((n,), bool)
    else:
        hit_f = isect_ops.intersect(
            scene, o_b, w_hat, jnp.full((n,), eps), t_e * (1.0 + 1e-4)
        )
        L_f, valid_f = shade(hit_f)
    # back side: continue past the occluder
    hit_b = isect_ops.intersect(
        scene, o_b, w_hat, t_e * (1.0 + 1e-4), jnp.full((n,), BIG)
    )
    L_b, _ = shade(hit_b)  # miss → black background (L_b already 0)
    dL = L_f - L_b

    # image-space geometry: silhouette projects THROUGH the camera directly
    proj = lambda p: project_to_raster(camera, p)
    xy, jm = jax.jvp(proj, (e,), (edot,))
    _, jv = jax.jvp(proj, (e,), (u,))
    jm_len = jnp.sqrt(jnp.maximum(jnp.sum(jm * jm, -1), 1e-20))
    jm_hat = jm / jm_len[:, None]
    perp = jnp.stack([-jm_hat[:, 1], jm_hat[:, 0]], axis=-1)

    # orient perp toward the BACKGROUND: probe camera rays half a pixel to
    # each side; the occluder side hits at ~t_e, the background side farther
    delta = 0.5
    probe_t = lambda xy_: isect_ops.intersect(
        scene,
        *(lambda r: (r.o, r.d))(generate_rays(
            camera, xy_, jnp.full((n, 2), 0.5), 1)),
        jnp.full((n,), eps), jnp.full((n,), BIG),
    ).t
    t_plus = probe_t(xy + delta * perp)
    t_minus = probe_t(xy - delta * perp)
    near = t_e * (1.0 + 1e-2)
    occ_plus = t_plus < near
    occ_minus = t_minus < near
    is_boundary = occ_plus != occ_minus
    sgn = jnp.where(occ_plus, -1.0, 1.0)  # background side = +perp when
    n_im = perp * sgn[:, None]            # the +side is NOT the occluder

    speed_im = jnp.sum(jv * n_im, axis=-1)
    scale = speed_im * jm_len / K
    ok = valid_f & is_boundary & sample_mask
    contrib = jnp.where(ok[:, None], dL * scale[:, None], 0.0)

    px = jnp.floor(xy[:, 0]).astype(jnp.int32)
    py = jnp.floor(xy[:, 1]).astype(jnp.int32)
    in_view = (
        (px >= 0) & (px < config.width) & (py >= 0) & (py < config.height)
    )
    flat = jnp.clip(py, 0, config.height - 1) * config.width + jnp.clip(
        px, 0, config.width - 1
    )
    contrib = jnp.where(in_view[:, None], contrib, 0.0)
    dimg = jnp.zeros((config.height * config.width, 3), jnp.float32)
    dimg = dimg.at[flat].add(contrib)
    return dimg.reshape(config.height, config.width, 3)
