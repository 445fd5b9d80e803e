"""Shared render passes: the camera pass (with wavefront specular chains) and
direct lighting with shadow rays.

The reference does specular chains by device-side recursion inside the
closest-hit program (raytracing.cu:90-104, depth cap 10) and direct lighting
with in-kernel shadow rtTrace (raytracing.cu:49-84). Here both become
masked wavefront iterations: a `lax.while_loop` over the whole ray batch for
specular chains, and dense any-hit passes for shadow rays.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from raytrace_tpu.core import samples as samples_lib, struct
from raytrace_tpu.core import vec
from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.ops import intersect as isect_ops
from raytrace_tpu.scene.scene import Scene
from raytrace_tpu.shading import light as light_ops
from raytrace_tpu.shading import material as mat_ops

BIG = isect_ops.BIG


def bounded_loop(cond, body, init, n_iters: int, differentiable: bool,
                 remat: bool = False):
    """while_loop for forward-only speed (early exit when every lane is done)
    or a fixed-trip fori_loop when reverse-mode AD must flow through the walk
    (lax.while_loop has no transpose rule; bodies are fully masked so the
    extra iterations are no-ops).

    remat: rematerialize each iteration in the backward pass
    (jax.checkpoint) — the walk then stores only per-iteration CARRIES
    instead of every intersection intermediate, trading recompute FLOPs for
    HBM residual traffic on the fwd+bwd path."""
    if differentiable:
        # prevent_cse=False: inside fori/scan CSE across iterations cannot
        # happen anyway, so the optimization barriers prevent_cse inserts
        # would only constrain the compiler
        step = (jax.checkpoint(body, prevent_cse=False) if remat else body)
        return jax.lax.fori_loop(0, n_iters, lambda i, s: step(s), init)
    return jax.lax.while_loop(cond, body, init)


@struct.dataclass
class CameraRecords:
    """Per-pixel-sample hit records — the RayTracingRecord buffer
    (reference: photonmapping.h:7-24) as SoA tensors.

    status: 0 = diffuse hit, 1 = miss, 2 = exception (specular chain > cap).
    atten realizes the reference's declared-but-unused accum_atten: the
    specular-chain throughput (with Kr applied — see shading/material.py).
    """
    status: Array  # [N] int32
    p: Array  # [N, 3]
    ns: Array  # [N, 3]
    ng: Array  # [N, 3]
    dpdu: Array  # [N, 3]
    dpdv: Array  # [N, 3]
    direction: Array  # [N, 3] incoming ray direction at the hit
    mat: Array  # [N] int32
    light: Array  # [N] int32
    atten: Array  # [N, 3]
    # pixel footprint radius at the hit, from the camera ray differentials
    # (reference generates CudaRayDifferential but never consumes rx/ry,
    # common.cu.h:7-14; here they seed per-pixel initial PPM radii — what
    # pbrt's SPPM does). 0 when differentials weren't supplied.
    footprint: Array  # [N]
    uv: Array = None  # [N, 2] surface uv at the hit (texture seam)

    @property
    def hit(self) -> Array:
        return self.status == 0


def compact_queue_size(config: RenderConfig, n: int) -> int:
    """Static width of the compacted-survivor queue (0 disables)."""
    if not config.wavefront_compact or config.differentiable:
        return 0
    k = config.compact_queue or max(8192, n // 8)
    return 0 if k >= n else k


def camera_pass(
    scene: Scene, o: Array, d: Array, config: RenderConfig, rays=None,
    return_aux: bool = False,
):
    """Trace camera rays, following specular chains up to the cap
    (reference: raytracing.cu:87-128).

    rays: optional RayDifferentials for the INITIAL segment; when given, the
    pixel footprint radius is recorded at the first hit (differentials are
    not propagated through specular chains — the footprint is a radius
    seed, not texture filtering).
    return_aux: also return {'pair_overflow': int32} — accumulated cluster
    pair-budget overflow across the chain (0 = traversal was exact)."""
    n = o.shape[0]
    if config.differentiable:
        # RECORD AND REPLAY (same design as trace_photons): hit geometry is
        # stop_gradient'd, so the camera records' only differentiable
        # content is atten = Π_j kd[m_j] ⊙ (parameter-free residuals) over
        # the specular chain. Run the FAST non-differentiable pass (early-
        # exit while_loop + compaction) recording the chain of specular
        # material ids, then rebuild atten as sg(atten)·N/sg(N) with
        # N = Π kd[m_j] — identical primal, exact gradient, and AD never
        # sees an intersect.
        import dataclasses

        cfg_walk = dataclasses.replace(config, differentiable=False)
        scene_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, scene)
        rec, aux, chain = _camera_pass_recorded(
            scene_sg, o, d, cfg_walk, rays)
        kd = scene.materials.kd
        n_prod = jnp.ones((n, 3), jnp.float32)
        for j in range(chain.shape[1]):
            m = chain[:, j]
            n_prod = n_prod * jnp.where(
                (m >= 0)[:, None], kd[jnp.maximum(m, 0)], 1.0)
        n_sg = jax.lax.stop_gradient(n_prod)
        atten = jnp.where(
            n_sg != 0.0,
            jax.lax.stop_gradient(rec.atten)
            * n_prod / jnp.where(n_sg == 0.0, 1.0, n_sg),
            0.0,
        )
        rec = rec.replace(atten=atten)
        if return_aux:
            return rec, aux
        return rec

    return _camera_pass_impl(scene, o, d, config, rays, return_aux,
                             record=False)


def _camera_pass_recorded(scene, o, d, config, rays):
    """Non-differentiable camera pass that ALSO returns the per-ray chain
    of specular material ids [n, max_specular_depth+1] (−1 padded) — the
    differentiable structure of atten for the record-and-replay AD path."""
    return _camera_pass_impl(scene, o, d, config, rays, return_aux=True,
                             record=True)


def _camera_pass_impl(scene, o, d, config, rays, return_aux, record):
    n = o.shape[0]
    DS = config.max_specular_depth + 1
    k = compact_queue_size(config, n)
    if k:
        return _camera_pass_compact(scene, o, d, config, rays, k,
                                    return_aux, record=record)
    eps = jnp.float32(config.scene_epsilon)

    def empty_records():
        z3 = jnp.zeros((n, 3), jnp.float32)
        return CameraRecords(
            status=jnp.full((n,), 1, jnp.int32),  # default miss
            p=z3, ns=z3, ng=z3, dpdu=z3, dpdv=z3, direction=d,
            mat=jnp.full((n,), -1, jnp.int32),
            light=jnp.full((n,), -1, jnp.int32),
            atten=jnp.ones((n, 3), jnp.float32),
            uv=jnp.zeros((n, 2), jnp.float32),
            footprint=jnp.zeros((n,), jnp.float32),
        )

    def cond(state):
        depth, active, *_ = state
        return (depth <= config.max_specular_depth) & jnp.any(active)

    def body(state):
        depth, active, o, d, atten, rec, ovf, rec_st = state
        tmin = jnp.full((n,), eps)
        hit = isect_ops.intersect(scene, o, d, tmin,
                                  jnp.where(active, jnp.float32(BIG), 0.0))
        ovf = ovf + hit.pair_overflow
        spec = mat_ops.is_specular(scene.materials, hit.mat)
        spec_hit = active & hit.valid & spec
        diff_hit = active & hit.valid & ~spec
        missed = active & ~hit.valid

        if rays is not None:
            # footprint at distance t along the PRIMARY ray: half the sum of
            # the rx/ry offset magnitudes at the hit plane (valid on the
            # first segment; kept frozen through specular bounces)
            p_rx = rays.rx_o + rays.rx_d * hit.t[:, None]
            p_ry = rays.ry_o + rays.ry_d * hit.t[:, None]
            fp = 0.5 * (vec.length(p_rx - hit.p) + vec.length(p_ry - hit.p))
            fp = jnp.where(depth == 0, fp, 0.0)
        else:
            fp = jnp.zeros((n,), jnp.float32)

        w = lambda m, a, b: jnp.where(m[..., None] if a.ndim == 2 else m, a, b)
        first_hit = (active & hit.valid) & (rec.footprint == 0.0)
        rec = CameraRecords(
            status=jnp.where(diff_hit, 0, jnp.where(missed, 1, rec.status)),
            p=w(diff_hit, hit.p, rec.p),
            ns=w(diff_hit, hit.ns, rec.ns),
            ng=w(diff_hit, hit.ng, rec.ng),
            dpdu=w(diff_hit, hit.dpdu, rec.dpdu),
            dpdv=w(diff_hit, hit.dpdv, rec.dpdv),
            direction=w(diff_hit, d, rec.direction),
            mat=jnp.where(diff_hit, hit.mat, rec.mat),
            light=jnp.where(diff_hit, hit.light, rec.light),
            atten=rec.atten,
            uv=w(diff_hit, hit.uv, rec.uv),
            footprint=jnp.where(first_hit, fp, rec.footprint),
        )

        thr, wi = mat_ops.specular(
            scene.materials, hit.mat, hit.ns, hit.dpdu, -d
        )
        o2 = jnp.where(spec_hit[:, None], hit.p, o)
        d2 = jnp.where(spec_hit[:, None], wi, d)
        atten2 = jnp.where(spec_hit[:, None], atten * thr, atten)
        if record:
            # record only bounces whose atten factor contains kd (mirror;
            # glass thr is ones — see mat_ops.kd_in_specular)
            rec_m = spec_hit & mat_ops.kd_in_specular(
                scene.materials, hit.mat)
            chain, cptr = rec_st
            col = jnp.clip(cptr, 0, DS - 1)
            ccols = jnp.arange(DS, dtype=jnp.int32)
            chain = jnp.where(
                rec_m[:, None] & (ccols[None, :] == col[:, None]),
                hit.mat[:, None], chain)
            rec_st = (chain, cptr + rec_m.astype(jnp.int32))
        return depth + 1, spec_hit, o2, d2, atten2, rec, ovf, rec_st

    rec_st0 = ((jnp.full((n, DS), -1, jnp.int32),
                jnp.zeros((n,), jnp.int32)) if record else ())
    depth, active, o, d, atten, rec, ovf, rec_st = bounded_loop(
        cond, body,
        (jnp.int32(0), jnp.ones((n,), bool), o, d,
         jnp.ones((n, 3), jnp.float32), empty_records(), jnp.int32(0),
         rec_st0),
        n_iters=config.max_specular_depth + 1,
        differentiable=config.differentiable,
        remat=config.remat_walks,
    )
    # rays still active past the cap → exception flag (reference:
    # raytracing.cu:98-101)
    rec = rec.replace(
        status=jnp.where(active, 2, rec.status),
        atten=atten,
    )
    if record:
        return rec, dict(pair_overflow=ovf), rec_st[0]
    if return_aux:
        return rec, dict(pair_overflow=ovf)
    return rec


def _camera_pass_compact(
    scene: Scene, o: Array, d: Array, config: RenderConfig, rays, k: int,
    return_aux: bool = False, record: bool = False,
):
    """camera_pass with survivor compaction: bounce 0 runs full-batch (every
    ray is live), then the specular survivors — a few percent of the batch —
    are gathered into a static k-wide queue and processed TO COMPLETION by
    an inner bounce loop that only ever touches k lanes; results scatter
    back once per batch, instead of a full-width jnp.nonzero + record
    scatters on every bounce. One outer batch iteration suffices unless
    > k rays survive bounce 0.
    Per-ray math is identical to the full-batch loop (each lane's outcome
    is a pure function of its own state); records match up to XLA fusion
    noise."""
    n = o.shape[0]
    eps = jnp.float32(config.scene_epsilon)
    cap = config.max_specular_depth
    DS = cap + 1
    chain = (jnp.full((n, DS), -1, jnp.int32) if record else None)

    # ---- bounce 0: full batch --------------------------------------------
    hit = isect_ops.intersect(
        scene, o, d, jnp.full((n,), eps), jnp.full((n,), BIG),
    )
    ovf0 = hit.pair_overflow
    spec = mat_ops.is_specular(scene.materials, hit.mat)
    spec_hit = hit.valid & spec
    diff_hit = hit.valid & ~spec

    if rays is not None:
        p_rx = rays.rx_o + rays.rx_d * hit.t[:, None]
        p_ry = rays.ry_o + rays.ry_d * hit.t[:, None]
        fp = 0.5 * (vec.length(p_rx - hit.p) + vec.length(p_ry - hit.p))
        fp = jnp.where(hit.valid, fp, 0.0)
    else:
        fp = jnp.zeros((n,), jnp.float32)

    w = lambda m, a, b: jnp.where(m[..., None] if a.ndim == 2 else m, a, b)
    z3 = jnp.zeros((n, 3), jnp.float32)
    rec = CameraRecords(
        status=jnp.where(diff_hit, 0, 1),  # miss default; spec stays "miss"
        p=w(diff_hit, hit.p, z3),
        ns=w(diff_hit, hit.ns, z3),
        ng=w(diff_hit, hit.ng, z3),
        dpdu=w(diff_hit, hit.dpdu, z3),
        dpdv=w(diff_hit, hit.dpdv, z3),
        direction=d,
        mat=jnp.where(diff_hit, hit.mat, -1),
        light=jnp.where(diff_hit, hit.light, -1),
        atten=jnp.ones((n, 3), jnp.float32),
        uv=w(diff_hit, hit.uv, jnp.zeros((n, 2), jnp.float32)),
        footprint=fp,
    )
    thr, wi = mat_ops.specular(scene.materials, hit.mat, hit.ns, hit.dpdu, -d)
    o = w(spec_hit, hit.p, o)
    d = w(spec_hit, wi, d)
    atten = w(spec_hit, thr, jnp.ones((n, 3), jnp.float32))
    active = spec_hit
    if record:
        rec_m0 = spec_hit & mat_ops.kd_in_specular(scene.materials, hit.mat)
        chain = chain.at[:, 0].set(jnp.where(rec_m0, hit.mat, -1))

    # ---- batches of ≤ k survivors, each walked to completion --------------
    max_batches = -(-n // k)
    wk = lambda m, a, b: jnp.where(m[..., None] if a.ndim == 2 else m, a, b)

    def inner_cond(s):
        bounce, alive, *_ = s
        return (bounce <= cap) & jnp.any(alive)

    def inner_body(s):
        """One specular bounce for the k queued lanes (k-sized ops only)."""
        bounce, alive, o_k, d_k, atten_k, st_k, rk, ovf_k, rec_k = s
        hit = isect_ops.intersect(
            scene, o_k, d_k, jnp.full((k,), eps),
            jnp.where(alive, jnp.float32(BIG), 0.0),  # dead lanes cull 0
        )
        ovf_k = ovf_k + hit.pair_overflow
        spec = mat_ops.is_specular(scene.materials, hit.mat)
        spec_k = alive & hit.valid & spec
        diff_k = alive & hit.valid & ~spec
        miss_k = alive & ~hit.valid

        st_k = jnp.where(diff_k, 0, jnp.where(miss_k, 1, st_k))
        rk = tuple(
            wk(diff_k, v, cur) for v, cur in zip(
                (hit.p, hit.ns, hit.ng, hit.dpdu, hit.dpdv, d_k, hit.uv),
                rk[:7])
        ) + tuple(
            jnp.where(diff_k, v, cur) for v, cur in zip(
                (hit.mat, hit.light), rk[7:])
        )
        thr, wi2 = mat_ops.specular(
            scene.materials, hit.mat, hit.ns, hit.dpdu, -d_k
        )
        o_k = wk(spec_k, hit.p, o_k)
        d_k = wk(spec_k, wi2, d_k)
        atten_k = wk(spec_k, atten_k * thr, atten_k)
        if record:
            rec_m = spec_k & mat_ops.kd_in_specular(scene.materials, hit.mat)
            ch_k, cp_k = rec_k
            col = jnp.clip(cp_k, 0, DS - 1)
            # one-hot column select instead of a `.at[krows, col].set`
            # per-row scatter (same result)
            ccols = jnp.arange(DS, dtype=jnp.int32)
            ch_k = jnp.where(
                rec_m[:, None] & (ccols[None, :] == col[:, None]),
                hit.mat[:, None], ch_k)
            rec_k = (ch_k, cp_k + rec_m.astype(jnp.int32))
        return (bounce + 1, spec_k, o_k, d_k, atten_k, st_k, rk, ovf_k,
                rec_k)

    def outer_cond(s):
        it, active, *_ = s
        return (it < max_batches) & jnp.any(active)

    def outer_body(s):
        it, active, o, d, atten, rec, ovf, chain_g = s
        idx_raw = jnp.nonzero(active, size=k, fill_value=n)[0]
        sel = idx_raw < n
        idx = jnp.minimum(idx_raw, n - 1)

        zk3 = jnp.zeros((k, 3), jnp.float32)
        rk = (zk3, zk3, zk3, zk3, zk3, d[idx],
              jnp.zeros((k, 2), jnp.float32),
              jnp.full((k,), -1, jnp.int32), jnp.full((k,), -1, jnp.int32))
        rec_k0 = (((chain_g[idx],
                    jnp.ones((k,), jnp.int32)) if record else ()))
        init = (jnp.int32(1), sel, o[idx], d[idx], atten[idx],
                jnp.full((k,), 1, jnp.int32), rk, jnp.int32(0), rec_k0)
        (_, alive_end, _, _, atten_k, st_k, rk, ovf_k,
         rec_k) = jax.lax.while_loop(inner_cond, inner_body, init)
        # still alive after the cap → exception flag (raytracing.cu:98-101)
        st_k = jnp.where(alive_end, 2, st_k)

        def scat(buf, val):
            # fill lanes have idx_raw = n → dropped; selected lanes always
            # write their batch value, so no old-row gather is needed
            return buf.at[idx_raw].set(val, mode="drop")

        rec = CameraRecords(
            status=scat(rec.status, st_k),
            p=scat(rec.p, rk[0]),
            ns=scat(rec.ns, rk[1]),
            ng=scat(rec.ng, rk[2]),
            dpdu=scat(rec.dpdu, rk[3]),
            dpdv=scat(rec.dpdv, rk[4]),
            direction=scat(rec.direction, rk[5]),
            mat=scat(rec.mat, rk[7]),
            light=scat(rec.light, rk[8]),
            atten=scat(rec.atten, atten_k),
            uv=scat(rec.uv, rk[6]),
            footprint=rec.footprint,
        )
        if record:
            # ch_k was seeded from chain_g[idx], so fill lanes (dropped
            # anyway) and sel lanes alike carry the right rows
            ch_k, _ = rec_k
            chain_g = chain_g.at[idx_raw].set(ch_k, mode="drop")
        active = active.at[idx_raw].set(False, mode="drop")
        return it + 1, active, o, d, atten, rec, ovf + ovf_k, chain_g

    init = (jnp.int32(0), active, o, d, atten, rec, ovf0,
            chain if record else jnp.zeros((0,), jnp.int32))
    _, _, _, _, _, rec, ovf, chain = jax.lax.while_loop(
        outer_cond, outer_body, init)
    if record:
        return rec, dict(pair_overflow=ovf), chain
    if return_aux:
        return rec, dict(pair_overflow=ovf)
    return rec


def static_light_samples(scene: Scene, config: RenderConfig) -> tuple[int, ...]:
    """Concrete per-light sample counts, read on the host (static under jit)."""
    ns = np.asarray(jax.device_get(scene.lights.n_samples))
    return tuple(int(min(x, config.max_light_samples)) for x in ns)


def direct_lighting(
    scene: Scene,
    rec: CameraRecords,
    key: Array,
    config: RenderConfig,
    light_samples: tuple[int, ...],
    include_emitted: bool = True,
    sample_ids: Array | None = None,
    return_aux: bool = False,
):
    """Direct lighting with shadow rays at the recorded hit points
    (reference: raytracing.cu:49-84 directLight).

    L = lightL(self) + Σ_lights Σ_s atten·|n_s·wi|·f·li / (pdf·nSamples)
    Shadow rays run over the unnormalized uwi in [eps, 1-eps]
    (reference: raytracing.cu:72).

    sample_ids: GLOBAL pixel-sample ids (default arange(n)). Light-sample
    uniforms are threefry(key, light/sample, global id) — a pure function of
    the global id, so an N-chip sharded render draws exactly the same
    numbers as the 1-chip render (same contract as the photon walk,
    renderers/photon.trace_photons).
    """
    n = rec.p.shape[0]
    hit = rec.hit
    wo = vec.normalize(-rec.direction)
    L = jnp.zeros((n, 3), jnp.float32)
    if include_emitted:
        L += light_ops.light_L(scene.lights, rec.light, -rec.direction)
    if sample_ids is None:
        sample_ids = jnp.arange(n, dtype=jnp.uint32)

    # unified sample-request layout (reference: CudaSample::Add2D offsets
    # feeding bRandom2D, util/sampler/cudasample.cpp:2-25 +
    # cudalight.cu.h:34-35): one stratified 2D request per light
    layout = samples_lib.SampleLayout()
    offsets = [layout.add_2d(ns_i) for ns_i in light_samples]
    u2d = layout.materialize_2d(key, sample_ids)  # [N, total, 2]

    eps = config.shadow_epsilon

    def one_sample(L, ovf, i, col, inv_ns):
        """Contribution of one (light, stratified-sample) pair. `i`/`col` may
        be traced (scan) or static (direct call)."""
        u = u2d[:, col] if isinstance(col, int) else jnp.take(
            u2d, col, axis=1
        )
        li, uwi, pdf = light_ops.sample_L_illum(scene.lights, i, rec.p, u)
        shadowed, ovf_s = isect_ops.occluded_aux(
            scene, rec.p, uwi,
            jnp.full((n,), eps, jnp.float32),
            jnp.full((n,), 1.0 - eps, jnp.float32),
        )
        wi = vec.normalize(uwi)
        fr = mat_ops.f(scene.materials, rec.mat, wo, wi, uv=rec.uv)
        cos = vec.absdot(rec.ns, wi)
        good = hit & ~shadowed & (pdf > 0.0) & (vec.length_squared(li) > 0.0)
        contrib = cos[:, None] * fr * li * (inv_ns / jnp.where(
            pdf == 0.0, 1.0, pdf
        ))[:, None]
        return L + jnp.where(good[:, None], contrib, 0.0), ovf + ovf_s

    # flattened (light, sample) work list. A Python loop here would inline
    # one intersector per light sample into the graph (the round-2
    # cold-compile regression); lax.scan compiles the shadow pass ONCE.
    pairs = [
        (i, offsets[i] + s, 1.0 / ns_i)
        for i, ns_i in enumerate(light_samples)
        for s in range(ns_i)
    ]
    ovf = jnp.int32(0)
    if len(pairs) == 0:
        pass
    elif len(pairs) == 1:
        i, col, inv_ns = pairs[0]
        L, ovf = one_sample(L, ovf, i, col, jnp.float32(inv_ns))
    else:
        xs = (
            jnp.asarray([p[0] for p in pairs], jnp.int32),
            jnp.asarray([p[1] for p in pairs], jnp.int32),
            jnp.asarray([p[2] for p in pairs], jnp.float32),
        )
        (L, ovf), _ = jax.lax.scan(
            lambda c, x: (one_sample(c[0], c[1], x[0], x[1], x[2]), None),
            (L, ovf), xs,
        )
    L = jnp.where(hit[:, None], L, 0.0)
    if return_aux:
        return L, dict(pair_overflow=ovf)
    return L


