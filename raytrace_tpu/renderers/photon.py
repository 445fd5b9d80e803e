"""Progressive photon-mapping renderer — the main workload.

Reproduces the reference's 4-pass pipeline (photonmappingrenderer.cpp:31-45)
as wavefront JAX passes:

  1. camera pass      raytracing.cu           → renderers/common.camera_pass
  2. photon tracing   photontracing.cu        → trace_photons (vmapped walk,
                                                 permuted-Halton light samples,
                                                 per-bounce Russian roulette —
                                                 the reference has RR written
                                                 but commented out,
                                                 photontracing.cu:173-178)
  3. photon gathering gathering.cu:104-126    → progressive radius/flux update
                                                 over the hash grid (α = 0.7)
  4. final gathering  gathering.cu:129-146    → L = DL + flux/(π r² Nemitted)

Photon slots are disjoint per path exactly like the reference
(pm_index = path·max_depth, photontracing.cu:82) — a [paths·max_depth] photon
tensor with a validity mask instead of the kd-tree bitfields.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from raytrace_tpu.core import sampling, spectrum, struct, vec
from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.ops import intersect as isect_ops
from raytrace_tpu.ops import photon_grid
from raytrace_tpu.renderers import common
from raytrace_tpu.scene.camera import PerspectiveCamera, generate_rays, pixel_samples
from raytrace_tpu.scene.scene import Scene
from raytrace_tpu.shading import light as light_ops
from raytrace_tpu.shading import material as mat_ops
from raytrace_tpu.utils import film

BIG = isect_ops.BIG


@struct.dataclass
class ProgressiveState:
    """Per-pixel-sample PPM statistics (the reference keeps these inside
    RayTracingRecord, photonmapping.h:16-19). This pytree is the natural
    checkpoint between photon waves (SURVEY.md §5.4)."""
    radius2: Array  # [N]
    photon_count: Array  # [N] float (α-weighted count)
    flux: Array  # [N, 3]
    # per-pixel emitted photon paths over the waves this pixel PARTICIPATED
    # in (a gather job-budget overflow skips a pixel's wave: its flux lacks
    # that wave's photons, so its normalization must exclude those paths —
    # the unbiased treatment of overflow). None = legacy
    # callers; final_gathering then normalizes by the global emitted count.
    emitted: Array = None  # [N] float


def initial_radius2(rec: common.CameraRecords, config: RenderConfig) -> Array:
    """Per-pixel starting search radius² for the progressive state.

    Reference parity (footprint_radius_scale == 0): the global constant
    radius² = 4 (raytracing.cu:123). SPPM mode (> 0): radius is the pixel's
    camera-ray-differential footprint × scale, clamped — what pbrt's SPPM
    integrator does, and the reason CameraRecords carries `footprint`."""
    n = rec.footprint.shape[0]
    base = jnp.full((n,), config.initial_radius2, jnp.float32)
    if config.footprint_radius_scale <= 0.0:
        return base
    fp = config.footprint_radius_scale * rec.footprint
    r2 = jnp.clip(fp * fp, config.min_radius2, config.initial_radius2)
    return jnp.where(rec.footprint > 0.0, r2, base)


def gather_cell_size(rec: common.CameraRecords, state: "ProgressiveState"):
    """Grid cell edge for the spatial gather: the 90th-percentile live query
    radius. The rowspan gather's per-tile reach (ceil(max_tile_radius/cell))
    keeps results exact for ANY cell size; a high percentile keeps spans
    tight for the typical tile while the few big-radius tiles just reach
    further (the previous global-max rule let ONE distant pixel inflate the
    cell size — and every tile's photon spans — by an order of magnitude).
    Under progressive shrinking and footprint radii this tightens the grid
    pass by pass."""
    live = jnp.where(rec.hit, state.radius2, jnp.nan)
    q90 = jnp.nanquantile(live, 0.9)
    q90 = jnp.where(jnp.isnan(q90), 1.0, q90)  # no hits at all
    return jnp.sqrt(jnp.maximum(q90, 1e-12))


def trace_photons(
    scene: Scene,
    config: RenderConfig,
    key: Array,
    pass_idx: int,
    light_index: int | None = None,
    path_offset=0,
    with_aux: bool = False,
):
    """One photon wave: `photon_paths` light paths, ≤ max_photon_depth diffuse
    deposits each (reference: photontracing.cu:80-185).

    The emission sample is a permuted-Halton point at index path·max_depth
    (matching pm_index striding, photontracing.cu:82-83); bounce uniforms come
    from threefry folded with (pass, purpose) — a pure function of indices, so
    results are reproducible at any sharding (unlike the reference's global
    cuRAND stream, cudarandom.h:15).

    DIFFERENTIABLE PATH (config.differentiable) — record and replay: hit
    geometry is stop_gradient'd by design, so the only differentiable
    content of a photon is its alpha = X · Le[light] · Π_j kd[m_j], with X
    a parameter-independent scalar chain (cosines, pdfs, texture factors,
    Fresnel terms). The walk therefore runs in its FAST non-differentiable
    form (while_loop + survivor compaction — AD never sees an intersect)
    while RECORDING each deposit's material-id chain, and alpha is
    reconstructed differentiably as

        alpha = sg(alpha_walk) · N / sg(N),   N = Le[lid] ⊙ Π_j kd[m_j]

    — bit-identical primal, exact gradient (∂alpha/∂kd_m = alpha·c_m/kd_m).
    Caveat: parameter channels that are EXACTLY zero get zero gradient
    through this ratio (alpha is zero there anyway); optimizers keep
    albedos off exact zero.
    """
    import dataclasses

    if config.differentiable:
        # Russian roulette STAYS ON under AD (round 5): record-and-replay
        # yields the DETACHED-SAMPLING estimator for free — the survival
        # indicator and the 1/P reweights live entirely inside
        # sg(alpha_walk), and the replay ratio differentiates only
        # N = Le·Πkd. Per surviving path the gradient is (dN/dθ)·alpha/N =
        # g'/P, whose expectation over the survival Bernoulli(P) is
        # exactly g' — the score-function term of the indicator cancels
        # the -g·P'/P pathwise piece, leaving the detached form (the same
        # cancellation detached-sampling differentiable renderers rely
        # on). Bonus: the differentiable primal is now BIT-IDENTICAL to
        # the forward render (round 4 ran the diff walk RR-off — ~1.5×
        # the walk work and ~2× the valid photons through the gather VJP).
        cfg_walk = dataclasses.replace(config, differentiable=False)
        scene_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, scene)
        pm, aux, chain, lid_slot = _trace_photons_core(
            scene_sg, cfg_walk, key, pass_idx, light_index, path_offset,
            record=True,
        )
        kd = scene.materials.kd
        le = scene.lights.intensity
        n_prod = le[lid_slot]  # [slots, 3]
        for j in range(chain.shape[1]):
            m = chain[:, j]
            n_prod = n_prod * jnp.where(
                (m >= 0)[:, None], kd[jnp.maximum(m, 0)], 1.0)
        n_sg = jax.lax.stop_gradient(n_prod)
        alpha = jnp.where(
            n_sg != 0.0,
            jax.lax.stop_gradient(pm.alpha)
            * n_prod / jnp.where(n_sg == 0.0, 1.0, n_sg),
            0.0,
        )
        pm = photon_grid.PhotonMap(
            p=pm.p, alpha=alpha, wi=pm.wi, valid=pm.valid)
        if with_aux:
            return pm, aux
        return pm

    pm, aux, _, _ = _trace_photons_core(
        scene, config, key, pass_idx, light_index, path_offset,
        record=False,
    )
    if with_aux:
        return pm, aux
    return pm


def _dep_write(buf, dep, slot, v, depth: int, width: int):
    """Masked per-path deposit into a [rows, depth·width] slab buffer WITHOUT
    a scatter: one-hot on the slot column, pure elementwise select
    (bit-identical to the flat `buf.at[row·depth+slot].set(...)` scatter it
    replaced; which of the two is faster on the GPU is not measured)."""
    cols = jnp.arange(depth * width, dtype=jnp.int32) // jnp.int32(width)
    mask = dep[:, None] & (cols[None, :] == slot[:, None])
    return jnp.where(mask, jnp.tile(v, (1, depth)), buf)


def _dep_mark(valid, dep, slot, depth: int):
    """Validity counterpart of _dep_write: valid [rows, depth] |= one-hot."""
    cols = jnp.arange(depth, dtype=jnp.int32)
    return valid | (dep[:, None] & (cols[None, :] == slot[:, None]))


def _chain_append(chain, app, col, mat, CH: int):
    """chain [rows, CH] one-hot append (same scatter-avoidance as
    _dep_write: `.at[rows, col].set` is a serialized row scatter)."""
    cols = jnp.arange(CH, dtype=jnp.int32)
    mask = app[:, None] & (cols[None, :] == col[:, None])
    return jnp.where(mask, mat[:, None], chain)


def _bounce_uniforms(k_bounce, gids, n_int):
    """3 uniforms for this bounce, a pure function of (pass key, GLOBAL path
    id, n_int) — sharding-invariant like the precomputed table it replaces
    (the [paths, depth+1, 3] table needed a per-step row gather from a
    rank-3 array; two threefry fold_ins need none).
    Each diffuse continuation has a distinct n_int (cont always increments),
    so no bounce ever reuses another bounce's numbers."""
    def one(g, ni):
        k = jax.random.fold_in(jax.random.fold_in(k_bounce, g), ni)
        return jax.random.uniform(k, (3,), dtype=jnp.float32)

    return jax.vmap(one)(gids, n_int)


def _trace_photons_core(
    scene: Scene,
    config: RenderConfig,
    key: Array,
    pass_idx: int,
    light_index: int | None = None,
    path_offset=0,
    record: bool = False,
):
    n_paths = config.photon_paths
    max_depth = config.max_photon_depth
    k_perm, k_bounce = jax.random.split(jax.random.fold_in(key, pass_idx))

    # emission sampling (photontracing.cu:83-97)
    # path_offset shards the global Halton/RNG index space across chips:
    # seeds are a pure function of (pass, global path id), so an N-chip render
    # reproduces the 1-chip photon set exactly (SURVEY.md §7 hard part 5; the
    # reference's single global cuRAND seed, cudarandom.h:15, is the
    # anti-pattern this replaces).
    perms = sampling.halton_permutations(k_perm)
    stride = max_depth if config.halton_stride_by_depth else 1
    global_path_ids = jnp.arange(n_paths, dtype=jnp.uint32) + jnp.uint32(
        path_offset
    )
    halton_idx = global_path_ids * jnp.uint32(stride)
    smp = sampling.halton_sample_4d(halton_idx, perms)  # [paths, 4]
    # Per-path light selection for multi-light scenes: the reference shoots
    # every photon from light 0 (gContext["lightSourceIndex"]->setUint(0),
    # photonmappingrenderer.cpp:211), silently dropping indirect light from
    # the rest. We stripe paths over the table by GLOBAL path id (uniform
    # pick, Le scaled by n_lights = 1/pmf) — deterministic at any sharding.
    n_lights = scene.lights.count
    if light_index is None and n_lights > 1:
        i_light = (global_path_ids % jnp.uint32(n_lights)).astype(jnp.int32)
        light_scale = jnp.float32(n_lights)
    else:
        i_light = light_index if light_index is not None else 0
        light_scale = jnp.float32(1.0)
    le, o, d, ns_l, pdf = light_ops.sample_Le(
        scene.lights, i_light, smp[:, 0], smp[:, 1], smp[:, 2], smp[:, 3]
    )
    le = le * light_scale
    alpha = vec.absdot(ns_l, d)[:, None] * le / jnp.where(pdf == 0.0, 1.0, pdf)[:, None]
    alive = (pdf > 0.0) & ~spectrum.is_black(le)

    # Photon slot buffers are [paths, max_depth·3] slabs (one row per path,
    # one 3-wide column block per deposit slot — the reference's pm_index
    # striding, photontracing.cu:82, as a row-local column index). Deposits
    # are written with _dep_write's dense one-hot select instead of a
    # scatter; the final reshape to the flat [paths·max_depth, 3] map is
    # layout-compatible (row-major), so downstream consumers see the exact
    # same slot order.
    n_slots = n_paths * max_depth
    CH = config.max_photon_bounces  # chain capacity (≤ one append per step)
    ph_p = jnp.zeros((n_paths, max_depth * 3), jnp.float32)
    ph_alpha = jnp.zeros((n_paths, max_depth * 3), jnp.float32)
    ph_wi = jnp.zeros((n_paths, max_depth * 3), jnp.float32)
    ph_valid = jnp.zeros((n_paths, max_depth), bool)
    ph_chain = (jnp.full((n_paths, max_depth * CH), -1, jnp.int32)
                if record else None)

    step = partial(_photon_step, scene, config)
    k = common.compact_queue_size(config, n_paths)
    if k:
        ((ph_p, ph_alpha, ph_wi, ph_valid), pair_ovf,
         ph_chain) = _photon_walk_compact(
            step, k_bounce, global_path_ids, alive, o, d, alpha,
            (ph_p, ph_alpha, ph_wi, ph_valid), config, k,
            ph_chain=ph_chain,
        )
    else:
        def cond(state):
            it, alive, *_ = state
            return (it < config.max_photon_bounces) & jnp.any(alive)

        def body(state):
            it, alive, o, d, alpha, n_int, ph, ovf, rec_st = state
            ph_p, ph_alpha, ph_wi, ph_valid, ph_ch = ph
            u = _bounce_uniforms(k_bounce, global_path_ids, n_int)
            out = step(o, d, alpha, n_int, alive, u)
            ovf = ovf + out["pair_overflow"]
            dep = out["deposit"]
            slot = out["slot"]
            ph_p = _dep_write(ph_p, dep, slot, out["dep_p"], max_depth, 3)
            ph_alpha = _dep_write(ph_alpha, dep, slot, out["dep_alpha"],
                                  max_depth, 3)
            ph_wi = _dep_write(ph_wi, dep, slot, out["dep_wi"], max_depth, 3)
            ph_valid = _dep_mark(ph_valid, dep, slot, max_depth)
            if record:
                chain, cptr = rec_st
                # deposit FIRST (its alpha excludes this surface), then
                # append this bounce's material for the continuation
                ph_ch = _dep_write(ph_ch, dep, slot, chain, max_depth, CH)
                app = out["append"]
                col = jnp.clip(cptr, 0, CH - 1)
                chain = _chain_append(chain, app, col, out["append_mat"], CH)
                cptr = cptr + app.astype(jnp.int32)
                rec_st = (chain, cptr)
            return (
                it + 1, out["alive"], out["o"], out["d"], out["alpha"],
                out["n_int"], (ph_p, ph_alpha, ph_wi, ph_valid, ph_ch),
                ovf, rec_st,
            )

        rec_st0 = ((jnp.full((n_paths, CH), -1, jnp.int32),
                    jnp.zeros((n_paths,), jnp.int32)) if record else ())
        init = (
            jnp.int32(0), alive, o, d, alpha,
            jnp.zeros((n_paths,), jnp.int32),
            (ph_p, ph_alpha, ph_wi, ph_valid, ph_chain), jnp.int32(0),
            rec_st0,
        )
        (_, _, _, _, _, _, (ph_p, ph_alpha, ph_wi, ph_valid, ph_chain),
         pair_ovf, _) = common.bounded_loop(
            cond, body, init,
            n_iters=config.max_photon_bounces,
            differentiable=config.differentiable,
            remat=config.remat_walks,
        )
    pm = photon_grid.PhotonMap(
        p=ph_p.reshape(n_slots, 3),
        alpha=ph_alpha.reshape(n_slots, 3),
        wi=ph_wi.reshape(n_slots, 3),
        valid=ph_valid.reshape(n_slots),
    )
    if record:
        ph_chain = ph_chain.reshape(n_slots, CH)
    # per-slot light id (pure function of global path ids — no recording)
    if record:
        if light_index is None and n_lights > 1:
            lid_slot = jnp.repeat(
                (global_path_ids % jnp.uint32(n_lights)).astype(jnp.int32),
                max_depth)
        else:
            lid = light_index if light_index is not None else 0
            lid_slot = jnp.full((n_slots,), lid, jnp.int32)
    else:
        lid_slot = None
    return pm, dict(pair_overflow=pair_ovf), ph_chain, lid_slot


def _photon_step(
    scene: Scene, config: RenderConfig, o, d, alpha, n_int, act, u
) -> dict:
    """One photon-walk step for a batch of lanes (full-width or a compacted
    queue): intersect, classify specular/diffuse, compute the deposit and the
    continuation state. Pure per-lane math — identical at any batching.
    Reference semantics: photontracing.cu:113-185."""
    width = o.shape[0]
    max_depth = config.max_photon_depth
    eps = jnp.float32(config.scene_epsilon)
    # DEAD lanes get an empty t-window (tmax = 0): their BVH traversal
    # fails the first box test and retires, so a late queue bounce with few
    # live lanes does not re-intersect every lane's stale ray
    hit = isect_ops.intersect(
        scene, o, d, jnp.full((width,), eps),
        jnp.where(act, jnp.float32(BIG), 0.0),
    )
    alive = act & hit.valid  # miss → photon dies (photontracing.cu:193)
    pair_overflow = hit.pair_overflow
    spec = mat_ops.is_specular(scene.materials, hit.mat)
    spec_hit = alive & spec
    diff_hit = alive & ~spec

    # --- specular bounce (photontracing.cu:113-134) -----------------------
    thr, wi_s = mat_ops.specular(scene.materials, hit.mat, hit.ns, hit.dpdu, -d)

    # --- diffuse: deposit if bounced at least once
    # (indirect-only map, photontracing.cu:141-151) -------------------------
    deposit = diff_hit & (n_int >= 1)
    slot = jnp.clip(n_int - 1, 0, max_depth - 1)

    # --- diffuse continuation (photontracing.cu:153-184) -------------------
    cont = diff_hit & (n_int < max_depth)
    fr, wi_d, pdf_b = mat_ops.sample_f(
        scene.materials, hit.mat, hit.ns, hit.dpdu, -d, u[:, 0], u[:, 1],
        uv=hit.uv,
    )
    cont = cont & ~spectrum.is_black(fr) & (pdf_b > 0.0)
    anew = (
        alpha
        * fr
        * vec.absdot(wi_d, vec.normalize(hit.ns))[:, None]
        / jnp.where(pdf_b == 0.0, 1.0, pdf_b)[:, None]
    )
    if config.russian_roulette and not config.differentiable:
        # the commented-out pbrt roulette, enabled
        # (photontracing.cu:173-178): P = min(1, y(anew)/y(alpha)).
        # `not differentiable` guards only the REVERSE-MODE fori_loop
        # walk (where the survival branch has no transpose); the
        # record-and-replay AD path runs this very branch with
        # differentiable=False and keeps roulette ON — the 1/P reweight
        # is stop-gradiented wholesale there (detached sampling, see
        # trace_photons), which is unbiased: the indicator's score term
        # cancels the pathwise -g·P'/P piece exactly.
        y_old = spectrum.luminance(alpha)
        y_new = spectrum.luminance(anew)
        p_cont = jnp.minimum(1.0, y_new / jnp.where(y_old == 0.0, 1.0, y_old))
        survive = u[:, 2] <= p_cont
        cont = cont & survive & (p_cont > 0.0)
        anew = anew / jnp.where(p_cont == 0.0, 1.0, p_cont)[:, None]

    # --- merge next-ray state ----------------------------------------------
    next_alive = spec_hit | cont
    o2 = jnp.where(next_alive[:, None], hit.p, o)
    d2 = jnp.where(spec_hit[:, None], wi_s, jnp.where(cont[:, None], wi_d, d))
    alpha2 = jnp.where(
        spec_hit[:, None], alpha * thr, jnp.where(cont[:, None], anew, alpha)
    )
    # nIntersections: specular bumps 0→1 only (photontracing.cu:126-129);
    # diffuse continuation increments (photontracing.cu:182)
    n_int2 = jnp.where(
        spec_hit & (n_int == 0), 1, jnp.where(cont, n_int + 1, n_int)
    )
    # a specular path whose throughput went black can never deposit again
    next_alive = next_alive & ~spectrum.is_black(alpha2)
    return dict(
        deposit=deposit, slot=slot, dep_p=hit.p, dep_alpha=alpha, dep_wi=-d,
        o=o2, d=d2, alpha=alpha2, n_int=n_int2, alive=next_alive,
        pair_overflow=pair_overflow,
        # chain recording (record-and-replay AD, trace_photons): append a
        # bounce's material id iff its alpha factor actually contains kd —
        # diffuse continuations (fr = kd/π) and MIRROR bounces (thr = Kr,
        # stored in kd). GLASS throughput is ones (kd-independent): recording
        # it would yield a spurious d(alpha)/d(kd[glass]) in the replay
        # ratio (the true gradient is 0).
        append=next_alive
        & (cont | (spec_hit & mat_ops.kd_in_specular(scene.materials,
                                                     hit.mat))),
        append_mat=hit.mat,
    )


def _photon_walk_compact(step, k_bounce, gids, alive, o, d, alpha, ph,
                         config, k, ph_chain=None):
    """Photon walk with survivor compaction (see common.compact_queue_size):
    step 0 runs full-batch (every path is live), then survivors are gathered
    into a static k-wide queue and walked TO COMPLETION by an inner bounce
    loop over k lanes only; their deposit slab rows write back once per
    batch, instead of a full-width jnp.nonzero + state scatters on every
    step; deposits use _dep_write's dense one-hot and the batches k-ROW
    slab gathers/scatters. Each path takes
    at most `max_photon_bounces` steps, so the walks produce the same
    photon sets as the full-batch loop up to XLA fusion noise."""
    n = o.shape[0]
    max_depth = config.max_photon_depth
    record = ph_chain is not None
    CH = config.max_photon_bounces
    ph_p, ph_alpha, ph_wi, ph_valid = ph  # [n, max_depth·w] slab buffers
    chain = (jnp.full((n, CH), -1, jnp.int32) if record else None)
    cptr = (jnp.zeros((n,), jnp.int32) if record else None)

    # ---- step 0: full batch ----------------------------------------------
    u0 = _bounce_uniforms(k_bounce, gids, jnp.zeros((n,), jnp.int32))
    out = step(o, d, alpha, jnp.zeros((n,), jnp.int32), alive, u0)
    pair_ovf = out["pair_overflow"]
    dep = out["deposit"]
    slot = out["slot"]
    ph_p = _dep_write(ph_p, dep, slot, out["dep_p"], max_depth, 3)
    ph_alpha = _dep_write(ph_alpha, dep, slot, out["dep_alpha"], max_depth, 3)
    ph_wi = _dep_write(ph_wi, dep, slot, out["dep_wi"], max_depth, 3)
    ph_valid = _dep_mark(ph_valid, dep, slot, max_depth)
    if record:
        ph_chain = _dep_write(ph_chain, dep, slot, chain, max_depth, CH)
        app = out["append"]
        col = jnp.clip(cptr, 0, CH - 1)
        chain = _chain_append(chain, app, col, out["append_mat"], CH)
        cptr = cptr + app.astype(jnp.int32)
    alive = out["alive"]
    o, d, alpha, n_int = out["o"], out["d"], out["alpha"], out["n_int"]
    alive = alive & (config.max_photon_bounces > 1)

    # ---- warm full-width steps --------------------------------------------
    # photon survivors decay slowly (RR survival ≈ y(kd) per bounce), so
    # compacting right after step 0 would split ~60% of the batch across
    # several queue batches, each re-walked to its full depth. A few more
    # full-width steps first let the population decay below the queue width
    # so ONE batch finishes the tail. (The camera pass doesn't need this:
    # only specular hits survive bounce 0.)
    # 0 = auto: small launches warm 3 full-width steps (survivor decay is
    # slow and queue batches re-walk to full depth), but at multi-million-
    # path scale each full-width step is an expensive incoherent intersect,
    # so ONE warm step precedes the k-wide queue there (the walks are
    # equivalent estimators at any batching)
    warm_cfg = config.compact_warm_steps or (3 if n < (1 << 21) else 1)
    warm = min(warm_cfg, config.max_photon_bounces - 1)
    if warm > 1:
        def wcond(s):
            it, alive, *_ = s
            return (it < warm) & jnp.any(alive)

        def wbody(s):
            it, alive, o, d, alpha, n_int, ph, ovf, rec_st = s
            ph_p, ph_alpha, ph_wi, ph_valid, ph_ch = ph
            u = _bounce_uniforms(k_bounce, gids, n_int)
            out = step(o, d, alpha, n_int, alive, u)
            ovf = ovf + out["pair_overflow"]
            dep = out["deposit"]
            slot = out["slot"]
            ph_p = _dep_write(ph_p, dep, slot, out["dep_p"], max_depth, 3)
            ph_alpha = _dep_write(ph_alpha, dep, slot, out["dep_alpha"],
                                  max_depth, 3)
            ph_wi = _dep_write(ph_wi, dep, slot, out["dep_wi"], max_depth, 3)
            ph_valid = _dep_mark(ph_valid, dep, slot, max_depth)
            if record:
                ch, cp = rec_st
                ph_ch = _dep_write(ph_ch, dep, slot, ch, max_depth, CH)
                app = out["append"]
                col = jnp.clip(cp, 0, CH - 1)
                ch = _chain_append(ch, app, col, out["append_mat"], CH)
                rec_st = (ch, cp + app.astype(jnp.int32))
            alive2 = out["alive"] & (it + 1 < config.max_photon_bounces)
            return (it + 1, alive2, out["o"], out["d"], out["alpha"],
                    out["n_int"], (ph_p, ph_alpha, ph_wi, ph_valid, ph_ch),
                    ovf, rec_st)

        (wsteps, alive, o, d, alpha, n_int,
         (ph_p, ph_alpha, ph_wi, ph_valid, ph_chain), pair_ovf,
         rec_w) = jax.lax.while_loop(
            wcond, wbody,
            (jnp.int32(1), alive, o, d, alpha, n_int,
             (ph_p, ph_alpha, ph_wi, ph_valid, ph_chain), pair_ovf,
             ((chain, cptr) if record else ())),
        )
        if record:
            chain, cptr = rec_w
    else:
        wsteps = jnp.int32(1)

    max_batches = -(-n // k)

    def inner_cond(s):
        stp, alive_k, *_ = s
        return (stp < config.max_photon_bounces) & jnp.any(alive_k)

    def inner_body(s):
        """One walk step for the k queued lanes — k-sized ops only; deposits
        land in the batch-local [k, max_depth·w] slab rows."""
        (stp, alive_k, o_k, d_k, a_k, ni_k, gid_k, dph, ovf_k,
         rec_k) = s
        dp, da, dw, dv, dc = dph
        u = _bounce_uniforms(k_bounce, gid_k, ni_k)
        out = step(o_k, d_k, a_k, ni_k, alive_k, u)
        ovf_k = ovf_k + out["pair_overflow"]
        depk = out["deposit"]
        slot = out["slot"]
        dp = _dep_write(dp, depk, slot, out["dep_p"], max_depth, 3)
        da = _dep_write(da, depk, slot, out["dep_alpha"], max_depth, 3)
        dw = _dep_write(dw, depk, slot, out["dep_wi"], max_depth, 3)
        dv = _dep_mark(dv, depk, slot, max_depth)
        if record:
            ch_k, cp_k = rec_k
            dc = _dep_write(dc, depk, slot, ch_k, max_depth, CH)
            app = out["append"]
            col = jnp.clip(cp_k, 0, CH - 1)
            ch_k = _chain_append(ch_k, app, col, out["append_mat"], CH)
            rec_k = (ch_k, cp_k + app.astype(jnp.int32))
        return (stp + 1, out["alive"], out["o"], out["d"], out["alpha"],
                out["n_int"], gid_k, (dp, da, dw, dv, dc), ovf_k, rec_k)

    def outer_cond(s):
        it, alive, *_ = s
        return (it < max_batches) & jnp.any(alive)

    def outer_body(s):
        it, alive, ph, ovf = s
        ph_p, ph_alpha, ph_wi, ph_valid, ph_ch = ph
        idx_raw = jnp.nonzero(alive, size=k, fill_value=n)[0]
        sel = idx_raw < n
        idx = jnp.minimum(idx_raw, n - 1)

        # batch-local slab rows seeded from the full-width-step deposits so
        # the final row write-back can't erase them (k-ROW gathers — the
        # former flat [k·max_depth]-row form cost a full-width scatter's
        # worth per buffer per batch)
        dph = (ph_p[idx], ph_alpha[idx], ph_wi[idx], ph_valid[idx],
               ph_ch[idx] if record else None)
        rec_k = ((chain[idx], cptr[idx]) if record else ())
        init = (wsteps, sel, o[idx], d[idx], alpha[idx], n_int[idx],
                gids[idx], dph, jnp.int32(0), rec_k)
        _, _, _, _, _, _, _, dph, ovf_k, _ = jax.lax.while_loop(
            inner_cond, inner_body, init
        )
        # unselected (fill) lanes never run a live step (act=False → no
        # deposit), so their dph rows are untouched seeds; idx_raw = n for
        # them → dropped by the scatter
        scat = lambda buf, v: buf.at[idx_raw].set(v, mode="drop")
        ph = (
            scat(ph_p, dph[0]),
            scat(ph_alpha, dph[1]),
            scat(ph_wi, dph[2]),
            scat(ph_valid, dph[3]),
            scat(ph_ch, dph[4]) if record else None,
        )
        alive2 = alive.at[idx_raw].set(False, mode="drop")
        return it + 1, alive2, ph, ovf + ovf_k

    init = (jnp.int32(0), alive,
            (ph_p, ph_alpha, ph_wi, ph_valid, ph_chain), pair_ovf)
    _, _, ph, pair_ovf = jax.lax.while_loop(outer_cond, outer_body, init)
    return ph[:4], pair_ovf, ph[4]


ROWSPAN_MIN_SLOTS = 1 << 14
# implementation of the row-span gather's job blocks on the render path
# (rowspan_gather.gather_radius_rowspan `impl`); tools/ab_rowspan.py
# compiles the render with each value for the kernel A/B
ROWSPAN_IMPL = "pallas"


def gather_method(platform: str, n_slots: int, config: RenderConfig) -> str:
    """Radius-search implementation for a photon map of n_slots slots:
    "dense" (exact all-pairs scan), "rowspan" (exact row-span gather,
    ops/rowspan_gather.py) or "grid" (the budgeted hash grid).

    On the GPU every path is exact: the row-span gather from
    ROWSPAN_MIN_SLOTS slots up, the all-pairs scan below. Elsewhere (the
    CPU) maps under AD below 2^15 slots take the all-pairs scan and the
    rest the hash grid."""
    if config.exact_gather:
        return "dense"
    if config.differentiable and n_slots < (1 << 15):
        return "dense"
    if platform == "gpu":
        return "rowspan" if n_slots >= ROWSPAN_MIN_SLOTS else "dense"
    return "grid"


def rowspan_capacity(config: RenderConfig, n_slots: int) -> tuple[int, int]:
    """(job_budget, rounds) of the row-span gather: capacity is their
    product in (query tile, photon chunk) jobs. Config 0 = 2^17 jobs × a
    round count that scales with the map, clamped to [4, 16]."""
    rounds = config.gather_rounds or max(4, min(16, n_slots >> 18))
    return config.gather_job_budget or (1 << 17), rounds


def gathering_pass(
    scene: Scene,
    rec: common.CameraRecords,
    state: ProgressiveState,
    photons: photon_grid.PhotonMap,
    config: RenderConfig,
    interpret: bool = False,
) -> tuple[ProgressiveState, dict]:
    """Progressive radius/flux update (reference: gathering.cu:104-126).

    The radius search is chosen by gather_method from the platform and the
    map size. interpret=True runs the row-span gather's Pallas kernels in
    the Pallas interpreter (tests on the CPU).

    Gather JOB-BUDGET overflow is UNBIASED when state.emitted is tracked
    (the renderer entry points initialize it): a pixel tile the budget
    skipped returns L = 0 / M = 0 AND is excluded from that pixel's
    emitted-path normalization — the pixel's estimate simply uses fewer
    waves (still warned + counted in the aux dict; raise
    config.gather_rounds / gather_job_budget to eliminate it). Legacy
    callers with state.emitted = None keep the old biased-dark semantics
    under overflow (final_gathering then normalizes by ALL emitted
    paths)."""
    wo = vec.normalize(-rec.direction)
    kd_over_pi = mat_ops.f(scene.materials, rec.mat, wo, wo, uv=rec.uv)

    gather_overflow = jnp.int32(0)
    covered = None  # None = every query participated (exact paths)
    method = gather_method(jax.default_backend(), photons.p.shape[0], config)
    if method == "dense":
        idl, m = photon_grid.gather_radius_dense(
            photons, rec.p, state.radius2, rec.ns, kd_over_pi
        )
        info = dict(valid_photons=jnp.sum(photons.valid).astype(jnp.int32),
                    max_cell_occupancy=jnp.int32(-1))  # -1 = exact path
    elif method == "rowspan":
        from raytrace_tpu.ops import rowspan_gather

        # Photons sorted by linear cell key, per-tile (z, y)-row spans merged
        # into a packed (tile, chunk) job list — cost ∝ photons actually
        # near each query tile. Cell size is the q90 LIVE radius
        # (gather_cell_size) and each tile reaches ceil(max_tile_radius /
        # cell) cells; miss-pixel queries have radius² = 0 so they never
        # widen a tile's cell box. DIFFERENTIABLE: custom VJP over the same
        # job list, so fwd+bwd both run the kernels.
        cell_size = gather_cell_size(rec, state)
        q_r2 = jnp.where(rec.hit, state.radius2, 0.0)
        job_budget, rounds = rowspan_capacity(config, photons.p.shape[0])
        idl, m, gather_overflow, covered = (
            rowspan_gather.gather_radius_rowspan(
                photons.p, photons.alpha, photons.wi, photons.valid,
                cell_size, rec.p, q_r2, rec.ns, kd_over_pi,
                r_max=config.gather_r_max,
                rounds=rounds,
                job_budget=job_budget,
                impl=ROWSPAN_IMPL,
                interpret=interpret,
                return_covered=True,
            )
        )
        isect_ops.debug_warn_nonzero(
            gather_overflow,
            "WARNING raytrace_tpu: gather job budget overflow by {} "
            "jobs — affected pixel tiles skip this wave (excluded "
            "from their normalization); raise gather_rounds",
        )
        info = dict(valid_photons=jnp.sum(photons.valid).astype(jnp.int32),
                    max_cell_occupancy=jnp.int32(-1))  # -1: exact, no budget
    else:
        cell_size = jnp.sqrt(jnp.float32(config.initial_radius2))
        grid = photon_grid.build_photon_grid(photons, cell_size)
        idl, m = photon_grid.gather_radius(
            grid, rec.p, state.radius2, rec.ns, wo, kd_over_pi,
            max_per_cell=config.grid_max_photons_per_cell,
        )
        occ = photon_grid.max_cell_occupancy(grid)
        # the per-cell budget TRUNCATES flux (and gradient) when exceeded —
        # fail loudly instead of silently biasing the estimate; the excess
        # also rides the aux dict (gather_overflow) for host-side assertions
        over_budget = jnp.maximum(
            occ - config.grid_max_photons_per_cell, 0
        ).astype(jnp.int32)
        isect_ops.debug_warn_nonzero(
            over_budget,
            "WARNING raytrace_tpu: photon grid cell occupancy exceeds "
            "grid_max_photons_per_cell by {} — flux/gradient truncated; "
            "raise the budget or use the exact gather",
        )
        gather_overflow = gather_overflow + over_budget
        info = dict(valid_photons=grid.n_valid, max_cell_occupancy=occ)
    info["gather_overflow"] = gather_overflow

    m = jnp.where(rec.hit, m, 0)
    a = jnp.float32(config.ppm_alpha)
    mf = m.astype(jnp.float32)
    new_count = state.photon_count + a * mf
    denom = state.photon_count + mf
    ratio = new_count / jnp.where(denom == 0.0, 1.0, denom)
    upd = m > 0
    if state.emitted is not None:
        # paths this wave = slots / max depth (robust to sharded maps whose
        # slot count is the GATHERED total, parallel/sharded.py)
        paths_wave = jnp.float32(photons.p.shape[0] // config.max_photon_depth)
        part = paths_wave if covered is None else jnp.where(
            covered, paths_wave, 0.0)
        emitted = state.emitted + part
    else:
        emitted = None
    state = ProgressiveState(
        radius2=jnp.where(upd, state.radius2 * ratio, state.radius2),
        photon_count=jnp.where(upd, new_count, state.photon_count),
        flux=jnp.where(upd[:, None], (state.flux + idl) * ratio[:, None], state.flux),
        emitted=emitted,
    )
    return state, info


def final_gathering(
    rec: common.CameraRecords,
    direct: Array,
    state: ProgressiveState,
    emitting_photons: Array,
) -> Array:
    """Combine DL + IDL (reference: gathering.cu:129-146), weighted by the
    specular-chain throughput (the reference's unused accum_atten, done
    right).

    When state.emitted is tracked, each pixel normalizes by the paths of
    the waves it PARTICIPATED in (gather-overflow waves excluded — the
    unbiased SPPM estimator restricted to that pixel's covered waves);
    emitting_photons is the legacy global denominator otherwise."""
    if state.emitted is not None:
        denom = state.radius2 * jnp.maximum(state.emitted, 1.0)
        have = (state.photon_count != 0.0) & (state.emitted > 0.0)
    else:
        denom = state.radius2 * emitting_photons
        have = state.photon_count != 0.0
    idl = jnp.where(
        have[:, None],
        state.flux * sampling.INV_PI / denom[:, None],
        0.0,
    )
    L = rec.atten * (direct + idl)
    return jnp.where(rec.hit[:, None], L, 0.0)


def render_photon(
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    key: Array,
    jitter: bool = True,
    return_aux: bool = False,
):
    """Full progressive photon-mapping render → [H, W, 3] image."""
    light_samples = common.static_light_samples(scene, config)
    img, aux = _render_photon(
        scene, camera, key, config, light_samples, jitter
    )
    if return_aux:
        return img, aux
    return img


@partial(jax.jit, static_argnames=("config", "light_samples", "jitter"))
def _ppm_setup(
    scene: Scene,
    camera: PerspectiveCamera,
    key: Array,
    config: RenderConfig,
    light_samples: tuple[int, ...],
    jitter: bool,
):
    """Deterministic per-render setup: pixel samples, camera records, direct
    lighting, zeroed PPM state. Recomputed (not checkpointed) on resume —
    it is a pure function of (key, config)."""
    k_pix, k_light, k_photon = jax.random.split(key, 3)
    xy, lens = pixel_samples(
        k_pix, config.width, config.height, config.spp, jitter=jitter
    )
    rays = generate_rays(camera, xy, lens, config.spp)
    rec, cam_aux = common.camera_pass(scene, rays.o, rays.d, config,
                                      rays=rays, return_aux=True)
    direct, dl_aux = common.direct_lighting(
        scene, rec, k_light, config, light_samples, include_emitted=True,
        return_aux=True,
    )
    n = rays.o.shape[0]
    state = ProgressiveState(
        radius2=initial_radius2(rec, config),
        photon_count=jnp.zeros((n,), jnp.float32),
        flux=jnp.zeros((n, 3), jnp.float32),
        emitted=jnp.zeros((n,), jnp.float32),
    )
    pair_ovf = cam_aux["pair_overflow"] + dl_aux["pair_overflow"]
    return xy, rec, direct, state, k_photon, pair_ovf


@partial(jax.jit, static_argnames=("config",))
def _ppm_wave(
    scene: Scene,
    rec: common.CameraRecords,
    state: ProgressiveState,
    k_photon: Array,
    pass_idx: Array,
    config: RenderConfig,
):
    """One progressive photon wave: trace + gather + radius/flux update.
    pass_idx is traced, so every wave reuses one compilation."""
    photons, taux = trace_photons(scene, config, k_photon, pass_idx,
                                  with_aux=True)
    state, info = gathering_pass(scene, rec, state, photons, config)
    info["pair_overflow"] = taux["pair_overflow"]
    return state, info


def render_photon_progressive(
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    key: Array,
    jitter: bool = True,
    checkpoint_path: str | None = None,
    save_every: int = 1,
    verbose: bool = False,
    return_aux: bool = False,
):
    """Wave-by-wave progressive render with optional checkpoint/resume
    (SURVEY.md §5.4 — the reference's PPM state persists only in device
    memory within one run and passes is hard-coded to 1,
    photonmappingrenderer.cpp:38).

    If checkpoint_path exists, rendering resumes from the stored wave;
    otherwise every `save_every` waves the state is written. Waves are pure
    functions of (key, pass index), so resumed == uninterrupted exactly.

    Returns (image [H, W, 3], ProgressiveState); with return_aux, a third
    aux dict whose pair_overflow covers the SETUP intersects (camera pass +
    shadow rays) plus every executed wave's photon-bounce intersects — the
    same 0 == exact contract `_render_photon` provides (a resumed run only
    accounts the waves it executed; re-validate from wave 0 for a full
    frame audit).
    """
    import os

    from raytrace_tpu.utils import checkpoint as ckpt

    light_samples = common.static_light_samples(scene, config)
    xy, rec, direct, state, k_photon, _setup_ovf = _ppm_setup(
        scene, camera, key, config, light_samples, jitter
    )
    pair_ovf = _setup_ovf
    gather_ovf = jnp.int32(0)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        state, start, _, _ = ckpt.load_progressive(checkpoint_path)
    for p in range(start, config.photon_passes):
        from raytrace_tpu.utils import metrics

        with metrics.Throughput() as tp:
            state, info = _ppm_wave(
                scene, rec, state, k_photon, jnp.int32(p), config
            )
            jax.block_until_ready(state.flux)
        pair_ovf = pair_ovf + info["pair_overflow"]
        gather_ovf = gather_ovf + info["gather_overflow"]
        if verbose:
            # per-pass structured log (the reference logs its valid-photon
            # count per pass, photonmappingrenderer.cpp:164)
            metrics.log_pass(
                "photon_wave", wave=p,
                valid_photons=int(info["valid_photons"]),
                photons_per_s=f"{tp.rate(config.photon_paths):.3e}",
                mean_radius2=float(
                    jnp.mean(jnp.where(rec.hit, state.radius2, 0.0))
                ),
            )
        done = p + 1
        if checkpoint_path and save_every and (
            done % save_every == 0 or done == config.photon_passes
        ):
            ckpt.save_progressive(
                checkpoint_path, jax.device_get(state), done, key,
                emitted_photons=float(config.photon_paths) * done,
            )
    emitting = jnp.float32(config.photon_paths * config.photon_passes)
    L = final_gathering(rec, direct, state, emitting)
    img = film.splat(xy, L, config.width, config.height,
                     config.pixel_filter, config.filter_radius)
    if return_aux:
        aux = dict(pair_overflow=pair_ovf, gather_overflow=gather_ovf)
        return img, state, aux
    return img, state


@partial(jax.jit, static_argnames=("config", "light_samples", "jitter"))
def _render_photon(
    scene: Scene,
    camera: PerspectiveCamera,
    key: Array,
    config: RenderConfig,
    light_samples: tuple[int, ...],
    jitter: bool,
):
    k_pix, k_light, k_photon = jax.random.split(key, 3)
    xy, lens = pixel_samples(
        k_pix, config.width, config.height, config.spp, jitter=jitter
    )
    rays = generate_rays(camera, xy, lens, config.spp)
    n = rays.o.shape[0]

    # pass 1: camera records + direct lighting (raytracing.cu)
    rec, cam_aux = common.camera_pass(scene, rays.o, rays.d, config,
                                      rays=rays, return_aux=True)
    direct, dl_aux = common.direct_lighting(
        scene, rec, k_light, config, light_samples, include_emitted=True,
        return_aux=True,
    )

    state = ProgressiveState(
        radius2=initial_radius2(rec, config),
        photon_count=jnp.zeros((n,), jnp.float32),
        flux=jnp.zeros((n, 3), jnp.float32),
        emitted=jnp.zeros((n,), jnp.float32),
    )

    # progressive photon waves (reference hard-codes passes=1,
    # photonmappingrenderer.cpp:38; ours is configurable). lax.scan over the
    # pass index compiles ONE wave regardless of photon_passes — pass_idx
    # only feeds RNG fold_ins, so the trace is pass-independent.
    def wave(carry, p):
        state, vp, occ, ovf, povf = carry
        photons, taux = trace_photons(scene, config, k_photon, p,
                                      with_aux=True)
        state, info = gathering_pass(scene, rec, state, photons, config)
        return (
            state,
            vp + info["valid_photons"],
            jnp.maximum(occ, info["max_cell_occupancy"]),
            ovf + info["gather_overflow"],
            povf + taux["pair_overflow"],
        ), None

    (state, valid_photons, max_occ, gather_ovf, photon_pair_ovf), _ = (
        jax.lax.scan(
            wave,
            (state, jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0)),
            jnp.arange(config.photon_passes),
        )
    )

    emitting = jnp.float32(config.photon_paths * config.photon_passes)
    L = final_gathering(rec, direct, state, emitting)
    img = film.splat(xy, L, config.width, config.height,
                     config.pixel_filter, config.filter_radius)
    aux = dict(
        valid_photons=valid_photons,
        max_cell_occupancy=max_occ,
        gather_overflow=gather_ovf,
        # intersections dropped by a traversal budget across every camera,
        # shadow and photon-bounce intersect of the frame (every traversal
        # is exact, so 0; callers assert on it)
        pair_overflow=(cam_aux["pair_overflow"] + dl_aux["pair_overflow"]
                       + photon_pair_ovf),
        mean_radius2=jnp.mean(jnp.where(rec.hit, state.radius2, 0.0)),
        mean_photon_count=jnp.mean(state.photon_count),
    )
    return img, aux
