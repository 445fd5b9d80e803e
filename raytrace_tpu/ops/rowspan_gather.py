"""Exact photon radius search + shading over a linear-cell-sorted photon grid:
the row-span gather.

The reference walks a kd-tree per pixel with an explicit 40-deep stack
(gathering.cu:25-96). Here the search is a packed job list over a sorted
photon array:

  1. photons sort by LINEAR cell key (cz<<20 | cy<<10 | cx), so every
     (z, y) row's x-interval is ONE contiguous span of the sorted array;
  2. queries sort by Morton key and group into TILE_Q-query tiles; each
     tile's neighborhood box becomes ≤ r_max row spans (two searchsorted
     calls per row); rows have strictly increasing key ranges, so spans
     are disjoint;
  3. each tile's spans are merged (no photon chunk is scanned twice for a
     tile) and expanded into a tile-major list of (tile, chunk) jobs, so a
     tile's jobs form the contiguous range [tile_start, tile_start +
     tile_jobs) of the list;
  4. every job is one [TILE_Q, chunk] block of the exact dist² < r² test
     (gathering.cu:40-42) and the |n_s·wi|-weighted flux sum.

Step 4 has two implementations over the same job list:
  - "pallas": a Pallas kernel through Triton. One program per query
    sub-tile loops over its tile's job range, loads each photon chunk from
    device memory in p_block slices, keeps S (rgb) and the count M in
    registers and writes its output once. The VJP kernel runs one program
    per photon sub-chunk over the chunk-major job list (deterministic, no
    atomics).
  - "xla": the same per-job weight blocks in jax.numpy, batched over jobs
    with a scatter-add into the tiles (the kernel's test reference and the
    plain side of the kernel A/B).

Capacity: the job list holds job_budget·rounds jobs. Truncation cuts a
tile-major SUFFIX; a tile is complete exactly when tile_start + tile_jobs ≤
capacity, and incomplete tiles return S = M = 0 (their pixels skip the wave;
`covered` reports which queries were complete).

DIFFERENTIABILITY: the kernels accumulate the raw weighted-flux sum
    S[q] = Σ_{p: dist²<r²} |n_s·wi_p| · α_p          (and the count M)
and the Lambert kd/π factor multiplies outside, so L = kd·S gets its kd
gradient from plain AD. S is linear in α with weights that depend only on
stop-gradient geometry, so its VJP is the transposed accumulation over the
same job list (reference estimator being differentiated: gathering.cu:104-146,
which has no backward at all).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

ROWSPAN_CHUNK = 512
R_MAX = 32
TILE_Q = 128
_KEY_SENTINEL = jnp.int32(0x40000000)  # > any packed key (30 bits)

# Row layouts of the kernel operands ([rows, N] structure-of-arrays).
_Q_ROWS = 8   # qx qy qz r2 nsx nsy nsz pad
_G_ROWS = 8   # px py pz wx wy wz valid pad


class KernelConfig(NamedTuple):
    """Static choices of the per-job block implementation. The block sizes
    are the fastest of a sweep at the headline config on an H100
    (tools/ab_rowspan.py; PERF.md)."""
    impl: str = "pallas"      # "pallas" (Triton kernel) | "xla" (jnp)
    interpret: bool = False   # Pallas interpreter (CPU tests only)
    chunk: int = ROWSPAN_CHUNK
    q_block: int = 8          # forward: queries per program
    p_block: int = 128        # forward: photons per register block
    bwd_q_block: int = 128    # backward: queries per register block
    bwd_p_block: int = 32     # backward: photons per program
    num_warps: int = 4
    num_stages: int = 1
    xla_job_batch: int = 64   # jobs per step of the jnp version


# what gather_radius_rowspan runs (impl, interpret and chunk come from its
# arguments); tools/ab_rowspan.py swaps in its plain-version batch size
DEFAULT_KERNEL = KernelConfig()


def _weights(q, g):
    """In-radius mask and |n_s·wi| weight (zero outside) for broadcastable
    query fields q = (qx, qy, qz, r2, nsx, nsy, nsz) and photon fields
    g = (px, py, pz, wx, wy, wz, valid)."""
    qx, qy, qz, r2, nx, ny, nz = q
    px, py, pz, wx, wy, wz, pv = g
    dx = qx - px
    dy = qy - py
    dz = qz - pz
    dist2 = dx * dx + dy * dy + dz * dz
    ok = (dist2 < r2) & (pv > 0.0)
    w = jnp.abs(nx * wx + ny * wy + nz * wz)
    return ok, jnp.where(ok, w, 0.0)


# ---------------------------------------------------------------------------
# Pallas kernels (Triton route). Both keep their sums as [query, photon]
# register blocks updated elementwise, and reduce across the block once,
# after the last job: a reduction per block step would cost cross-thread
# shuffles on every step.
# ---------------------------------------------------------------------------

def _fwd_kernel(tstart_ref, tcount_ref, jchunk_ref, q_ref, geo_ref,
                alpha_ref, out_ref, *, chunk, qb, pb):
    i = pl.program_id(0)
    tile = i // (TILE_Q // qb)
    qs = pl.ds(i * qb, qb)
    q = tuple(q_ref[k, qs][:, None] for k in range(7))
    j0 = tstart_ref[tile]
    nj = tcount_ref[tile]

    def block(b, acc, base):
        ps = pl.ds(base + b * pb, pb)
        g = tuple(geo_ref[k, ps][None, :] for k in range(7))
        ok, wm = _weights(q, g)
        s0, s1, s2, m = acc
        return (s0 + wm * alpha_ref[0, ps][None, :],
                s1 + wm * alpha_ref[1, ps][None, :],
                s2 + wm * alpha_ref[2, ps][None, :],
                m + ok.astype(jnp.float32))

    def job(j, acc):
        base = jchunk_ref[j0 + j] * chunk
        return jax.lax.fori_loop(
            0, chunk // pb, functools.partial(block, base=base), acc)

    z = jnp.zeros((qb, pb), jnp.float32)
    acc = jax.lax.fori_loop(0, nj, job, (z, z, z, z))
    for k in range(4):
        out_ref[k, qs] = jnp.sum(acc[k], axis=1)


def _bwd_kernel(cstart_ref, ccount_ref, jtile_ref, q_ref, cot_ref, geo_ref,
                dalpha_ref, *, chunk, qb, pb):
    i = pl.program_id(0)
    c = i // (chunk // pb)
    ps = pl.ds(i * pb, pb)
    g = tuple(geo_ref[k, ps][None, :] for k in range(7))
    j0 = cstart_ref[c]
    nj = ccount_ref[c]

    def block(b, acc, base):
        qs = pl.ds(base + b * qb, qb)
        q = tuple(q_ref[k, qs][:, None] for k in range(7))
        _, wm = _weights(q, g)
        return tuple(acc[k] + wm * cot_ref[k, qs][:, None] for k in range(3))

    def job(j, acc):
        base = jtile_ref[j0 + j] * TILE_Q
        return jax.lax.fori_loop(
            0, TILE_Q // qb, functools.partial(block, base=base), acc)

    z = jnp.zeros((qb, pb), jnp.float32)
    acc = jax.lax.fori_loop(0, nj, job, (z, z, z))
    for k in range(3):
        dalpha_ref[k, ps] = jnp.sum(acc[k], axis=0)


def _pallas(kernel, cfg: KernelConfig, name: str, grid: int, out_shape):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(grid,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=cfg.num_warps, num_stages=cfg.num_stages),
        interpret=cfg.interpret,
        name=name,
    )


def _fwd_pallas(cfg: KernelConfig, alpha, geo, q, jobs):
    job_tile, job_chunk, tile_start, tile_count, _ = jobs
    nq = q.shape[1]
    kernel = functools.partial(_fwd_kernel, chunk=cfg.chunk, qb=cfg.q_block,
                               pb=cfg.p_block)
    return _pallas(kernel, cfg, "rowspan_gather_fwd", nq // cfg.q_block,
                   jax.ShapeDtypeStruct((4, nq), jnp.float32))(
        tile_start, tile_count, job_chunk, q, geo, alpha)


def _bwd_pallas(cfg: KernelConfig, geo, q, cot, jobs):
    job_tile, job_chunk, _, _, n_exec = jobs
    n_pad = geo.shape[1]
    n_chunks = n_pad // cfg.chunk
    n_tiles = q.shape[1] // TILE_Q
    cap = job_chunk.shape[0]
    valid = jnp.arange(cap, dtype=jnp.int32) < n_exec
    # chunk-major job order (ties by tile, so the sums run in a fixed order)
    key = jnp.where(valid, job_chunk * n_tiles + job_tile, n_chunks * n_tiles)
    jtile_c = job_tile[jnp.argsort(key)]
    ccount = jnp.zeros((n_chunks,), jnp.int32).at[
        jnp.where(valid, job_chunk, n_chunks)].add(1, mode="drop")
    cstart = jnp.cumsum(ccount) - ccount
    kernel = functools.partial(_bwd_kernel, chunk=cfg.chunk,
                               qb=cfg.bwd_q_block, pb=cfg.bwd_p_block)
    return _pallas(kernel, cfg, "rowspan_gather_bwd", n_pad // cfg.bwd_p_block,
                   jax.ShapeDtypeStruct((3, n_pad), jnp.float32))(
        cstart, ccount, jtile_c, q, cot, geo)


# ---------------------------------------------------------------------------
# Plain jax.numpy version of the same job blocks
# ---------------------------------------------------------------------------

def _xla_job_loop(cfg: KernelConfig, q, geo, jobs, body, init):
    """Run body(acc, tiles, chunks, ok_job, q_blk, g_blk) over the executed
    jobs in batches of cfg.xla_job_batch. q_blk fields are [B, TILE_Q, 1],
    g_blk fields [B, 1, chunk]."""
    job_tile, job_chunk, _, _, n_exec = jobs
    cap = job_chunk.shape[0]
    n_tiles = q.shape[1] // TILE_Q
    n_chunks = geo.shape[1] // cfg.chunk
    qt = q.reshape(_Q_ROWS, n_tiles, TILE_Q).transpose(1, 0, 2)
    gt = geo.reshape(_G_ROWS, n_chunks, cfg.chunk).transpose(1, 0, 2)
    bsz = cfg.xla_job_batch

    def step(i, acc):
        j = i * bsz + jnp.arange(bsz, dtype=jnp.int32)
        ok_job = j < n_exec
        jj = jnp.minimum(j, cap - 1)
        tiles, chunks = job_tile[jj], job_chunk[jj]
        qb, gb = qt[tiles], gt[chunks]
        q_blk = tuple(qb[:, k, :, None] for k in range(7))
        g_blk = tuple(gb[:, k, None, :] for k in range(7))
        return body(acc, tiles, chunks, ok_job, q_blk, g_blk)

    return jax.lax.fori_loop(0, -(-n_exec // bsz), step, init)


def _fwd_xla(cfg: KernelConfig, alpha, geo, q, jobs):
    nq = q.shape[1]
    n_tiles = nq // TILE_Q
    at = alpha.reshape(3, -1, cfg.chunk).transpose(1, 0, 2)

    def body(out, tiles, chunks, ok_job, q_blk, g_blk):
        ok, wm = _weights(q_blk, g_blk)
        ok = ok & ok_job[:, None, None]
        wm = jnp.where(ok_job[:, None, None], wm, 0.0)
        ab = at[chunks]
        s = [jnp.sum(wm * ab[:, k, None, :], axis=-1) for k in range(3)]
        s.append(jnp.sum(ok.astype(jnp.float32), axis=-1))
        return out.at[tiles].add(jnp.stack(s, axis=1))  # [B, 4, TILE_Q]

    out = _xla_job_loop(cfg, q, geo, jobs, body,
                        jnp.zeros((n_tiles, 4, TILE_Q), jnp.float32))
    return out.transpose(1, 0, 2).reshape(4, nq)


def _bwd_xla(cfg: KernelConfig, geo, q, cot, jobs):
    n_pad = geo.shape[1]
    n_chunks = n_pad // cfg.chunk
    ct = cot.reshape(3, -1, TILE_Q).transpose(1, 0, 2)

    def body(d, tiles, chunks, ok_job, q_blk, g_blk):
        _, wm = _weights(q_blk, g_blk)
        wm = jnp.where(ok_job[:, None, None], wm, 0.0)
        cb = ct[tiles]
        da = [jnp.sum(wm * cb[:, k, :, None], axis=1) for k in range(3)]
        return d.at[chunks].add(jnp.stack(da, axis=1))  # [B, 3, chunk]

    d = _xla_job_loop(cfg, q, geo, jobs, body,
                      jnp.zeros((n_chunks, 3, cfg.chunk), jnp.float32))
    return d.transpose(1, 0, 2).reshape(3, n_pad)


_FWD = {"pallas": _fwd_pallas, "xla": _fwd_xla}
_BWD = {"pallas": _bwd_pallas, "xla": _bwd_xla}


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def flux_sums(cfg: KernelConfig, alpha, geo, q, jobs):
    """[4, NQ] rows S_r, S_g, S_b, M over the executed jobs. alpha [3, P],
    geo [8, P] and q [8, NQ] are row layouts (_G_ROWS / _Q_ROWS); jobs =
    (job_tile, job_chunk, tile_start, tile_count, n_exec) with tile_count
    zero for incomplete tiles and the executed jobs the prefix [0, n_exec).
    Differentiable in alpha only (custom VJP over the same job list)."""
    return _FWD[cfg.impl](cfg, alpha, geo, q, jobs)


def _flux_sums_fwd(cfg, alpha, geo, q, jobs):
    return flux_sums(cfg, alpha, geo, q, jobs), (geo, q, jobs)


def _flux_sums_bwd(cfg, res, cot):
    geo, q, jobs = res
    dalpha = _BWD[cfg.impl](cfg, geo, q, cot[:3], jobs)
    f0 = lambda x: np.zeros(x.shape, jax.dtypes.float0)
    return (dalpha, jnp.zeros_like(geo), jnp.zeros_like(q),
            jax.tree_util.tree_map(f0, jobs))


flux_sums.defvjp(_flux_sums_fwd, _flux_sums_bwd)


# ---------------------------------------------------------------------------
# Job list + public entry point
# ---------------------------------------------------------------------------

def build_jobs(photons_p, photons_alpha, photons_wi, photons_valid,
               cell_size, q_p, radius2, q_ns, *, chunk, capacity, r_max):
    """Sort photons and queries, build the tile-major (tile, chunk) job list.

    Returns (alpha [3, P_pad], geo [8, P_pad], q [8, NQ_pad], jobs,
    q_order, overflow, complete); q_order[i] is the query stored at sorted
    slot i and complete [n_tiles] marks the tiles whose jobs all fit."""
    from raytrace_tpu.ops import photon_grid as pg

    sg = jax.lax.stop_gradient
    q_p_s = sg(q_p)
    radius2 = sg(radius2)
    n = q_p.shape[0]
    p = photons_p.shape[0]
    cell_size = jnp.float32(cell_size)

    # ---- sort photons by linear cell key (invalid → sentinel, sorts last)
    pp = sg(photons_p)
    pv = sg(photons_valid)
    cell = jnp.floor(pp / cell_size).astype(jnp.int32)
    big = jnp.int32(2**30)
    origin = jnp.min(jnp.where(pv[:, None], cell, big), axis=0)
    origin = jnp.where(origin == big, 0, origin)  # no valid photons
    pcell = jnp.clip(cell - origin, 0, 1023)
    pack = lambda z, y, x: (z << 20) | (y << 10) | x
    pkey = jnp.where(
        pv, pack(pcell[:, 2], pcell[:, 1], pcell[:, 0]), _KEY_SENTINEL
    )
    order = jnp.argsort(pkey)
    pkey_s = pkey[order]

    # one packed [P, 11] row gather instead of eleven [P] gathers; geometry
    # columns are stop-gradiented, the alpha columns stay differentiable
    packed = jnp.concatenate(
        [pp, sg(photons_wi), pv.astype(jnp.float32)[:, None],
         jnp.zeros((p, 1), jnp.float32), photons_alpha], axis=1)
    packed_s = packed[order]
    p_pad = -p % chunk
    packed_s = jnp.pad(packed_s, ((0, p_pad), (0, 0)))
    n_chunks = packed_s.shape[0] // chunk
    geo = packed_s[:, :_G_ROWS].T
    alpha = packed_s[:, _G_ROWS:].T

    # ---- Morton-sort queries for tile spatial coherence
    live = radius2 > 0.0
    qcell = jnp.clip(
        jnp.floor(q_p_s / cell_size).astype(jnp.int32) - origin, 0, 1023
    )
    qkey = pg.morton3(qcell)
    qorder = jnp.argsort(jnp.where(live, qkey, jnp.uint32(0xFFFFFFFF)))

    n_pad = -n % TILE_Q
    pad_q = lambda x: jnp.pad(x[qorder].T, ((0, 0), (0, n_pad)))
    q = jnp.concatenate(
        [pad_q(q_p_s), pad_q(radius2[:, None]), pad_q(sg(q_ns)),
         jnp.zeros((1, n + n_pad), jnp.float32)], axis=0)  # pad r² = 0

    # ---- per-tile neighborhood boxes over LIVE queries --------------------
    # adaptive reach: each tile extends by ceil(max_live_radius_tile / cell)
    # cells, so exactness holds for ANY cell size (a query at a cell edge
    # with radius r touches at most ceil(r/cell) cells per axis). This is
    # what lets the cell track the TYPICAL radius instead of the global max
    # — one far-away pixel no longer inflates every tile's spans.
    n_tiles = (n + n_pad) // TILE_Q
    qc_t = jnp.pad(qcell[qorder], ((0, n_pad), (0, 0))).reshape(
        n_tiles, TILE_Q, 3)
    live_t = jnp.pad(live[qorder], (0, n_pad)).reshape(n_tiles, TILE_Q)
    r2_t = jnp.max(q[3].reshape(n_tiles, TILE_Q), axis=1)
    reach_t = jnp.ceil(
        jnp.sqrt(jnp.maximum(r2_t, 0.0)) / cell_size
    ).astype(jnp.int32)[:, None]
    blo = jnp.clip(jnp.min(
        jnp.where(live_t[..., None], qc_t, big), axis=1) - reach_t, 0, 1023)
    bhi = jnp.clip(jnp.max(
        jnp.where(live_t[..., None], qc_t, -big), axis=1) + reach_t, 0, 1023)
    any_live = jnp.any(live_t, axis=1)
    nz = bhi[:, 2] - blo[:, 2] + 1
    ny = bhi[:, 1] - blo[:, 1] + 1
    n_rows = nz * ny

    # rows r ∈ [0, r_max), three tightness levels per tile:
    #   1. n_rows ≤ r_max: one span per (z, y) box row — tightest;
    #   2. nz ≤ r_max:     one span per z-SLAB (keys of a slab's whole
    #      y×x box are contiguous in the z-major linear order) — each slab
    #      over-covers its y-range gaps but EXCLUDES other z levels (a
    #      whole-box span covers every key between the corner z's, i.e.
    #      most of the photon array on large scenes);
    #   3. else: the conservative whole-box span (exact, rarely hit).
    r_ids = jnp.arange(r_max, dtype=jnp.int32)[None, :]  # [1, r_max]
    fits_zy = (n_rows <= r_max)[:, None]
    fits_z = ~fits_zy & (nz <= r_max)[:, None]
    zr = blo[:, 2:3] + r_ids // ny[:, None]
    yr = blo[:, 1:2] + r_ids % ny[:, None]
    klo_fit = pack(zr, yr, blo[:, 0:1])
    khi_fit = pack(zr, yr, bhi[:, 0:1]) + 1
    zs = blo[:, 2:3] + r_ids
    klo_slab = pack(zs, blo[:, 1:2], blo[:, 0:1])
    khi_slab = pack(zs, bhi[:, 1:2], bhi[:, 0:1]) + 1
    klo_fb = pack(blo[:, 2:3], blo[:, 1:2], blo[:, 0:1])
    khi_fb = pack(bhi[:, 2:3], bhi[:, 1:2], bhi[:, 0:1]) + 1
    klo = jnp.where(
        fits_zy, klo_fit,
        jnp.where(fits_z, klo_slab, jnp.where(r_ids == 0, klo_fb, 0)),
    )
    khi = jnp.where(
        fits_zy, khi_fit,
        jnp.where(fits_z, khi_slab, jnp.where(r_ids == 0, khi_fb, 0)),
    )
    valid_row = any_live[:, None] & jnp.where(
        fits_zy, r_ids < n_rows[:, None],
        jnp.where(fits_z, r_ids < nz[:, None], r_ids == 0),
    )

    lo_e = jnp.searchsorted(pkey_s, klo.ravel()).reshape(n_tiles, r_max)
    hi_e = jnp.searchsorted(pkey_s, khi.ravel()).reshape(n_tiles, r_max)
    has = valid_row & (lo_e < hi_e)
    c_lo = jnp.where(has, lo_e // chunk, 0)
    c_hi = jnp.where(has, -(-hi_e // chunk), 0)  # exclusive

    # ---- job list by span-merge + run-expansion ---------------------------
    # Sort each tile's ≤ r_max spans by start chunk, clip overlaps against
    # an exclusive running max of the ends (the union survives exactly),
    # prefix-sum clipped lengths into span offsets, and expand job ids with
    # the scatter-ones + cummax run-expansion idiom. Jobs stay tile-major
    # with ascending chunks, as the suffix-truncation contract requires.
    n_spans_t = r_max
    s_lo, s_hi = jax.lax.sort((c_lo, c_hi), dimension=1, num_keys=1)
    prev_hi = jnp.concatenate(
        [jnp.zeros((n_tiles, 1), jnp.int32),
         jax.lax.cummax(s_hi, axis=1)[:, :-1]], axis=1)
    clip_lo = jnp.maximum(s_lo, prev_hi)
    length = jnp.maximum(s_hi - clip_lo, 0)  # empty spans contribute 0
    lens_flat = length.reshape(-1)  # [n_tiles·n_spans_t], tile-major
    offs = jnp.cumsum(lens_flat)
    n_jobs = offs[-1]
    starts = offs - lens_flat  # inclusive start offset per span
    overflow = jnp.maximum(n_jobs - capacity, 0)
    # scatter each nonempty span's FLAT id (+1) at its start offset, then a
    # running max assigns every job its span (distinct starts by
    # construction; flat ids ascend with starts, so cummax is exact)
    flat_ids = jnp.arange(n_tiles * n_spans_t, dtype=jnp.int32)
    marks = jnp.zeros((capacity,), jnp.int32).at[
        jnp.where(lens_flat > 0, starts, capacity)
    ].max(flat_ids + 1, mode="drop")
    span_of_job = jnp.clip(jax.lax.cummax(marks) - 1, 0,
                           n_tiles * n_spans_t - 1)
    pos_in_span = (jnp.arange(capacity, dtype=jnp.int32)
                   - starts[span_of_job])
    job_chunk = jnp.minimum(
        clip_lo.reshape(-1)[span_of_job] + pos_in_span, n_chunks - 1)
    job_tile = span_of_job // n_spans_t

    tile_jobs = jnp.sum(length, axis=1)
    tile_start = jnp.cumsum(tile_jobs) - tile_jobs
    complete = tile_start + tile_jobs <= capacity
    tile_count = jnp.where(complete, tile_jobs, 0)
    jobs = (job_tile, job_chunk, tile_start, tile_count,
            jnp.sum(tile_count))
    return alpha, geo, q, jobs, qorder, overflow, complete


@functools.partial(
    jax.jit,
    static_argnames=("impl", "interpret", "chunk", "job_budget", "r_max",
                     "rounds", "return_covered"))
def gather_radius_rowspan(
    photons_p: Array,      # [P, 3]
    photons_alpha: Array,  # [P, 3]
    photons_wi: Array,     # [P, 3]
    photons_valid: Array,  # [P] bool
    cell_size,             # scalar grid cell edge — a free TUNING knob:
                           # tiles reach ceil(max_tile_radius / cell) cells,
                           # so results are exact for ANY cell size. Sweet
                           # spot ≈ a high percentile of the live radii
                           # (renderers/photon.gather_cell_size).
    q_p: Array,            # [N, 3]
    radius2: Array,        # [N] (0 disables the query: never matches,
                           #      excluded from tile boxes)
    q_ns: Array,           # [N, 3]
    q_kd_over_pi: Array,   # [N, 3]
    impl: str = "pallas",
    interpret: bool = False,
    chunk: int = ROWSPAN_CHUNK,
    job_budget: int = 1 << 17,
    r_max: int = R_MAX,
    rounds: int = 1,
    return_covered: bool = False,
) -> tuple[Array, Array, Array]:
    """Exact radius search + photon shading → (L [N, 3], M [N] int32,
    overflow [] int32), overflow counting the jobs past the job_budget·rounds
    capacity.

    impl: "pallas" runs the Triton-route kernels (interpret=True runs them
    in the Pallas interpreter, for tests on the CPU); "xla" runs the plain
    jax.numpy version of the same job blocks.

    DIFFERENTIABLE in photons_alpha and q_kd_over_pi; all geometry
    (positions, radii, normals, validity) is stop-gradiented.

    Overflow: queries of incomplete tiles return L = 0, M = 0 — their
    progressive state does not advance that wave. overflow == 0 means every
    tile was scanned completely (exact).

    return_covered: additionally return a [N] bool marking queries whose
    tile was scanned completely (True everywhere when overflow == 0) — the
    per-pixel participation flag the renderer uses to exclude skipped waves
    from a pixel's emitted-path normalization, which keeps overflow unbiased
    instead of biased-dark."""
    n = q_p.shape[0]
    alpha, geo, q, jobs, qorder, overflow, complete = build_jobs(
        photons_p, photons_alpha, photons_wi, photons_valid, cell_size,
        q_p, radius2, q_ns, chunk=chunk, capacity=job_budget * rounds,
        r_max=r_max)
    cfg = DEFAULT_KERNEL._replace(impl=impl, interpret=interpret, chunk=chunk)
    out = flux_sums(cfg, alpha, geo, q, jobs)
    unsort = jnp.argsort(qorder)
    S = out[:3, :n].T[unsort]
    L = q_kd_over_pi * S
    m = jax.lax.stop_gradient(out[3, :n][unsort]).astype(jnp.int32)
    if return_covered:
        covered = jnp.repeat(complete, TILE_Q)[:n][unsort]
        return L, m, overflow, covered
    return L, m, overflow
