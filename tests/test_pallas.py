"""Row-span photon gather (ops/rowspan_gather.py): the Triton-route Pallas
kernels in the Pallas interpreter and the plain jax.numpy version, against
the exact dense gather (photon_grid.gather_radius_dense) and each other."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytrace_tpu.ops import photon_grid as pg
from raytrace_tpu.ops import rowspan_gather as rg


def test_pallas_rowspan_gather_matches_dense():
    """The row-span kernel (linear cell keys, per-tile (z,y)-row spans,
    packed job list) must reproduce the exact dense gather, including
    r²=0-disabled queries, invalid photons, and off-tile-boundary counts."""
    rng = np.random.default_rng(41)
    P, N = 3000, 300
    cell = 0.5
    centers = rng.uniform(-3, 3, (12, 3))
    p = (centers[rng.integers(0, 12, P)] +
         rng.normal(scale=0.4, size=(P, 3))).astype(np.float32)
    alpha = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    wi = rng.normal(size=(P, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    valid = rng.uniform(size=P) < 0.8

    qp = rng.uniform(-3.5, 3.5, (N, 3)).astype(np.float32)
    r2 = rng.uniform(0.01, cell * cell, N).astype(np.float32)
    r2[rng.uniform(size=N) < 0.2] = 0.0  # disabled (miss-pixel) queries
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    kd = rng.uniform(0, 1, (N, 3)).astype(np.float32)

    photons = pg.PhotonMap(p=jnp.asarray(p), alpha=jnp.asarray(alpha),
                           wi=jnp.asarray(wi), valid=jnp.asarray(valid))
    L_ref, m_ref = pg.gather_radius_dense(
        photons, jnp.asarray(qp), jnp.asarray(r2), jnp.asarray(ns),
        jnp.asarray(kd),
    )
    L, m, ovf = rg.gather_radius_rowspan(
        photons.p, photons.alpha, photons.wi, photons.valid, cell,
        jnp.asarray(qp), jnp.asarray(r2), jnp.asarray(ns), jnp.asarray(kd),
        interpret=True, chunk=256,
    )
    assert int(ovf) == 0
    np.testing.assert_allclose(np.asarray(L), np.asarray(L_ref),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m), np.asarray(m_ref))


def test_pallas_rowspan_gather_overflow_counted():
    """With a tiny job budget the kernel must COUNT the jobs it skipped
    rather than silently truncating (observability contract)."""

    rng = np.random.default_rng(7)
    P, N = 4096, 260
    p = rng.uniform(-4, 4, (P, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    wi = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (P, 1))
    qp = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    r2 = np.full(N, 0.25, np.float32)
    ns = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (N, 1))
    kd = np.full((N, 3), 0.3, np.float32)
    _, _, ovf = rg.gather_radius_rowspan(
        jnp.asarray(p), jnp.asarray(alpha), jnp.asarray(wi),
        jnp.ones((P,), bool), 0.5, jnp.asarray(qp), jnp.asarray(r2),
        jnp.asarray(ns), jnp.asarray(kd), interpret=True, chunk=128,
        job_budget=4,
    )
    assert int(ovf) > 0


def test_pallas_rowspan_gather_no_valid_photons():

    rng = np.random.default_rng(5)
    P, N = 300, 130
    p = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    z3 = jnp.zeros((P, 3), jnp.float32)
    L, m, ovf = rg.gather_radius_rowspan(
        jnp.asarray(p), z3, z3, jnp.zeros((P,), bool), 1.0,
        jnp.asarray(rng.uniform(-1, 1, (N, 3)).astype(np.float32)),
        jnp.full((N,), 0.5, jnp.float32),
        jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (N, 1)),
        jnp.full((N, 3), 0.3, jnp.float32),
        interpret=True, chunk=128,
    )
    assert np.asarray(m).sum() == 0
    assert np.abs(np.asarray(L)).sum() == 0.0


def _rowspan_fixture(seed=3, P=3000, N=500):
    rng = np.random.default_rng(seed)
    pp = rng.uniform(0, 8, (P, 3)).astype(np.float32)
    pa = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    pw = rng.normal(size=(P, 3)).astype(np.float32)
    pw /= np.linalg.norm(pw, axis=1, keepdims=True)
    pv = rng.uniform(size=P) < 0.8
    qp = rng.uniform(0, 8, (N, 3)).astype(np.float32)
    r2 = rng.uniform(0.01, 0.4, N).astype(np.float32)
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    kd = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return tuple(jnp.asarray(x) for x in (pp, pa, pw, pv, qp, r2, ns, kd))


def test_pallas_rowspan_custom_vjp_matches_dense_ad():
    """The rowspan gather's custom VJP (transposed Pallas accumulation over
    the same job list) must produce the same dalpha/dkd as plain AD through
    the exact dense gather — the kernel the fwd+bwd path runs on the GPU."""
    pp, pa, pw, pv, qp, r2, ns, kd = _rowspan_fixture()
    cell = float(jnp.sqrt(r2.max()))
    pm = pg.PhotonMap(p=pp, alpha=pa, wi=pw, valid=pv)
    rng = np.random.default_rng(11)
    cot = jnp.asarray(rng.normal(size=qp.shape).astype(np.float32))

    def f_rs(alpha, kd_):
        L, _, _ = rg.gather_radius_rowspan(
            pp, alpha, pw, pv, cell, qp, r2, ns, kd_,
            interpret=True, chunk=256,
        )
        return jnp.sum(L * cot)

    def f_dense(alpha, kd_):
        L, _ = pg.gather_radius_dense(pm.replace(alpha=alpha), qp, r2, ns, kd_)
        return jnp.sum(L * cot)

    g1 = jax.grad(f_rs, argnums=(0, 1))(pa, kd)
    g2 = jax.grad(f_dense, argnums=(0, 1))(pa, kd)
    np.testing.assert_allclose(np.asarray(g1[0]), np.asarray(g2[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(g1[1]), np.asarray(g2[1]),
                               rtol=1e-4, atol=1e-5)


def test_pallas_rowspan_overflow_defined_output():
    """Budget overflow must yield DEFINED output: fully-scanned tiles exact,
    the partial/unvisited tail exactly (L, M) = 0 — never garbage.
    Gradients stay finite under overflow."""
    pp, pa, pw, pv, qp, r2, ns, kd = _rowspan_fixture(seed=9)
    cell = float(jnp.sqrt(r2.max()))
    pm = pg.PhotonMap(p=pp, alpha=pa, wi=pw, valid=pv)
    L_ref, m_ref = pg.gather_radius_dense(pm, qp, r2, ns, kd)

    L, m, ovf = rg.gather_radius_rowspan(
        pp, pa, pw, pv, cell, qp, r2, ns, kd,
        interpret=True, chunk=256, job_budget=30,
    )
    assert int(ovf) > 0
    assert np.isfinite(np.asarray(L)).all()
    covered = np.asarray(m) > 0
    assert covered.any()  # some tiles were fully scanned within the budget
    np.testing.assert_allclose(np.asarray(L)[covered],
                               np.asarray(L_ref)[covered],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m)[covered],
                                  np.asarray(m_ref)[covered])
    # the masked tail is exactly zero, not uninitialized memory
    zeroed = ~covered
    assert float(np.abs(np.asarray(L)[zeroed]).max()) == 0.0

    g = jax.grad(
        lambda a: jnp.sum(
            rg.gather_radius_rowspan(
                pp, a, pw, pv, cell, qp, r2, ns, kd,
                interpret=True, chunk=256, job_budget=30,
            )[0]
        )
    )(pa)
    assert np.isfinite(np.asarray(g)).all()


def test_pallas_rowspan_custom_vjp_matches_finite_differences():
    """Direct FD validation of the custom VJP (not just dense-AD
    equivalence): perturb single alpha/kd entries and compare central
    differences of a scalar loss against the returned gradient."""

    pp, pa, pw, pv, qp, r2, ns, kd = _rowspan_fixture(seed=21, P=1500, N=300)
    cell = float(jnp.sqrt(r2.max()))
    rng = np.random.default_rng(2)
    cot = jnp.asarray(rng.normal(size=qp.shape).astype(np.float32))

    def loss(alpha, kd_):
        L, _, _ = rg.gather_radius_rowspan(
            pp, alpha, pw, pv, cell, qp, r2, ns, kd_,
            interpret=True, chunk=256,
        )
        return jnp.sum(L * cot)

    g_a, g_k = jax.grad(loss, argnums=(0, 1))(pa, kd)
    h = 1e-2
    # probe the largest-|gradient| entries (random entries mostly have
    # exactly-zero gradient: invalid photons / photons outside every radius)
    top_a = np.dstack(np.unravel_index(
        np.argsort(-np.abs(np.asarray(g_a)).ravel())[:3], g_a.shape))[0]
    top_k = np.dstack(np.unravel_index(
        np.argsort(-np.abs(np.asarray(g_k)).ravel())[:2], g_k.shape))[0]
    assert float(np.abs(np.asarray(g_a)[tuple(top_a[0])])) > 1e-4
    for idx in map(tuple, top_a):
        e = jnp.zeros_like(pa).at[idx].set(h)
        fd = (float(loss(pa + e, kd)) - float(loss(pa - e, kd))) / (2 * h)
        np.testing.assert_allclose(fd, float(g_a[idx]), rtol=2e-2, atol=1e-4)
    for idx in map(tuple, top_k):
        e = jnp.zeros_like(kd).at[idx].set(h)
        fd = (float(loss(pa, kd + e)) - float(loss(pa, kd - e))) / (2 * h)
        np.testing.assert_allclose(fd, float(g_k[idx]), rtol=2e-2, atol=1e-4)


def test_pallas_rowspan_adaptive_reach_small_cell():
    """Exactness with a cell SMALLER than most radii: per-tile reach
    (ceil(max_tile_radius/cell)) must cover every in-radius photon — the
    regime the old fixed-±1-neighborhood contract forbade."""
    pp, pa, pw, pv, qp, r2, ns, kd = _rowspan_fixture(seed=33)
    pm = pg.PhotonMap(p=pp, alpha=pa, wi=pw, valid=pv)
    L_ref, m_ref = pg.gather_radius_dense(pm, qp, r2, ns, kd)
    for cell in (0.1, 0.25, 2.0):  # radii run up to ~0.63
        L, m, ovf = rg.gather_radius_rowspan(
            pp, pa, pw, pv, cell, qp, r2, ns, kd,
            interpret=True, chunk=256, r_max=64,
        )
        assert int(ovf) == 0, cell
        np.testing.assert_allclose(np.asarray(L), np.asarray(L_ref),
                                   rtol=2e-4, atol=1e-5, err_msg=str(cell))
        np.testing.assert_array_equal(np.asarray(m), np.asarray(m_ref))


def test_pallas_rowspan_zslab_fallback_exact():
    """Force the intermediate z-slab regime (n_rows > r_max but nz <= r_max)
    and the whole-box regime (nz > r_max): both must stay exact — the
    z-slab level is what keeps big-scene tiles off the catastrophic
    whole-box span."""
    rng = np.random.default_rng(55)
    P, N = 4000, 256
    # photons in a wide flat slab: many (y, x) cells, few z cells
    pp = np.stack([rng.uniform(0, 8, P), rng.uniform(0, 8, P),
                   rng.uniform(0, 0.9, P)], -1).astype(np.float32)
    pa = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    pw = rng.normal(size=(P, 3)).astype(np.float32)
    pw /= np.linalg.norm(pw, axis=1, keepdims=True)
    pv = rng.uniform(size=P) < 0.9
    qp = np.stack([rng.uniform(0, 8, N), rng.uniform(0, 8, N),
                   rng.uniform(0, 0.9, N)], -1).astype(np.float32)
    r2 = rng.uniform(0.02, 0.1, N).astype(np.float32)
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    kd = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    args = tuple(jnp.asarray(x) for x in (pp, pa, pw, pv))
    qargs = tuple(jnp.asarray(x) for x in (qp, r2, ns, kd))
    pm = pg.PhotonMap(p=args[0], alpha=args[1], wi=args[2], valid=args[3])
    L_ref, m_ref = pg.gather_radius_dense(pm, qargs[0], qargs[1], qargs[2],
                                          qargs[3])
    # cell small → boxes span many (z,y) rows; r_max tiny → z-slab / box
    for r_max in (4, 2):
        L, m, ovf = rg.gather_radius_rowspan(
            *args, 0.15, *qargs, interpret=True, chunk=256,
            r_max=r_max, job_budget=1 << 15,
        )
        assert int(ovf) == 0, r_max
        np.testing.assert_allclose(np.asarray(L), np.asarray(L_ref),
                                   rtol=2e-4, atol=1e-5, err_msg=str(r_max))
        np.testing.assert_array_equal(np.asarray(m), np.asarray(m_ref))


def test_pallas_rowspan_multiround_exact_and_grad():
    """Capacity is job_budget × rounds: a job list that overflows ONE
    budget but fits the total capacity must stay exact, and the custom VJP
    must match dense AD at that capacity."""
    pp, pa, pw, pv, qp, r2, ns, kd = _rowspan_fixture(seed=77)
    cell = float(jnp.sqrt(r2.max()))
    pm = pg.PhotonMap(p=pp, alpha=pa, wi=pw, valid=pv)
    L_ref, m_ref = pg.gather_radius_dense(pm, qp, r2, ns, kd)

    # reference single-round run to learn the job count, then shrink the
    # per-round budget below it
    _, _, ovf_probe = rg.gather_radius_rowspan(
        pp, pa, pw, pv, cell, qp, r2, ns, kd, interpret=True, chunk=256,
        job_budget=8, rounds=1,
    )
    n_jobs = int(ovf_probe) + 8
    b = max(2, n_jobs // 5)  # forces ≥5 rounds worth of jobs
    rounds = -(-n_jobs // b) + 1
    L, m, ovf = rg.gather_radius_rowspan(
        pp, pa, pw, pv, cell, qp, r2, ns, kd, interpret=True, chunk=256,
        job_budget=b, rounds=rounds,
    )
    assert int(ovf) == 0
    np.testing.assert_allclose(np.asarray(L), np.asarray(L_ref),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m), np.asarray(m_ref))

    cot = jnp.asarray(
        np.random.default_rng(1).normal(size=qp.shape).astype(np.float32))

    def f_mr(alpha, kd_):
        L, _, _ = rg.gather_radius_rowspan(
            pp, alpha, pw, pv, cell, qp, r2, ns, kd_, interpret=True,
            chunk=256, job_budget=b, rounds=rounds,
        )
        return jnp.sum(L * cot)

    def f_dense(alpha, kd_):
        L, _ = pg.gather_radius_dense(pm.replace(alpha=alpha), qp, r2, ns,
                                      kd_)
        return jnp.sum(L * cot)

    g1 = jax.grad(f_mr, argnums=(0, 1))(pa, kd)
    g2 = jax.grad(f_dense, argnums=(0, 1))(pa, kd)
    np.testing.assert_allclose(np.asarray(g1[0]), np.asarray(g2[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(g1[1]), np.asarray(g2[1]),
                               rtol=1e-4, atol=1e-5)


def test_rowspan_covered_flag_contract():
    """return_covered: queries in completely-scanned tiles are flagged True
    and match the dense gather exactly; flagged-False queries return
    L = 0 / M = 0. With enough budget every query is covered."""
    rng = np.random.default_rng(23)
    P, N = 4096, 512
    p = rng.uniform(-4, 4, (P, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    wi = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (P, 1))
    qp = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    r2 = np.full(N, 0.25, np.float32)
    ns = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (N, 1))
    kd = np.full((N, 3), 0.3, np.float32)
    args = (jnp.asarray(p), jnp.asarray(alpha), jnp.asarray(wi),
            jnp.ones((P,), bool), 0.5, jnp.asarray(qp), jnp.asarray(r2),
            jnp.asarray(ns), jnp.asarray(kd))

    photons = pg.PhotonMap(p=args[0], alpha=args[1], wi=args[2],
                           valid=args[3])
    L_ref, m_ref = pg.gather_radius_dense(
        photons, args[5], args[6], args[7], args[8])

    L, m, ovf, cov = rg.gather_radius_rowspan(
        *args, interpret=True, chunk=128, job_budget=64,
        return_covered=True,
    )
    cov = np.asarray(cov)
    assert int(ovf) > 0
    assert cov.any() and (~cov).any()
    np.testing.assert_allclose(np.asarray(L)[cov], np.asarray(L_ref)[cov],
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m)[cov],
                                  np.asarray(m_ref)[cov])
    assert np.all(np.asarray(L)[~cov] == 0.0)
    assert np.all(np.asarray(m)[~cov] == 0)

    L2, m2, ovf2, cov2 = rg.gather_radius_rowspan(
        *args, interpret=True, chunk=128, rounds=4,
        return_covered=True,
    )
    assert int(ovf2) == 0
    assert np.asarray(cov2).all()
    np.testing.assert_allclose(np.asarray(L2), np.asarray(L_ref),
                               rtol=2e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Triton-route kernels (interpreter) vs the plain jax.numpy job blocks
# ---------------------------------------------------------------------------

_KERNEL_CASES = {
    # query/photon counts off every tile and chunk boundary
    "ragged": dict(P=1999, N=333),
    # fewer queries than one tile
    "single_tile": dict(P=700, N=100),
    # counts exactly on the tile/chunk boundaries
    "aligned": dict(P=1024, N=256),
    "no_valid_photons": dict(P=600, N=200, frac_valid=0.0),
    # photons piled into a small ball: many jobs per tile
    "clustered": dict(P=2500, N=300, extent=1.0),
    # capacity overflow: the incomplete tail must match too
    "overflow": dict(P=3000, N=500, job_budget=20),
}


def _kernel_case(name):
    c = dict(frac_valid=0.8, extent=8.0, job_budget=1 << 12)
    c.update(_KERNEL_CASES[name])
    rng = np.random.default_rng(sorted(_KERNEL_CASES).index(name) + 100)
    P, N, ext = c["P"], c["N"], c["extent"]
    pp = rng.uniform(0, ext, (P, 3)).astype(np.float32)
    pa = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    pw = rng.normal(size=(P, 3)).astype(np.float32)
    pw /= np.linalg.norm(pw, axis=1, keepdims=True)
    pv = rng.uniform(size=P) < c["frac_valid"]
    qp = rng.uniform(0, ext, (N, 3)).astype(np.float32)
    r2 = rng.uniform(0.01, 0.4, N).astype(np.float32) * (ext / 8.0) ** 2
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    kd = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    cot = rng.normal(size=(N, 3)).astype(np.float32)
    arrays = tuple(jnp.asarray(x) for x in (pp, pa, pw, pv, qp, r2, ns, kd))
    cell = float(np.sqrt(r2.max()))
    return arrays, cell, c["job_budget"], jnp.asarray(cot)


def _run_rowspan(impl, arrays, cell, job_budget, alpha=None, kd=None):
    pp, pa, pw, pv, qp, r2, ns, kd0 = arrays
    return rg.gather_radius_rowspan(
        pp, pa if alpha is None else alpha, pw, pv, cell, qp, r2, ns,
        kd0 if kd is None else kd, impl=impl, interpret=(impl == "pallas"),
        chunk=256, job_budget=job_budget, return_covered=True)


@pytest.mark.parametrize("case", sorted(_KERNEL_CASES))
def test_rowspan_kernel_matches_plain_forward(case):
    """Forward: the kernel and the jnp version agree on S·kd, M, the
    overflow count and the covered flags; covered queries also match the
    dense oracle."""
    arrays, cell, budget, _ = _kernel_case(case)
    L_k, m_k, o_k, c_k = _run_rowspan("pallas", arrays, cell, budget)
    L_x, m_x, o_x, c_x = _run_rowspan("xla", arrays, cell, budget)
    assert int(o_k) == int(o_x)
    np.testing.assert_array_equal(np.asarray(c_k), np.asarray(c_x))
    np.testing.assert_array_equal(np.asarray(m_k), np.asarray(m_x))
    np.testing.assert_allclose(np.asarray(L_k), np.asarray(L_x),
                               rtol=2e-5, atol=1e-6)
    pp, pa, pw, pv, qp, r2, ns, kd = arrays
    L_ref, m_ref = pg.gather_radius_dense(
        pg.PhotonMap(p=pp, alpha=pa, wi=pw, valid=pv), qp, r2, ns, kd)
    cov = np.asarray(c_k)
    if case == "overflow":
        assert int(o_k) > 0 and cov.any() and (~cov).any()
    else:
        assert int(o_k) == 0 and cov.all()
    np.testing.assert_allclose(np.asarray(L_k)[cov], np.asarray(L_ref)[cov],
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m_k)[cov],
                                  np.asarray(m_ref)[cov])
    assert np.all(np.asarray(L_k)[~cov] == 0.0)


@pytest.mark.parametrize("case", sorted(_KERNEL_CASES))
def test_rowspan_kernel_matches_plain_vjp(case):
    """VJP: the chunk-major backward kernel and the jnp transpose give the
    same d/dalpha and d/dkd."""
    arrays, cell, budget, cot = _kernel_case(case)
    pa, kd = arrays[1], arrays[7]

    def loss(impl):
        return lambda a, k: jnp.sum(
            _run_rowspan(impl, arrays, cell, budget, alpha=a, kd=k)[0] * cot)

    g_k = jax.grad(loss("pallas"), argnums=(0, 1))(pa, kd)
    g_x = jax.grad(loss("xla"), argnums=(0, 1))(pa, kd)
    for a, b in zip(g_k, g_x):
        assert np.isfinite(np.asarray(a)).all()
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=1e-6)
