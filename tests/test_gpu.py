"""Compiled-GPU tests of the row-span gather (skip without a card).

The CPU suite runs the kernels in the Pallas interpreter, which cannot show
what the Triton compiler makes of them. Run on a machine with a GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytrace_tpu.ops import photon_grid as pg
from raytrace_tpu.ops import rowspan_gather as rg

pytestmark = pytest.mark.gpu


def _case(gpu_device, P=200_000, N=50_000, seed=0):
    rng = np.random.default_rng(seed)
    put = lambda x: jax.device_put(jnp.asarray(x), gpu_device)
    pp = rng.uniform(0, 8, (P, 3)).astype(np.float32)
    pa = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    pw = rng.normal(size=(P, 3)).astype(np.float32)
    pw /= np.linalg.norm(pw, axis=1, keepdims=True)
    pv = rng.uniform(size=P) < 0.7
    qp = rng.uniform(0, 8, (N, 3)).astype(np.float32)
    r2 = rng.uniform(0.001, 0.02, N).astype(np.float32)
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    kd = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return tuple(put(x) for x in (pp, pa, pw, pv, qp, r2, ns, kd))


def test_compiled_kernel_matches_plain_and_dense(gpu_device):
    pp, pa, pw, pv, qp, r2, ns, kd = args = _case(gpu_device)
    cell = float(jnp.sqrt(r2.max()))
    outs = {impl: rg.gather_radius_rowspan(*args[:4], cell, *args[4:],
                                           impl=impl)
            for impl in ("pallas", "xla")}
    (L_k, m_k, o_k), (L_x, m_x, o_x) = outs["pallas"], outs["xla"]
    assert int(o_k) == 0 and int(o_x) == 0
    np.testing.assert_array_equal(np.asarray(m_k), np.asarray(m_x))
    np.testing.assert_allclose(np.asarray(L_k), np.asarray(L_x),
                               rtol=1e-4, atol=1e-6)
    L_ref, m_ref = pg.gather_radius_dense(
        pg.PhotonMap(p=pp, alpha=pa, wi=pw, valid=pv), qp, r2, ns, kd)
    np.testing.assert_array_equal(np.asarray(m_k), np.asarray(m_ref))
    np.testing.assert_allclose(np.asarray(L_k), np.asarray(L_ref),
                               rtol=1e-4, atol=1e-6)


def test_compiled_vjp_and_overflow_match_plain(gpu_device):
    args = _case(gpu_device, seed=1)
    cell = float(jnp.sqrt(args[5].max()))
    cot = jax.random.normal(jax.random.PRNGKey(0), args[4].shape)

    def grads(impl, **kw):
        def loss(a, k):
            L = rg.gather_radius_rowspan(*args[:1], a, *args[2:4], cell,
                                         *args[4:7], k, impl=impl, **kw)[0]
            return jnp.sum(L * cot)
        return jax.grad(loss, argnums=(0, 1))(args[1], args[7])

    for a, b in zip(grads("pallas"), grads("xla")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
    small = dict(job_budget=64, rounds=1, return_covered=True)
    L_k, _, o_k, c_k = rg.gather_radius_rowspan(
        *args[:4], cell, *args[4:], impl="pallas", **small)
    L_x, _, o_x, c_x = rg.gather_radius_rowspan(
        *args[:4], cell, *args[4:], impl="xla", **small)
    assert int(o_k) == int(o_x) > 0
    np.testing.assert_array_equal(np.asarray(c_k), np.asarray(c_x))
    assert float(jnp.abs(L_k[~c_k]).max()) == 0.0
