"""Platform plumbing: the pytree dataclass helper, the compile-cache
placement, and the choice of gather implementation by platform."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytrace_tpu
from raytrace_tpu.core import struct
from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.renderers import photon as ph


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    n: int = struct.field(pytree_node=False, default=3)


def test_struct_flatten_unflatten_roundtrip():
    x = _Pair(a=jnp.arange(3.0), b=jnp.ones((2,)), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(x)
    assert len(leaves) == 2  # the static field is not a leaf
    y = jax.tree_util.tree_unflatten(treedef, leaves)
    assert y.n == 5
    np.testing.assert_array_equal(np.asarray(y.a), np.asarray(x.a))
    # None children stay None (an empty subtree), as optional fields need
    z = jax.tree_util.tree_map(lambda v: v * 2, _Pair(a=jnp.ones(2)))
    assert z.b is None and z.n == 3


def test_struct_static_fields_specialize_jit():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.n)
        return p.a * p.n

    assert float(f(_Pair(a=jnp.ones(()), n=2))) == 2.0
    assert float(f(_Pair(a=jnp.ones(()), n=2))) == 2.0
    assert float(f(_Pair(a=jnp.ones(()), n=4))) == 4.0
    assert traces == [2, 4]  # a static value is part of the cache key


def test_struct_replace_and_frozen():
    x = _Pair(a=jnp.zeros(2))
    y = x.replace(n=7, b=jnp.ones(1))
    assert (x.n, x.b) == (3, None)
    assert y.n == 7 and y.b.shape == (1,)
    with pytest.raises(dataclasses.FrozenInstanceError):
        x.n = 1


@pytest.mark.parametrize("case", ["env_set", "unset", "opt_out"])
def test_compile_cache_placement(case, tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        raytrace_tpu.__file__)))
    env = {
        "env_set": {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)},
        "unset": {},
        "opt_out": {"RAYTRACE_NO_COMPILE_CACHE": "1",
                    "JAX_COMPILATION_CACHE_DIR": str(tmp_path)},
    }[case]
    want = {"env_set": str(tmp_path),
            "unset": os.path.join(root, ".jax_cache"),
            "opt_out": None}[case]
    assert raytrace_tpu.compile_cache_dir(env) == want
    # the default is fixed: no temp name, pid or time in it
    assert raytrace_tpu.compile_cache_dir({}) == raytrace_tpu.compile_cache_dir({})


_BASE = RenderConfig()
_DIFF = RenderConfig(differentiable=True)
_EXACT = RenderConfig(exact_gather=True)


@pytest.mark.parametrize("platform,n_slots,config,want", [
    ("gpu", 1 << 20, _BASE, "rowspan"),
    ("gpu", ph.ROWSPAN_MIN_SLOTS, _BASE, "rowspan"),
    ("gpu", ph.ROWSPAN_MIN_SLOTS - 1, _BASE, "dense"),
    ("gpu", 1 << 20, _EXACT, "dense"),
    ("gpu", 1 << 14, _DIFF, "dense"),
    ("gpu", 1 << 16, _DIFF, "rowspan"),
    ("cpu", 1 << 20, _BASE, "grid"),
    ("cpu", 1 << 14, _DIFF, "dense"),
    ("cpu", 1 << 20, _EXACT, "dense"),
])
def test_gather_method_by_platform(platform, n_slots, config, want):
    assert ph.gather_method(platform, n_slots, config) == want


def test_rowspan_capacity_scales_with_the_map():
    assert ph.rowspan_capacity(_BASE, 1 << 20) == (1 << 17, 4)
    assert ph.rowspan_capacity(_BASE, 1 << 24) == (1 << 17, 16)
    cfg = RenderConfig(gather_rounds=2, gather_job_budget=64)
    assert ph.rowspan_capacity(cfg, 1 << 24) == (64, 2)
