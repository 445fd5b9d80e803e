"""Child process for the 2-process jax.distributed CPU test.

Launched by tests/test_multihost.py::test_two_process_distributed_render as
    python tests/_distributed_child.py <pid> <nproc> <port> <out.npy>
Each process owns 2 virtual CPU devices; the 2×2 ('hosts', 'chips')
hierarchical mesh exercises the REAL multi-process code path: per-chip
photon waves over disjoint global path-id slices, two-hop all_gather
(within-process axis first, cross-process axis second), and
pixel shards over the flattened mesh (parallel/sharded._radiance_shard).
"""
import os
import sys

pid, nproc, port, out = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()
# cross-machine CPU AOT cache entries can segfault on load (see conftest)
os.environ.setdefault("RAYTRACE_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nproc,
    process_id=pid,
)

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from raytrace_tpu.core.config import RenderConfig  # noqa: E402
from raytrace_tpu.parallel import multihost, sharded  # noqa: E402
from raytrace_tpu.scene import presets  # noqa: E402

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc

scene, camera = presets.cornell_box(size=16)
config = RenderConfig(
    width=16, height=16, spp=4, scene_epsilon=1e-3,
    photon_paths=1 << 9, photon_passes=1, max_photon_bounces=4,
    exact_gather=True,
)
mesh = multihost.make_hierarchical_mesh()
assert mesh.axis_names == ("hosts", "chips")
assert mesh.devices.shape == (nproc, 2), mesh.devices.shape

img = sharded.render_photon_sharded(
    scene, camera, config, jax.random.PRNGKey(21), mesh, jitter=False
)
# force full replication so every process can read the whole image
img = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(img)
img = np.asarray(img)
assert np.isfinite(img).all()
if pid == 0:
    np.save(out, img)
print(f"child {pid} OK", flush=True)
