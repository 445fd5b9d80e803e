"""Multi-host structure on the virtual CPU mesh: hierarchical mesh shape,
distributed-init gating, and the scaling report's plumbing."""
import jax
import numpy as np

from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.parallel import multihost
from raytrace_tpu.scene import presets

KEY = jax.random.PRNGKey(2)


def test_initialize_distributed_noop_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert multihost.initialize_distributed() is False


def test_hierarchical_mesh_single_host():
    mesh = multihost.make_hierarchical_mesh()
    assert mesh.axis_names == ("hosts", "chips")
    assert mesh.devices.shape == (1, len(jax.devices()))


def test_scaling_report_structure():
    size = 16
    scene, camera = presets.cornell_box(size=size)
    config = RenderConfig(
        width=size, height=size, spp=8, scene_epsilon=1e-3,
        photon_paths=1 << 9, photon_passes=1, max_photon_bounces=4,
    )
    rep = multihost.scaling_report(
        scene, camera, config, KEY, device_counts=(1, 8), n_iters=1)
    assert set(rep) == {1, 8, "efficiency"}
    assert rep[1] > 0 and rep[8] > 0
    assert np.isfinite(rep["efficiency"])


def test_hierarchical_mesh_two_hop_matches_single_device():
    """The ('hosts', 'chips') hierarchical mesh path — linear chip ids over
    both axes + two-hop photon all_gather (inner axis first, outer axis
    second) — must reproduce the 1-device render exactly (up to float
    reassociation), same contract as the flat mesh."""
    import jax.numpy as jnp  # noqa: F401
    from jax.sharding import Mesh

    from raytrace_tpu.parallel import sharded

    size = 16
    scene, camera = presets.cornell_box(size=size)
    config = RenderConfig(
        width=size, height=size, spp=8, scene_epsilon=1e-3,
        photon_paths=1 << 10, photon_passes=2, max_photon_bounces=4,
        exact_gather=True,
    )
    hmesh = Mesh(
        np.asarray(jax.devices()).reshape(2, 4), ("hosts", "chips")
    )
    img_h = np.asarray(sharded.render_photon_sharded(
        scene, camera, config, KEY, hmesh, jitter=False))

    mesh1 = sharded.make_mesh(jax.devices()[:1])
    img_1 = np.asarray(sharded.render_photon_sharded(
        scene, camera, config, KEY, mesh1, jitter=False))
    np.testing.assert_allclose(img_h, img_1, rtol=5e-4, atol=5e-5)


def test_two_process_distributed_render(tmp_path):
    """REAL multi-process run: 2 jax.distributed CPU processes × 2 virtual
    devices each, hierarchical (2, 2) mesh, cross-process all_gather on the
    'hosts' axis. The image must match this (single-process) interpreter's
    1-device render bit-for-float — photon ids are global, so process count
    is invisible to the estimator."""
    import socket
    import subprocess
    import sys

    from raytrace_tpu.parallel import sharded

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    out = tmp_path / "img0.npy"
    repo = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    env = dict(__import__("os").environ)
    env["PYTHONPATH"] = repo + ":" + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)  # child sets its own 2-device flag
    child = str(__import__("pathlib").Path(__file__).with_name(
        "_distributed_child.py"))
    procs = [
        subprocess.Popen(
            [sys.executable, child, str(i), "2", str(port), str(out)],
            env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(o)
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {i} failed:\n{o[-4000:]}"
        assert f"child {i} OK" in o

    img2 = np.load(out)
    size = 16
    scene, camera = presets.cornell_box(size=size)
    config = RenderConfig(
        width=size, height=size, spp=4, scene_epsilon=1e-3,
        photon_paths=1 << 9, photon_passes=1, max_photon_bounces=4,
        exact_gather=True,
    )
    mesh1 = sharded.make_mesh(jax.devices()[:1])
    img_1 = np.asarray(sharded.render_photon_sharded(
        scene, camera, config, jax.random.PRNGKey(21), mesh1, jitter=False))
    np.testing.assert_allclose(img2, img_1, rtol=5e-4, atol=5e-5)
