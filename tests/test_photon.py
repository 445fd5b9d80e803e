"""Photon-mapping renderer tests: photon tracing semantics, progressive
updates, and Cornell-box GI sanity (BASELINE config[1] shape)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace_tpu.core.config import RenderConfig
from raytrace_tpu.oracle import cpu_reference as orc
from raytrace_tpu.renderers import common
from raytrace_tpu.renderers.photon import render_photon, trace_photons
from raytrace_tpu.scene.camera import PerspectiveCamera, generate_rays, pixel_samples
from raytrace_tpu.ops import photon_grid as pg

from tests.scenes import cornell_box_scene

SIZE = 32
FOV = 65.0


def small_config(**kw):
    base = dict(
        width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
        photon_paths=4096, max_photon_depth=4, max_photon_bounces=10,
        initial_radius2=0.04,
    )
    base.update(kw)
    return RenderConfig(**base)


class TestPhotonTracing:
    def test_deposits_are_indirect_only(self):
        """First diffuse hits must NOT deposit (indirect-only map,
        photontracing.cu:141-151). With max one extra bounce the map holds
        only ≥1-bounce photons; all deposited photons must be inside the box."""
        scene, _, _ = cornell_box_scene()
        config = small_config(photon_paths=2048)
        photons = trace_photons(scene, config, jax.random.PRNGKey(0), 0)
        valid = np.asarray(photons.valid)
        assert valid.sum() > 100  # the closed box bounces plenty
        p = np.asarray(photons.p)[valid]
        assert np.all(p[:, 0] >= -1.01) and np.all(p[:, 0] <= 1.01)
        assert np.all(p[:, 2] >= -0.01) and np.all(p[:, 2] <= 2.01)
        # incident directions are unit
        wi = np.asarray(photons.wi)[valid]
        np.testing.assert_allclose(np.linalg.norm(wi, axis=-1), 1.0, atol=1e-3)

    def test_energy_bounded(self):
        """Per-photon alpha bounded by emitted power scale; RR keeps the
        walk unbiased without runaway weights."""
        scene, _, _ = cornell_box_scene(emit=30.0, light_radius=0.5)
        config = small_config(photon_paths=2048)
        photons = trace_photons(scene, config, jax.random.PRNGKey(1), 0)
        valid = np.asarray(photons.valid)
        alpha = np.asarray(photons.alpha)[valid]
        assert np.all(np.isfinite(alpha))
        assert np.all(alpha >= 0.0)
        # Russian roulette preserves LUMINANCE (p = min(1, y'/y), pbrt /
        # photontracing.cu:173-178): y(alpha) can never exceed the emission
        # luminance bound |N·d|·y(I·area)/(1/2π). Individual channels may
        # exceed it (channel/luminance ratio of a saturated albedo).
        y = alpha @ np.array([0.212671, 0.715160, 0.072169])
        emax = 30.0 * np.pi * 0.5**2 * 2 * np.pi * 1.01
        assert y.max() <= emax

    def test_rr_off_matches_depth_cap(self):
        scene, _, _ = cornell_box_scene()
        config = small_config(photon_paths=512, russian_roulette=False)
        photons = trace_photons(scene, config, jax.random.PRNGKey(2), 0)
        valid = np.asarray(photons.valid).reshape(512, 4)
        # without RR, slot k filled implies slot k-1 filled (contiguous
        # deposits per path, photontracing.cu:144 slot = nInt-1)
        for k in range(1, 4):
            assert not np.any(valid[:, k] & ~valid[:, k - 1])


class TestPhotonRender:
    def test_cornell_box_gi(self):
        scene, _, c2w = cornell_box_scene(n_light_samples=1)
        cam = PerspectiveCamera.make(c2w, FOV, SIZE, SIZE)
        config = small_config()
        img, aux = render_photon(
            scene, cam, config, jax.random.PRNGKey(0), return_aux=True
        )
        img = np.asarray(img)
        assert np.all(np.isfinite(img))
        assert img.max() > 0.01
        assert int(aux["valid_photons"]) > 500
        assert int(aux["max_cell_occupancy"]) <= config.grid_max_photons_per_cell, (
            "grid cell overflow — gather would truncate"
        )
        # progressive state updated where photons landed
        assert float(aux["mean_photon_count"]) > 0.0

    def test_indirect_adds_energy(self):
        """GI image ≥ direct-only image everywhere (IDL ≥ 0), and strictly
        brighter on average in a closed box."""
        scene, _, c2w = cornell_box_scene()
        cam = PerspectiveCamera.make(c2w, FOV, SIZE, SIZE)
        config = small_config()
        key = jax.random.PRNGKey(3)
        img_gi = np.asarray(render_photon(scene, cam, config, key))
        cfg_direct = small_config(photon_paths=4096)
        # direct-only: same pipeline with photons that never gather
        # (radius² → 0)
        cfg_direct = small_config(initial_radius2=1e-12)
        img_d = np.asarray(render_photon(scene, cam, cfg_direct, key))
        assert img_gi.mean() > img_d.mean() * 1.02
        assert np.all(img_gi + 1e-6 >= img_d * 0.98)  # IDL only adds

    def test_radius_shrinks_with_more_passes(self):
        scene, _, c2w = cornell_box_scene()
        cam = PerspectiveCamera.make(c2w, FOV, SIZE, SIZE)
        key = jax.random.PRNGKey(4)
        _, aux1 = render_photon(
            scene, cam, small_config(photon_passes=1), key, return_aux=True
        )
        _, aux3 = render_photon(
            scene, cam, small_config(photon_passes=3), key, return_aux=True
        )
        assert float(aux3["mean_radius2"]) < float(aux1["mean_radius2"])
        assert float(aux3["mean_photon_count"]) > float(aux1["mean_photon_count"])

    def test_direct_component_matches_oracle_statistically(self):
        """The photon renderer's DL term vs the oracle's area-light direct
        lighting, compared as image means (MC noise → statistical tolerance)."""
        scene, oracle, c2w = cornell_box_scene(n_light_samples=4)
        cam = PerspectiveCamera.make(c2w, FOV, SIZE, SIZE)
        config = small_config(initial_radius2=1e-12)  # kill IDL
        # pixel centers on both sides: the emitter contributes radiance 30 to
        # a handful of pixels, so jittered-vs-center pixel positions would
        # dominate the comparison
        img = np.asarray(
            render_photon(scene, cam, config, jax.random.PRNGKey(5),
                          jitter=False)
        )
        rng = np.random.default_rng(11)
        area_samples = {0: [rng.uniform(size=2) for _ in range(64)]}
        ref = orc.render_direct(
            oracle, c2w, FOV, SIZE, SIZE, scene_eps=1e-3,
            include_emitted=True, area_samples=area_samples,
        )
        assert abs(img.mean() - ref.mean()) / ref.mean() < 0.03


class TestGatherOverflowUnbiased:
    """Gather job-budget overflow must be UNBIASED, not just observable:
    a pixel tile skipped by the
    budget is excluded from that pixel's emitted-path normalization, so
    its estimate uses fewer waves instead of being biased dark."""

    def _setup(self):
        from raytrace_tpu.renderers import photon as ph
        from raytrace_tpu.scene.camera import generate_rays, pixel_samples

        scene, _, c2w = cornell_box_scene()
        cam = PerspectiveCamera.make(c2w, FOV, SIZE, SIZE)
        # slots = 4096 * 4 = 16384 = 2^14 → the rowspan branch
        config = small_config(photon_paths=4096)
        xy, lens = pixel_samples(
            jax.random.PRNGKey(0), SIZE, SIZE, 1, jitter=False)
        rays = generate_rays(cam, xy, lens, 1)
        rec = common.camera_pass(scene, rays.o, rays.d, config)
        n = rays.o.shape[0]
        state0 = ph.ProgressiveState(
            radius2=ph.initial_radius2(rec, config),
            photon_count=jnp.zeros((n,), jnp.float32),
            flux=jnp.zeros((n, 3), jnp.float32),
            emitted=jnp.zeros((n,), jnp.float32),
        )
        w1 = trace_photons(scene, config, jax.random.PRNGKey(7), 0)
        w2 = trace_photons(scene, config, jax.random.PRNGKey(7), 1)
        return ph, scene, rec, config, state0, w1, w2

    def test_overflow_excludes_wave_from_normalization(self, monkeypatch):
        import dataclasses

        ph, scene, rec, config, state0, w1, w2 = self._setup()
        cfg_exact = dataclasses.replace(config, exact_gather=True)

        # reference: both waves exact
        s_e1, _ = ph.gathering_pass(scene, rec, state0, w1, cfg_exact)
        s_e2, _ = ph.gathering_pass(scene, rec, s_e1, w2, cfg_exact)
        # wave-2-only reference (what a wave-1-skipped pixel should equal)
        s_w2, _ = ph.gathering_pass(scene, rec, state0, w2, cfg_exact)

        # wave 1 through the rowspan kernel (Pallas interpreter) with a
        # budget that overflows
        monkeypatch.setattr(ph, "gather_method", lambda *a: "rowspan")
        cfg_ovf = dataclasses.replace(
            config, gather_rounds=1, gather_job_budget=8)
        s_o1, info = ph.gathering_pass(scene, rec, state0, w1, cfg_ovf,
                                       interpret=True)
        assert int(info["gather_overflow"]) > 0
        monkeypatch.undo()
        s_o2, _ = ph.gathering_pass(scene, rec, s_o1, w2, cfg_exact)

        paths = float(config.photon_paths)
        emitted = np.asarray(s_o2.emitted)
        cov = np.asarray(s_o1.emitted) == paths  # covered in wave 1
        assert cov.any() and (~cov).any(), "need both covered and skipped"
        np.testing.assert_allclose(emitted[cov], 2 * paths)
        np.testing.assert_allclose(emitted[~cov], paths)

        # covered pixels: identical to the all-exact run (the rowspan tile
        # scan is exact for completely-scanned tiles, any cell size)
        np.testing.assert_allclose(
            np.asarray(s_o2.flux)[cov], np.asarray(s_e2.flux)[cov],
            rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(s_o2.radius2)[cov], np.asarray(s_e2.radius2)[cov],
            rtol=2e-5)
        # skipped pixels: exactly the wave-2-only state (wave 1 never
        # touched them)
        np.testing.assert_allclose(
            np.asarray(s_o2.flux)[~cov], np.asarray(s_w2.flux)[~cov],
            rtol=1e-6, atol=0)

        # final_gathering normalizes per pixel: skipped pixels divide by
        # ONE wave of paths — their IDL equals the wave-2-only render's,
        # NOT half of it (the old biased-dark behavior)
        direct = jnp.zeros((emitted.shape[0], 3), jnp.float32)
        L_mix = np.asarray(ph.final_gathering(
            rec, direct, s_o2, jnp.float32(2 * paths)))
        L_w2 = np.asarray(ph.final_gathering(
            rec, direct, s_w2, jnp.float32(paths)))
        skipped_lit = (~cov) & (np.asarray(s_o2.photon_count) > 0)
        assert skipped_lit.any()
        np.testing.assert_allclose(
            L_mix.reshape(-1, 3)[skipped_lit],
            L_w2.reshape(-1, 3)[skipped_lit], rtol=1e-5)
