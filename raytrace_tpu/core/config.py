"""Typed render configuration.

The reference scatters its real configuration over compile-time constants
(SURVEY.md §5.6); every one of them is promoted to a field here:
  scene_epsilon 0.1 / 0.01    photonmappingrenderer.cpp:52, simplerender.cpp:25
  photon max depth 4          photonmappingrenderer.cpp:183
  photon launch 512×512       photonmappingrenderer.cpp:184-185
  randoms/bounce 3            photonmappingrenderer.cpp:182
  progressive passes 1        photonmappingrenderer.cpp:38
  initial gather radius² 4.0  raytracing.cu:123
  PPM alpha 0.7               gathering.cu:116
  specular depth cap 10       raytracing.cu:98
  glass eta 1.5               cudamaterial.cu.h:118 (now per-material, this is
                              just the default)
  RNG seed 777                cudarandom.h:15
  kd-tree stack depth 40      gathering.cu:9 (no analogue: we use a hash grid)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # -- shared ---------------------------------------------------------
    width: int = 256
    height: int = 256
    spp: int = 1                      # samples per pixel (stratified)
    scene_epsilon: float = 0.1        # min-t for secondary rays
    shadow_epsilon: float = 1e-3      # shadow ray [eps, 1-eps] on unnormalized dir
    seed: int = 777                   # reference cuRAND default seed
    max_light_samples: int = 4        # static cap on per-light nSamples
    pixel_filter: str = "box"         # film reconstruction filter: "box" |
                                      # "triangle" | "gaussian" (the
                                      # reference splats through pbrt's
                                      # PixelFilter; utils/film.splat)
    filter_radius: float = 0.0        # 0 = the filter's pbrt default
                                      # (box 0.5, triangle/gaussian 2)

    # -- camera-pass specular chains -------------------------------------
    max_specular_depth: int = 10      # camera-ray specular bounce cap

    # -- photon tracing ---------------------------------------------------
    photon_paths: int = 512 * 512    # photon paths per progressive pass
    max_photon_depth: int = 4         # diffuse deposits per path (= slot count)
    max_photon_bounces: int = 10      # total walk iterations incl. specular
    russian_roulette: bool = True     # reference has it commented out
                                      # (photontracing.cu:173-178); BASELINE
                                      # asks for per-bounce RR, so default on.
                                      # Ignored when differentiable=True: the
                                      # survival test is discontinuous in the
                                      # material params and the 1/P reweight
                                      # has no pathwise gradient, and the
                                      # fixed-trip diff walk gains nothing
                                      # from roulette (renderers/photon.py)
    halton_stride_by_depth: bool = False  # True = reference quirk: Halton
                                      # indices stride by max_photon_depth
                                      # (pm_index, photontracing.cu:82),
                                      # which under-covers the base-2 dim;
                                      # False = consecutive (pbrt behavior)
    photon_passes: int = 1            # progressive photon passes

    # -- progressive gathering --------------------------------------------
    initial_radius2: float = 4.0      # per-pixel starting search radius²
    ppm_alpha: float = 0.7            # Hachisuka radius-shrink alpha
    footprint_radius_scale: float = 0.0  # >0: seed each pixel's starting
                                      # radius from its camera-ray
                                      # differential footprint (SPPM-style,
                                      # radius = scale·footprint, clamped to
                                      # [min_radius2, initial_radius2]).
                                      # 0 = reference parity: every pixel
                                      # starts at initial_radius2
                                      # (raytracing.cu:123). Footprint radii
                                      # sharpen the render AND collapse the
                                      # gather cost at high resolution (the
                                      # global radius² = 4 makes every
                                      # query scan the whole photon map in
                                      # scene-sized boxes)
    min_radius2: float = 1e-10        # floor for footprint-seeded radii

    # -- photon hash grid --------------------------------------------------
    grid_max_photons_per_cell: int = 32  # static per-cell budget (masked)
    exact_gather: bool = False        # True: exact streamed all-pairs gather
                                      # (photon_grid.gather_radius_dense) —
                                      # no per-cell truncation; the oracle
                                      # setting for parity tests and small
                                      # scenes. False: fast spatial paths
    # row-span gather job capacity = gather_job_budget × gather_rounds jobs
    # (one (query tile, photon chunk) block each). 0 = derive from the
    # photon-map size: 2^17 jobs × rounds scaled with the map, clamped to
    # [4, 16]. Tests shrink the budget to force (unbiased) overflow at
    # small scale. r_max is the per-tile (z, y)-row span budget.
    gather_rounds: int = 0
    gather_r_max: int = 64
    gather_job_budget: int = 0

    # -- intersection -------------------------------------------------------
    use_bvh: bool = False             # brute-force is faster for tiny scenes
    ray_chunk: int = 0                # if >0, process rays in chunks this size

    # -- wavefront compaction ----------------------------------------------
    # After the first full-batch bounce, the specular-chain and photon walks
    # gather the surviving rays into a fixed-size queue (jnp.nonzero with a
    # static size) and intersect only the queue — the dense kernels' cost is
    # ∝ batch width, and survivors decay geometrically, so the loop tail
    # stops paying full-batch price. Per-ray math is a pure function of
    # per-ray state (uniforms keyed by global ids), so results match the
    # full-batch loop up to XLA fusion noise (last-ulp). Disabled on the
    # differentiable path (the fixed-trip fori_loop stays full-batch).
    wavefront_compact: bool = True
    compact_queue: int = 0            # queue width; 0 = auto (max(8192, n/8))
    compact_warm_steps: int = 0       # photon-walk full-width steps before
                                      # the first compaction; 0 = auto (3 for
                                      # small launches, 1 at ≥2^21 paths where
                                      # each full-width step is an expensive
                                      # incoherent intersect). Survivors decay
                                      # slowly (RR ≈ y(kd)/bounce), so
                                      # compacting too early splits the walk
                                      # into several full-depth queue batches

    # -- differentiation -----------------------------------------------------
    differentiable: bool = False      # True: bounded fori_loop walks (reverse-
    remat_walks: bool = False        # checkpoint each differentiable walk
                                      # iteration (recompute in bwd instead
                                      # of storing intersection residuals)
                                      # mode AD works, every ray pays the full
                                      # bounce cap); False: early-exit
                                      # while_loop (forward-only, faster)

    @property
    def n_pixel_samples(self) -> int:
        return self.width * self.height * self.spp
