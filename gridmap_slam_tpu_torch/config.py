"""Typed configuration for the TPU-native 2D LiDAR SLAM engine.

(A copy of gridmap_slam_tpu/config.py: importing anything from the JAX
package loads jax and flax, which the port must not need.
tests/test_torch_config_io.py holds the two copies equal.)

Every numeric constant of the reference implementation is collected here as an
overridable, typed default (the reference hard-codes them; see SURVEY.md §5
"Config / flag system").  Sources (reference file:line):

- Robot geometry:          slam/Robot.java:8-20
- Sensor model:            slam/SensorModel.java:20-25
- Map geometry:            slam/SLAM.java:57, slam/GridMap.java:85-95
- Particle count:          slam/SLAM.java:50
- Motion noise model:      slam/Odometry.java:60-69
- Scan matcher window:     slam/GridMap.java:324-325 (brute force ±0.20 m/±15°)
- Likelihood field:        slam/GridMap.java:94-95, 259 (sigma, zHit)
- Integration thresholds:  slam/GridMap.java:210, 223 (additionalSteps=2, tol=2)
- Large-rotation skip:     slam/SLAM.java:82 (|dTheta| > 30 deg)

Configs are frozen (hashable) dataclasses so they can be closed over by jitted
functions as static data.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    """Differential-drive robot calibration constants (slam/Robot.java:8-20)."""

    wheel_distance: float = 0.22           # m between wheels
    wheel_diameter: float = 0.063          # m
    motor_steps_per_rev: int = 32 * 30     # 960 encoder counts / wheel revolution
    sensor_steps_per_rev: int = 720        # stepper turret steps / revolution
    sensor_angle_offset: float = -math.pi / 2.0


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Inverse sensor model (slam/SensorModel.java:20-41)."""

    max_range: float = 10.0    # m, modeled max sensing range
    p_free: float = 0.30
    p_occupied: float = 0.90
    p_prior: float = 0.50
    # Occupied band half-width and extra wall thickness, in cells
    # (slam/GridMap.java:210,223: hitTolerance=2 cells, additionalSteps=2).
    hit_tolerance_cells: float = 2.0

    @property
    def l_free(self) -> float:
        return math.log(self.p_free / (1.0 - self.p_free))

    @property
    def l_occ(self) -> float:
        return math.log(self.p_occupied / (1.0 - self.p_occupied))


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Odometry sampling-noise model (slam/Odometry.java:60-69).

    sd_center = (base_center + |dCenter| * rel_center) / 2
    sd_theta  = base_theta_deg (in rad) + |dTheta| * rel_theta
    """

    base_center: float = 0.01
    rel_center: float = 0.05
    base_theta_deg: float = 5.0
    rel_theta: float = 0.1

    def sd_center(self, d_center):
        return (self.base_center + abs(d_center) * self.rel_center) / 2.0

    def sd_theta(self, d_theta):
        return math.radians(self.base_theta_deg) + abs(d_theta) * self.rel_theta


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Occupancy grid geometry (slam/SLAM.java:57, slam/GridMap.java:80-100)."""

    width_m: float = 6.0
    height_m: float = 6.0
    resolution: float = 0.05               # m / cell
    origin: Tuple[float, float] = (-3.0, -3.0)   # world coords of lower-left corner

    @property
    def cells_x(self) -> int:
        return int(math.ceil(self.width_m / self.resolution))

    @property
    def cells_y(self) -> int:
        return int(math.ceil(self.height_m / self.resolution))

    # Override for the likelihood-field blur width, in cells (0 = the
    # reference's formula below).  Global relocalization wants a WIDER
    # field than the reference's ~1-cell tracking sigma: with a sharp
    # field, a heading between two theta bins displaces endpoints by
    # range * dtheta/2 >> sigma, so per-particle surface scores are
    # dominated by bin-alignment luck rather than mode identity and the
    # posterior's mode masses random-walk (round-5 P-sweep finding,
    # docs/bench/psweep_r5.json).  Classic MCL uses sigma ~0.2-0.5 m for
    # exactly this reason.
    likelihood_sigma_cells: float = 0.0

    @property
    def likelihood_sigma(self) -> float:
        # sigma = sqrt(0.05 / resolution) cells (slam/GridMap.java:94)
        if self.likelihood_sigma_cells > 0.0:
            return self.likelihood_sigma_cells
        return math.sqrt(0.05 / self.resolution)

    @property
    def likelihood_radius(self) -> int:
        # kernel has `ceil(3 sigma)` cells on either side (slam/GridMap.java:95)
        return int(math.ceil(self.likelihood_sigma * 3))


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Correlative scan matcher (TPU-native replacement for the reference's
    BOBYQA local optimizer, slam/GridMap.java:348-369; search window follows the
    brute-force variant at slam/GridMap.java:324-325).

    Two-stage dense search: a coarse (dx, dy, dtheta) grid over the full window
    followed by a fine grid centered on the coarse argmax.  Budget:
    coarse nt*nx*ny + fine nt*nx*ny pose evaluations per particle, comparable to
    the reference's <=500 BOBYQA evals but embarrassingly parallel.
    """

    # Half-window sizes around the motion-sampled pose.
    window_xy: float = 0.20        # m     (reference xSpan/ySpan)
    window_theta_deg: float = 15.0  # deg  (reference thetaSpan)
    # Coarse grid: translations at one map resolution, theta at 3 deg.
    coarse_nxy: int = 9
    coarse_nt: int = 11
    # Fine grid spans one coarse cell around the coarse argmax.
    fine_nxy: int = 5
    fine_nt: int = 5
    # Additional halving refinement stages after the fine stage (sub-cell).
    extra_refine_stages: int = 1
    # Coarse-stage cost controls: score every `stride`-th beam and/or use
    # nearest-cell lookups in the COARSE grid only (refine stages always
    # rescore all beams bilinearly).  Defaults measured ATE-neutral on the
    # canonical datasets (docs/ate_parity_*) while cutting the matcher's
    # dominant gather traffic ~16x in the coarse stage; set stride 1 +
    # coarse_nearest=False for the exhaustive search.
    coarse_beam_stride: int = 4
    coarse_nearest: bool = True
    # Run the coarse basin-finding stage on a 2x2-mean-pooled
    # HALF-RESOLUTION field with bilinear taps (all dense backends:
    # pallas / matmul / gather; the splat backend AND the tiled engine
    # (parallel/tiled.py) ignore it — tiled scores its coarse stage at
    # full resolution, so default configs are trajectory-equivalent but
    # not schedule-identical across those engines).  ~4x less
    # coarse-stage work; the fine stages rescore at full resolution, so
    # only basin SELECTION can differ.  Measured TRAJECTORY-IDENTICAL
    # (same ATE and per-scan Neff) on all three canonical datasets and
    # the parity bench, at 60.7 -> 83.3 scans/s on the Pallas path
    # (docs/bench/halfres_ate_r4.json) — hence on by default.
    coarse_halfres: bool = True
    # Scoring implementation:
    #   "gather" — batched bilinear lookups (random access; ~0.3 GB/s
    #     effective on TPU, docs/TPU_FAULT.md);
    #   "splat"  — bilinearly-splatted endpoint images + statically shifted
    #     dense frame dots (identical scores, tests/test_matcher_splat.py);
    #   "matmul" — bilinear lookups as two-tap one-hot MXU contractions
    #     (ops/matcher_matmul.py): same candidate schedule AND scores as
    #     "gather" (tests/test_matcher_matmul.py), no gathers, no dense
    #     frame dots — the fastest pure-XLA TPU path;
    #   "pallas" — VMEM-resident Pallas stage-scoring kernel
    #     (ops/pallas/matcher.py): same schedule/scores up to f32 summation
    #     order, zero HBM intermediates.  Requires map width <= 124 cells
    #     and a real TPU (tests cover it in interpret mode);
    #   "auto"   — on a real TPU: the Pallas kernel when the map fits
    #     (<= 124 cells wide; the DEFAULT fast path since round 5 —
    #     silicon-validated at 83.9 scans/s on the parity preset), matmul
    #     otherwise; gather on CPU (caches make random lookups cheap; the
    #     one-hot matmuls are a loss there).  GRIDMAP_PALLAS=0 disables
    #     the Pallas resolution (escape hatch; portable path is identical
    #     in schedule and scores).
    impl: str = "auto"
    # matmul backend in bf16 (f32 accumulate, range-centered field): ~3-6x
    # MXU speedup on v5e vs f32 passes, at ~0.1-0.2 log-score quantization
    # noise (ATE-neutral on the canonical datasets, tests/
    # test_matcher_matmul.py::test_matmul_bf16_close).  False = bit-clean
    # scores identical to the gather backend.
    matmul_bf16: bool = True
    # Surface mode (SharedMapSLAM.step_surface, ops/surface.py): precompute
    # the measurement likelihood over (theta bins x all cells) once per scan
    # — one MXU correlation, cost independent of particle count — then
    # weight every particle with ~8 trilinear taps.  The mode for 1M+
    # particles (BASELINE config 3).
    surface_nt: int = 25                  # theta bins
    surface_theta_span_deg: float = 24.0  # bins span center +/- this
    surface_crop_cells: int = 0           # C volume extent; 0 = full map
    # +/-1-cell hill-climb refinement steps.  Default 0 (pure MCL
    # weighting): measured BETTER ATE than climbing at >=256 particles —
    # the climb collapses particle diversity onto local maxima — and ~10x
    # fewer volume taps per particle (the dominant 1M-particle cost).
    surface_refine_steps: int = 0
    # Surface-mode weight temperature: log-weights are MULTIPLIED by this
    # factor before normalization.  Raw per-scan log-likelihoods are sums
    # over ~180 beams; their spread across a sampled cloud is tens of
    # nats, so exp() degenerates (Neff ~0.5 % of P at 1M) and the filter
    # resamples EVERY scan — ~30 % of the 1M step (docs/bench/
    # ROOFLINE.md).  0.0 (default) = AUTO: 1/sqrt(n_valid_hit_beams)
    # per scan (~0.075 at 180 beams); 1.0 = reference semantics (raw
    # product, slam/SLAM.java:99).  Evidence (docs/bench/
    # temp_study_r5.json + temp_study2_r5.json): at 1M particles
    # auto-temp with the 0.15 gate below is strictly better than
    # untempered (ATE 0.0353 vs 0.0372, 30 vs 50 ms/scan); at 100k it
    # trades ~1 cm ATE on the canonical logs for half the resamples.
    surface_weight_temp: float = 0.0
    # Surface-mode resample gate: resample when
    # Neff < surface_resample_fraction * P (the RBPF paths keep the
    # reference's 0.5 via SlamConfig.resample_fraction,
    # app/GridMapApp.java:185).  With tempered weights Neff sits at
    # 20-30 % of P while tracking, so 0.15 makes the 22 ms @1M resample
    # occasional instead of per-scan; study artifacts above.
    surface_resample_fraction: float = 0.15
    # Volume correlation at MXU-native bf16 (f32 accumulate, exact shift
    # mass subtracted; ops/surface.scan_surface).  OFF by default: surface
    # mode weights particles by RAW volume samples (no per-particle
    # refinement to absorb noise), and the ~0.1-0.2 log-score quantization
    # measurably collapses Neff and doubles ATE at moderate particle counts
    # (measured at 256p; see round-3 notes).  The RBPF matcher's
    # matmul_bf16 is unaffected because its hill-climb refinement runs
    # before weighting.
    surface_bf16: bool = False
    # Volume correlation algorithm: "auto" picks FFT when the direct
    # conv's flop count (nt * K^2 * crop^2) is large (city-scale crops —
    # ~3 orders of magnitude fewer flops), direct conv otherwise (exact,
    # and faster at small-map sizes); "direct"/"fft" force.
    surface_corr: str = "auto"
    # AMCL-style recovery injection (Augmented MCL, Probabilistic
    # Robotics table 8.3) for surface-mode localization: track slow/fast
    # exponential averages of the per-scan mean log-weight; when the fast
    # average collapses relative to the slow one — the mid-run-kidnap
    # signature (NB: Neff alone cannot detect it: after a kidnap every
    # particle is uniformly BAD, so Neff goes UP) — resampling replaces a
    # max(0, 1 - exp(l_fast - l_slow)) fraction of particles with
    # uniform draws over the map x full heading circle.  Both 0 disables
    # (default; mapping runs must not inject).  Implemented uniformly in
    # the single-device shared-map steps AND the distributed engines
    # (shmap/tiled/surface_sharded inject into their global resample
    # slots; models/shared.recovery_update + inject_uniform).
    surface_reinject_slow: float = 0.0    # e.g. 0.05
    surface_reinject_fast: float = 0.0    # e.g. 0.5
    # Measurement likelihood mixture (slam/GridMap.java:259).
    z_hit: float = 0.9
    # Scale on the motion log-prior added to the matcher objective
    # (0 = pure measurement likelihood; 1 = reference-style objective).
    prior_weight: float = 1.0
    # Disable scan matching entirely (motion-model dead reckoning).
    enabled: bool = True

    @property
    def z_random(self) -> float:
        return 1.0 - self.z_hit


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Top-level engine configuration."""

    robot: RobotConfig = RobotConfig()
    sensor: SensorConfig = SensorConfig()
    motion: MotionConfig = MotionConfig()
    map: MapConfig = MapConfig()
    matcher: MatcherConfig = MatcherConfig()

    num_particles: int = 500               # slam/SLAM.java:50
    max_beams: int = 360                   # fixed scan width (pad/truncate)
    # Skip map integration for large rotations (slam/SLAM.java:82).
    skip_update_dtheta_deg: float = 30.0
    # Resample when neff < num_particles * resample_fraction
    # (app/GridMapApp.java:185).
    resample_fraction: float = 0.5
    # Reference behavior: weights are OVERWRITTEN with p(z|x,m) each scan
    # (slam/SLAM.java:99).  True switches to proper sequential importance
    # weighting (w *= p(z|x,m), reset to uniform on resample) — the
    # GMapping-style accumulation; off by default for parity.
    accumulate_weights: bool = False
    # Localization-only mode: never integrate scans into the map (known-map
    # relocalization / kidnapped-robot runs keep the loaded map pristine
    # while the filter converges).
    freeze_map: bool = False
    # Particle chunk size for memory-bounded vmap (lax.map over chunks).
    particle_chunk: int = 0                # 0 = single chunk (all particles)
    # Number of bins in the bearing -> beam-index lookup table used by the
    # dense map update (power of two).
    beam_lut_bins: int = 2048
    # Dense correlative update: treat beams as rays of ~1 cell width
    # (emulates the reference's per-beam DDA cell set, slam/RayIterator.java).
    dtype: str = "float32"
    # Pallas kernels for the fused LL-field build and map update:
    # "auto" = use on TPU when the map shape is tile-aligned (H%8, W%128) and
    # beam_lut_bins % H == 0; "on" / "off" force.
    use_pallas: str = "auto"

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    def with_overrides(self, overrides: dict) -> "SlamConfig":
        """Apply dotted-key overrides, e.g. {"num_particles": 1000,
        "map.resolution": 0.1, "matcher.z_hit": 0.95} — the CLI/flag
        override surface (the reference has no config system; SURVEY §5)."""
        cfg = self
        for key, value in overrides.items():
            parts = key.split(".")
            if len(parts) == 1:
                cfg = dataclasses.replace(cfg, **{parts[0]: value})
            elif len(parts) == 2:
                sub = getattr(cfg, parts[0])
                field_type = type(getattr(sub, parts[1]))
                sub = dataclasses.replace(
                    sub, **{parts[1]: field_type(value)
                            if field_type in (int, float, bool) else value})
                cfg = dataclasses.replace(cfg, **{parts[0]: sub})
            else:
                raise KeyError(f"unsupported override depth: {key}")
        return cfg

    @staticmethod
    def parse_overrides(pairs) -> dict:
        """Parse ["key=value", ...] strings (numbers auto-coerced)."""
        out = {}
        for pair in pairs:
            key, _, raw = pair.partition("=")
            if not _:
                raise ValueError(f"expected key=value, got {pair!r}")
            try:
                value = int(raw)
            except ValueError:
                try:
                    value = float(raw)
                except ValueError:
                    value = {"true": True, "false": False}.get(
                        raw.lower(), raw)
            out[key.strip()] = value
        return out


# Benchmark / example configurations (BASELINE.json "configs").
def reference_parity_config() -> SlamConfig:
    """Config 0: exact reference defaults (500 particles, 6x6 m @ 5 cm)."""
    return SlamConfig()


def pr1_config() -> SlamConfig:
    """Config 1: 100 particles, 20x20 m @ 5 cm (CPU-runnable)."""
    return SlamConfig(
        num_particles=100,
        map=MapConfig(width_m=20.0, height_m=20.0, resolution=0.05,
                      origin=(-10.0, -10.0)),
    )


def chip_config(num_particles: int = 10_000) -> SlamConfig:
    """Config 2: 10k particles vmapped on one chip."""
    return SlamConfig(num_particles=num_particles, particle_chunk=512)


# Surface-mode presets of the port (bench.py --preset mega / city), not in
# the JAX package's config.py.
def mega_config() -> SlamConfig:
    """1M particles in surface mode on the reference 6 x 6 m map at 5 cm
    (120 x 120), 192 beam slots, no hill-climb refinement."""
    return SlamConfig(
        num_particles=1_000_000, max_beams=192, particle_chunk=0,
        map=MapConfig(width_m=6.0, height_m=6.0, resolution=0.05,
                      origin=(-3.0, -3.0)),
    ).with_overrides({"matcher.surface_refine_steps": 0})


def city_config() -> SlamConfig:
    """Config 3: 1M particles in surface mode on a 200 x 200 m map at 5 cm
    (4000 x 4000, 64 MB), the volume over a 512-cell crop around the
    cloud."""
    return SlamConfig(
        num_particles=1_000_000, max_beams=192, particle_chunk=0,
        map=MapConfig(width_m=200.0, height_m=200.0, resolution=0.05,
                      origin=(-100.0, -100.0)),
    ).with_overrides({"matcher.surface_refine_steps": 0,
                      "matcher.surface_crop_cells": 512})
