"""Map configuration: every knob of the DSP-map pipeline as one frozen dataclass.

The reference (g-ch/DSP-map) spreads configuration over three tiers: compile-time
``#define`` blocks at the top of each header (``include/dsp_dynamic.h:37-56``),
runtime setters (``include/dsp_dynamic.h:355-382``) and a PyQt tool that rewrites
the source text (``script/set_map_parameters.py:392-452``).  Here all of it is a
single frozen dataclass; derived sizes (pyramid counts, slot capacities) are
computed once and fix every tensor shape of the step -- the analogue of the
reference's compile-time constants.

This module is the port's own copy of ``dspmap_tpu/config.py`` (standard
library only): the same fields, defaults, derived sizes and presets, so that
``MapConfig(**dataclasses.asdict(cfg))`` carries a configuration between the
two packages.  A test holds the two copies equal field by field.  The
``use_pallas_*`` fields are kept for that round trip and are inert here: on
a CUDA tensor the port's kernels always run.

The three reference header variants (``dsp_dynamic.h``,
``dsp_dynamic_multiple_neighbors.h``, ``dsp_static.h``) share ~85% of their code
and differ only in parameters and two behavioral switches (motion model and
estimator); they are expressed as the presets :func:`dsp_dynamic`,
:func:`dsp_dynamic_multi_neighbors` and :func:`dsp_static`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Tuple

MotionModel = Literal["constant_velocity", "static"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """All parameters of one DSP-map instance.

    Defaults mirror ``include/dsp_dynamic.h`` (the recommended Type-II map):
    map geometry ``:38-44``, horizons ``:46-47``, FOV ``:49-50``, filter
    parameters from the constructor init list ``:145-168``.
    """

    # --- voxel grid (dsp_dynamic.h:38-41) -------------------------------
    nx: int = 66
    ny: int = 66
    nz: int = 40
    voxel_resolution: float = 0.15

    # --- FOV pyramid partition (dsp_dynamic.h:42,49-50) -----------------
    angle_resolution_deg: int = 3
    half_fov_h_deg: int = 42
    half_fov_v_deg: int = 24
    #: neighborhood radius N -> (2N+1)^2 pyramid cells take part in the
    #: measurement update.  1 in dsp_dynamic.h (:1135-1136), 2 in
    #: dsp_dynamic_multiple_neighbors.h (:43).
    pyramid_neighbor_radius: int = 1

    # --- particle population (dsp_dynamic.h:43-44,64-66) ----------------
    max_particles_per_voxel: int = 9
    #: slot capacity per voxel = safety_factor * max_particles_per_voxel
    #: (x2 in the dynamic headers :65, x5 in dsp_static.h:63).
    voxel_slot_safety_factor: int = 2
    limit_motion_to_xy_plane: bool = True
    motion_model: MotionModel = "constant_velocity"

    # --- future-status prediction horizons (dsp_dynamic.h:46-47) --------
    prediction_horizons: Tuple[float, ...] = (0.05, 0.2, 0.5, 1.0, 1.5, 2.0)

    # --- filter parameters (ctor defaults, dsp_dynamic.h:154-163) -------
    position_noise_std: float = 0.2
    velocity_noise_std: float = 0.1
    sigma_ob: float = 0.2
    kappa: float = 0.01
    p_detection: float = 0.95
    newborn_particle_weight: float = 0.04
    newborn_particles_per_point: int = 20
    #: fraction of newborn particles forced static at minimum
    #: (0.15 dsp_dynamic.h:808; 0.2 dsp_static.h:791).
    min_static_newborn_fraction: float = 0.15
    #: fraction of newborns whose velocity comes from the filter/estimator
    #: model (the rest are random-velocity exploration) (dsp_dynamic.h:811).
    model_newborn_fraction: float = 0.8
    #: uniform random newborn velocity ranges (dsp_dynamic.h:895-897).
    random_newborn_vxy: float = 1.5
    random_newborn_vz: float = 0.5
    #: extra velocity-noise multiplier for estimator-derived newborns
    #: (dsp_dynamic.h:884-886).
    estimator_newborn_noise_gain: float = 4.0

    #: occlusion slack added to the per-pyramid max measured range
    #: (0.3 m in dsp_dynamic.h:70,761; voxel_resolution in the other two).
    occlusion_slack: float = 0.3
    #: particles below this weight are removed before occupancy counting
    #: (dsp_dynamic.h:941-942).
    weight_cull_threshold: float = 1e-3
    #: voxels with fewer valid particles are not resampled (dsp_dynamic.h:986).
    resample_min_count: int = 5

    # --- initial velocity estimator (dsp_dynamic.h:1377-1544) -----------
    estimator_enabled: bool = True
    #: ground split height & clustering tolerance derive from this
    #: (static member, dsp_dynamic.h:132; set via
    #: setOriginalVoxelFilterResolution :380-382).
    voxel_filter_resolution: float = 0.15
    dynamic_cluster_max_points: int = 200
    dynamic_cluster_max_height: float = 1.5
    cluster_min_points: int = 5
    cluster_max_points: int = 10000
    assoc_distance_gate: float = 1.5
    assoc_point_num_gate: int = 100
    max_cluster_velocity: float = 5.0

    # --- static capacities (fixed shapes of the step) --------------------
    #: input point budget per frame (map_sim_example.cpp:48).
    max_input_points: int = 5000
    #: per-pyramid observation capacity (dsp_dynamic.h:69).
    max_obs_points_per_pyramid: int = 100
    #: per-pyramid particle capacity for the measurement update; ``None``
    #: derives the reference formula SAFE_PARTICLE_NUM/PYRAMID_NUM*2
    #: (dsp_dynamic.h:64-66) rounded up to a multiple of 8.
    pyramid_slot_capacity: int | None = None
    #: max tracked dynamic clusters in the velocity estimator.  The reference
    #: has no cap (std::vector); 16 is generous for its street scenes and the
    #: exact assignment solve is O(n^2) sequential steps, so keep this
    #: tight.
    max_clusters: int = 16
    #: capacity of the per-frame cross-voxel mover / moving-particle buffers
    #: (a fixed-shape budget; the reference has no analogue because it
    #: relocates serially).  Only self-moving particles enter these buffers
    #: -- street scene peaks: 1.1k movers / 1.5k future-movers -- and every
    #: gather in the mover chain scales
    #: with this capacity; overflow is killed and counted
    #: (``mover_overflow_killed`` / ``future_overflow`` metrics).
    mover_capacity: int = 1 << 12
    #: label-propagation sweeps for Euclidean clustering (with pointer
    #: jumping; 2^n reach per sweep covers any practical cluster diameter).
    cluster_propagation_iters: int = 12
    # --- measurement-update processing tiers (a processing layout; no
    # semantics change).  The reference's per-pyramid capacities
    # (SAFE_PARTICLE_NUM_PYRAMID=462, 100 obs points; dsp_dynamic.h:64-69)
    # are kill/drop thresholds sized for worst-case density, but realized
    # per-cell occupancy is far below them (peak
    # 176 particles / 100 points on the street scene).  Processing dense
    # [n_pyr, capacity] tiles at the full thresholds wastes ~20x the pair
    # work, so the update splits each axis in two tiers: ranks below the
    # dense tier go through dense tiles; ranks between the dense tier and
    # the reference threshold take an exact compacted spill path (identical
    # math, different layout).  Kill/drop thresholds are unchanged.
    #: dense particle tier per pyramid cell; ``None`` derives
    #: ``min(pyramid_slots, 64)`` (32 at 1-degree resolution).
    pyramid_dense_slots: int | None = None
    #: capacity of the compacted spill-particle buffer (ranks in
    #: [dense_slots, pyramid_slots)); overflow skips the update that frame
    #: and is counted in ``metrics["update_spill_overflow"]``.
    particle_spill_capacity: int = 4096
    #: dense observation tier per pyramid cell; ``None`` derives
    #: ``min(max_obs_points_per_pyramid, 32)`` (16 at 1-degree resolution).
    obs_dense_points: int | None = None
    #: scatter-budget bucket for newborn insertion (ops/insert.py): when the
    #: frame's insertable newborns fit, they are compacted before the nine
    #: field scatters; otherwise the exact full-capacity scatter runs.  ``None`` disables the
    #: specialization (single full-capacity program).  Consumed through
    #: :meth:`birth_insert_budget`, which widens it on deep-slot variants.
    birth_compact_capacity: int | None = 1 << 14
    #: capacity (in *cells*) of the spill-observation tier: cells holding
    #: more than the dense tier of points get a compacted per-cell tile of
    #: the remainder (up to the reference drop threshold).  Overflowing
    #: cells' spill points are dropped and counted; the street scene peaks
    #: at ~10 spilled cells.
    obs_spill_capacity: int = 64
    #: the JAX package's kernel switches: inert in the port (kept so that a
    #: configuration round-trips between the packages)
    use_pallas_sweep: bool = False
    use_pallas_occupancy: bool = True
    use_pallas_update: bool = False
    #: cross-slab mover exchange on the shard_map fast path
    #: (parallel/shard_step.py): ``"all_gather"`` delivers every mover to
    #: every shard (n-1 buffers of traffic, unconditionally correct);
    #: ``"ring"`` exchanges only with the ``ring_hops`` nearest slabs in
    #: each direction over ``ppermute`` (2*hops buffers -- the neighbor
    #: exchange SURVEY.md section 7.1.7 names).  Ring is valid because the
    #: z-major storage layout makes slabs contiguous z-ranges and per-frame
    #: self-motion crosses few z-rows; movers bound further than
    #: ``ring_hops`` slabs are dropped and counted in
    #: ``mover_overflow_killed``.  The future-status scatter (prediction
    #: horizons up to 2 s of reach) always uses all_gather.
    mover_exchange: str = "all_gather"
    #: neighbor radius (slabs, each direction) for ``mover_exchange="ring"``
    ring_hops: int = 1
    #: maintain the per-particle last-update-time plane.  The reference
    #: stores this field but never reads it (``voxels_with_particle[..][8]``
    #: is write-only, dsp_dynamic.h:787,1194 -- no consumer anywhere), and
    #: neither does any output here (the CSV format has no time column).
    #: Off by default: skipping the ``t`` writes removes one plane from the
    #: insert scatters, the measurement-update writeback and the resample
    #: copy placement.  Turn on to keep the plane current
    #: (e.g. for custom telemetry over checkpoints).
    record_particle_time: bool = False
    #: particle storage layout.  ``"pool"`` is the dense ``[S, V]``
    #: slot-pool translation of the reference's static arrays
    #: (``dsp_dynamic.h:116``); ``"compact"`` stores the live population in
    #: one ``[P]`` SoA array (``P = compact_capacity``) and runs every pool
    #: pass as O(alive) sort/segment/scatter work instead of streaming the
    #: ``S*V`` slot planes (ops/compact.py).  Per-voxel capacity semantics
    #: (drop-on-full, ``dsp_dynamic.h:1198-1200,1227-1229``) are enforced
    #: by within-voxel arrival ranks in both layouts.  The realized live
    #: population is ~21k particles in a 3.1M-slot flagship pool, so the
    #: compact layout moves ~100x fewer bytes per frame.
    layout: str = "pool"
    #: row capacity of the compact layout's particle array; ``None``
    #: derives ``min(slots_per_voxel * storage_voxels, 2^17)`` -- a budget
    #: ~6x the flagship's steady-state alive population.  When the global
    #: row pool is exhausted, surplus newborns/resample-copies are dropped
    #: and counted (``metrics["pool_overflow"]``); per-voxel capacity is
    #: unchanged.  No reference analogue (its global bound is the full
    #: ``V*S`` array).
    particle_capacity: int | None = None
    #: global capacity of the in-FOV particle buffer; ``None`` derives
    #: ``min(n_pyramids * pyramid_slots, 2^15)``.  Overflow particles keep
    #: their weight but skip the measurement update that frame (the
    #: reference's only cap is the per-pyramid slot list); overflow is
    #: counted in ``metrics["fov_global_overflow"]`` and guarded by scale
    #: tests.  Every gather and scatter in the FOV path scales with this
    #: capacity, not the live population -- keep it near 2-3x the realistic
    #: in-FOV peak (street scene: 11.5k dynamic / 16k multi-neighbor).
    fov_capacity: int | None = None

    # ---------------------------------------------------------------- derived
    @property
    def voxel_num(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def slots_per_voxel(self) -> int:
        return self.max_particles_per_voxel * self.voxel_slot_safety_factor

    @property
    def storage_voxels(self) -> int:
        """Physical pool-plane width: ``voxel_num`` rounded up to a multiple
        of 1024.  The pad columns are dead storage (``storage_index`` is
        always < ``voxel_num``, so nothing is ever inserted or killed
        there; readouts gather through [voxel_num]-sized index tables) --
        they exist so every row of a pool plane starts on an aligned
        address, which the relayout kernels (``ops/relayout.py``) require
        for their 16-byte copies.  Cost: <= 1023 dead voxels (< 1.4%%).

        Huge maps additionally round up to a multiple of 65536 when that
        costs < 4%% extra voxels (the JAX package's rule, kept so that
        states carry over between the packages)."""
        base = _round_up(self.voxel_num, 1024)
        big = _round_up(self.voxel_num, 65536)
        plane_bytes = self.slots_per_voxel * base * 4
        if plane_bytes >= (16 << 20) and big <= base * 1.04:
            return big
        return base

    @property
    def compact_capacity(self) -> int:
        """Row count P of the compact particle array (see ``layout``).

        Default 2^16 = ~3x the flagship street scene's steady-state alive
        population; every per-row cost in the compact core scales with P,
        so keep it tight and watch
        ``metrics["pool_overflow"]``."""
        if self.particle_capacity is not None:
            return self.particle_capacity
        return min(self.slots_per_voxel * self.storage_voxels, 1 << 16)

    @property
    def n_pyramids_h(self) -> int:
        return 2 * self.half_fov_h_deg // self.angle_resolution_deg

    @property
    def n_pyramids_v(self) -> int:
        return 2 * self.half_fov_v_deg // self.angle_resolution_deg

    @property
    def n_pyramids(self) -> int:
        return self.n_pyramids_h * self.n_pyramids_v

    @property
    def angle_resolution_rad(self) -> float:
        return math.radians(self.angle_resolution_deg)

    @property
    def half_fov_h_rad(self) -> float:
        return math.radians(self.half_fov_h_deg)

    @property
    def half_fov_v_rad(self) -> float:
        return math.radians(self.half_fov_v_deg)

    @property
    def half_extent(self) -> Tuple[float, float, float]:
        r = self.voxel_resolution
        return (self.nx * r * 0.5, self.ny * r * 0.5, self.nz * r * 0.5)

    @property
    def n_horizons(self) -> int:
        return len(self.prediction_horizons)

    @property
    def pyramid_slots(self) -> int:
        """Particle capacity per pyramid cell in the measurement update.

        Reference formula (dsp_dynamic.h:63-66): SAFE_PARTICLE_NUM =
        VOXEL_NUM*MAX_PARTICLE_NUM_VOXEL + 1e5; capacity = SAFE_PARTICLE_NUM /
        (360*180/res^2) * 2.  Rounded up to a multiple of 8 (the JAX
        package's rule).
        """
        if self.pyramid_slot_capacity is not None:
            return self.pyramid_slot_capacity
        safe_particle_num = self.voxel_num * self.max_particles_per_voxel + 100_000
        global_pyramids = 360 * 180 // (self.angle_resolution_deg**2)
        cap = safe_particle_num // global_pyramids * 2
        return _round_up(max(cap, 8), 8)

    @property
    def dense_slots(self) -> int:
        """Dense particle tier of the measurement update (see
        ``pyramid_dense_slots``)."""
        if self.pyramid_dense_slots is not None:
            return min(self.pyramid_dense_slots, self.pyramid_slots)
        base = 64 if self.angle_resolution_deg >= 2 else 32
        return min(self.pyramid_slots, base)

    @property
    def obs_dense(self) -> int:
        """Dense observation tier of the measurement update (see
        ``obs_dense_points``)."""
        if self.obs_dense_points is not None:
            return min(self.obs_dense_points, self.max_obs_points_per_pyramid)
        base = 32 if self.angle_resolution_deg >= 2 else 16
        return min(self.max_obs_points_per_pyramid, base)

    @property
    def birth_insert_budget(self) -> int | None:
        """Effective newborn-insertion scatter budget.  Eligibility for
        insertion is per-voxel arrival rank < slots_per_voxel, so deep-slot
        variants (static x5, multi-neighbor x6 safety factors,
        dsp_static.h:46 / dsp_dynamic_multiple_neighbors.h:64) keep far
        more of the 100k candidate table eligible and the 16k budget would
        fall through to the full-size scatter path every frame.  The port
        runs the full-width insertion only and does not read this."""
        if self.birth_compact_capacity is None:
            return None
        if self.slots_per_voxel >= 40:
            return max(self.birth_compact_capacity, 1 << 15)
        return self.birth_compact_capacity


    @property
    def fov_buffer_capacity(self) -> int:
        if self.fov_capacity is not None:
            return self.fov_capacity
        return min(self.n_pyramids * self.pyramid_slots, 1 << 15)

    @property
    def neighbor_cells(self) -> int:
        n = 2 * self.pyramid_neighbor_radius + 1
        return n * n

    @property
    def birth_capacity(self) -> int:
        return self.max_input_points * self.newborn_particles_per_point

    @property
    def min_static_newborns(self) -> int:
        return int(self.newborn_particles_per_point * self.min_static_newborn_fraction)

    @property
    def model_newborns(self) -> int:
        return int(self.newborn_particles_per_point * self.model_newborn_fraction)

    @property
    def cluster_tolerance(self) -> float:
        """Euclidean clustering tolerance = 2 x filter resolution
        (dsp_dynamic.h:1411)."""
        return 2.0 * self.voxel_filter_resolution

    def validate(self) -> "MapConfig":
        if 360 % self.angle_resolution_deg or 180 % self.angle_resolution_deg:
            raise ValueError("angle_resolution_deg must divide 360 and 180")
        if self.half_fov_h_deg % self.angle_resolution_deg:
            raise ValueError("half_fov_h_deg must be a multiple of angle resolution")
        if self.half_fov_v_deg % self.angle_resolution_deg:
            raise ValueError("half_fov_v_deg must be a multiple of angle resolution")
        if self.motion_model not in ("constant_velocity", "static"):
            raise ValueError(f"unknown motion model {self.motion_model!r}")
        if self.layout not in ("pool", "compact"):
            raise ValueError(f"unknown layout {self.layout!r}")
        return self


# ------------------------------------------------------------------ presets

def dsp_dynamic(**overrides) -> MapConfig:
    """Type-II constant-velocity map, `include/dsp_dynamic.h` parameters.

    ``fov_capacity``: street-scene candidate peak (in-FOV + movers +
    future-movers) is ~13k; 24576 keeps a 1.8x margin while every
    capacity-sized gather in the FOV chain is a quarter smaller than at the
    32k default.  Overflow is counted
    (``fov_global_overflow``) and guarded by the adversarial-scene tests.
    """
    overrides.setdefault("fov_capacity", 24576)
    return dataclasses.replace(MapConfig(), **overrides).validate()


def dsp_dynamic_multi_neighbors(**overrides) -> MapConfig:
    """`include/dsp_dynamic_multiple_neighbors.h`: 1 deg pyramids with a
    (2*2+1)^2 = 25-cell update neighborhood (mn:42-43), 50x50x30 grid at
    0.2 m (mn:38-41), 30 particles/voxel (mn:44), FOV 42/27 deg (mn:50-51),
    occlusion slack = voxel resolution (mn:761)."""
    cfg = MapConfig(
        nx=50,
        ny=50,
        nz=30,
        voxel_resolution=0.2,
        angle_resolution_deg=1,
        pyramid_neighbor_radius=2,
        max_particles_per_voxel=30,
        half_fov_h_deg=42,
        half_fov_v_deg=27,
        occlusion_slack=0.2,
        voxel_filter_resolution=0.2,
        # the reference's 100-point pyramid capacity is kept verbatim
        # (mn:69); the two-tier update makes it cheap (realized 1-degree
        # cells peak at ~51 points on the street scene, so the dense tier
        # carries 16 and the rest take the exact spill path).
        # inert in the port (see the field)
        use_pallas_update=True,
        # dense particle tier 16 (default 32 at 1 degree): realized 1-deg
        # cell occupancy averages ~3 particles, so halving the dense tile
        # halves the pair work and the fovbin tensors with zero spill
        # overflow on the street scene; the tiers are a processing layout
        # -- results are exact either way.
        pyramid_dense_slots=16,
    )
    return dataclasses.replace(cfg, **overrides).validate()


def dsp_static(**overrides) -> MapConfig:
    """Type-I zero-velocity map, `include/dsp_static.h`: prediction zeroes
    velocities (st:640-646), newborns always static (st:804-824), estimator is
    a v=0 pass-through (st:1285-1309), 50x50x30 at 0.2 m with a x5 slot safety
    factor (st:38-63), occlusion slack = voxel resolution (st:744), newborn
    static floor 0.2 (st:791)."""
    cfg = MapConfig(
        nx=50,
        ny=50,
        nz=30,
        voxel_resolution=0.2,
        angle_resolution_deg=3,
        half_fov_h_deg=42,
        half_fov_v_deg=27,
        max_particles_per_voxel=10,
        voxel_slot_safety_factor=5,
        motion_model="static",
        estimator_enabled=False,
        min_static_newborn_fraction=0.2,
        occlusion_slack=0.2,
        voxel_filter_resolution=0.2,
        # inert in the port (see the field)
        use_pallas_update=True,
        # dense tier 32 (default 64 at 3 degrees): zero spill overflow
        # (exact -- two-tier is a processing layout).  The dynamic preset keeps 64: 32 overflowed the spill
        # buffer there (186 particles would skip their update).
        pyramid_dense_slots=32,
    )
    return dataclasses.replace(cfg, **overrides).validate()


def example_node_settings(cfg: MapConfig) -> MapConfig:
    """Runtime overrides applied by the reference ROS node
    (src/map_sim_example.cpp:522-526): prediction noise 0.05/0.05,
    observation sigma 0.1, 20 newborns of weight 1e-4 per point, 0.1 m input
    voxel filter."""
    return dataclasses.replace(
        cfg,
        position_noise_std=0.05,
        velocity_noise_std=0.05,
        sigma_ob=0.1,
        newborn_particle_weight=0.0001,
        newborn_particles_per_point=20,
        voxel_filter_resolution=0.1,
    ).validate()


def performance_level_parameters(
    level: float,
    voxel_resolution: float = 0.15,
    fov_angle_h: int = 87,
    fov_angle_v: int = 51,
) -> dict:
    """The tuner's performance->parameter mapping as a pure function.

    Mirrors ``script/set_map_parameters.py``: the level->(pyramid resolution,
    voxel filter, particle density) piecewise map (:459-475), the derived
    ``MAX_PARTICLE_NUM_VOXEL = density * res^3`` floored at 5 (:387-390), the
    suggested occupancy threshold by resolution (:428-433), and the FOV
    half-angle clipping to angle-resolution multiples (:443-452).

    ``level`` in [20, 100]: higher = more accurate (1 deg pyramids, finer
    filter, denser particles) and slower.
    """
    level = float(min(max(level, 20.0), 100.0))
    if level < 35.0:
        pyr_res, voxel_filter = 1, 0.2
        density = int((3000 - 1000) * (level - 20) / 15 + 1000)
    elif level < 50.0:
        pyr_res, voxel_filter = 1, 0.15
        density = int((3000 - 2000) * (level - 35) / 15 + 2000)
    elif level < 70.0:
        pyr_res, voxel_filter = 3, 0.15
        density = int((3000 - 2000) * (level - 50) / 20 + 2000)
    else:
        pyr_res, voxel_filter = 3, 0.1
        density = int((6000 - 2500) * (level - 70) / 30 + 2500)

    max_ppv = max(5, int(density * voxel_resolution**3))
    occupancy_threshold = 0.2
    if voxel_resolution > 0.18:
        occupancy_threshold = 0.5
    if voxel_resolution > 0.28:
        occupancy_threshold = 0.6
    half_fov_h = int((fov_angle_h - pyr_res) / 2 / pyr_res) * pyr_res
    half_fov_v = int((fov_angle_v - pyr_res) / 2 / pyr_res) * pyr_res
    return dict(
        angle_resolution_deg=pyr_res,
        voxel_filter_resolution=voxel_filter,
        particle_density=density,
        voxel_resolution=voxel_resolution,
        max_particles_per_voxel=max_ppv,
        occupancy_threshold=occupancy_threshold,
        half_fov_h_deg=half_fov_h,
        half_fov_v_deg=half_fov_v,
    )


def large_urban(**overrides) -> MapConfig:
    """BASELINE.json config 4: 30 x 30 x 6 m at 0.1 m voxels (300x300x60 =
    5.4M voxels), 6 future horizons, dense urban clouds.

    Particle density follows the tuner formula at this resolution
    (set_map_parameters.py:387-390): density * 0.1^3 floored at 5 -> 5
    particles/voxel, 10 slots -- a 54M-slot pool (~2 GB of f32 state) in the
    pool layout.
    """
    cfg = MapConfig(
        nx=300,
        ny=300,
        nz=60,
        voxel_resolution=0.1,
        max_particles_per_voxel=5,
        voxel_filter_resolution=0.1,
        position_noise_std=0.05,
        velocity_noise_std=0.05,
        sigma_ob=0.1,
        newborn_particle_weight=0.0001,
        # the derived per-pyramid capacity formula gives 7528 here (it scales
        # with voxel count); 512 is generous against the FOV buffer and
        # keeps the update tiles the same size as the default map's
        pyramid_slot_capacity=512,
        # dense urban clouds put more particles in FOV than the default
        # street scenes; keep 2^16 headroom at this scale
        fov_capacity=1 << 16,
        # inert in the port (see the field)
        use_pallas_sweep=True,
        # The alive-proportional compact layout suits this scale: the pool
        # layout streams the 54M-slot planes every pass while the live
        # population is ~50k.  131072 rows = ~2.5x the realized
        # population; overflow is counted (metrics["pool_overflow"]).
        layout="compact",
        particle_capacity=1 << 17,
    )
    return dataclasses.replace(cfg, **overrides).validate()
