"""The per-frame signal chain (mirrors ``dspmap_tpu/models/pipeline.py``:
the pool branch of ``make_step`` on its fused-sweep arm, and
``_make_step_compact`` for ``cfg.layout == "compact"``):

ingest -> velocity estimation -> fused sweep -> rebin + FOV registration
-> measurement update -> particle birth -> occupancy/future/resample

The compact layout runs the same chain over the ``[P]`` particle array
(``ops/compact.py``); ingest, the estimator and the measurement update are
shared verbatim.

Admission control (``dsp_dynamic.h:193-208``) is decided on the host from
the frame's numpy inputs and the state's host copy of the last pose and
timestamp; a rejected frame returns the state unchanged.  Nothing else in
the step reads a device value on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import MapConfig
from .. import geometry
from ..state import MapState, flatten_pool
from ..estimator import estimate_velocities
from ..ops.project import project_points
from ..ops.sweep import sweep
from ..ops.fov import rebin_and_register
from ..ops.update import measurement_update
from ..ops.birth import particle_birth, particle_birth_compact
from ..ops.common import padded_buffer, to_device
from ..ops.compact import (occupancy_compact, rebin_compact,
                           register_fov_compact, sweep_compact)
from ..ops.occupancy import occupancy_and_resample
from ..ops.relayout import zeros_flat


class Frame(NamedTuple):
    """One sensor frame, as host (numpy) arrays."""

    points: np.ndarray  # f32 [P, 3] body-frame points
    n_points: int  # valid prefix length of ``points``
    sensor_pos: np.ndarray  # f32 [3] world position
    quat: np.ndarray  # f32 [4] wxyz body->world attitude
    timestamp: np.float32  # seconds


class StepOutput(NamedTuple):
    accepted: bool
    weight_sum: torch.Tensor  # f32 [V]
    metrics: dict  # name -> 0-dim tensor on the state's device
    estimator_cloud: tuple  # (points [P,3], vel [P,3], dynamic [P], valid [P])


#: names of the step's metrics, in the JAX package's order
METRIC_NAMES = (
    "valid_points", "in_fov", "pyramid_full_killed", "fov_global_overflow",
    "update_spill_overflow", "moved_out", "movers", "mover_overflow_killed",
    "voxel_full_killed", "updated_particles", "obs_spill_overflow",
    "birth_candidates", "born", "newborn_weight", "alive", "culled",
    "resampled_voxels", "resample_dropped", "resample_copies",
    "future_moving", "future_overflow",
)
#: the compact layout's metrics: birth and occupancy also count the rows
#: dropped for want of free rows in the ``[P]`` array
COMPACT_METRIC_NAMES = METRIC_NAMES + ("pool_overflow",)


def make_draws(cfg: MapConfig, gen: torch.Generator, device):
    """The step's random draws from ``gen``: ``(fresh_intensity [C] on
    [0.1, 1), noise_p, noise_v [P, n_b, 3] standard normal, noise_u
    [P, n_b, 3] on [-1, 1))``."""
    shape = (cfg.max_input_points, cfg.newborn_particles_per_point, 3)
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    fresh = torch.rand(cfg.max_clusters, **kw) * 0.9 + 0.1
    noise_p = torch.randn(shape, **kw)
    noise_v = torch.randn(shape, **kw)
    noise_u = torch.rand(shape, **kw) * 2.0 - 1.0
    return fresh, noise_p, noise_v, noise_u


def make_step(cfg: MapConfig, with_metrics: bool = True,
              admission_control: bool = True, shard=None):
    """Build ``step(state, frame, draws=None) -> (state, StepOutput)``.

    ``draws`` (see :func:`make_draws`) injects the step's random numbers;
    ``None`` draws them from ``state.gen``.  The device is the state's
    device and every tensor the step creates is created there.  The step
    does not modify its input state's tensors: the returned state holds
    new ones.

    ``with_metrics=False`` returns the metrics ``{"alive": ...}`` only.
    Unlike the JAX step, where it lets the compiler drop some twenty
    reductions, it saves no work here: the stages still compute and launch
    their counters every frame, and only the returned dict is trimmed.
    ``admission_control=False`` runs the frame whatever its pose and time
    step; ``StepOutput.accepted`` still says whether admission control
    would have taken it.  ``shard`` (the JAX package's sharded fast path)
    is not ported: anything but ``None`` raises.
    """
    cfg.validate()
    if shard is not None:
        raise NotImplementedError(
            "the sharded step is not ported yet (ROADMAP.md, queue 1, item 19)")
    compact = cfg.layout == "compact"
    if not (cfg.limit_motion_to_xy_plane or cfg.motion_model == "static"):
        raise NotImplementedError(
            "the port runs the fused-sweep (deterministic prediction) path only")

    def step(state: MapState, frame: Frame, draws=None):
        dev = state.device
        sensor_pos = np.asarray(frame.sensor_pos, np.float32)
        quat = np.asarray(frame.quat, np.float32)
        ts = np.float32(frame.timestamp)
        last_pos = state.last_sensor_pos if state.initialized else sensor_pos
        last_t = state.last_timestamp if state.initialized else ts
        dt = np.float32(ts - np.float32(last_t))
        delta = sensor_pos - np.asarray(last_pos, np.float32)
        accepted = bool(geometry.quaternion_is_valid_np(quat)
                        and np.all(np.abs(delta) <= np.float32(10.0))
                        and dt >= 0.0 and dt <= 10.0)
        if admission_control and not accepted:
            return state, _rejected(state, cfg, with_metrics)

        if draws is None:
            draws = make_draws(cfg, state.gen, dev)
        fresh, noise_p, noise_v, noise_u = (
            d.to(dev) if isinstance(d, torch.Tensor)
            else to_device(d, torch.float32, dev) for d in draws)
        origin = geometry.window_origin_np(sensor_pos, cfg)
        update_time = np.float32(np.float32(state.update_time) + dt)
        rt = state.params

        # -- ingest (dsp_dynamic.h:234-293) -----------------------------
        points = to_device(frame.points, torch.float32, dev)
        point_valid = torch.arange(points.shape[0], device=dev) < int(
            frame.n_points)
        obs = project_points(points, point_valid, sensor_pos, quat, cfg)
        expected_newborn = (rt.newborn_particle_weight
                            * obs.n_valid_points.to(torch.float32)
                            * cfg.newborn_particles_per_point)

        # -- velocity estimation (dsp_dynamic.h:297,1377) ---------------
        est_out, est_state = estimate_velocities(
            obs.cloud_world, obs.cloud_valid, state.estimator, cfg, dt, fresh)

        # -- fused sweep: advance, window masks, pyramid geometry -------
        # The velocity clamp (vz = 0 under limit-xy, v = 0 in the static
        # model) holds at every write site, so the clamped planes are zeros.
        p = state.particles
        if cfg.motion_model == "static":
            z = torch.zeros_like(p.vx)
            p = dataclasses.replace(p, vx=z, vy=z, vz=z)
        else:
            p = dataclasses.replace(p, vz=torch.zeros_like(p.vz))
        if compact:
            p, sw = sweep_compact(p, cfg, dt, origin, sensor_pos, quat)
            p, _, rebin_stats = rebin_compact(p, sw, cfg)
            p, fovbin, fov_stats = register_fov_compact(p, cfg, sw.pyr, sw.fov,
                                                        sensor_pos)
            fov_stats.update(rebin_stats)
        else:
            sw = sweep(p, cfg, dt, origin, sensor_pos, quat)
            p = dataclasses.replace(p, px=sw.px, py=sw.py, pz=sw.pz,
                                    flags=sw.flags)
            # -- flat mid-frame phase (state.flatten_pool): from here
            # through birth every scatter and gather runs on flat [S*V]
            # planes; occupancy_and_resample converts back once.  Planes
            # of 16 MiB or more are copied by the relayout kernel into
            # working buffers that the scatters write in place; smaller
            # planes are views and each scatter copies as before.
            # The constant-zero velocity planes are made anew in flat form
            # rather than copied (each its own working buffer where the
            # scatters write in place); sw.tags and sw.new_cell are fresh
            # kernel outputs that nothing scatters into, so a view serves.
            zero_planes = (("vx", "vy", "vz") if cfg.motion_model == "static"
                           else ("vz",))
            p = flatten_pool(p, skip=zero_planes + (
                () if cfg.record_particle_time else ("t",)))
            in_place = padded_buffer(p.flags) is not None
            p = dataclasses.replace(p, **{
                n: (zeros_flat(p.flags.shape[0], torch.float32, dev)
                    if in_place else getattr(p, n).view(-1))
                for n in zero_planes})
            sw = sw._replace(tags=sw.tags.view(-1),
                             new_cell=sw.new_cell.view(-1))
            p, fovbin, future_movers, fov_stats = rebin_and_register(
                p, cfg, sw, sensor_pos, update_time)

        # -- measurement update (dsp_dynamic.h:304,704-793) -------------
        p, norm_coeff, upd_stats = measurement_update(
            p, fovbin, obs, cfg, expected_newborn, update_time, rt)

        # -- particle birth (dsp_dynamic.h:315,796-921) -----------------
        birth = particle_birth_compact if compact else particle_birth
        p, birth_stats = birth(
            p, cfg, (noise_p, noise_v, noise_u),
            est_points=est_out.points, est_vel=est_out.vel,
            est_dynamic=est_out.dynamic, est_valid=est_out.valid,
            norm_coeff=norm_coeff, origin=origin, update_time=update_time,
            rt=rt)

        # -- occupancy + future + resample (dsp_dynamic.h:322,924) ------
        if compact:
            p, weight_sum, vel_avg, future, occ_stats = occupancy_compact(
                p, cfg, origin, state.future)
        else:
            p, weight_sum, vel_avg, future, occ_stats = occupancy_and_resample(
                p, cfg, origin, state.future, future_movers)

        new_state = dataclasses.replace(
            state, particles=p, weight_sum=weight_sum, vel_avg=vel_avg,
            future=future, sensor_pos=sensor_pos,
            last_sensor_pos=sensor_pos.copy(), origin=origin,
            update_time=update_time, last_timestamp=ts,
            update_counter=state.update_counter + 1, initialized=True,
            estimator=est_state)
        if with_metrics:
            metrics = {"valid_points": obs.n_valid_points, **fov_stats,
                       **upd_stats, **birth_stats, **occ_stats}
            if compact:
                metrics["pool_overflow"] = (birth_stats["pool_overflow"]
                                            + occ_stats["pool_overflow"])
        else:
            metrics = {"alive": occ_stats["alive"]}
        cloud = (est_out.points, est_out.vel, est_out.dynamic, est_out.valid)
        return new_state, StepOutput(accepted, weight_sum, metrics, cloud)

    return step


def _rejected(state: MapState, cfg: MapConfig,
              with_metrics: bool) -> StepOutput:
    dev = state.device
    P = cfg.max_input_points
    names = COMPACT_METRIC_NAMES if cfg.layout == "compact" else METRIC_NAMES
    if not with_metrics:
        names = ("alive",)
    metrics = {k: torch.zeros((), device=dev,
                              dtype=torch.float32 if k == "newborn_weight"
                              else torch.int64)
               for k in names}
    cloud = (torch.zeros((P, 3), device=dev), torch.zeros((P, 3), device=dev),
             torch.zeros(P, dtype=torch.bool, device=dev),
             torch.zeros(P, dtype=torch.bool, device=dev))
    return StepOutput(False, state.weight_sum, metrics, cloud)


def read_occupancy(state: MapState, cfg: MapConfig, threshold: float = 0.7):
    """``(occupied[V], centers[V, 3], future[V, T], weight[V], new_state)``
    in the reference's ego voxel order; the returned state has its future
    accumulators cleared (``dsp_dynamic.h:420-424``)."""
    dev = state.device
    gather = geometry.ego_grid_gather_indices(state.origin, cfg, dev).to(
        torch.int64)
    weight = state.weight_sum[gather]
    occupied = weight > threshold
    wv = geometry.storage_to_world_voxel(state.origin, cfg, dev)[gather]
    centers = geometry.voxel_center(wv, cfg)
    future = state.future[:, gather].T
    return occupied, centers, future, weight, clear_future_prediction(state)


def get_occupancy_map(state: MapState, cfg: MapConfig, threshold: float = 0.7):
    """``getOccupancyMapWithFutureStatus`` (dsp_dynamic.h:405-426):
    ``(occupied[V], centers[V, 3], future[V, T], new_state)``."""
    occupied, centers, future, _, new_state = read_occupancy(
        state, cfg, threshold)
    return occupied, centers, future, new_state


def clear_future_prediction(state: MapState) -> MapState:
    """``clearOccupancyMapPrediction`` (dsp_dynamic.h:429-438)."""
    return dataclasses.replace(state, future=torch.zeros_like(state.future))


# --- live runtime setters (dsp_dynamic.h:355-382) --------------------------
#
# The knobs ride ``state.params`` (:class:`~dspmap_tpu_torch.state.
# RuntimeParams`) as host floats rounded to float32, as the JAX package's
# traced f32 scalars: a setter returns a new state and the next step reads
# the new values.


def _set_params(state: MapState, **kw) -> MapState:
    params = dataclasses.replace(
        state.params, **{k: float(np.float32(v)) for k, v in kw.items()})
    return dataclasses.replace(state, params=params)


def set_prediction_variance(state: MapState, position_std,
                            velocity_std) -> MapState:
    """``setPredictionVariance`` (dsp_dynamic.h:355-360)."""
    return _set_params(state, position_noise_std=position_std,
                       velocity_noise_std=velocity_std)


def set_observation_stddev(state: MapState, sigma_ob) -> MapState:
    """``setObservationStdDev`` (dsp_dynamic.h:362-365)."""
    return _set_params(state, sigma_ob=sigma_ob)


def set_newborn_particle_weight(state: MapState, weight) -> MapState:
    """``setNewBornParticleWeight`` (dsp_dynamic.h:367-370)."""
    return _set_params(state, newborn_particle_weight=weight)


def set_detection_probability(state: MapState, p_detection) -> MapState:
    """The constructor's P_d knob (dsp_dynamic.h:157) as a live setter."""
    return _set_params(state, p_detection=p_detection)


def set_clutter_intensity(state: MapState, kappa) -> MapState:
    """The constructor's kappa knob (dsp_dynamic.h:158) as a live setter."""
    return _set_params(state, kappa=kappa)
