"""The per-frame signal chain (mirrors ``dspmap_tpu/models/pipeline.py``:
``make_step`` on both of its prediction arms, ``_make_step_compact`` for
``cfg.layout == "compact"``, and the multi-sensor steps):

ingest -> velocity estimation -> prediction -> rebin + FOV registration
-> measurement update -> particle birth -> occupancy/future/resample

Deterministic prediction (limit-xy or the static model) takes the fused
sweep (``ops/sweep.py``) and ``rebin_and_register``; noisy prediction takes
``propagate`` -> ``rebin`` -> ``register_fov``, with its pool-shaped
normal draws.  The compact layout runs the same chain over the ``[P]``
particle array (``ops/compact.py``); ingest, the estimator and the
measurement update are shared verbatim.

:func:`make_multisensor_step` fuses several depth cameras into one map:
prediction and rebin once a frame, then FOV registration, the measurement
update and birth for each sensor in turn (the sequential multi-sensor PHD
composition), then one occupancy pass.

A step is a host prologue and a device body.  The prologue decides
admission control (``dsp_dynamic.h:193-208``) from the frame's numpy inputs
and the state's host copy of the last pose and timestamp -- a rejected
frame returns the state unchanged -- and computes the frame's values (time
step, update time, window origin, rotation) on the host; they reach the
device with the runtime parameters and the points in two frame blocks and
one copy (``scalars.py``).  The body takes only tensors: every
per-frame value it uses comes from the blocks, and every Python scalar it
hands an operation comes from the configuration, so one CUDA graph can be
captured over it and replayed a frame (``models/graphed.py``).  Nothing in
the step reads a device value on the host.  The multi-sensor step's
prologue (:func:`multisensor_prologue`) also decides which cameras are
admitted, and its body (:func:`make_multisensor_body`) is built for one
pattern of admitted cameras: a graph a pattern.

``make_step(cfg, shard=ShardCtx(...))`` and ``make_multisensor_step(cfg,
n, shard=ShardCtx(...))`` build the step of one rank of the sharded step
(``parallel/``): the state is the rank's slab, the frame, the estimator and
the replicated draws are the same on every rank, and the cross-slab work
runs as collectives.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..config import MapConfig
from .. import geometry
from ..state import EstimatorState, MapState, flatten_pool, init_state
from ..estimator import estimate_velocities
from ..ops.project import project_points
from ..ops.propagate import propagate
from ..ops.rebin import rebin
from ..ops.sweep import sweep
from ..ops.fov import rebin_and_register, register_fov
from ..ops.update import measurement_update
from ..ops.birth import particle_birth, particle_birth_compact
from ..ops.common import ShardCtx, frame_tensor, padded_buffer, to_device
from ..ops.compact import (fov_geometry_compact, occupancy_compact,
                           rebin_compact, rebin_exchange_compact,
                           register_fov_compact, sweep_compact)
from ..ops.occupancy import occupancy_and_resample
from ..ops.relayout import zeros_flat
from .. import scalars


class Frame(NamedTuple):
    """One sensor frame, as host (numpy) arrays; for the multi-sensor step
    every field carries a leading ``[n_sensors]`` axis
    (:func:`stack_frames`)."""

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
#: the multi-sensor step's metrics: the occupancy stage's alone
MULTISENSOR_METRIC_NAMES = ("alive", "culled", "resampled_voxels",
                            "resample_dropped", "resample_copies",
                            "future_moving", "future_overflow")
#: metrics that the sharded step computes from replicated inputs: the same
#: on every rank, so they are not summed over the ranks (every other
#: counter is the rank's part of the sum)
REPLICATED_METRICS = frozenset({"valid_points", "newborn_weight",
                                "birth_candidates", "obs_spill_overflow"})


def is_noisy(cfg: MapConfig) -> bool:
    """Whether ``cfg`` takes the noisy prediction arm (a dynamic model
    with 3-D motion); limit-xy and the static model make it noise-free."""
    return not (cfg.limit_motion_to_xy_plane or cfg.motion_model == "static")


def _particle_shape(cfg: MapConfig, n_shards: int = 1) -> tuple:
    """The shape of a particle plane, or of a slab's of ``n_shards``."""
    if cfg.layout == "compact":
        return (cfg.compact_capacity // n_shards,)
    return (cfg.slots_per_voxel, cfg.storage_voxels // n_shards)


def rank_generator(gen: torch.Generator, rank: int) -> torch.Generator:
    """A generator of ``rank``'s own draws, on ``gen``'s device, seeded from
    ``gen``'s state and ``rank`` (the counterpart of the JAX package's
    ``fold_in(key, axis_index)``): the same for the same state and rank,
    different across ranks and, as ``gen`` advances, across frames.
    Reading the state of a CUDA generator does not wait for the card."""
    h = hashlib.blake2b(gen.get_state().numpy().tobytes(), digest_size=8)
    h.update(int(rank).to_bytes(4, "little"))
    out = torch.Generator(device=gen.device)
    out.manual_seed(int.from_bytes(h.digest(), "little") >> 1)
    return out


def _draw(fn, shape, gen: torch.Generator, device, out=None):
    """``fn`` (``torch.rand`` or ``torch.randn``) float32 draws of
    ``shape`` from ``gen`` into ``out``, a new tensor on ``device`` when
    ``None``: the same numbers and the same advance of ``gen`` either
    way."""
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=device)
    return fn(shape, generator=gen, out=out)


def _sensor_draws(cfg: MapConfig, gen: torch.Generator, device,
                  out=(None,) * 4) -> tuple:
    shape = (cfg.max_input_points, cfg.newborn_particles_per_point, 3)
    fresh = _draw(torch.rand, (cfg.max_clusters,), gen, device,
                  out[0]).mul_(0.9).add_(0.1)
    noise_p = _draw(torch.randn, shape, gen, device, out[1])
    noise_v = _draw(torch.randn, shape, gen, device, out[2])
    noise_u = _draw(torch.rand, shape, gen, device, out[3]).mul_(2.0).sub_(1.0)
    return fresh, noise_p, noise_v, noise_u


def _pool_normal(cfg: MapConfig, m: int, gen: torch.Generator, device,
                 n_shards: int = 1, out=None) -> torch.Tensor:
    """``m`` standard-normal particle planes (``[m, S, V/n]`` or ``[m,
    P/n]``)."""
    return _draw(torch.randn, (m,) + _particle_shape(cfg, n_shards), gen,
                 device, out)


def make_draws(cfg: MapConfig, gen: torch.Generator, device, shard=None,
               out=None):
    """The step's random draws from ``gen``: ``(fresh_intensity [C] on
    [0.1, 1), noise_p, noise_v [P, n_b, 3] standard normal, noise_u
    [P, n_b, 3] on [-1, 1))``; a noisy-prediction configuration
    (:func:`is_noisy`) appends the standard normals ``prop_noise`` ``[3,
    S, V]`` and ``fov_noise`` ``[2, S, V]`` (``[3, P]`` and ``[2, P]`` in
    the compact layout), drawn after the other four.

    With ``shard`` (a :class:`~..ops.common.ShardCtx`) the first four are
    replicated -- drawn from ``gen``, which is the same on every rank --
    and the two pool-shaped ones are the rank's own, at the slab's shape
    (``[3, S, V/n]``, ``[2, S, V/n]``; ``[3, P/n]``, ``[2, P/n]``), drawn
    from :func:`rank_generator`.

    ``out`` is a tuple of tensors of these shapes on ``device`` (the
    graphed step's draw buffers; a rank's, with ``shard``) that the draws
    are written into and returned in, with the same numbers and the same
    advance of ``gen``."""
    out = (None,) * 6 if out is None else tuple(out)
    draws = _sensor_draws(cfg, gen, device, out[:4])
    if not is_noisy(cfg):
        return draws
    n = 1 if shard is None else shard.n_shards
    own = gen if shard is None else rank_generator(gen, shard.rank)
    prop = _pool_normal(cfg, 3, own, device, n, out[4])
    return draws + (prop, _pool_normal(cfg, 2, own, device, n, out[5]))


def make_multisensor_draws(cfg: MapConfig, n_sensors: int,
                           gen: torch.Generator, device, shard=None,
                           out=None):
    """The multi-sensor step's random draws from ``gen``, in this order:
    ``prop_noise`` (``[3, S, V]`` or ``[3, P]``; noisy configurations
    only, else ``None``), then for each sensor ``(fresh, noise_p, noise_v,
    noise_u)`` as :func:`make_draws` makes them, with ``fov_noise`` (``[2,
    S, V]`` or ``[2, P]``) appended on noisy configurations.  Returns
    ``(prop_noise, per-sensor tuples)``; every draw is made up front and a
    sensor's are used only if it is admitted, so a skipped camera never
    shifts another's draws.

    With ``shard`` (a :class:`~..ops.common.ShardCtx`) each sensor's four
    are replicated -- drawn from ``gen`` in sensor order, the same on every
    rank -- and the pool-shaped normals are the rank's own, at the slab's
    shape (``[3, S, V/n]`` and ``[2, S, V/n]``; ``[3, P/n]`` and ``[2,
    P/n]``), drawn in the same order from one :func:`rank_generator`.

    ``out`` is a structure of tensors as this returns (the graphed step's
    draw buffers; a rank's, with ``shard``) that the draws are written into
    and returned in, with the same numbers and the same advance of
    ``gen``."""
    noisy = is_noisy(cfg)
    n = 1 if shard is None else shard.n_shards
    own = gen if shard is None or not noisy else rank_generator(gen,
                                                                shard.rank)
    prop_out, sensor_out = ((None, ((None,) * 5,) * n_sensors) if out is None
                            else out)
    prop = _pool_normal(cfg, 3, own, device, n, prop_out) if noisy else None
    return prop, tuple(
        _sensor_draws(cfg, gen, device, tuple(o[:4]))
        + ((_pool_normal(cfg, 2, own, device, n, o[4]),) if noisy else ())
        for o in sensor_out)


def _on_device(draws, dev) -> tuple:
    return tuple(d.to(dev) if isinstance(d, torch.Tensor)
                 else to_device(d, torch.float32, dev) for d in draws)


def _map_draws(fn, draws):
    """``fn`` of each draw in a nest of tuples of draws (``None`` kept)."""
    if draws is None:
        return None
    if isinstance(draws, (tuple, list)):
        return tuple(_map_draws(fn, d) for d in draws)
    return fn(draws)


def _pose_check(state: MapState, sensor_pos, ts):
    """``(dt, jump_ok)``: the frame's time step from the state's host copy
    of the last timestamp, and whether the pose jump and the time step
    pass admission control (``dsp_dynamic.h:193-208``)."""
    last_pos = state.last_sensor_pos if state.initialized else sensor_pos
    last_t = state.last_timestamp if state.initialized else ts
    dt = np.float32(ts - np.float32(last_t))
    delta = sensor_pos - np.asarray(last_pos, np.float32)
    return dt, bool(np.all(np.abs(delta) <= np.float32(10.0))
                    and dt >= 0.0 and dt <= 10.0)


def _clamp_velocities(p, cfg: MapConfig):
    """The deterministic arms' velocity clamp (vz = 0 under limit-xy, v = 0
    in the static model) holds at every write site, so the clamped planes
    are zeros; the noisy arm has no clamp."""
    if cfg.motion_model == "static":
        z = torch.zeros_like(p.vx)
        return dataclasses.replace(p, vx=z, vy=z, vz=z)
    if cfg.limit_motion_to_xy_plane:
        return dataclasses.replace(p, vz=torch.zeros_like(p.vz))
    return p


def _observe(frame_points, n_points, sensor_pos, quat, cfg: MapConfig, rt,
             dev):
    """Ingest (``dsp_dynamic.h:234-293``): ``(obs, expected_newborn)``.
    The frame's values are the frame block's tensors (the points buffer,
    ``n_points``, ``sensor_pos``, ``quat``, ``rt``'s fields) or host
    values."""
    points = frame_tensor(frame_points, torch.float32, dev)
    if not isinstance(n_points, torch.Tensor):
        n_points = int(n_points)
    point_valid = torch.arange(points.shape[0], device=dev) < n_points
    obs = project_points(points, point_valid, sensor_pos, quat, cfg)
    expected_newborn = (rt.newborn_particle_weight
                        * obs.n_valid_points.to(torch.float32)
                        * cfg.newborn_particles_per_point)
    return obs, expected_newborn


class Prologue(NamedTuple):
    """The host half of a step: admission and the frame's host values."""

    accepted: bool
    dt: np.float32
    timestamp: np.float32
    sensor_pos: np.ndarray  # f32 [3]
    quat: np.ndarray  # f32 [4]
    origin: np.ndarray  # i32 [3]
    update_time: np.float32

    def blocks(self, cfg: MapConfig, state: MapState, n_points) -> tuple:
        """The frame's host blocks (``scalars.py``)."""
        return scalars.host_blocks(
            cfg, dt=self.dt, update_time=self.update_time,
            sensor_pos=self.sensor_pos, quat=self.quat, params=state.params,
            origin=self.origin, n_points=n_points)

    def advance(self, state: MapState, **tensors) -> MapState:
        """``state`` after an accepted frame: its tensors replaced by
        ``tensors`` and its host copies of pose and time by the frame's."""
        return dataclasses.replace(
            state, sensor_pos=self.sensor_pos,
            last_sensor_pos=self.sensor_pos.copy(), origin=self.origin,
            update_time=self.update_time, last_timestamp=self.timestamp,
            update_counter=state.update_counter + 1, initialized=True,
            **tensors)


def prologue(state: MapState, frame: Frame, cfg: MapConfig) -> Prologue:
    """The host prologue of :func:`make_step`'s step: admission control
    from the frame's pose and the state's host copies, the window origin,
    the time step and the update time, in numpy float32."""
    sensor_pos = np.asarray(frame.sensor_pos, np.float32)
    quat = np.asarray(frame.quat, np.float32)
    ts = np.float32(frame.timestamp)
    dt, jump_ok = _pose_check(state, sensor_pos, ts)
    accepted = bool(geometry.quaternion_is_valid_np(quat) and jump_ok)
    return Prologue(accepted, dt, ts, sensor_pos, quat,
                    geometry.window_origin_np(sensor_pos, cfg),
                    np.float32(np.float32(state.update_time) + dt))


class BodyOut(NamedTuple):
    """What the device body returns: the state's new tensors and the
    step's outputs."""

    particles: object  # Particles
    weight_sum: torch.Tensor
    vel_avg: torch.Tensor
    future: torch.Tensor
    estimator: EstimatorState
    metrics: dict
    cloud: tuple


def make_body(cfg: MapConfig, with_metrics: bool = True, shard=None):
    """The device body of :func:`make_step`'s step: ``body(particles,
    future, estimator, fs, points, draws) -> BodyOut`` with ``fs`` the
    frame's :class:`~.scalars.FrameScalars`, ``points`` its ``[P, 3]``
    buffer and ``draws`` :func:`make_draws`' tensors on the device.  It
    takes only tensors, reads no device value on the host and modifies none
    of its inputs."""
    compact = cfg.layout == "compact"
    lo = 0 if shard is None else shard.lo
    noisy = is_noisy(cfg)

    def body(particles, future_in, estimator, fs, points, draws) -> BodyOut:
        dev = points.device
        fresh, noise_p, noise_v, noise_u, *noise = draws
        prop_noise, fov_noise = noise if noisy else (None, None)
        rt = fs.params
        sensor_pos, R, origin = fs.sensor_pos, fs.R, fs.origin
        update_time = fs.update_time

        obs, expected_newborn = _observe(points, fs.n_points, sensor_pos,
                                         fs.quat, cfg, rt, dev)

        # -- velocity estimation (dsp_dynamic.h:297,1377) ---------------
        est_out, est_state = estimate_velocities(
            obs.cloud_world, obs.cloud_valid, estimator, cfg, fs.dt, fresh)

        # -- prediction + rebin + FOV (dsp_dynamic.h:300,627-701,
        # 1232-1271) -----------------------------------------------------
        p = _clamp_velocities(particles, cfg)
        future_movers = None
        if compact:
            p, sw = sweep_compact(p, cfg, fs.dt, origin, sensor_pos, R=R,
                                  noise=prop_noise, rt=rt)
            if shard is None:
                p, _, rebin_stats = rebin_compact(p, sw, cfg, with_metrics)
                pyr, fov_mask = sw.pyr, sw.fov
            else:
                # arrivals changed the slab's rows: the FOV geometry is
                # taken anew
                p, rebin_stats = rebin_exchange_compact(p, sw, cfg, shard,
                                                        with_metrics)
                pyr, fov_mask = fov_geometry_compact(p, cfg, sensor_pos,
                                                     R=R)
            p, fovbin, fov_stats = register_fov_compact(
                p, cfg, pyr, fov_mask, sensor_pos, fov_noise, rt,
                with_metrics)
            fov_stats.update(rebin_stats)
        elif noisy:
            # no flat mid-frame phase here, as in the JAX package: the
            # planes stay [S, V] through birth
            p = propagate(p, cfg, prop_noise, fs.dt, rt)
            p, rebin_stats = rebin(p, cfg, origin, update_time, shard,
                                   with_metrics)
            p, fovbin, fov_stats = register_fov(
                p, cfg, sensor_pos, noise=fov_noise, rt=rt,
                with_metrics=with_metrics, R=R)
            fov_stats.update(rebin_stats)
        else:
            sw = sweep(p, cfg, fs.dt, origin, sensor_pos, cell_base=lo,
                       origin_mod=fs.origin_mod, R=R)
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
                p, cfg, sw, sensor_pos, update_time, shard, with_metrics)

        # -- measurement update (dsp_dynamic.h:304,704-793) -------------
        p, norm_coeff, upd_stats = measurement_update(
            p, fovbin, obs, cfg, expected_newborn, update_time, rt, shard,
            with_metrics)

        # -- particle birth (dsp_dynamic.h:315,796-921) -----------------
        birth = particle_birth_compact if compact else particle_birth
        p, birth_stats = birth(
            p, cfg, (noise_p, noise_v, noise_u),
            est_points=est_out.points, est_vel=est_out.vel,
            est_dynamic=est_out.dynamic, est_valid=est_out.valid,
            norm_coeff=norm_coeff, origin=origin, update_time=update_time,
            rt=rt, shard=shard, with_metrics=with_metrics)

        # -- occupancy + future + resample (dsp_dynamic.h:322,924) ------
        if compact:
            p, weight_sum, vel_avg, future, occ_stats = occupancy_compact(
                p, cfg, origin, future_in, shard, with_metrics)
        else:
            p, weight_sum, vel_avg, future, occ_stats = occupancy_and_resample(
                p, cfg, origin, future_in, future_movers, shard,
                with_metrics)

        if with_metrics:
            metrics = {"valid_points": obs.n_valid_points, **fov_stats,
                       **upd_stats, **birth_stats, **occ_stats}
            if compact:
                metrics["pool_overflow"] = (birth_stats["pool_overflow"]
                                            + occ_stats["pool_overflow"])
        else:
            metrics = occ_stats  # {"alive"} alone
        if shard is not None:
            metrics = _sum_counters(metrics, shard)
        cloud = (est_out.points, est_out.vel, est_out.dynamic, est_out.valid)
        return BodyOut(p, weight_sum, vel_avg, future, est_state, metrics,
                       cloud)

    return body


def make_step(cfg: MapConfig, with_metrics: bool = True,
              admission_control: bool = True, shard=None):
    """Build ``step(state, frame, draws=None) -> (state, StepOutput)``.

    Noisy prediction (:func:`is_noisy`) takes ``propagate`` -> ``rebin``
    -> ``register_fov`` on ``[S, V]`` planes where the deterministic arms
    take the fused sweep and the flat mid-frame phase.

    ``draws`` (see :func:`make_draws`) injects the step's random numbers;
    ``None`` draws them from ``state.gen``.  The device is the state's
    device and every tensor the step creates is created there.  The step
    does not modify its input state's tensors: the returned state holds
    new ones.

    ``with_metrics=False`` returns the metrics ``{"alive": ...}`` only,
    and the stages skip the reductions that only the other counters read
    (the JAX step leaves the same to its compiler).
    ``admission_control=False`` runs the frame whatever its pose and time
    step; ``StepOutput.accepted`` still says whether admission control
    would have taken it.

    ``shard`` (a :class:`~..ops.common.ShardCtx`) builds one rank's step of
    the sharded step (``parallel.make_shardmap_step`` builds it for a
    mesh): the state is the rank's slab (``parallel.shard_state``), the
    frame is the same on every rank, and the cross-slab work runs as
    collectives over the ranks -- the sum of the C(z) partials, the mover
    and future-mover exchanges, the sum of birth's classification, and one
    sum of the counters (all but :data:`REPLICATED_METRICS`).  On a noisy
    configuration each rank draws its own pool-shaped noise
    (:func:`make_draws`).
    """
    cfg.validate()
    if shard is not None and not isinstance(shard, ShardCtx):
        raise TypeError(
            f"shard must be a ShardCtx, got {type(shard).__name__}")
    body = make_body(cfg, with_metrics, shard)
    layout = scalars.layout(cfg)

    def step(state: MapState, frame: Frame, draws=None):
        dev = state.device
        pro = prologue(state, frame, cfg)
        if admission_control and not pro.accepted:
            return state, _rejected(state, cfg, with_metrics)
        if draws is None:
            draws = make_draws(cfg, state.gen, dev, shard)
        draws = _on_device(draws, dev)
        f, i, points = scalars.stage(
            layout, *pro.blocks(cfg, state, frame.n_points),
            frame.points, dev)
        out = body(state.particles, state.future, state.estimator,
                   scalars.FrameScalars(f[0], i[0]), points[0], draws)
        new_state = pro.advance(
            state, particles=out.particles, weight_sum=out.weight_sum,
            vel_avg=out.vel_avg, future=out.future, estimator=out.estimator)
        return new_state, StepOutput(pro.accepted, out.weight_sum,
                                     out.metrics, out.cloud)

    return step


def _sum_counters(metrics: dict, shard: ShardCtx) -> dict:
    """Every counter but :data:`REPLICATED_METRICS` summed over the ranks,
    in one collective (the counters ride one int64 vector)."""
    names = [k for k in metrics if k not in REPLICATED_METRICS]
    total = shard.psum(torch.stack([metrics[k].to(torch.int64)
                                    for k in names]))
    return {**metrics, **{k: v.to(metrics[k].dtype)
                          for k, v in zip(names, total.unbind(0))}}


def stack_frames(frames) -> Frame:
    """One multi-sensor frame from one :class:`Frame` per sensor: every
    field with a leading ``[n_sensors]`` axis."""
    return Frame(
        points=np.stack([np.asarray(f.points, np.float32) for f in frames]),
        n_points=np.asarray([int(f.n_points) for f in frames], np.int32),
        sensor_pos=np.stack([np.asarray(f.sensor_pos, np.float32)
                             for f in frames]),
        quat=np.stack([np.asarray(f.quat, np.float32) for f in frames]),
        timestamp=np.asarray([f.timestamp for f in frames], np.float32))


def init_multisensor_state(cfg: MapConfig, n_sensors: int, seed: int = 0,
                           sensor_pos=(0.0, 0.0, 0.0), device=None) -> MapState:
    """A state for :func:`make_multisensor_step`: :func:`~dspmap_tpu_torch.
    state.init_state`'s, on ``device`` (``None``: the CUDA card; raises
    without one), with a leading ``[n_sensors]`` axis on every estimator
    tensor (one velocity-estimator track per sensor)."""
    state = init_state(cfg, seed, sensor_pos, device=device)
    est = state.estimator
    return dataclasses.replace(state, estimator=EstimatorState(**{
        f.name: getattr(est, f.name).expand(
            (n_sensors,) + tuple(getattr(est, f.name).shape)).clone()
        for f in dataclasses.fields(EstimatorState)}))


def _sensor_estimator(est: EstimatorState, i: int) -> EstimatorState:
    return EstimatorState(**{f.name: getattr(est, f.name)[i]
                             for f in dataclasses.fields(EstimatorState)})


class MultisensorPrologue(NamedTuple):
    """The host half of a multi-sensor step: the frame's admission and
    values (:class:`Prologue` of camera 0's pose and time), the cameras
    admitted, and one block pair a camera, stacked (``None`` on a rejected
    frame)."""

    frame: Prologue
    admitted: tuple  # bool, one a camera
    f: np.ndarray | None  # f32 [n_sensors, N_F]
    i: np.ndarray | None  # i32 [n_sensors, N_I]

    @property
    def accepted(self) -> bool:
        return self.frame.accepted

    def advance(self, state: MapState, **tensors) -> MapState:
        """:meth:`Prologue.advance`: camera 0's pose and the frame's time."""
        return self.frame.advance(state, **tensors)


def multisensor_prologue(state: MapState, frames: Frame, cfg: MapConfig,
                         n_sensors: int) -> MultisensorPrologue:
    """The host prologue of :func:`make_multisensor_step`'s step.  The
    frame is rejected on camera 0's pose jump or time step, or when no
    camera has a valid quaternion; a camera with an invalid quaternion is
    left out of ``admitted`` alone.  Every camera shares camera 0's
    timestamp, time step, window origin and update time; its block pair
    carries its own pose and point count."""
    quats = np.asarray(frames.quat, np.float32)
    poses = np.asarray(frames.sensor_pos, np.float32)
    if quats.shape[0] != n_sensors:
        raise ValueError(f"{quats.shape[0]} sensor frames for a step of "
                         f"{n_sensors} sensors")
    admitted = tuple(bool(geometry.quaternion_is_valid_np(q)) for q in quats)
    ts = np.float32(np.asarray(frames.timestamp, np.float32)[0])
    dt, jump_ok = _pose_check(state, poses[0], ts)
    pro = Prologue(any(admitted) and jump_ok, dt, ts, poses[0].copy(),
                   quats[0], geometry.window_origin_np(poses[0], cfg),
                   np.float32(np.float32(state.update_time) + dt))
    if not pro.accepted:
        return MultisensorPrologue(pro, admitted, None, None)
    n_points = np.asarray(frames.n_points)
    blocks = [scalars.host_blocks(
        cfg, dt=dt, update_time=pro.update_time, sensor_pos=poses[k],
        quat=quats[k], params=state.params, origin=pro.origin,
        n_points=n_points[k]) for k in range(n_sensors)]
    return MultisensorPrologue(pro, admitted,
                               np.stack([b[0] for b in blocks]),
                               np.stack([b[1] for b in blocks]))


def make_multisensor_body(cfg: MapConfig, n_sensors: int, admitted,
                          shard=None):
    """The device body of :func:`make_multisensor_step`'s step for one
    pattern of admitted cameras (``admitted``, a bool a camera, static to
    the body as a ``static_argnames`` is to ``jit``): ``body(particles,
    future, estimator, fs, points, draws) -> BodyOut`` with ``estimator``
    the ``[n_sensors]``-stacked tracks, ``fs`` the stacked
    :class:`~.scalars.FrameScalars` (``[n_sensors, N_F]``, ``[n_sensors,
    N_I]``), ``points`` ``[n_sensors, P, 3]`` and ``draws``
    :func:`make_multisensor_draws`' tensors on the device.  It takes only
    tensors, reads no device value on the host and modifies none of its
    inputs; its metrics are the occupancy stage's and its cloud ``()``.

    The stages are looked up in this module when the body runs, so a
    caller that replaces one here (a teacher-forced check) reaches it.
    The per-camera stages skip the counters the step discards
    (``with_metrics=False``); the mover exchange and occupancy keep
    theirs."""
    compact = cfg.layout == "compact"
    admitted = tuple(bool(a) for a in admitted)
    if len(admitted) != n_sensors or not any(admitted):
        raise ValueError(f"admitted {admitted} for {n_sensors} sensors: one "
                         "flag a sensor, at least one set")

    def body(particles, future_in, estimator, fs, points, draws) -> BodyOut:
        dev = points.device
        prop_noise, sensor_draws = draws
        fss = [scalars.FrameScalars(fs.f[k], fs.i[k])
               for k in range(n_sensors)]
        fs0 = fss[0]
        rt = fs0.params

        p = particles
        if compact:
            p, sw = sweep_compact(_clamp_velocities(p, cfg), cfg, fs0.dt,
                                  fs0.origin, fs0.sensor_pos, R=fs0.R,
                                  noise=prop_noise, rt=rt)
            if shard is None:
                p, _, _ = rebin_compact(p, sw, cfg)
            else:
                p, _ = rebin_exchange_compact(p, sw, cfg, shard)
        else:
            p = propagate(p, cfg, prop_noise, fs0.dt, rt)
            p, _ = rebin(p, cfg, fs0.origin, fs0.update_time, shard)

        tracks = []
        for i in range(n_sensors):
            est = _sensor_estimator(estimator, i)
            if not admitted[i]:  # skipped: its measurement stage is the identity
                tracks.append(est)
                continue
            fs = fss[i]
            fresh, noise_p, noise_v, noise_u, *fov_noise = sensor_draws[i]
            fov_noise = fov_noise[0] if fov_noise else None
            obs, expected_newborn = _observe(
                points[i], fs.n_points, fs.sensor_pos, fs.quat, cfg, rt, dev)
            est_out, est = estimate_velocities(
                obs.cloud_world, obs.cloud_valid, est, cfg, fs.dt, fresh)
            tracks.append(est)
            if compact:
                pyr, fov_mask = fov_geometry_compact(p, cfg, fs.sensor_pos,
                                                     R=fs.R)
                p, fovbin, _ = register_fov_compact(
                    p, cfg, pyr, fov_mask, fs.sensor_pos, fov_noise, rt,
                    with_metrics=False)
            else:
                p, fovbin, _ = register_fov(p, cfg, fs.sensor_pos,
                                            noise=fov_noise, rt=rt,
                                            with_metrics=False, R=fs.R)
            p, norm_coeff, _ = measurement_update(
                p, fovbin, obs, cfg, expected_newborn, fs.update_time, rt,
                shard, with_metrics=False)
            birth = particle_birth_compact if compact else particle_birth
            p, _ = birth(
                p, cfg, (noise_p, noise_v, noise_u),
                est_points=est_out.points, est_vel=est_out.vel,
                est_dynamic=est_out.dynamic, est_valid=est_out.valid,
                norm_coeff=norm_coeff, origin=fs.origin,
                update_time=fs.update_time, rt=rt, shard=shard,
                with_metrics=False)

        if compact:
            p, weight_sum, vel_avg, future, occ_stats = occupancy_compact(
                p, cfg, fs0.origin, future_in, shard)
        else:
            p, weight_sum, vel_avg, future, occ_stats = occupancy_and_resample(
                p, cfg, fs0.origin, future_in, None, shard)
        if shard is not None:
            occ_stats = _sum_counters(occ_stats, shard)
        # a fresh tensor a field, a skipped camera's track (a view of the
        # input) copied too
        estimator = EstimatorState(**{
            f.name: torch.stack([getattr(e, f.name) for e in tracks])
            for f in dataclasses.fields(EstimatorState)})
        return BodyOut(p, weight_sum, vel_avg, future, estimator, occ_stats,
                       ())

    return body


def make_multisensor_step(cfg: MapConfig, n_sensors: int, shard=None):
    """Build ``step(state, frames, draws=None) -> (state, StepOutput)`` for
    one map fed by ``n_sensors`` depth cameras (mirrors the JAX package's
    ``make_multisensor_step`` and its compact form).

    Prediction and rebin run once a frame (pool: ``propagate`` ->
    ``rebin``; compact: ``sweep_compact`` -> ``rebin_compact``); then for
    each sensor in turn ingest, the velocity estimator (its own track:
    the state's estimator tensors carry a leading ``[n_sensors]`` axis, see
    :func:`init_multisensor_state`), FOV registration, the measurement
    update and birth, each sensor updating the weights the previous one
    left (the sequential multi-sensor PHD composition); then one occupancy
    pass.  ``frames`` is a :class:`Frame` whose fields carry a leading
    ``[n_sensors]`` axis (:func:`stack_frames`); all sensors share sensor
    0's timestamp.

    The step is :func:`multisensor_prologue` on the host, the frame staged
    in one copy, then :func:`make_multisensor_body`'s body for the admitted
    pattern.  Admission has two levels, decided on the host: the frame is
    rejected (the state returned unchanged) on sensor 0's pose jump or
    time step, or when no sensor has a valid quaternion; a sensor with an
    invalid quaternion is skipped alone.  ``draws`` (see
    :func:`make_multisensor_draws`) injects the random numbers; ``None``
    draws them from ``state.gen``, every sensor's whether it is admitted
    or not.  The metrics are the occupancy stage's and ``estimator_cloud``
    is ``()``.

    ``shard`` (a :class:`~..ops.common.ShardCtx`) builds one rank's step of
    the sharded multi-sensor step (``parallel.make_shardmap_step(...,
    n_sensors=)``), as :func:`make_step`'s ``shard`` does: the state is the
    rank's slab with the estimator tensors replicated, the frames are the
    same on every rank, and so is every admission decision, taken on the
    host from them.  A frame makes one mover exchange (``rebin``; compact:
    ``rebin_exchange_compact``), then for each admitted sensor the sum of
    the C(z) partials and of birth's classification, then the occupancy
    stage's future-mover exchange and one sum of the counters.  FOV
    registration works on the slab's own slots, the estimator and the
    birth table on the replicated frames.  Pool-shaped noise is each
    rank's own (:func:`make_multisensor_draws`)."""
    cfg.validate()
    if shard is not None and not isinstance(shard, ShardCtx):
        raise TypeError(
            f"shard must be a ShardCtx, got {type(shard).__name__}")
    layout = scalars.layout(cfg, n_sensors)

    def step(state: MapState, frames: Frame, draws=None):
        dev = state.device
        pro = multisensor_prologue(state, frames, cfg, n_sensors)
        if not pro.accepted:
            return state, _rejected_multisensor(state, cfg)
        if draws is None:
            draws = make_multisensor_draws(cfg, n_sensors, state.gen, dev,
                                           shard)
        draws = _map_draws(lambda d: _on_device((d,), dev)[0], draws)
        f, i, points = scalars.stage(layout, pro.f, pro.i, frames.points,
                                     dev)
        body = make_multisensor_body(cfg, n_sensors, pro.admitted, shard)
        out = body(state.particles, state.future, state.estimator,
                   scalars.FrameScalars(f, i), points, draws)
        new_state = pro.advance(
            state, particles=out.particles, weight_sum=out.weight_sum,
            vel_avg=out.vel_avg, future=out.future, estimator=out.estimator)
        return new_state, StepOutput(True, out.weight_sum, out.metrics, ())

    return step


def _rejected_multisensor(state: MapState, cfg: MapConfig) -> StepOutput:
    names = MULTISENSOR_METRIC_NAMES + (
        ("pool_overflow",) if cfg.layout == "compact" else ())
    return StepOutput(False, state.weight_sum, {
        k: torch.zeros((), dtype=torch.int64, device=state.device)
        for k in names}, ())


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
