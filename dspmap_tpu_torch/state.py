"""Map state as plain dataclasses of tensors (mirrors ``dspmap_tpu/state.py``).

Layout is the JAX package's at every public function: slot planes
``[S, V]`` (S = slots per voxel, V = storage voxels) in the pool layout,
1-D planes ``[P = cfg.compact_capacity]`` in the compact layout, flags int32 with
0 dead / 1 valid / 3 newborn, f32 values, and a horizon-major future grid
``[T, V]``.

Between the sweep and the occupancy stage the step keeps the pool planes
in their flat ``[S*V]`` form (:func:`flatten_pool` / :func:`unflatten_pool`,
as the JAX package does).  A flat plane is ``.reshape(-1)`` of the
``[S, V]`` tensor, except for planes of :data:`_DMA_RELAYOUT_BYTES` or more:
those are copied by the relayout kernels (``ops/relayout.py``) into a
working buffer that the step owns and may scatter into in place.

Every entry point that builds a state builds it on the CUDA card unless the
caller names another device.

The JAX ``rng`` key has no counterpart: the step draws its noise from a
``torch.Generator`` held in :attr:`MapState.gen` (seeded in
:func:`init_state`), or takes injected draws (see
``models.pipeline.make_step``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import MapConfig
from .ops import relayout

FLAG_DEAD = 0
FLAG_VALID = 1
FLAG_NEWBORN = 3

_PLANES = ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card and
    raises when there is none (nothing carries on on the CPU unasked)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the map state is built on the card by default; "
            "pass device='cpu' to build it on the CPU")
    return torch.device("cuda")


def _to(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    })


@dataclasses.dataclass
class Particles:
    """SoA particle store, every field ``[S, V]`` (pool layout) or ``[P]``
    (compact layout); flags int32, the rest f32."""

    flags: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    weight: torch.Tensor
    t: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        return self.flags != FLAG_DEAD

    @property
    def newborn(self) -> torch.Tensor:
        return self.flags == FLAG_NEWBORN

    def to(self, device) -> "Particles":
        return _to(self, device)

    def clone(self) -> "Particles":
        return dataclasses.replace(
            self, **{n: getattr(self, n).clone() for n in _PLANES})


@dataclasses.dataclass
class RuntimeParams:
    """The live-settable filter scalars (``dsp_dynamic.h:355-382``) as host
    floats: they scale math and never sizes."""

    sigma_ob: float
    position_noise_std: float
    velocity_noise_std: float
    p_detection: float
    kappa: float
    newborn_particle_weight: float

    @staticmethod
    def from_config(cfg: MapConfig) -> "RuntimeParams":
        return RuntimeParams(
            sigma_ob=float(np.float32(cfg.sigma_ob)),
            position_noise_std=float(np.float32(cfg.position_noise_std)),
            velocity_noise_std=float(np.float32(cfg.velocity_noise_std)),
            p_detection=float(np.float32(cfg.p_detection)),
            kappa=float(np.float32(cfg.kappa)),
            newborn_particle_weight=float(
                np.float32(cfg.newborn_particle_weight)),
        )


@dataclasses.dataclass
class EstimatorState:
    """Previous-frame dynamic-cluster features (``dsp_dynamic.h:1401,1542``)."""

    prev_centers: torch.Tensor  # f32 [C, 3]
    prev_point_num: torch.Tensor  # i32 [C]
    prev_intensity: torch.Tensor  # f32 [C]
    prev_valid: torch.Tensor  # bool [C]

    def to(self, device) -> "EstimatorState":
        return _to(self, device)


@dataclasses.dataclass
class MapState:
    """Complete filter state threaded through ``make_step``'s step.

    ``sensor_pos``/``last_sensor_pos``/``origin``/``update_time``/
    ``last_timestamp``/``update_counter``/``initialized`` are host values
    (numpy or Python scalars): admission control and the window origin are
    decided on the host from frame inputs, so the step needs no device
    sync for them.
    """

    particles: Particles
    weight_sum: torch.Tensor  # f32 [V]
    vel_avg: torch.Tensor  # f32 [V, 3]
    future: torch.Tensor  # f32 [T, V]
    gen: torch.Generator
    sensor_pos: np.ndarray  # f32 [3]
    last_sensor_pos: np.ndarray  # f32 [3]
    origin: np.ndarray  # i32 [3]
    update_time: np.float32
    last_timestamp: np.float32
    update_counter: int
    initialized: bool
    estimator: EstimatorState
    params: RuntimeParams

    @property
    def device(self) -> torch.device:
        return self.weight_sum.device

    def to(self, device) -> "MapState":
        """Copy to ``device``; the generator is re-seeded there from a draw
        of the current one (a generator cannot move between devices)."""
        device = torch.device(device)
        seed = int(torch.randint(0, 2**62, (1,), generator=self.gen,
                                 device=self.gen.device).item())
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return dataclasses.replace(
            self,
            particles=self.particles.to(device),
            weight_sum=self.weight_sum.to(device),
            vel_avg=self.vel_avg.to(device),
            future=self.future.to(device),
            gen=gen,
            estimator=self.estimator.to(device),
        )


#: planes of this many bytes or more (with ``V % 1024 == 0``) change form
#: through the relayout kernels (the JAX package's line, ``state.py:88``)
_DMA_RELAYOUT_BYTES = 16 << 20


def _takes_relayout(x: torch.Tensor, width: int) -> bool:
    """Whether a pool plane of ``width`` voxels changes form by a copy."""
    return (x.numel() * x.element_size() >= _DMA_RELAYOUT_BYTES
            and width % 1024 == 0)


def ravel_plane(x: torch.Tensor) -> torch.Tensor:
    """``[S, V]`` -> ``[S*V]``.  A large plane is copied by
    :func:`~dspmap_tpu_torch.ops.relayout.to_flat` (kernel K5a on a CUDA
    tensor) into a flat working buffer of the step; any other plane is a
    view of ``x``."""
    if x.dim() == 2 and _takes_relayout(x, x.shape[1]):
        return relayout.to_flat(x)
    return x.reshape(-1)


def unravel_plane(x: torch.Tensor, slots: int) -> torch.Tensor:
    """``[S*V]`` -> ``[S, V]`` (inverse of :func:`ravel_plane`): a fresh
    exact-size plane from
    :func:`~dspmap_tpu_torch.ops.relayout.from_flat` (kernel K5b on a CUDA
    tensor) for a large plane, a view otherwise."""
    v = x.shape[0] // slots
    if _takes_relayout(x, v):
        return relayout.from_flat(x, slots, v)
    return x.reshape(slots, v)


def flatten_pool(p: Particles, skip: tuple = ()) -> Particles:
    """Ravel every pool plane to its flat ``[S*V]`` form: the mid-frame
    representation of the scatter-heavy stages (mover insertion ->
    measurement writeback -> birth insertion).  The large planes (see
    :func:`ravel_plane`) are copied together, by one call of
    :func:`~dspmap_tpu_torch.ops.relayout.to_flat_many`.

    ``skip`` names planes left in their 2-D form: planes that nothing
    touches during the flat phase (the ``t`` plane when
    ``record_particle_time`` is off).  ``flags`` can never be skipped
    (:func:`unflatten_pool` keys off it)."""
    names = {f.name for f in dataclasses.fields(p)}
    if not (isinstance(skip, (tuple, frozenset, set))
            and set(skip) <= names - {"flags"}):
        raise ValueError(
            f"flatten_pool skip must be a tuple/set of pool field names "
            f"excluding 'flags'; got {skip!r}")
    todo = [n for n in _PLANES if n not in skip]
    big = [n for n in todo if getattr(p, n).dim() == 2
           and _takes_relayout(getattr(p, n), getattr(p, n).shape[1])]
    flat = {n: getattr(p, n).reshape(-1) for n in todo if n not in big}
    if big:
        flat.update(zip(big, relayout.to_flat_many(
            [getattr(p, n) for n in big])))
    return dataclasses.replace(p, **flat)


def unflatten_pool(p: Particles, slots: int, views: tuple = ()) -> Particles:
    """Restore ``[S, V]`` planes from the flat mid-frame form (a no-op on
    planes already 2-D, such as those :func:`flatten_pool` skipped).  The
    large planes become fresh planes of the exact size, by one call of
    :func:`~dspmap_tpu_torch.ops.relayout.from_flat_many`.

    ``views`` names planes to restore as views whatever their size: planes
    that the caller only reads and then drops (the occupancy pool pass reads
    each of its inputs once and writes fresh outputs)."""
    if p.flags.dim() == 2:
        return p
    todo = [n for n in _PLANES if getattr(p, n).dim() == 1]
    v = p.flags.shape[0] // slots
    big = [n for n in todo if n not in views
           and _takes_relayout(getattr(p, n), v)]
    planes = {n: getattr(p, n).view(slots, v) for n in todo if n not in big}
    if big:
        planes.update(zip(big, relayout.from_flat_many(
            [getattr(p, n) for n in big], slots, v)))
    return dataclasses.replace(p, **planes)


def init_estimator_state(cfg: MapConfig, device=None) -> EstimatorState:
    device = resolve_device(device)
    c = cfg.max_clusters
    return EstimatorState(
        prev_centers=torch.zeros((c, 3), dtype=torch.float32, device=device),
        prev_point_num=torch.zeros((c,), dtype=torch.int32, device=device),
        prev_intensity=torch.zeros((c,), dtype=torch.float32, device=device),
        prev_valid=torch.zeros((c,), dtype=torch.bool, device=device),
    )


def init_state(cfg: MapConfig, seed: int = 0, sensor_pos=(0.0, 0.0, 0.0),
               init_particle_num: int = 0, init_weight: float = 0.01,
               device=None) -> MapState:
    """Fresh map centered at ``sensor_pos`` on ``device`` (``None``: the
    CUDA card; raises without one): particle planes ``[S, V]`` in the pool
    layout, ``[P]`` in the compact layout, empty unless
    ``init_particle_num`` uniform particles of weight ``init_weight`` are
    scattered over the window (:func:`add_random_particles`).

    ``seed`` seeds the step's ``torch.Generator``."""
    device = resolve_device(device)
    v = cfg.storage_voxels
    shape = ((cfg.compact_capacity,) if cfg.layout == "compact"
             else (cfg.slots_per_voxel, v))
    sensor_np = np.asarray(sensor_pos, np.float32)
    half = np.asarray(cfg.half_extent, np.float32)
    origin_np = np.floor(
        (sensor_np - half) / np.float32(cfg.voxel_resolution) + np.float32(0.5)
    ).astype(np.int32)

    def zeros(dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    particles = Particles(
        flags=zeros(torch.int32), px=zeros(), py=zeros(), pz=zeros(),
        vx=zeros(), vy=zeros(), vz=zeros(), weight=zeros(), t=zeros(),
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    state = MapState(
        particles=particles,
        weight_sum=torch.zeros((v,), dtype=torch.float32, device=device),
        vel_avg=torch.zeros((v, 3), dtype=torch.float32, device=device),
        future=torch.zeros((cfg.n_horizons, v), dtype=torch.float32,
                           device=device),
        gen=gen,
        sensor_pos=sensor_np,
        last_sensor_pos=sensor_np.copy(),
        origin=origin_np,
        update_time=np.float32(0.0),
        last_timestamp=np.float32(0.0),
        update_counter=0,
        initialized=False,
        estimator=init_estimator_state(cfg, device),
        params=RuntimeParams.from_config(cfg),
    )
    if init_particle_num > 0:
        state = add_random_particles(state, cfg, init_particle_num,
                                     init_weight)
    return state


def add_random_particles(state: MapState, cfg: MapConfig, num: int,
                         avg_weight: float, draws=None) -> MapState:
    """Scatter ``num`` particles of weight ``avg_weight`` uniformly over the
    window around ``state.sensor_pos`` (``addRandomParticles``,
    ``dsp_dynamic.h:594-624``); a voxel keeps those that fit its free slots
    in arrival order and drops the rest.

    ``draws = (pos [num, 3], vel [num, 3])``, uniform on [-1, 1), injects
    the random numbers (positions in units of the window's half extent);
    ``None`` draws them from ``state.gen``.  Velocities obey the
    configuration's clamp (v = 0 in the static model, vz = 0 under
    limit-xy), the one write site where an unclamped velocity could enter
    the pool."""
    from .ops.common import to_device
    from .ops.compact import _scatter_add_cols, insert_compact
    from .ops.insert import insert_particles

    dev = state.device
    if draws is None:
        kw = dict(generator=state.gen, device=dev, dtype=torch.float32)
        draws = (torch.rand((num, 3), **kw) * 2.0 - 1.0,
                 torch.rand((num, 3), **kw) * 2.0 - 1.0)
    u_pos, vel = (d.to(dev) if isinstance(d, torch.Tensor)
                  else to_device(d, torch.float32, dev) for d in draws)
    half = to_device(np.asarray(cfg.half_extent, np.float32), torch.float32,
                     dev)
    pos = to_device(state.sensor_pos, torch.float32, dev) + u_pos * half
    if cfg.motion_model == "static":
        vel = torch.zeros_like(vel)
    elif cfg.limit_motion_to_xy_plane:
        vel = torch.cat([vel[:, :2], torch.zeros_like(vel[:, 2:])], dim=1)
    weight = torch.full((num,), float(avg_weight), dtype=torch.float32,
                        device=dev)
    valid = torch.ones((num,), dtype=torch.bool, device=dev)
    p = state.particles
    if cfg.layout == "compact":
        from . import geometry

        cell = geometry.storage_index_planar(
            *geometry.world_voxel_planar(p.px, p.py, p.pz, cfg), cfg)
        alive = p.flags != FLAG_DEAD
        (count_v,) = _scatter_add_cols(cell, alive, (alive,),
                                       cfg.storage_voxels)
        p, _, _ = insert_compact(
            p, cfg, pos=pos, vel=vel, weight=weight, valid=valid,
            origin=state.origin, flag=FLAG_VALID,
            t=state.update_time if cfg.record_particle_time else None,
            count_v=count_v)
    else:
        p = insert_particles(p, cfg, pos=pos, vel=vel, weight=weight,
                             valid=valid, origin=state.origin,
                             flag=FLAG_VALID, t=state.update_time)
    return dataclasses.replace(state, particles=p)


# -------------------------------------------------- cross-framework carriers

def state_from_numpy(tree, cfg: MapConfig, device=None, seed: int = 0):
    """Build the port's :class:`MapState` on ``device`` (``None``: the CUDA
    card; raises without one) from the JAX package's ``MapState`` after
    ``jax.device_get`` (any object with the same attribute names whose
    leaves are numpy arrays).  The JAX ``rng`` key has no counterpart; the
    port's generator is seeded from ``seed``."""
    device = resolve_device(device)

    def t(x, dtype=None):
        a = np.asarray(x)
        out = torch.from_numpy(np.array(a, copy=True)).to(device)
        return out if dtype is None else out.to(dtype)

    p = tree.particles
    particles = Particles(**{n: t(getattr(p, n)) for n in _PLANES})
    e = tree.estimator
    est = EstimatorState(
        prev_centers=t(e.prev_centers, torch.float32),
        prev_point_num=t(e.prev_point_num, torch.int32),
        prev_intensity=t(e.prev_intensity, torch.float32),
        prev_valid=t(e.prev_valid, torch.bool),
    )
    prm = tree.params
    params = RuntimeParams(**{
        f.name: float(np.asarray(getattr(prm, f.name)))
        for f in dataclasses.fields(RuntimeParams)
    })
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return MapState(
        particles=particles,
        weight_sum=t(tree.weight_sum, torch.float32),
        vel_avg=t(tree.vel_avg, torch.float32),
        future=t(tree.future, torch.float32),
        gen=gen,
        sensor_pos=np.asarray(tree.sensor_pos, np.float32).copy(),
        last_sensor_pos=np.asarray(tree.last_sensor_pos, np.float32).copy(),
        origin=np.asarray(tree.origin, np.int32).copy(),
        update_time=np.float32(np.asarray(tree.update_time)),
        last_timestamp=np.float32(np.asarray(tree.last_timestamp)),
        update_counter=int(np.asarray(tree.update_counter)),
        initialized=bool(np.asarray(tree.initialized)),
        estimator=est,
        params=params,
    )


def to_numpy(x):
    """A tensor (on any device) as a numpy array; anything else as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def state_to_numpy(state: MapState) -> dict:
    """Every array of ``state`` as numpy, in the JAX ``MapState``'s field
    names (nested dicts for ``particles``, ``estimator`` and ``params``)."""
    n = to_numpy
    return {
        "particles": {k: n(getattr(state.particles, k)) for k in _PLANES},
        "weight_sum": n(state.weight_sum),
        "vel_avg": n(state.vel_avg),
        "future": n(state.future),
        "sensor_pos": np.asarray(state.sensor_pos),
        "last_sensor_pos": np.asarray(state.last_sensor_pos),
        "origin": np.asarray(state.origin),
        "update_time": np.float32(state.update_time),
        "last_timestamp": np.float32(state.last_timestamp),
        "update_counter": np.int32(state.update_counter),
        "initialized": np.bool_(state.initialized),
        "estimator": {f.name: n(getattr(state.estimator, f.name))
                      for f in dataclasses.fields(EstimatorState)},
        "params": dataclasses.asdict(state.params),
    }
