"""Map parallelism: the voxel grid, and the particles in it, split into
contiguous slabs over the ranks of a process group (mirrors
``dspmap_tpu/parallel/sharding.py``).

Storage order is z-major (``geometry.storage_index``), so a slab is a
z-range of the grid.  Every ``[S, V]`` / ``[T, V]`` state tensor splits on
its voxel axis, every ``[V, ...]`` tensor on its first, the compact
layout's ``[P]`` rows on theirs (each rank's rows hold its slab's
particles); everything else -- the estimator, the host scalars, the
generator -- is the same on every rank (:func:`state_shardings`).

PyTorch has no SPMD partitioner, so the JAX package's GSPMD form (the
unchanged step jitted over sharded operands, bit-identical to one device)
has no counterpart: :func:`make_sharded_step` is the explicitly scheduled
step of :mod:`.shard_step` with its layout pinned, and it is held to the
``shard_map`` step's bars, not to bit-equality with one device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import MapConfig
from ..state import HOST_LEAVES, MapState, Particles, tensor_leaves


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks the map is split over: ``group`` (``None``: the default
    group), its ``size`` and this process's ``rank`` in it."""

    group: object
    size: int
    rank: int


def make_mesh(n: int | None = None, group=None) -> Mesh:
    """The mesh of ``group`` (default: every process of the default
    group).  Without a process group it is a mesh of one process, whose
    collectives are the identity.  ``n`` checks the group's size."""
    if dist.is_initialized():
        size, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        if group is not None:
            raise RuntimeError("a process group is given, but "
                               "torch.distributed is not initialized")
        size, rank = 1, 0
    if n is not None and n != size:
        raise ValueError(f"a mesh of {n} asked for, the group has {size}")
    return Mesh(group=group, size=size, rank=rank)


def _leaves(state: MapState) -> dict:
    """The state's arrays and tensors by their path in the JAX state."""
    out = tensor_leaves(state)
    out.update({name: getattr(state, name) for name in HOST_LEAVES})
    return out


def _split_axis(shape: tuple, V: int, P: int | None):
    """The JAX package's rule: ``[S, V]`` and ``[T, V]`` split on the last
    axis, ``[V, ...]`` on the first, compact ``[P]`` rows on the first;
    anything else is replicated (``None``)."""
    if len(shape) == 2 and shape[-1] == V:
        return 1
    if len(shape) >= 1 and shape[0] == V:
        return 0
    if P is not None and len(shape) == 1 and shape[0] == P:
        return 0
    return None


def state_shardings(state: MapState) -> dict:
    """Which leaves split, and on which axis: ``{path: axis or None}`` for
    every array of the state, by its path in the JAX ``MapState``
    (``"particles.flags"``, ``"weight_sum"``, ``"estimator.prev_centers"``,
    ...).  Holds for a whole state and for a slab alike."""
    V = state.weight_sum.shape[0]
    flags = state.particles.flags
    P = flags.shape[0] if flags.dim() == 1 else None
    return {k: _split_axis(tuple(getattr(x, "shape", ())), V, P)
            for k, x in _leaves(state).items()}


def _replace(state: MapState, new: dict) -> MapState:
    """``state`` with the tensors at the paths of ``new`` replaced."""
    top = {k: v for k, v in new.items() if "." not in k}

    def sub(prefix):
        return {k.split(".", 1)[1]: v for k, v in new.items()
                if k.startswith(prefix + ".")}

    return dataclasses.replace(
        state, **top,
        particles=dataclasses.replace(state.particles, **sub("particles")),
        estimator=dataclasses.replace(state.estimator, **sub("estimator")))


def shard_state(state: MapState, mesh: Mesh) -> MapState:
    """This rank's slab of a whole ``state`` (every rank passes the same
    state): each split leaf cut to its ``1/n`` on its axis, as a fresh
    contiguous tensor on the state's device; the replicated leaves and a
    copy of the generator as they are.

    In the compact layout, block ``r`` of the ``[P]`` rows must hold the
    particles of slab ``r`` (the sharded step keeps it so), as in the JAX
    package: an empty state or one from :func:`gather_state` does."""
    n, r = mesh.size, mesh.rank
    new = {}
    leaves = _leaves(state)
    for k, axis in state_shardings(state).items():
        if axis is None:
            continue
        x = leaves[k]
        if x.shape[axis] % n:
            raise ValueError(f"{k} of shape {tuple(x.shape)} does not split "
                             f"over {n} ranks")
        m = x.shape[axis] // n
        new[k] = x.narrow(axis, r * m, m).contiguous()
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(state.gen.get_state())
    return dataclasses.replace(_replace(state, new), gen=gen)


def gather_state(state: MapState, mesh: Mesh) -> MapState:
    """The whole state back from every rank's slab, on every rank (each
    split leaf ``all_gather``-ed and joined in rank order on its axis)."""
    new = {}
    leaves = _leaves(state)
    for k, axis in state_shardings(state).items():
        if axis is None:
            continue
        x = leaves[k].contiguous()
        if mesh.size == 1 and not dist.is_initialized():
            new[k] = x.clone()
            continue
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        new[k] = torch.cat(parts, dim=axis)
    return _replace(state, new)


def _slab_shapes(cfg: MapConfig, n: int, n_sensors: int | None) -> dict:
    """The shapes a slab's split leaves and its replicated estimator
    leaves must have (the latter with their leading ``[n_sensors]`` axis
    on a multi-sensor state)."""
    v = cfg.storage_voxels // n
    planes = ((cfg.compact_capacity // n,) if cfg.layout == "compact"
              else (cfg.slots_per_voxel, v))
    out = {f"particles.{f.name}": planes
           for f in dataclasses.fields(Particles)}
    out.update({"weight_sum": (v,), "vel_avg": (v, 3),
                "future": (cfg.n_horizons, v)})
    lead = () if n_sensors is None else (n_sensors,)
    c = cfg.max_clusters
    out.update({"estimator.prev_centers": lead + (c, 3),
                **{f"estimator.{k}": lead + (c,) for k in (
                    "prev_point_num", "prev_intensity", "prev_valid")}})
    return out


class _PinnedStep:
    """A rank's step with its layout pinned: every split leaf of the state
    in and out must have the slab's shape and every estimator leaf its own,
    all on the state's device.  Other attributes are the step's."""

    def __init__(self, step, want: dict):
        self._step, self._want = step, want

    def _check(self, state: MapState, where: str, dev) -> None:
        leaves = _leaves(state)
        for k, shape in self._want.items():
            x = leaves[k]
            if tuple(x.shape) != shape or x.device != dev:
                raise ValueError(f"{where}: {k} is {tuple(x.shape)} on "
                                 f"{x.device}, the slab's is {shape} on {dev}")

    def __call__(self, state: MapState, frame, draws=None):
        dev = state.device
        self._check(state, "step input", dev)
        new_state, out = self._step(state, frame, draws)
        self._check(new_state, "step output", dev)
        return new_state, out

    def __getattr__(self, name):
        return getattr(self._step, name)


def make_sharded_step(cfg: MapConfig, mesh: Mesh, with_metrics: bool = True,
                      device=None, n_sensors: int | None = None):
    """The sharded step with its layout pinned: ``step(state, frame,
    draws=None)`` takes this rank's slab and returns the next one, and
    raises unless every split leaf has the slab's shape and every
    estimator leaf its own (with the leading ``[n_sensors]`` axis of a
    multi-sensor state), all on the state's device, in and out.

    This is :func:`~.shard_step.make_shardmap_step`'s step: PyTorch has no
    partitioner to place the collectives of the unchanged step, as the JAX
    package's GSPMD form does (bit-identical to one device there); here it
    is held to the ``shard_map`` step's bars.  ``n_sensors`` builds the
    multi-sensor step over a state of ``init_multisensor_state`` -- the
    counterpart of the JAX package's ``make_sharded_step(cfg, mesh,
    step=make_multisensor_step(cfg, n), template_state=...)``, whose
    budgets (FOV buffer, spill, mover buffers) are the whole map's; here
    they are each rank's, as in the ``shard_map`` step."""
    from .shard_step import make_shardmap_step

    return _PinnedStep(
        make_shardmap_step(cfg, mesh, with_metrics, device, n_sensors),
        _slab_shapes(cfg, mesh.size, n_sensors))


def make_graphed_sharded_step(cfg: MapConfig, mesh: Mesh,
                              with_metrics: bool = True, device=None,
                              n_sensors: int | None = None):
    """:func:`make_sharded_step` as CUDA graphs, the counterpart of the JAX
    package's pinned-layout ``jax.jit(step, in_shardings=...,
    donate_argnums=0)``: :func:`~.shard_step.make_graphed_shardmap_step`'s
    graphed step with the slab checked in and out as
    :func:`make_sharded_step` checks it.  Its ``captures``,
    ``capture_ms``, ``pool_bytes`` and ``release()`` are the graphed
    step's."""
    from .shard_step import make_graphed_shardmap_step

    return _PinnedStep(
        make_graphed_shardmap_step(cfg, mesh, with_metrics, device,
                                   n_sensors),
        _slab_shapes(cfg, mesh.size, n_sensors))
