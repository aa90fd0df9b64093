"""The explicitly scheduled sharded step (mirrors
``dspmap_tpu/parallel/shard_step.py``, the JAX package's ``shard_map`` fast
path).

One process a shard, each holding a contiguous slab of the storage grid
(``parallel.shard_state``); the step body runs on the slab with every
cross-slab interaction placed by hand as a ``torch.distributed``
collective:

* ``all_reduce`` of the ``[n_pyr, (2N+1)^2 K]`` C(z) partials -- the
  measurement update's only sum over particles (``ops/update.py``);
* the exchange of the compacted mover and future-mover buffers --
  ``all_gather`` (in rank order), or with ``cfg.mover_exchange = "ring"``
  the ``cfg.ring_hops`` nearest ranks each way -- and insertion of the
  arrivals each rank owns (``ops/fov.py``, ``ops/rebin.py``,
  ``ops/compact.py``, ``ops/occupancy.py``);
* ``all_reduce`` of birth's DS classification sums; the newborn table is
  the same on every rank (replicated draws), each rank inserting only the
  newborns whose voxel it owns (``ops/birth.py``);
* one ``all_reduce`` of the metric counters (``models/pipeline.py``).

The multi-sensor step (``n_sensors``) makes one mover exchange a frame,
the update's and birth's sums once an admitted sensor, then the
occupancy stage's exchange and the counters' sum.  Frames, the estimator
(one track a sensor), the birth table and the replicated draws are the
same on every rank, and so is every admission decision, taken on the
host from the frames, so every rank makes the same collectives and every
replicated quantity comes out the same; pool-shaped noise (noisy
configurations only) is each rank's own (``models.pipeline.make_draws``,
``make_multisensor_draws``).

Deviations from the single-device step, as in the JAX package: capacities
(FOV buffer, spill, mover buffers) are per rank, so n ranks tolerate n
times the load before overflow; arrivals from other slabs land behind the
local movers in rank order, so which candidate takes the last slot of a
*contested* voxel can differ.
"""

from __future__ import annotations

import sys

import torch.distributed as dist

from ..config import MapConfig
from ..ops.common import ShardCtx, ring_transport
from ..state import resolve_device
from .sharding import Mesh, make_mesh


def shard_ctx(cfg: MapConfig, mesh: Mesh, device) -> ShardCtx:
    """This rank's :class:`~..ops.common.ShardCtx` on ``mesh``: slab
    ``rank * V/n`` onward, the ring transport chosen once for the group's
    backend and ``device`` (and printed on standard error)."""
    n = mesh.size
    V = cfg.storage_voxels
    if V % n != 0:
        raise ValueError(f"storage_voxels {V} not divisible by mesh size {n}")
    if cfg.layout == "compact" and cfg.compact_capacity % n != 0:
        raise ValueError(f"compact_capacity {cfg.compact_capacity} not "
                         f"divisible by mesh size {n}")
    transport = ring_transport(mesh.group, device)
    backend = (dist.get_backend(mesh.group) if dist.is_initialized()
               else "none")
    print(f"[shard] rank {mesh.rank} of {n}: backend {backend}, device "
          f"{device}, ring transport {transport}", file=sys.stderr,
          flush=True)
    return ShardCtx(n_shards=n, rank=mesh.rank, lo=mesh.rank * (V // n),
                    group=mesh.group, transport=transport)


def make_shardmap_step(cfg: MapConfig, mesh: Mesh | None = None,
                       with_metrics: bool = True, device=None,
                       n_sensors: int | None = None):
    """Build this rank's sharded step, ``step(state, frame, draws=None)``,
    with ``state`` this rank's slab (``shard_state``) and the frame the
    same on every rank.  Covers both layouts and both prediction arms; see
    :func:`~..models.pipeline.make_step` for the semantics and
    :func:`~..models.pipeline.make_draws` for the draws.  ``device`` is
    where the slabs live (``None``: the CUDA card; it fixes the ring
    transport).

    ``n_sensors`` builds the rank's step of the multi-sensor step instead
    (:func:`~..models.pipeline.make_multisensor_step`, ``step(state,
    frames, draws=None)``; the state from ``init_multisensor_state``, its
    estimator tensors with their leading ``[n_sensors]`` axis replicated;
    the draws of :func:`~..models.pipeline.make_multisensor_draws`).  Its
    metrics are the occupancy stage's, so it takes no ``with_metrics``."""
    from ..models.pipeline import make_multisensor_step, make_step

    mesh = mesh if mesh is not None else make_mesh()
    if n_sensors is not None and not with_metrics:
        raise ValueError("the multi-sensor step has no with_metrics option")
    shard = shard_ctx(cfg, mesh, resolve_device(device))
    if n_sensors is not None:
        return make_multisensor_step(cfg, n_sensors, shard=shard)
    return make_step(cfg, with_metrics=with_metrics, shard=shard)


def make_graphed_shardmap_step(cfg: MapConfig, mesh: Mesh | None = None,
                               with_metrics: bool = True, device=None,
                               n_sensors: int | None = None):
    """This rank's sharded step as CUDA graphs, the counterpart of the JAX
    package's ``jax.jit(shard_map(body), donate_argnums=0)``: the step of
    :func:`make_shardmap_step` (same arguments, same bits on the same frames
    and draws) with the rank's body -- its collectives included -- captured
    once and replayed, as :func:`~..models.graphed.make_graphed_step` (one
    camera) and :func:`~..models.graphed.make_graphed_multisensor_step`
    (``n_sensors``, one graph a pattern of admitted cameras) do on one
    card.  The static buffers are the slab's, and so are the draw buffers
    (a noisy configuration's pool-shaped noise drawn from the rank's own
    generator into them).

    Every rank captures a pattern at the same frame: admission is decided
    on the host from the frames, which every rank shares, so every rank's
    graph holds the same collectives in the same order.

    The collectives must run on the card's stream, which only NCCL does:
    a group of another backend (gloo runs its collectives on host threads,
    which a graph cannot hold) raises, as does a ``device`` off the card or
    a state off it; a capture that fails raises, and nothing falls back to
    the eager step.  A mesh of one process without a process group makes
    no collective and is the graphed step on the whole slab."""
    from ..models.graphed import GraphedMultisensorStep, GraphedStep

    mesh = mesh if mesh is not None else make_mesh()
    if n_sensors is not None and not with_metrics:
        raise ValueError("the multi-sensor step has no with_metrics option")
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the graphed sharded step runs on the CUDA card; "
                         f"slabs on {device} take make_shardmap_step")
    if dist.is_initialized() and dist.get_backend(mesh.group) != "nccl":
        raise ValueError(
            f"the graphed sharded step takes an NCCL group, not "
            f"{dist.get_backend(mesh.group)}: a CUDA graph holds collectives "
            "on the card's stream, and this backend runs them on host threads")
    shard = shard_ctx(cfg, mesh, device)
    if n_sensors is not None:
        return GraphedMultisensorStep(cfg, n_sensors, shard=shard,
                                      eager="make_shardmap_step")
    return GraphedStep(cfg, with_metrics, shard=shard,
                       eager="make_shardmap_step")
