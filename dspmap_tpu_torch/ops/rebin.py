"""Voxel reassignment after the noisy prediction (mirrors
``dspmap_tpu/ops/rebin.py``): move-or-vanish semantics of ``moveParticle`` /
``removeParticle`` (``dsp_dynamic.h:1206-1279, 686-690``).

Window leavers die; movers (particles whose storage cell changed) vacate
their slots, are compacted and grouped by destination in one stable sort,
and are re-inserted with the capacity-limited insertion, whose full-voxel
drops are the reference's vanish path (``dsp_dynamic.h:1227-1229``).
Movers beyond ``cfg.mover_capacity`` die and are counted.  On a slab of
the sharded step the compacted movers are exchanged across the ranks and
each rank inserts the arrivals it owns.  The fused-sweep arm of the step
does the same work in ``ops/fov.py::rebin_and_register``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MapConfig
from .. import geometry
from .common import (compact_and_group, compact_mask, pool_take,
                     sort_by_destination)
from .insert import insert_sorted

#: the payload columns a mover carries, in ``insert_sorted``'s order
PAYLOAD = ("px", "py", "pz", "vx", "vy", "vz", "weight")


def rebin(particles, cfg: MapConfig, origin, t, shard=None,
          with_metrics=True):
    """Re-home particles whose storage cell changed; kill window leavers.
    ``particles`` are ``[S, V]`` planes, ``origin`` the window origin and
    ``t`` the update time (the frame block's tensors, or host values).
    Returns ``(new_particles, stats)``; ``stats`` is empty without
    ``with_metrics``.

    ``shard`` (:class:`~.common.ShardCtx`): the planes are this rank's slab
    and mover destinations are global; the compacted movers (payload and
    destination) are exchanged (``all_gather``, or the ring of
    ``cfg.ring_hops`` neighbours) and each rank inserts, in shard-major
    order, the arrivals whose cell it owns."""
    S, V = particles.flags.shape
    m_cap = cfg.mover_capacity
    valid = particles.valid
    t = t if cfg.record_particle_time else None

    wx, wy, wz = geometry.world_voxel_planar(particles.px, particles.py,
                                             particles.pz, cfg)
    inside = geometry.in_window_planar(wx, wy, wz, origin, cfg) & valid
    moved_out = valid & ~inside
    new_cell = geometry.storage_index_planar(wx, wy, wz, cfg)
    lo = 0 if shard is None else shard.lo
    current = lo + torch.arange(V, dtype=new_cell.dtype,
                                device=new_cell.device)
    mover = inside & (new_cell != current[None, :])

    vacated = dataclasses.replace(
        particles, flags=torch.where(mover | moved_out, 0, particles.flags))
    if shard is None:
        idx, cell, ranks, sel_valid, n_movers = compact_and_group(
            mover, new_cell, m_cap, V)
        payload = torch.stack([pool_take(getattr(particles, n), idx)
                               for n in PAYLOAD], dim=-1)
        new_particles, _, keep = insert_sorted(
            vacated, cfg, cell=cell, ranks=ranks, payload=payload,
            valid=sel_valid, flag=1, t=t)
        n_kept = n_movers.clamp(max=m_cap)
        n_arrivals, over = n_kept, n_movers - n_kept
    else:
        # local compaction (unordered), then the cross-slab exchange
        idx, ok, n_kept, buf_over = compact_mask(mover, m_cap)
        dest = torch.where(ok, pool_take(new_cell, idx), -1)
        hops, ring_undelivered = None, 0
        if cfg.mover_exchange == "ring":
            hops = cfg.ring_hops
            if with_metrics:
                reach = shard.ring_reachable(dest.clamp(min=0), V, hops)
                ring_undelivered = (ok & ~reach).sum()
        a_dest, a_ok, *a_cols = shard.exchange(
            [dest, ok] + [pool_take(getattr(particles, n), idx)
                          for n in PAYLOAD], hops)
        own_i, own_ok, n_arrivals, own_over = compact_mask(
            a_ok & shard.owns(a_dest, V), m_cap)
        own_i = own_i.to(torch.int64)
        cell_local = torch.where(own_ok, a_dest[own_i] - shard.lo, V)
        order, sorted_cell, ranks_sorted = sort_by_destination(cell_local,
                                                               own_ok)
        rows = own_i[order.to(torch.int64)]
        payload = torch.stack([c[rows] for c in a_cols], dim=-1)
        new_particles, _, keep = insert_sorted(
            vacated, cfg, cell=sorted_cell.clamp(max=V), ranks=ranks_sorted,
            payload=payload, valid=sorted_cell < V, flag=1, t=t)
        over = buf_over + own_over + ring_undelivered
    stats = {
        "moved_out": moved_out.sum(),
        "movers": n_kept,
        "mover_overflow_killed": over,
        "voxel_full_killed": n_arrivals - keep.sum(),
    } if with_metrics else {}
    return new_particles, stats
