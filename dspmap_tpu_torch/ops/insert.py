"""Capacity-limited particle insertion (mirrors ``dspmap_tpu/ops/insert.py``):
candidates fill the first free slots of their voxel in arrival order, the
surplus of a full voxel is dropped (``dsp_dynamic.h:1198-1200,1227-1229``).

Only the immediate, full-width path is ported: the JAX package's
prefix-bucket ``compact_to`` switch and the deferred-payload path for
pools of 64 MB or more give the same result and exist for TPU scatter
costs.

Every function takes the pool planes in their ``[S, V]`` or their flat
``[S*V]`` form (``ops.common.pool_sv``); the scatters write a flat working
plane in place (``ops.common.pool_put``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MapConfig
from .. import geometry
from .common import (frame_float, inverse_ranks, pool_put, pool_sv,
                     sort_by_destination)


def empty_slot_lookup(flags: torch.Tensor, cell: torch.Tensor,
                      ranks: torch.Tensor):
    """Per candidate, the slot of the ``ranks``-th empty slot of voxel
    ``cell`` in ``flags [S, V]``.  Returns ``(slot, n_empty)`` with
    ``slot = S`` when ``ranks >= n_empty``."""
    empty = flags[:, cell.to(torch.int64)] == 0  # [S, M] (S row gathers)
    cum = torch.cumsum(empty, 0, dtype=torch.int32)
    n_empty = cum[-1]
    slot = (cum <= ranks[None, :]).sum(0, dtype=torch.int32)
    return torch.where(ranks < n_empty, slot, flags.shape[0]), n_empty


def allocate_slots(particles, cfg: MapConfig, cell, ranks, valid):
    """Final flat pool position per candidate (``S*V`` sentinel when the
    voxel is full or the candidate invalid).  Returns ``(flat, keep)``."""
    S, V = pool_sv(particles.flags, cfg)
    in_bounds = valid & (cell < V)
    safe_cell = cell.clamp(0, V - 1)
    slot, n_empty = empty_slot_lookup(particles.flags.view(S, V), safe_cell,
                                      ranks)
    keep = in_bounds & (ranks < n_empty)
    return torch.where(keep, slot * V + safe_cell, S * V), keep


def scatter_candidates(particles, flat, payload_cols, flag, t,
                       flag_extra=None):
    """Write ``payload_cols = (px, py, pz, vx, vy, vz, weight)`` at their
    allocated flat positions.  ``flag`` is a scalar or per-candidate
    array; ``flag_extra = (idx, vals)`` adds rows to the flags scatter
    only (disjoint from ``flat``); ``t`` is the update time (a 0-d tensor
    or a host float), ``None`` skips the time plane."""
    s_flat = flat
    vals = (flag.to(torch.int32) if isinstance(flag, torch.Tensor)
            else torch.full((), flag, dtype=torch.int32, device=flat.device)
            ).expand(flat.shape)
    if flag_extra is not None:
        s_flat = torch.cat([flat, flag_extra[0]])
        vals = torch.cat([vals, flag_extra[1].to(torch.int32)])
    p = particles
    names = ("px", "py", "pz", "vx", "vy", "vz", "weight")
    new = {n: pool_put(getattr(p, n), flat, c)
           for n, c in zip(names, payload_cols)}
    if t is not None:
        new["t"] = pool_put(p.t, flat, frame_float(t))
    return dataclasses.replace(p, flags=pool_put(p.flags, s_flat, vals), **new)


def insert_sorted(particles, cfg: MapConfig, *, cell, ranks, payload, valid,
                  flag, t):
    """Insert destination-sorted candidates: ``cell [M]`` (``>= V``
    invalid), ``ranks [M]`` their arrival ranks within the destination,
    ``payload [M, 7]`` = px, py, pz, vx, vy, vz, weight.  Returns
    ``(new_pool, flat, keep)``: each candidate's flat pool position
    (``S*V`` when dropped) and the insertion mask."""
    flat, keep = allocate_slots(particles, cfg, cell, ranks, valid)
    new = scatter_candidates(particles, flat, payload.unbind(1), flag, t)
    return new, flat, keep


def insert_particles(particles, cfg: MapConfig, *, pos, vel, weight, valid,
                     origin, flag, t, cell_base: int = 0):
    """Insert unsorted candidates; arrival ranks come from a stable
    destination sort.  Candidates outside the window are dropped
    (``dsp_dynamic.h:875,1062-1074``).  ``cell_base`` is the global storage
    cell of pool column 0 (a slab of the sharded step): candidates whose
    destination falls outside the slab are dropped here and inserted by the
    rank that owns it.  ``origin`` is the frame block's int32 ``[3]`` or a
    host origin."""
    S, V = pool_sv(particles.flags, cfg)
    wv = geometry.world_voxel(pos, cfg)
    inside = geometry.in_window(wv, origin, cfg)
    dest = geometry.storage_index(wv, cfg) - int(cell_base)
    valid = valid & inside & (dest >= 0) & (dest < V)
    order, _, ranks_sorted = sort_by_destination(dest, valid)
    ranks = inverse_ranks(order, ranks_sorted)
    flat, _ = allocate_slots(particles, cfg, torch.where(valid, dest, V),
                             ranks, valid)
    cols = (pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1], vel[:, 2],
            weight)
    return scatter_candidates(particles, flat, cols, flag, t)
