"""Voxel reassignment after the noisy prediction (mirrors
``dspmap_tpu/ops/rebin.py``, its unsharded branch): move-or-vanish
semantics of ``moveParticle`` / ``removeParticle``
(``dsp_dynamic.h:1206-1279, 686-690``).

Window leavers die; movers (particles whose storage cell changed) vacate
their slots, are compacted and grouped by destination in one stable sort,
and are re-inserted with the capacity-limited insertion, whose full-voxel
drops are the reference's vanish path (``dsp_dynamic.h:1227-1229``).
Movers beyond ``cfg.mover_capacity`` die and are counted.  The fused-sweep
arm of the step does the same work in ``ops/fov.py::rebin_and_register``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MapConfig
from .. import geometry
from .common import compact_and_group, pool_take
from .insert import insert_sorted

#: the payload columns a mover carries, in ``insert_sorted``'s order
PAYLOAD = ("px", "py", "pz", "vx", "vy", "vz", "weight")


def rebin(particles, cfg: MapConfig, origin, t, shard=None):
    """Re-home particles whose storage cell changed; kill window leavers.
    ``particles`` are ``[S, V]`` planes, ``origin`` the window origin and
    ``t`` the update time (host values).  Returns ``(new_particles,
    stats)``.  ``shard`` (the sharded exchange of the JAX package) is not
    ported: anything but ``None`` raises."""
    if shard is not None:
        raise NotImplementedError("the sharded rebin is not ported yet "
                                  "(ROADMAP.md, queue 1, item 19)")
    S, V = particles.flags.shape
    m_cap = cfg.mover_capacity
    valid = particles.valid

    wx, wy, wz = geometry.world_voxel_planar(particles.px, particles.py,
                                             particles.pz, cfg)
    inside = geometry.in_window_planar(wx, wy, wz, origin, cfg) & valid
    moved_out = valid & ~inside
    new_cell = geometry.storage_index_planar(wx, wy, wz, cfg)
    current = torch.arange(V, dtype=new_cell.dtype, device=new_cell.device)
    mover = inside & (new_cell != current[None, :])

    vacated = dataclasses.replace(
        particles, flags=torch.where(mover | moved_out, 0, particles.flags))
    idx, cell, ranks, sel_valid, n_movers = compact_and_group(
        mover, new_cell, m_cap, V)
    payload = torch.stack([pool_take(getattr(particles, n), idx)
                           for n in PAYLOAD], dim=-1)
    new_particles, _, keep = insert_sorted(
        vacated, cfg, cell=cell, ranks=ranks, payload=payload,
        valid=sel_valid, flag=1, t=t if cfg.record_particle_time else None)
    n_kept = n_movers.clamp(max=m_cap)
    stats = {
        "moved_out": moved_out.sum(),
        "movers": n_kept,
        "mover_overflow_killed": n_movers - n_kept,
        "voxel_full_killed": n_kept - keep.sum(),
    }
    return new_particles, stats
