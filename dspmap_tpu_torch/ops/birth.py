"""Particle birth around observed points with Dempster-Shafer static/dynamic
arbitration (mirrors ``dspmap_tpu/ops/birth.py``; see its docstring for the
reference semantics).  The random draws are arguments: ``noise_p`` and
``noise_v`` standard normal and ``noise_u`` uniform on [-1, 1), each
``[P, n_b, 3]``.

On a slab of the sharded step (``shard``, a :class:`~.common.ShardCtx`)
the per-point DS classification sums are taken over the rank's own voxels
and summed over the ranks (``all_reduce``); the estimator points and the
draws are the same on every rank, so every rank derives the same newborn
table, and each inserts only the newborns whose voxel it owns."""

from __future__ import annotations

import numpy as np
import torch

from ..config import MapConfig
from .. import geometry
from ..state import FLAG_NEWBORN
from .common import device_constant, frame_float, pool_sv
from .insert import insert_particles


def birth_table(cfg: MapConfig, est_points, est_vel, est_dynamic, w_static,
                w_mid, w_dyn, rt, noise_p, noise_v, noise_u):
    """DS arbitration + the newborn candidate table (``dsp_dynamic.h:850-907``).
    ``rt``'s fields are host floats or the frame block's 0-d tensors.
    Returns ``(pos [P, n_b, 3], vel [P, n_b, 3])``."""
    n_b = cfg.newborn_particles_per_point
    dev = est_points.device
    total = w_static + w_mid + w_dyn
    p_static = (2.0 * w_static + w_mid) * 0.5
    p_dynamic = (2.0 * w_dyn + w_mid) * 0.5
    p_static_norm = torch.where(total > 0.0, p_static / (p_static + p_dynamic),
                                0.0)
    n_model = cfg.model_newborns
    n_static = torch.clamp(torch.floor(n_model * p_static_norm).to(torch.int32),
                           min=cfg.min_static_newborns)

    b = torch.arange(n_b, dtype=torch.int32, device=dev)[None, :]
    pos = est_points[:, None, :] + noise_p * frame_float(
        rt.position_noise_std)
    if cfg.motion_model == "static":
        return pos, torch.zeros_like(pos)
    vel_known = est_vel[:, 0] > -100.0
    # the float32 product: exact in a Python float before an operation
    # rounds it, as on the device
    gain = frame_float(rt.velocity_noise_std) * float(
        np.float32(cfg.estimator_newborn_noise_gain))
    dyn = est_dynamic[:, None, None]
    v_model = torch.where(dyn, est_vel[:, None, :] + gain * noise_v, 0.0)
    span = device_constant([cfg.random_newborn_vxy, cfg.random_newborn_vxy,
                            cfg.random_newborn_vz], torch.float32, dev)
    v_random = torch.where(dyn, noise_u * span, 0.0)
    is_static_b = b < n_static[:, None]
    is_model_b = (~is_static_b) & vel_known[:, None] & (b < n_model)
    vel = torch.where(is_static_b[:, :, None], 0.0,
                      torch.where(is_model_b[:, :, None], v_model, v_random))
    if cfg.limit_motion_to_xy_plane:
        vel = torch.cat([vel[:, :, :2], torch.zeros_like(vel[:, :, 2:])], -1)
    return pos, vel


def _owned_cells(point_valid, cell_g, n_cells: int, shard):
    """``(owned, cell)``: the points whose voxel this rank owns and their
    local cell (clipped into the slab)."""
    if shard is None:
        return point_valid, cell_g.to(torch.int64)
    owned = point_valid & shard.owns(cell_g, n_cells)
    return owned, (cell_g - shard.lo).clamp(0, n_cells - 1).to(torch.int64)


def _point_sums(tables, owned, cell, shard):
    """Each per-voxel table read at the points' cells (0 where not owned),
    summed over the ranks on a slab."""
    zero = torch.zeros((), dtype=torch.float32, device=cell.device)
    sums = torch.stack([torch.where(owned, t[cell], zero) for t in tables])
    if shard is not None:
        sums = shard.psum(sums)
    return sums.unbind(0)


def particle_birth(particles, cfg: MapConfig, draws, *, est_points, est_vel,
                   est_dynamic, est_valid, norm_coeff, origin, update_time, rt,
                   shard=None, with_metrics=True):
    """Returns ``(new_particles, stats)``; ``draws = (noise_p, noise_v,
    noise_u)``.  The pool planes are ``[S, V]`` or flat ``[S*V]``; a flat
    working plane is written in place.  ``stats`` is empty without
    ``with_metrics``."""
    P = est_points.shape[0]
    n_b = cfg.newborn_particles_per_point
    w_new = rt.newborn_particle_weight * norm_coeff

    wv = geometry.world_voxel(est_points, cfg)
    point_valid = est_valid & geometry.in_window(wv, origin, cfg)
    cell_g = torch.where(point_valid, geometry.storage_index(wv, cfg), 0)

    # per-voxel class-weight tables, summed over slots in slot order
    S, V = pool_sv(particles.flags, cfg)
    owned, cell = _owned_cells(point_valid, cell_g, V, shard)
    if cfg.motion_model == "static":
        v_planes = ()
    elif cfg.limit_motion_to_xy_plane:
        v_planes = (particles.vx, particles.vy)
    else:
        v_planes = (particles.vx, particles.vy, particles.vz)
    v_planes = tuple(v.view(S, V) for v in v_planes)
    flags_sv, weight_sv = particles.flags.view(S, V), particles.weight.view(S, V)
    zero = torch.zeros((), dtype=torch.float32, device=est_points.device)
    w_static_v = w_mid_v = w_dyn_v = torch.zeros(V, dtype=torch.float32,
                                                 device=est_points.device)
    for s in range(S):
        fl = flags_sv[s]
        l1 = torch.zeros(V, dtype=torch.float32, device=fl.device)
        for v in v_planes:
            l1 = l1 + v[s].abs()
        w_c = torch.where((fl != 0) & (fl != FLAG_NEWBORN),
                          weight_sv[s], zero)
        w_static_v = w_static_v + torch.where(l1 < 0.1, w_c, zero)
        w_mid_v = w_mid_v + torch.where((l1 >= 0.1) & (l1 < 0.5), w_c, zero)
        w_dyn_v = w_dyn_v + torch.where(l1 >= 0.5, w_c, zero)
    w_static, w_mid, w_dyn = _point_sums((w_static_v, w_mid_v, w_dyn_v),
                                         owned, cell, shard)

    pos, vel = birth_table(cfg, est_points, est_vel, est_dynamic, w_static,
                           w_mid, w_dyn, rt, *draws)
    births = P * n_b
    valid = point_valid[:, None].expand(P, n_b).reshape(-1)
    new_particles = insert_particles(
        particles, cfg, pos=pos.reshape(births, 3), vel=vel.reshape(births, 3),
        weight=w_new.expand(births), valid=valid, origin=origin,
        flag=FLAG_NEWBORN,
        t=update_time if cfg.record_particle_time else None,
        cell_base=0 if shard is None else shard.lo,
    )
    stats = {
        "birth_candidates": valid.sum(),
        "born": new_particles.newborn.sum(),
        "newborn_weight": w_new,
    } if with_metrics else {}
    return new_particles, stats


def particle_birth_compact(particles, cfg: MapConfig, draws, *, est_points,
                           est_vel, est_dynamic, est_valid, norm_coeff, origin,
                           update_time, rt, shard=None, with_metrics=True):
    """:func:`particle_birth` over the compact layout: the per-voxel class
    tables come from one O(alive) segment table and the newborns land in
    free rows (per-voxel capacity exact, the global row budget counted in
    ``pool_overflow``; ``stats`` is empty without ``with_metrics``)."""
    from .compact import insert_compact, segment_table

    P = est_points.shape[0]
    n_b = cfg.newborn_particles_per_point
    w_new = rt.newborn_particle_weight * norm_coeff
    zero = torch.zeros((), dtype=torch.float32, device=est_points.device)

    considered = (particles.flags != 0) & (particles.flags != FLAG_NEWBORN)
    if cfg.motion_model == "static":
        v_planes = ()
    elif cfg.limit_motion_to_xy_plane:
        v_planes = (particles.vx, particles.vy)
    else:
        v_planes = (particles.vx, particles.vy, particles.vz)
    l1 = torch.zeros_like(particles.weight)
    for v in v_planes:
        l1 = l1 + v.abs()
    w_c = torch.where(considered, particles.weight, zero)
    wx, wy, wz = geometry.world_voxel_planar(particles.px, particles.py,
                                             particles.pz, cfg)
    n_cells = (cfg.storage_voxels if shard is None
               else cfg.storage_voxels // shard.n_shards)
    cell_p = geometry.storage_index_planar(wx, wy, wz, cfg) - (
        0 if shard is None else shard.lo)
    alive = particles.flags != 0
    w_static_v, w_mid_v, w_dyn_v, count_v = segment_table(
        cell_p, alive,
        (torch.where(considered & (l1 < 0.1), w_c, zero),
         torch.where(considered & (l1 >= 0.1) & (l1 < 0.5), w_c, zero),
         torch.where(considered & (l1 >= 0.5), w_c, zero),
         alive),  # current occupancy: the capacity baseline
        n_cells, max_run=cfg.slots_per_voxel)

    wv = geometry.world_voxel(est_points, cfg)
    point_valid = est_valid & geometry.in_window(wv, origin, cfg)
    owned, cell = _owned_cells(
        point_valid, torch.where(point_valid, geometry.storage_index(wv, cfg),
                                 0), n_cells, shard)
    w_static, w_mid, w_dyn = _point_sums((w_static_v, w_mid_v, w_dyn_v),
                                         owned, cell, shard)

    pos, vel = birth_table(cfg, est_points, est_vel, est_dynamic, w_static,
                           w_mid, w_dyn, rt, *draws)
    births = P * n_b
    valid = point_valid[:, None].expand(P, n_b).reshape(-1)
    new_particles, born, over = insert_compact(
        particles, cfg, pos=pos.reshape(births, 3), vel=vel.reshape(births, 3),
        weight=w_new.expand(births), valid=valid, origin=origin,
        flag=FLAG_NEWBORN,
        t=update_time if cfg.record_particle_time else None,
        count_v=count_v, shard=shard)
    stats = {
        "birth_candidates": valid.sum(),
        "born": born,
        "newborn_weight": w_new,
        "pool_overflow": over,
    } if with_metrics else {}
    return new_particles, stats
