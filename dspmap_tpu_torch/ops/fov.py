"""FOV registration (mirrors ``dspmap_tpu/ops/fov.py``):
:func:`register_fov` for the noisy-prediction and multi-sensor paths, and
the mover relocation + FOV registration of the fused-sweep path,
:func:`rebin_and_register` (``_rebin_chain_body`` there), both on the
shared two-tier binning ``_bin_candidates``.

One compaction over ``mover | fov | moving`` feeds three consumers: the
movers are re-inserted at their new cells with drop-on-full arrival ranks;
FOV candidates are ranked per pyramid cell, with ranks beyond the
reference's per-cell capacity killed (``dsp_dynamic.h:1256-1259``) and the
rest binned into the dense tier ``[n_pyr, S_t]`` and a compacted spill
tier; nonzero-velocity candidates form the ``future_movers`` set that the
occupancy stage scatters.

:func:`register_fov` compacts and ranks the FOV slots of the pool itself
and, on the noisy arm, jitters the surviving in-FOV particles' velocities
(``dsp_dynamic.h:1261-1269``: vx and vy get noise, vz is set to 0, under
the keep-still test of ``ops/propagate.py``).

Only the full-width, immediate-payload path is ported (the JAX package's
prefix-bucket ladder over candidate counts and its deferred payload for
pools of 64 MB or more give the same result); on a slab of the sharded step
:func:`rebin_and_register` exchanges the movers across ranks.
:func:`register_fov` needs no sharded arm: it works on the slab's own
slots, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import MapConfig
from .. import geometry
from .common import (compact_and_group, compact_mask, frame_float,
                     frame_floats, group_ranks, inverse_ranks, pool_fill,
                     pool_put, pool_sv, pool_take, scatter_set,
                     sort_by_destination)
from .insert import allocate_slots, scatter_candidates
from .propagate import jitter_mask


class FovBinning(NamedTuple):
    pos: torch.Tensor  # f32 [n_pyr, S_t, 3] world positions (dense tier)
    weight: torch.Tensor  # f32 [n_pyr, S_t]
    rng: torch.Tensor  # f32 [n_pyr, S_t] ego range
    mask: torch.Tensor  # bool [n_pyr, S_t]
    slot: torch.Tensor  # i32 [n_pyr, S_t] flat pool index
    sp_pos: torch.Tensor  # f32 [Psp, 3] spill tier
    sp_weight: torch.Tensor  # f32 [Psp]
    sp_rng: torch.Tensor  # f32 [Psp]
    sp_pyr: torch.Tensor  # i32 [Psp] (n_pyr sentinel)
    sp_mask: torch.Tensor  # bool [Psp]
    sp_slot: torch.Tensor  # i32 [Psp]
    sp_overflow: torch.Tensor  # i32 scalar


def _bin_candidates(cfg: MapConfig, total: int, sensor_pos, idx, cand_pyr,
                    ranks, sel_valid, n_fov, cols, with_metrics=True):
    """Two-tier binning of the pyramid-ranked FOV candidates.  ``idx`` are
    flat pool positions (``total`` = drop sentinel), ``cols`` the gathered
    ``(px, py, pz, weight)`` columns.  Returns ``(fovbin, kill, stats)``;
    ``stats`` is empty without ``with_metrics`` (``n_fov`` is then not
    read)."""
    dev = idx.device
    n_pyr, s_pyr, S_t = cfg.n_pyramids, cfg.pyramid_slots, cfg.dense_slots
    f_cap, p_cap = cfg.fov_buffer_capacity, cfg.particle_spill_capacity
    grid_cap = n_pyr * S_t

    keep = sel_valid & (ranks < S_t)
    spill_sel = sel_valid & (ranks >= S_t) & (ranks < s_pyr)
    kill = sel_valid & (ranks >= s_pyr)

    px, py, pz, w = cols
    s = frame_floats(sensor_pos)
    rng_c = torch.sqrt((px - s[0]) ** 2 + (py - s[1]) ** 2 + (pz - s[2]) ** 2)

    cell = torch.where(keep, cand_pyr * S_t + ranks, grid_cap)
    f32 = dict(dtype=torch.float32, device=dev)
    bpos = scatter_set(torch.zeros((grid_cap, 3), **f32), cell,
                       torch.stack([px, py, pz], dim=-1))
    bw = scatter_set(torch.zeros(grid_cap, **f32), cell, w)
    brng = scatter_set(torch.zeros(grid_cap, **f32), cell, rng_c)
    bmask = scatter_set(torch.zeros(grid_cap, dtype=torch.bool, device=dev),
                        cell, True)
    bslot = scatter_set(torch.full((grid_cap,), total, dtype=torch.int32,
                                   device=dev), cell, idx.to(torch.int32))

    if S_t < s_pyr:
        sp_i, sp_valid, _, sp_over = compact_mask(spill_sel, p_cap)
        sp_i = sp_i.to(torch.int64)
        sp_pos = torch.where(sp_valid[:, None],
                             torch.stack([px[sp_i], py[sp_i], pz[sp_i]], -1),
                             0.0)
        sp_w = torch.where(sp_valid, w[sp_i], 0.0)
        sp_rng = torch.where(sp_valid, rng_c[sp_i], 0.0)
        sp_pyr = torch.where(sp_valid, cand_pyr[sp_i], n_pyr).to(torch.int32)
        sp_slot = torch.where(sp_valid, idx[sp_i], total).to(torch.int32)
    else:
        sp_pos = torch.zeros((p_cap, 3), **f32)
        sp_w = torch.zeros(p_cap, **f32)
        sp_rng = torch.zeros(p_cap, **f32)
        sp_pyr = torch.full((p_cap,), n_pyr, dtype=torch.int32, device=dev)
        sp_valid = torch.zeros(p_cap, dtype=torch.bool, device=dev)
        sp_slot = torch.full((p_cap,), total, dtype=torch.int32, device=dev)
        sp_over = torch.zeros((), dtype=torch.int32, device=dev)

    fovbin = FovBinning(
        pos=bpos.view(n_pyr, S_t, 3), weight=bw.view(n_pyr, S_t),
        rng=brng.view(n_pyr, S_t), mask=bmask.view(n_pyr, S_t),
        slot=bslot.view(n_pyr, S_t), sp_pos=sp_pos, sp_weight=sp_w,
        sp_rng=sp_rng, sp_pyr=sp_pyr, sp_mask=sp_valid, sp_slot=sp_slot,
        sp_overflow=sp_over,
    )
    stats = {
        "in_fov": n_fov.clamp(max=f_cap),
        "pyramid_full_killed": kill.sum(),
        "fov_global_overflow": (n_fov - f_cap).clamp(min=0),
        "update_spill_overflow": sp_over,
    } if with_metrics else {}
    return fovbin, kill, stats


def fov_jitter(particles, cfg: MapConfig, alive_fov, noise, rt=None):
    """The in-FOV velocity perturbation of the noisy arm
    (``dsp_dynamic.h:1261-1269``): ``(vx, vy, vz)`` with ``noise [2, ...]``
    (standard normal) times ``velocity_noise_std`` added to vx and vy and
    vz set to 0 where ``alive_fov`` and not keep-still.  Under limit-xy and
    the static model the planes pass through (the branch is dead there)."""
    vx, vy, vz = particles.vx, particles.vy, particles.vz
    if cfg.limit_motion_to_xy_plane or cfg.motion_model == "static":
        return vx, vy, vz
    if noise is None:
        raise ValueError("the noisy arm of FOV registration takes a [2, ...] "
                         "standard-normal draw")
    sigma = cfg.velocity_noise_std if rt is None else rt.velocity_noise_std
    n = noise * frame_float(sigma)
    jitter = jitter_mask(vx, vy, vz, alive_fov)
    return (torch.where(jitter, vx + n[0], vx),
            torch.where(jitter, vy + n[1], vy),
            torch.where(jitter, 0.0, vz))


def register_fov(particles, cfg: MapConfig, sensor_pos, quat=None,
                 noise=None, rt=None, with_metrics=True, *, R=None):
    """FOV registration of ``[S, V]`` planes for one sensor pose (the
    frame block's ``sensor_pos`` and its rotation ``R=``; or host arrays
    and the wxyz quaternion ``quat``): every slot rotated into the
    sensor frame, in-FOV valid slots compacted and grouped by pyramid
    cell, ranks beyond the per-cell capacity killed, the rest binned; then
    the in-FOV velocity jitter (:func:`fov_jitter`; ``noise [2, S, V]`` on
    the noisy arm).  Returns ``(new_particles, FovBinning, stats)``; the
    binning indexes into ``new_particles``, and ``stats`` is empty without
    ``with_metrics``."""
    S, V = particles.flags.shape
    s = frame_floats(sensor_pos)
    sx, sy, sz = geometry.rotate_planar(geometry.frame_rotation(quat, R),
                                        particles.px - s[0],
                                        particles.py - s[1],
                                        particles.pz - s[2])
    pyr, in_fov = geometry.pyramid_index_planar(sx, sy, sz, cfg)
    fov_mask = particles.valid & in_fov
    idx, cand_pyr, ranks, sel_valid, n_fov = compact_and_group(
        fov_mask, pyr, cfg.fov_buffer_capacity, cfg.n_pyramids)
    cols = tuple(pool_take(getattr(particles, n), idx)
                 for n in ("px", "py", "pz", "weight"))
    fovbin, kill, stats = _bin_candidates(
        cfg, S * V, sensor_pos, idx, cand_pyr, ranks, sel_valid, n_fov, cols,
        with_metrics)
    flags = pool_put(particles.flags, torch.where(kill, idx, S * V), 0)
    vx, vy, vz = fov_jitter(particles, cfg, fov_mask & (flags != 0), noise, rt)
    return (dataclasses.replace(particles, flags=flags, vx=vx, vy=vy, vz=vz),
            fovbin, stats)


def rebin_and_register(particles, cfg: MapConfig, sw, sensor_pos,
                       update_time, shard=None, with_metrics=True):
    """Returns ``(new_particles, FovBinning, future_movers, stats)`` with
    ``future_movers = (flat[m_cap], valid[m_cap], n_dropped)``.  Without
    ``with_metrics`` the counters are not computed: ``stats`` is empty and
    ``n_dropped`` is ``None``.

    ``particles`` are the post-sweep planes and ``sw`` the sweep's tags and
    new cells, both ``[S, V]`` or both flat ``[S*V]`` (the step's mid-frame
    form).  A flat working plane is written in place: the caller's
    ``particles`` must not be read afterwards.

    ``shard`` (:class:`~.common.ShardCtx`): the planes are this rank's slab
    and mover destinations are global, so the mover buffer (payload, global
    destination, sweep tags) is exchanged over the ranks (``all_gather``, or
    the ring of ``cfg.ring_hops`` neighbours) and each rank inserts the
    arrivals whose cell it owns, behind its local movers in shard-major
    order.  FOV registration then ranks the local non-movers and the
    inserted arrivals, whose fov, moving and pyramid tags rode the
    exchange."""
    S, V = pool_sv(particles.flags, cfg)
    SV = S * V
    n_pyr = cfg.n_pyramids
    cap, m_cap = cfg.fov_buffer_capacity, cfg.mover_capacity
    dev = particles.flags.device
    t = update_time if cfg.record_particle_time else None

    idx, c_valid, _, _ = compact_mask(sw.candidate, cap)
    total_fov = sw.fov.sum() if with_metrics else None
    vacated = dataclasses.replace(
        particles, flags=pool_fill(particles.flags, sw.mover, 0))

    tags = pool_take(sw.tags, idx)
    px = pool_take(particles.px, idx)
    py = pool_take(particles.py, idx)
    pz = pool_take(particles.pz, idx)
    w = pool_take(particles.weight, idx)
    is_mover = ((tags & 1) != 0) & c_valid
    is_fov = ((tags & 2) != 0) & c_valid
    is_moving = ((tags & 4) != 0) & c_valid
    pyr = tags >> 4
    flat0 = torch.where(c_valid, idx, SV)

    # ---- movers: compact to the mover buffer and re-insert -------------
    mov_i, mov_ok, n_mov, mov_buf_over = compact_mask(is_mover, m_cap)
    mov_i = mov_i.to(torch.int64)
    mov_src = flat0[mov_i].clamp(max=SV - 1)
    mov_cell = torch.where(mov_ok, pool_take(sw.new_cell, mov_src), V)
    mov_vel = [pool_take(getattr(particles, n), mov_src)
               for n in ("vx", "vy", "vz")]
    own_over = ring_undelivered = 0
    if shard is None:
        ins_cell, ins_ok, n_arrivals = mov_cell, mov_ok, n_mov
        cols_m = (px[mov_i], py[mov_i], pz[mov_i], *mov_vel, w[mov_i])
    else:
        exp = [mov_cell, px[mov_i], py[mov_i], pz[mov_i], *mov_vel, w[mov_i],
               tags[mov_i], mov_ok & (mov_cell < cfg.voxel_num)]
        hops = None
        if cfg.mover_exchange == "ring":
            hops = cfg.ring_hops
            if with_metrics:
                reach = shard.ring_reachable(mov_cell.clamp(min=0), V, hops)
                ring_undelivered = (exp[-1] & ~reach).sum()
        *a_cols, a_tags, a_ok = shard.exchange(exp, hops)
        a_cell = a_cols.pop(0)
        own_i, ins_ok, n_arrivals, own_over = compact_mask(
            a_ok & shard.owns(a_cell, V), m_cap)
        own_i = own_i.to(torch.int64)
        ins_cell = torch.where(ins_ok, a_cell[own_i] - shard.lo, V)
        ins_tags = torch.where(ins_ok, a_tags[own_i], 0)
        cols_m = tuple(c[own_i] for c in a_cols)
    order, _, ranks_sorted = sort_by_destination(ins_cell, ins_ok)
    new_flat, keep_ins = allocate_slots(
        vacated, cfg, ins_cell, inverse_ranks(order, ranks_sorted), ins_ok)

    if shard is None:
        # ---- FOV ranks from the combined buffer (movers remapped) ------
        flat = scatter_set(flat0, torch.where(mov_ok, mov_i, cap),
                           torch.where(keep_ins, new_flat, SV))
        fov_sel = is_fov & (flat < SV)
        mv_sel = is_moving & (flat < SV)
        keys = torch.where(fov_sel, pyr, n_pyr).to(torch.int32)
        sorted_keys, f_order = torch.sort(keys, stable=True)
        f_ranks = inverse_ranks(f_order, group_ranks(sorted_keys))
        kill = fov_sel & (f_ranks >= cfg.pyramid_slots)
        # killed movers write flag 0 through their own row; non-mover kill
        # rows join the same flags scatter (disjoint by construction)
        killed_m = kill[mov_i.clamp(max=cap - 1)] & mov_ok
        mov_flag = torch.where(killed_m, 0, 1).to(torch.int32)
        kill_nm = torch.where(kill & ~is_mover, flat, SV)
        new_particles = scatter_candidates(
            vacated, new_flat, cols_m, mov_flag, t,
            flag_extra=(kill_nm, torch.zeros(cap, dtype=torch.int32,
                                             device=dev)))
        fovbin, _, stats = _bin_candidates(
            cfg, SV, sensor_pos, flat, keys, f_ranks, fov_sel, total_fov,
            cols=(px, py, pz, w), with_metrics=with_metrics)
    else:
        # ---- FOV ranks over local non-movers + inserted arrivals -------
        new_particles = scatter_candidates(vacated, new_flat, cols_m, 1, t)
        flat = torch.cat([torch.where(is_mover, SV, flat0.clamp(max=SV)),
                          torch.where(keep_ins, new_flat, SV)])
        fov_sel = torch.cat([is_fov & ~is_mover,
                             keep_ins & (((ins_tags >> 1) & 1) != 0)])
        fov_sel = fov_sel & (flat < SV)
        mv_sel = torch.cat([is_moving & ~is_mover,
                            keep_ins & (((ins_tags >> 2) & 1) != 0)])
        mv_sel = mv_sel & (flat < SV)
        keys = torch.where(fov_sel, torch.cat([pyr, ins_tags >> 4]),
                           n_pyr).to(torch.int32)
        sorted_keys, f_order = torch.sort(keys, stable=True)
        f_ranks = inverse_ranks(f_order, group_ranks(sorted_keys))
        cols = tuple(torch.cat([a, b]) for a, b in zip((px, py, pz, w),
                                                      cols_m[:3] + cols_m[6:]))
        fovbin, kill, stats = _bin_candidates(
            cfg, SV, sensor_pos, flat, keys, f_ranks, fov_sel, total_fov,
            cols, with_metrics)
        new_particles = dataclasses.replace(new_particles, flags=pool_put(
            new_particles.flags, torch.where(kill, flat, SV), 0))

    fm_i, fm_ok, _, fm_over = compact_mask(mv_sel, m_cap)
    future_movers = (
        torch.where(fm_ok, flat[fm_i.to(torch.int64)], SV),
        fm_ok,
        ((sw.moving.sum() - is_moving.sum()) + fm_over) if with_metrics
        else None,
    )
    if with_metrics:
        stats.update(
            moved_out=sw.moved_out.sum(),
            movers=n_mov.clamp(max=m_cap),
            mover_overflow_killed=((sw.mover.sum() - is_mover.sum())
                                   + mov_buf_over + own_over
                                   + ring_undelivered),
            voxel_full_killed=n_arrivals - keep_ins.sum(),
            fov_global_overflow=total_fov - is_fov.sum(),
        )
    return new_particles, fovbin, future_movers, stats
