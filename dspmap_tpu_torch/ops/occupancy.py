"""Occupancy extraction, multi-horizon future prediction and per-voxel
systematic resampling (mirrors ``dspmap_tpu/ops/occupancy.py``; see its
docstring for the reference semantics).

The pool pass -- cull, per-voxel aggregates, stats counters and the
systematic resample -- is kernel K1 (``csrc/occupancy.cu``) on CUDA
tensors and :func:`pool_pass_plain` (a port of ``_pool_pass_xla``) on the
CPU.  Both return the same tuple, counters included, and associate every
slot-axis float sum exactly as the JAX package's XLA CPU program does:
the placement thresholds ``ceil(x/wa - 1/2)`` turn a different association
into flag flips (voxels of equal-weight newborns sit exactly on that grid).
Sums run in slot order; the inclusive weight cumsum runs in slot order
within blocks of :data:`SCAN_BLOCK` slots and adds the running total of the
earlier blocks -- the association of XLA's rewrite of ``jnp.cumsum``
(measured bit-equal at 10, 18, 45, 48, 50, 60, 64 and 70 slots).  The
slot-axis totals (``weight_sum``, the velocity sums, the static
contribution) run in slot order up to 32 slots; from 33 to 64 slots XLA's
CPU reduce sums the first ``ceil(S/2)`` slots and the rest separately, each
in slot order, and adds the two (measured at 33, 45, 50, 60 and 64; at 65
and beyond it splits otherwise, and no preset goes there).
``torch.cumsum`` and ``torch.sum`` on the CPU accumulate float32 otherwise,
so the plain version spells its slot-axis sums out as row loops.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MapConfig
from .. import geometry, kernels
from ..state import unflatten_pool
from .common import compact_mask, device_constant, pool_take, scatter_add

#: slot depths the CUDA kernel is instantiated for: the flagship's, the
#: static preset's and the multi-neighbor preset's
KERNEL_SLOTS = (18, 50, 60)
#: block length of the slot-axis weight cumsum (see module docstring)
SCAN_BLOCK = 16


def _n_vel(cfg: MapConfig) -> int:
    """Velocity planes the pool pass carries: the pipeline's clamp
    invariant makes vz (limit-xy) or all three (static model) zero."""
    if cfg.motion_model == "static":
        return 0
    return 2 if cfg.limit_motion_to_xy_plane else 3


def rewritten_planes(cfg: MapConfig) -> tuple:
    """Names of the planes the pool pass reads and writes anew, in the
    order kernel K1 stages them; the others (the clamped velocity planes,
    ``t`` unless recorded) it hands through."""
    return (("flags", "weight") + ("vx", "vy", "vz")[:_n_vel(cfg)]
            + ("px", "py", "pz")
            + (("t",) if cfg.record_particle_time else ()))


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive slot-axis cumsum of ``[S, V]`` in x's dtype: in slot order
    within blocks of ``SCAN_BLOCK`` slots, plus the earlier blocks' total."""
    out = torch.empty_like(x)
    S = x.shape[0]
    base = None
    for b0 in range(0, S, SCAN_BLOCK):
        blk = x[b0].clone()
        out[b0] = blk if base is None else base + blk
        for s in range(b0 + 1, min(S, b0 + SCAN_BLOCK)):
            blk = blk + x[s]
            out[s] = blk if base is None else base + blk
        base = out[min(S, b0 + SCAN_BLOCK) - 1]
    return out


def sum_split(S: int) -> int:
    """Where the slot-axis total of ``S`` slots is split in two partial
    sums (``S``: not at all); see the module docstring."""
    return (S + 1) // 2 if 32 < S <= 64 else S


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Slot-axis total of ``[S, V]`` with XLA's association: slot order,
    in two partial sums beyond 32 slots."""
    S = x.shape[0]
    parts = []
    for lo, hi in ((0, sum_split(S)), (sum_split(S), S)):
        if lo < hi:
            acc = x[lo].clone()
            for s in range(lo + 1, hi):
                acc = acc + x[s]
            parts.append(acc)
    return parts[0] if len(parts) == 1 else parts[0] + parts[1]


def pool_pass_plain(particles, cfg: MapConfig, with_moving: bool = True):
    """Plain PyTorch pool pass.  Returns ``(fields, weight_sum[V],
    n_old[V], vel_sums (3 x [V]), static_contrib[V], moving[S, V] | None,
    counters)`` with ``counters = (n_valid, n_culled, do_rs, n_dropped,
    n_filled)`` as f32 ``[V]`` vectors."""
    p = particles
    S, V = p.flags.shape
    f32 = torch.float32
    n_vel = _n_vel(cfg)
    vels = (p.vx, p.vy, p.vz)[:n_vel]

    cull = (p.flags != 0) & (p.weight < cfg.weight_cull_threshold)
    flags = torch.where(cull, 0, p.flags)
    valid = flags != 0
    old = valid & (flags != 3)
    w = p.weight
    zero = torch.zeros((), dtype=f32, device=w.device)

    wv = torch.where(valid, w, zero)
    weight_sum = _row_sum(wv)
    n_old = old.to(f32).sum(0)
    vel_sums = [_row_sum(torch.where(old, v, zero)) for v in vels]
    vel_sums += [torch.zeros(V, dtype=f32, device=w.device)] * (3 - n_vel)
    mv = torch.zeros_like(old)
    for v in vels:
        mv = mv | (v != 0.0)
    moving = old & mv
    static_contrib = _row_sum(torch.where(old & ~moving, w, zero))

    count = valid.sum(0, dtype=torch.int32)
    do_rs = count >= cfg.resample_min_count
    n_target = count.clamp(max=cfg.max_particles_per_voxel)
    wa = torch.where(do_rs, weight_sum / n_target.clamp(min=1), 1.0)

    hi = _row_cumsum(wv)
    lo = hi - wv

    def n_grid(x):
        return torch.clamp(torch.ceil(x / wa - 0.5), min=0.0).to(torch.int32)

    copies = torch.where(valid & do_rs, n_grid(hi) - n_grid(lo), 0)
    kept = valid & do_rs & (copies >= 1)
    dropped = valid & do_rs & (copies == 0)
    extra = (copies - 1).clamp(min=0)

    is_free = ~valid | dropped
    free_i = is_free.to(torch.int32)
    free_rank = torch.cumsum(free_i, 0, dtype=torch.int32) - free_i
    total_free = free_i.sum(0, dtype=torch.int32)
    demand_end = torch.cumsum(extra, 0, dtype=torch.int32)
    total_extra = demand_end[-1]
    # per slot, the count of demand_end[j] <= free_rank: demand_end is
    # non-decreasing along the slot axis, so the count is a binary search
    src_idx = torch.searchsorted(demand_end.T.contiguous(),
                                 free_rank.T.contiguous(), right=True).T
    src_idx = src_idx.clamp(max=S - 1)  # == S only where nothing is filled
    filled = is_free & (free_rank < torch.minimum(total_extra, total_free)) & do_rs

    demand_start = demand_end - extra
    placed = torch.minimum((total_free[None, :] - demand_start).clamp(min=0),
                           extra)
    unplaced = (extra - placed).to(f32)

    new_w = torch.where(kept, wa * (1.0 + unplaced), w)
    new_w = torch.where(filled, wa.expand(S, V), new_w)
    new_flags = torch.where(valid, 1, flags)
    new_flags = torch.where(dropped, 0, new_flags)
    new_flags = torch.where(filled, 1, new_flags).to(torch.int32)

    def place(field):
        return torch.where(filled, field.gather(0, src_idx), field)

    fields = dict(flags=new_flags, weight=new_w, px=place(p.px),
                  py=place(p.py), pz=place(p.pz))
    for name, v in zip(("vx", "vy", "vz"), (p.vx, p.vy, p.vz)):
        fields[name] = place(v) if name in ("vx", "vy", "vz")[:n_vel] else v
    fields["t"] = place(p.t) if cfg.record_particle_time else p.t

    counters = (
        count.to(f32),
        cull.to(f32).sum(0),
        do_rs.to(f32),
        (dropped & ~filled).to(f32).sum(0),
        (filled & ~valid).to(f32).sum(0),
    )
    return (fields, weight_sum, n_old, tuple(vel_sums), static_contrib,
            moving if with_moving else None, counters)


def pool_pass_cuda(particles, cfg: MapConfig, with_moving: bool = True):
    """Kernel K1 on CUDA tensors; same return tuple as
    :func:`pool_pass_plain`."""
    p = particles
    S, V = p.flags.shape
    if S not in KERNEL_SLOTS:
        raise ValueError(f"occupancy kernel is built for S in {KERNEL_SLOTS}, "
                         f"got S={S}")
    n_vel = _n_vel(cfg)
    names = rewritten_planes(cfg)
    ins = [getattr(p, n) for n in names]
    kernels.check_cuda(*ins, shape=(S, V))
    if p.flags.dtype != torch.int32 or any(
            x.dtype != torch.float32 for x in ins[1:]):
        raise TypeError("occupancy kernel takes int32 flags, float32 planes")
    dev = p.flags.device

    outs = [torch.empty((S, V), dtype=x.dtype, device=dev) for x in ins]
    omoving = (torch.empty((S, V), dtype=torch.bool, device=dev)
               if with_moving else None)
    # weight_sum outlives the step in the returned state, so it is an
    # allocation of its own; the other per-voxel vectors share one
    ws = torch.empty(V, dtype=torch.float32, device=dev)
    rest = torch.empty((7 + n_vel, V), dtype=torch.float32,
                       device=dev).unbind(0)
    aggs, vsum = [ws, *rest[:7]], list(rest[7:])
    kernels.launch("occupancy_pool_pass",
                   ins + outs + [omoving] + aggs + vsum + [None] * (3 - n_vel),
                   (cfg.weight_cull_threshold,),
                   (S, V, n_vel, len(ins), cfg.resample_min_count,
                    cfg.max_particles_per_voxel))
    ws, n_old, static_c, n_valid, n_culled, do_rs, n_dropped, n_filled = aggs
    vsums = vsum + [torch.zeros(V, dtype=torch.float32, device=dev)] * (3 - n_vel)
    fields = {n: getattr(p, n) for n in ("vx", "vy", "vz", "t")}
    fields.update(zip(names, outs))
    return (fields, ws, n_old, tuple(vsums), static_c, omoving,
            (n_valid, n_culled, do_rs, n_dropped, n_filled))


def occupancy_pool_pass(particles, cfg: MapConfig, with_moving: bool = True):
    """Plain version for CPU tensors, kernel K1 for CUDA tensors."""
    if particles.flags.is_cuda:
        return pool_pass_cuda(particles, cfg, with_moving)
    return pool_pass_plain(particles, cfg, with_moving)


def occupancy_and_resample(particles, cfg: MapConfig, origin, future_in,
                           future_movers, shard=None, with_metrics=True):
    """Returns ``(new_particles, weight_sum[V], vel_avg[V, 3], future[T, V],
    stats)``; ``origin`` is the frame block's int32 ``[3]`` or a host
    origin.  ``future_movers = (flat, valid, n_dropped)`` is the
    pre-compacted nonzero-velocity candidate set from
    :func:`~.fov.rebin_and_register`; ``None`` (the noisy-prediction and
    multi-sensor paths) asks the pool pass for its ``[S, V]`` moving mask
    (kernel K1's ``with_moving`` arm on the card) and compacts it to
    ``cfg.mover_capacity`` movers.

    Ends the step's flat mid-frame phase.  The pool pass reads each plane
    it rewrites once and returns a fresh plane of the exact size, so those
    planes reach it as ``[S, V]`` views of their flat working buffers; only
    a flat plane that the pool pass hands through (a constant-zero velocity
    plane) is copied out (``state.unflatten_pool``; kernel K5b for large
    planes).  Either way the returned state holds no working buffer.

    ``shard`` (:class:`~.common.ShardCtx`): the pool pass is per voxel and
    runs on the slab as it is; only the future-status scatter crosses slabs
    (a moving particle's predicted cell can lie anywhere), so the compacted
    mover columns are gathered from every rank and each rank scatters the
    contributions whose cell it owns.

    Without ``with_metrics`` ``stats`` holds ``alive`` alone, and the other
    counters are not summed."""
    particles = unflatten_pool(particles, cfg.slots_per_voxel,
                               views=rewritten_planes(cfg))
    S, V = particles.flags.shape
    T = cfg.n_horizons
    dev = particles.flags.device

    (fields, weight_sum, n_old, vel_sums, static_contrib, moving,
     counters) = occupancy_pool_pass(particles, cfg,
                                     with_moving=future_movers is None)
    new_particles = dataclasses.replace(particles, **fields)

    denom = n_old.clamp(min=1.0)
    vel_avg = torch.stack([s / denom for s in vel_sums], dim=-1) * (
        n_old > 0)[:, None]

    # ---- future-status prediction (dsp_dynamic.h:950-964) --------------
    future = future_in + static_contrib[None, :]
    src = particles  # pre-resample planes, as in the JAX package
    if future_movers is not None:
        fm_flat, fm_ok, fm_dropped = future_movers
        idx = fm_flat.clamp(max=S * V - 1)
        fl = pool_take(src.flags, idx)
        wgt = pool_take(src.weight, idx)
        sel = (fm_ok & (fl != 0) & (fl != 3)
               & (wgt >= cfg.weight_cull_threshold))
        n_moving = sel.sum() if with_metrics else None
    else:
        idx, sel, n_moving, fm_dropped = compact_mask(moving,
                                                      cfg.mover_capacity)
        wgt = pool_take(src.weight, idx)
    m = [pool_take(getattr(src, n), idx)
         for n in ("px", "py", "pz", "vx", "vy", "vz")]
    m_w = torch.where(sel, wgt, 0.0)
    if shard is not None:
        *m, m_w, sel = shard.exchange(m + [m_w, sel])

    taus = device_constant(cfg.prediction_horizons, torch.float32,
                           dev)[:, None]
    fx = m[0][None, :] + m[3][None, :] * taus
    fy = m[1][None, :] + m[4][None, :] * taus
    fz = m[2][None, :] + m[5][None, :] * taus
    wx, wy, wz = geometry.world_voxel_planar(fx, fy, fz, cfg)
    ok = sel[None, :] & geometry.in_window_planar(wx, wy, wz, origin, cfg)
    cell = geometry.storage_index_planar(wx, wy, wz, cfg)
    if shard is not None:
        ok = ok & shard.owns(cell, V)
        cell = cell - shard.lo
    hor = V * torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    fidx = torch.where(ok, cell + hor, T * V)
    # duplicate (cell, horizon) hits accumulate, in index order
    future = scatter_add(future.reshape(-1), fidx.reshape(-1),
                         m_w[None, :].expand(T, -1).reshape(-1)).view(T, V)

    n_valid_v, n_culled_v, do_rs_v, n_dropped_v, n_filled_v = counters
    alive = (n_valid_v - n_dropped_v + n_filled_v).sum().to(torch.int32)
    if not with_metrics:
        return new_particles, weight_sum, vel_avg, future, {"alive": alive}
    stats = {
        "alive": alive,
        "culled": n_culled_v.sum().to(torch.int32),
        "resampled_voxels": do_rs_v.sum().to(torch.int32),
        "resample_dropped": n_dropped_v.sum().to(torch.int32),
        "resample_copies": n_filled_v.sum().to(torch.int32),
        "future_moving": n_moving,
        "future_overflow": fm_dropped,
    }
    return new_particles, weight_sum, vel_avg, future, stats
