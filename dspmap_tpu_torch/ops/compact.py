"""The compact layout's particle core (mirrors ``dspmap_tpu/ops/compact.py``;
see its docstring for the semantics): the live population rides one
``[P = cfg.compact_capacity]`` SoA array and every pool pass is O(alive)
work -- sorts, short-run segmented scans and scatter-adds.

The segmented scans are kernel K4 (``csrc/segscan.cu``) on CUDA tensors
and :func:`seg_cumsum_plain` / :func:`fill_from_end_plain` on the CPU, the
same Hillis-Steele recurrence with the same float adds in the same order,
so the two are bit-equal to each other and to the JAX package's
``_seg_cumsum`` / ``_fill_from_end``.  One call is one launch on the
columns where they lie (f32, bool or i32: no stack, no cast), and its
``[C, P]`` result feeds the run-end tables as it is.  Run sums stay
run-local: a global cumsum differenced at run ends moves them by ~3e-4
relative and flips resample boundaries.

Left out, each exact either way: the ``lax.switch`` bucket ladders of
``segment_table`` / ``_ends_table`` (the port compacts run ends at full
width; their ``direct`` branch is taken only when run ends outnumber the
largest bucket) and the prefix-bucket ladder of ``insert_compact``.  The
noisy-prediction arms take their standard-normal draws as arguments
(``noise [3, P]`` for the advance, ``[2, P]`` for the in-FOV jitter).

On a slab of the sharded step each rank's ``[P/n]`` rows hold the particles
of its slab of the grid: :func:`rebin_exchange_compact` keeps that so by
sending the movers that leave the slab to their owner, and the per-voxel
tables of birth and occupancy are slab-local.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import MapConfig
from .. import geometry, kernels
from ..state import FLAG_NEWBORN, FLAG_VALID
from .common import (DROP_ROWS, I32_MAX, add_at, compact_and_group,
                     compact_mask, device_constant, drop_rows, frame_float,
                     frame_floats, scatter_add, scatter_max, scatter_set,
                     sort_by_destination)
from .fov import _bin_candidates, fov_jitter
from .propagate import propagate

#: the largest reach (power of two >= max_run) the K4 kernel takes
KERNEL_MAX_REACH = 512
#: the most columns one K4 launch takes (the kernel's table, ``kMaxCols``)
KERNEL_MAX_COLUMNS = 8
#: the most rows (the kernel indexes rows with 32-bit integers)
KERNEL_MAX_ROWS = 1 << 30
#: the kernel's type code of a column
_COLUMN_TYPES = {torch.float32: 0, torch.bool: 1, torch.uint8: 1,
                 torch.int32: 2}


class CompactSweep(NamedTuple):
    """Per-row outcome of the fused advance/geometry pass."""

    cell: torch.Tensor  # i32 [P] storage cell of the advanced position
    mover: torch.Tensor  # bool [P]: cell changed this frame
    fov: torch.Tensor  # bool [P]: alive & inside & in FOV
    moving: torch.Tensor  # bool [P]: alive & nonzero velocity
    pyr: torch.Tensor  # i32 [P] pyramid cell (garbage where ~fov)
    moved_out: torch.Tensor  # bool [P]: left the window (killed)


def _table(cell, valid, upd: torch.Tensor, n_cells: int) -> torch.Tensor:
    """``zeros[n_cells + 1, C].at[idx].add(upd.T, mode="drop")[:n_cells]``
    for ``upd [C, n]`` as a column-major ``[C, n_cells]`` table (rows of it
    are contiguous).  Duplicate cells add in row order (:func:`add_at`);
    invalid rows land in sentinel columns (:func:`drop_rows`)."""
    idx = drop_rows(torch.where(valid, cell, -1), n_cells)
    out = torch.zeros((upd.shape[0], n_cells + DROP_ROWS),
                      dtype=torch.float32, device=upd.device)
    return add_at(out, idx, upd, dim=1)[:, :n_cells]


def _scatter_add_cols(cell, valid, cols, n_cells):
    """One multi-column scatter-add ``[P] -> C x [n_cells]``."""
    upd = torch.stack([c.to(torch.float32) for c in cols])
    return list(_table(cell, valid, upd, n_cells).unbind(0))


def _reach(max_run: int) -> int:
    r = 1
    while r < max_run:
        r *= 2
    return r


def _shift(x: torch.Tensor, d: int, fill, down: bool) -> torch.Tensor:
    """``x[i - d]`` (``down``) or ``x[i + d]`` along dim 0, ``fill`` where
    that row does not exist."""
    n = x.shape[0]
    pad = torch.full((min(d, n),) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    if d >= n:
        return pad
    return torch.cat([pad, x[:-d]]) if down else torch.cat([x[d:], pad])


def seg_cumsum_plain(x, is_start, max_run: int):
    """Inclusive within-run prefix sums of ``x [P]`` or ``[P, C]``; runs
    start at ``is_start``.  ``ceil(log2(max_run))`` shifted-add steps: live
    runs never exceed ``max_run`` rows."""
    s = x
    b = is_start[:, None].expand(x.shape) if x.dim() == 2 else is_start
    d, R = 1, _reach(max_run)
    while d < R:
        ps = _shift(s, d, 0.0, down=True)
        pb = _shift(b, d, True, down=True)
        s = torch.where(b, s, s + ps)
        b = b | pb
        d *= 2
    return s


def fill_from_end_plain(v, is_end, max_run: int):
    """Each run's END value broadcast backward over the run (reverse
    hold-last-marked segmented scan, the same short-run bound)."""
    s = v
    taken = is_end[:, None].expand(v.shape) if v.dim() == 2 else is_end
    d, R = 1, _reach(max_run)
    while d < R:
        ns = _shift(s, d, 0.0, down=False)
        nt = _shift(taken, d, False, down=False)
        s = torch.where(taken, s, ns)
        taken = taken | nt
        d *= 2
    return s


def _scan_block_plain(cols, is_start, is_end, max_run: int, n_tot: int):
    X = torch.stack([c.to(torch.float32) for c in cols], dim=-1)
    hi = seg_cumsum_plain(X, is_start, max_run)
    tot = (fill_from_end_plain(hi[:, :n_tot], is_end, max_run) if n_tot
           else hi[:, :0])
    return hi.T, tot.T


def _scan_block_cuda(cols, is_start, is_end, max_run: int, n_tot: int):
    """One launch of kernel K4 on the columns where they lie: the kernel
    takes a table of column pointers with a type code each and reads bool
    and i32 columns as f32 itself (exactly the plain version's
    ``.to(float32)``).  ``hi [C, P]`` and ``tot [n_tot, P]`` are two views
    of one allocation."""
    R = _reach(max_run)
    if R > KERNEL_MAX_REACH:
        raise ValueError(f"segscan kernel takes reach <= {KERNEL_MAX_REACH}, "
                         f"got {R} (max_run {max_run})")
    C = len(cols)
    if not 1 <= C <= KERNEL_MAX_COLUMNS:
        raise ValueError(f"segscan kernel takes 1..{KERNEL_MAX_COLUMNS} "
                         f"columns, got {C}")
    if not 0 <= n_tot <= C:
        raise ValueError(f"n_tot {n_tot} outside [0, {C}]")
    if is_start.dtype != torch.bool or is_end.dtype != torch.bool:
        raise TypeError("segscan flags must be bool")
    try:
        types = [_COLUMN_TYPES[c.dtype] for c in cols]
    except KeyError as e:
        raise TypeError(f"segscan columns are f32, bool, u8 or i32, "
                        f"got {e.args[0]}") from None
    P = cols[0].shape[0]
    if not 1 <= P <= KERNEL_MAX_ROWS:
        raise ValueError(f"segscan kernel takes 1..{KERNEL_MAX_ROWS} rows, "
                         f"got {P}")
    kernels.check_cuda(*cols, is_start, is_end, shape=(P,))
    out = torch.empty((C + n_tot, P), dtype=torch.float32,
                      device=cols[0].device)
    kernels.launch("seg_scans", [*cols, is_start, is_end, out], (),
                   (C, P, n_tot, R, *types))
    return out[:C], out[C:]


def seg_scans(cols, is_start, is_end, max_run: int, n_tot: int):
    """``(hi [C, P], tot [n_tot, P])``: the segmented scan pair, one row a
    column of ``cols`` (``tot`` for the first ``n_tot``) -- plain version
    for CPU tensors, kernel K4 for CUDA ones.  Columns are ``[P]`` tensors
    of f32, bool, u8 or i32, read as f32; on the card each must be
    contiguous (the kernel reads them where they lie)."""
    block = _scan_block_cuda if cols[0].is_cuda else _scan_block_plain
    return block(cols, is_start, is_end, max_run, n_tot)


def seg_scans_plain(cols, is_start, is_end, max_run: int, n_tot: int):
    """Plain version of :func:`seg_scans`, as lists of ``[P]`` columns."""
    hi, tot = _scan_block_plain(cols, is_start, is_end, max_run, n_tot)
    return list(hi.unbind(0)), list(tot.unbind(0))


def seg_scans_cuda(cols, is_start, is_end, max_run: int, n_tot: int):
    """Kernel K4 on CUDA tensors, as lists of ``[P]`` columns."""
    hi, tot = _scan_block_cuda(cols, is_start, is_end, max_run, n_tot)
    return list(hi.unbind(0)), list(tot.unbind(0))


def _run_bounds(key):
    """``(starts, ends)`` of the maximal runs of equal ``key``."""
    ne = key[1:] != key[:-1]
    one = torch.ones(1, dtype=torch.bool, device=key.device)
    return torch.cat([one, ne]), torch.cat([ne, one])


def _ends_table(cums, key, is_end, n_cells):
    """Per-run totals (``cums [C, P]`` = segmented cumsums, read at run
    ends) scatter-added into a ``[C, n_cells]`` table: run ends compacted
    first-to-last at full width, as the JAX package's bucketed branch."""
    e_i, e_ok, _, _ = compact_mask(is_end, key.shape[0])
    e_i = e_i.to(torch.int64)
    return _table(key[e_i], e_ok, cums[:, e_i], n_cells)


def segment_table(cell, valid, cols, n_cells, max_run: int = 64):
    """Per-cell sums of ``cols`` (``C x [n_cells]``), exact for any row
    order: maximal equal-key runs are summed run-locally by the segmented
    scan and their ends scatter-added."""
    key = torch.where(valid, cell.to(torch.int32), n_cells)
    prv, nxt = _run_bounds(key)
    is_end = nxt & (key < n_cells)
    zero = torch.zeros((), dtype=torch.float32, device=key.device)
    masked = [c & valid if c.dtype == torch.bool
              else torch.where(valid, c.to(torch.float32), zero) for c in cols]
    hi, _ = seg_scans(masked, prv, nxt, max_run, 0)
    return list(_ends_table(hi, key, is_end, n_cells).unbind(0))


def sweep_compact(particles, cfg: MapConfig, dt, origin, sensor_pos,
                  quat=None, noise=None, rt=None, *, R=None):
    """Prediction advance + window test + cell/pyramid geometry, one [P]
    pass.  Returns ``(new_particles, CompactSweep)``.  The frame's values
    are the frame block's tensors (its rotation as ``R=``) or host
    values, as ``ops/sweep.py::sweep_reference`` takes them.  The velocity
    noise follows ``ops/propagate.py`` (``noise [3, P]`` on the noisy arm,
    none under limit-xy; the static model does not advance)."""
    valid = particles.valid
    vx, vy, vz = particles.vx, particles.vy, particles.vz
    dt = frame_float(dt)
    if cfg.motion_model == "static":
        px, py, pz = particles.px, particles.py, particles.pz
    elif cfg.limit_motion_to_xy_plane:
        px = torch.where(valid, particles.px + vx * dt, particles.px)
        py = torch.where(valid, particles.py + vy * dt, particles.py)
        pz = torch.where(valid, particles.pz + vz * dt, particles.pz)
    else:
        adv = propagate(particles, cfg, noise, dt, rt)
        px, py, pz, vx, vy, vz = (adv.px, adv.py, adv.pz, adv.vx, adv.vy,
                                  adv.vz)

    wx, wy, wz = geometry.world_voxel_planar(px, py, pz, cfg)
    inside = geometry.in_window_planar(wx, wy, wz, origin, cfg)
    moved_out = valid & ~inside
    alive = valid & inside
    flags = torch.where(moved_out, 0, particles.flags).to(torch.int32)

    new_cell = geometry.storage_index_planar(wx, wy, wz, cfg)
    owx, owy, owz = geometry.world_voxel_planar(particles.px, particles.py,
                                                particles.pz, cfg)
    cur_cell = geometry.storage_index_planar(owx, owy, owz, cfg)
    mover = alive & (new_cell != cur_cell)

    s = frame_floats(sensor_pos)
    sx, sy, sz = geometry.rotate_planar(geometry.frame_rotation(quat, R),
                                        px - s[0], py - s[1], pz - s[2])
    pyr, in_fov = geometry.pyramid_index_planar(sx, sy, sz, cfg)
    fov = alive & in_fov
    moving = alive & ((vx != 0.0) | (vy != 0.0) | (vz != 0.0))

    new_particles = dataclasses.replace(particles, px=px, py=py, pz=pz,
                                        vx=vx, vy=vy, vz=vz, flags=flags)
    sw = CompactSweep(
        cell=torch.where(alive, new_cell, cfg.storage_voxels).to(torch.int32),
        mover=mover, fov=fov, moving=moving, pyr=pyr.to(torch.int32),
        moved_out=moved_out)
    return new_particles, sw


def rebin_compact(particles, sw: CompactSweep, cfg: MapConfig,
                  with_metrics=True):
    """Voxel capacity for relocated particles: movers rank behind their
    destination voxel's stayers and die at rank >= S; movers beyond
    ``cfg.mover_capacity`` die.  Returns ``(new_particles, stay_count[Vs],
    stats)``; ``stats`` is empty without ``with_metrics``."""
    S, Vs, m_cap = cfg.slots_per_voxel, cfg.storage_voxels, cfg.mover_capacity
    P = particles.flags.shape[0]
    alive = particles.flags != 0

    stayer = alive & ~sw.mover & (sw.cell < Vs)
    (stay_count,) = segment_table(sw.cell, stayer, (stayer,), Vs, max_run=S)

    mover = sw.mover & alive
    m_rank = torch.cumsum(mover, 0, dtype=torch.int32) - 1
    over_kill = mover & (m_rank >= m_cap)
    mover_in = mover & ~over_kill

    m_i, m_ok, n_mov, _ = compact_mask(mover_in, m_cap)
    m_i = m_i.to(torch.int64)
    m_cell = torch.where(m_ok, sw.cell[m_i], Vs)
    order, sorted_cell, ranks = sort_by_destination(m_cell, m_ok)
    cell_safe = sorted_cell.clamp(max=Vs - 1).to(torch.int64)
    kill_sorted = (sorted_cell < Vs) & (
        stay_count[cell_safe].to(torch.int32) + ranks >= S)
    kill_rows = torch.where(kill_sorted, m_i[order.to(torch.int64)], P)
    flags = torch.where(over_kill, 0, particles.flags).to(torch.int32)
    flags = scatter_set(flags, kill_rows, 0)

    stats = {
        "moved_out": sw.moved_out.sum(),
        "movers": n_mov.clamp(max=m_cap),
        "mover_overflow_killed": over_kill.sum(),
        "voxel_full_killed": kill_sorted.sum(),
    } if with_metrics else {}
    return dataclasses.replace(particles, flags=flags), stay_count, stats


def rebin_exchange_compact(particles, sw: CompactSweep, cfg: MapConfig,
                           shard, with_metrics=True):
    """The sharded relocation of the compact layout: movers within the slab
    are capacity-checked in place (:func:`rebin_compact`'s rule); movers
    that leave it vacate their row and ride an exchange of the compacted
    mover payload (``all_gather``, or the ring of ``cfg.ring_hops``
    neighbours), and the owning rank lands them in free rows behind its
    stayers' and surviving within-movers' claims, in shard-major order.

    As in the JAX package (``ops/compact.py``), the payload leaves the
    ``t`` plane out: under ``record_particle_time`` an arrival keeps the
    ``t`` its free row held (a defect of the reference kept here).
    Returns ``(new_particles, stats)``; ``stats`` is empty without
    ``with_metrics``."""
    P = particles.flags.shape[0]
    S, m_cap = cfg.slots_per_voxel, cfg.mover_capacity
    Vs = cfg.storage_voxels
    v_local = Vs // shard.n_shards
    alive = particles.flags != 0
    own = shard.owns(sw.cell, v_local)

    mover = sw.mover & alive
    within = mover & own
    cross = mover & ~own & (sw.cell < Vs)

    stayer = alive & ~sw.mover
    (stay_count,) = segment_table(sw.cell - shard.lo, stayer, (stayer,),
                                  v_local, max_run=S)

    # within-slab capacity check (strict, as in rebin_compact)
    w_rank = torch.cumsum(within, 0, dtype=torch.int32) - 1
    w_overkill = within & (w_rank >= m_cap)
    within = within & ~w_overkill
    w_i, w_ok, n_w, _ = compact_mask(within, m_cap)
    w_i = w_i.to(torch.int64)
    w_cell = torch.where(w_ok, sw.cell[w_i] - shard.lo, v_local)
    order_w, sc_w, ranks_w = sort_by_destination(w_cell, w_ok)
    sc_safe = sc_w.clamp(max=v_local - 1).to(torch.int64)
    kill_w = (sc_w < v_local) & (
        stay_count[sc_safe].to(torch.int32) + ranks_w >= S)
    kill_rows = torch.where(kill_w, w_i[order_w.to(torch.int64)], P)

    # cross-slab movers: vacate and exchange the payload
    c_rank = torch.cumsum(cross, 0, dtype=torch.int32) - 1
    c_overkill = cross & (c_rank >= m_cap)
    cross = cross & ~c_overkill
    c_i, c_ok, n_c, _ = compact_mask(cross, m_cap)
    c_i = c_i.to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=c_i.device)
    exp = [torch.where(c_ok, sw.cell[c_i], Vs)]
    exp += [getattr(particles, n)[c_i]
            for n in ("px", "py", "pz", "vx", "vy", "vz")]
    exp += [torch.where(c_ok, particles.weight[c_i], zero), c_ok]
    flags = torch.where(cross | c_overkill | w_overkill, 0,
                        particles.flags).to(torch.int32)
    flags = scatter_set(flags, kill_rows, 0)

    hops, ring_undelivered = None, 0
    if cfg.mover_exchange == "ring":
        hops = cfg.ring_hops
        if with_metrics:
            reach = shard.ring_reachable(exp[0].clamp(min=0), v_local, hops)
            ring_undelivered = (c_ok & ~reach).sum()
    a_cell, *a_pay, a_ok = shard.exchange(exp, hops)
    own_arr = a_ok & shard.owns(a_cell, v_local)

    # land arrivals behind stayers + surviving within-movers
    w_keep = (sc_w < v_local) & ~kill_w
    count_after = scatter_add(stay_count.to(torch.int32),
                              torch.where(w_keep, sc_w, v_local), 1)
    o_i, o_ok, n_own, o_over = compact_mask(own_arr, m_cap)
    o_i = o_i.to(torch.int64)
    cell_l = torch.where(o_ok, a_cell[o_i] - shard.lo, v_local)
    order_a, sc_a, r_a = sort_by_destination(cell_l, o_ok)
    room = (S - count_after[sc_a.clamp(max=v_local - 1).to(torch.int64)]
            ).clamp(min=0)
    eligible = (sc_a < v_local) & (r_a < room)
    free_rows, _, n_free, _ = compact_mask(flags == 0, m_cap)
    elig_rank = torch.cumsum(eligible, 0, dtype=torch.int32) - 1
    land = eligible & (elig_rank < n_free)
    row = torch.where(land, free_rows[elig_rank.clamp(0, m_cap - 1).to(
        torch.int64)], P)
    src = o_i[order_a.to(torch.int64)]

    new = {n: scatter_set(getattr(particles, n), row, c[src])
           for n, c in zip(("px", "py", "pz", "vx", "vy", "vz", "weight"),
                           a_pay)}
    new["flags"] = scatter_set(
        flags, row, torch.where(land, FLAG_VALID, 0).to(torch.int32))
    stats = {
        "moved_out": sw.moved_out.sum(),
        "movers": n_w + n_c,
        "mover_overflow_killed": (w_overkill.sum() + c_overkill.sum() + o_over
                                  + ring_undelivered),
        "voxel_full_killed": kill_w.sum() + (n_own - land.sum()),
    } if with_metrics else {}
    return dataclasses.replace(particles, **new), stats


def fov_geometry_compact(particles, cfg: MapConfig, sensor_pos, quat=None,
                         *, R=None):
    """``(pyramid cell [P], in-FOV mask [P])`` of the compact set for one
    sensor pose (the frame block's ``sensor_pos`` and ``R=``, or host
    arrays and the wxyz quaternion ``quat``): the per-sensor half of
    :func:`sweep_compact`'s geometry, for the multi-sensor step."""
    s = frame_floats(sensor_pos)
    sx, sy, sz = geometry.rotate_planar(geometry.frame_rotation(quat, R),
                                        particles.px - s[0],
                                        particles.py - s[1],
                                        particles.pz - s[2])
    pyr, in_fov = geometry.pyramid_index_planar(sx, sy, sz, cfg)
    return pyr.to(torch.int32), particles.valid & in_fov


def register_fov_compact(particles, cfg: MapConfig, pyr, fov_mask,
                         sensor_pos, noise=None, rt=None, with_metrics=True):
    """FOV registration over the compact set: compaction + pyramid grouping,
    the rank kill beyond the per-cell capacity and the dense + spill
    binning (``FovBinning.slot`` holds compact rows, sentinel ``P``), then
    the in-FOV velocity jitter of the noisy arm (``noise [2, P]``; see
    ``ops/fov.py::fov_jitter``).  Returns ``(new_particles, fovbin,
    stats)``; ``stats`` is empty without ``with_metrics``."""
    P = particles.flags.shape[0]
    fov_alive = fov_mask & (particles.flags != 0)
    idx, cand_pyr, ranks, sel_valid, _ = compact_and_group(
        fov_alive, pyr, cfg.fov_buffer_capacity, cfg.n_pyramids)
    i64 = idx.to(torch.int64)
    cols = (particles.px[i64], particles.py[i64], particles.pz[i64],
            particles.weight[i64])
    fovbin, kill, stats = _bin_candidates(
        cfg, P, sensor_pos, idx, cand_pyr, ranks, sel_valid,
        fov_alive.sum() if with_metrics else None, cols, with_metrics)
    flags = scatter_set(particles.flags, torch.where(kill, idx, P), 0)
    vx, vy, vz = fov_jitter(particles, cfg, fov_alive & (flags != 0), noise,
                            rt)
    return (dataclasses.replace(particles, flags=flags, vx=vx, vy=vy, vz=vz),
            fovbin, stats)


def insert_compact(particles, cfg: MapConfig, *, pos, vel, weight, valid,
                   origin, flag, t, count_v, shard=None):
    """Capacity-limited insertion into free rows (``addAParticle``): the
    candidates rank per destination voxel in arrival order and are eligible
    while ``rank < S - count_v[dest]``; eligible ones land in free rows
    first-to-last, the rest of them are dropped and counted.  Returns
    ``(new_particles, n_born, n_dropped)``.  With ``shard`` the candidates
    whose voxel this rank does not own are left to their owner, and
    ``count_v`` is the slab's table."""
    P = particles.flags.shape[0]
    S = cfg.slots_per_voxel
    Vs = count_v.shape[0]
    M = pos.shape[0]

    wv = geometry.world_voxel(pos, cfg)
    valid = valid & geometry.in_window(wv, origin, cfg)
    dest = geometry.storage_index(wv, cfg)
    if shard is not None:
        valid = valid & shard.owns(dest, Vs)
        dest = (dest - shard.lo).clamp(0, Vs - 1)
    order, sorted_dest, ranks = sort_by_destination(dest, valid)
    prefilter = (sorted_dest < I32_MAX) & (ranks < S)

    c_pos, c_ok, _, _ = compact_mask(prefilter, M)
    c_pos = c_pos.to(torch.int64)
    dest_c = sorted_dest[c_pos].clamp(max=Vs - 1).to(torch.int64)
    free_cap = (S - count_v[dest_c].to(torch.int32)).clamp(min=0)
    eligible = c_ok & (ranks[c_pos] < free_cap)
    free_rows, _, n_free, _ = compact_mask(particles.flags == 0, M)
    elig_rank = torch.cumsum(eligible, 0, dtype=torch.int32) - 1
    land = eligible & (elig_rank < n_free)
    row = torch.where(land, free_rows[elig_rank.clamp(0, M - 1).to(
        torch.int64)], P)
    src = order[c_pos].to(torch.int64)
    pay = torch.cat([pos, vel, weight[:, None]], dim=1)[src]  # [M, 7]

    def put(plane, vals):
        return scatter_set(plane, row, vals)

    new = dict(flags=put(particles.flags, flag))
    for k, name in enumerate(("px", "py", "pz", "vx", "vy", "vz", "weight")):
        new[name] = put(getattr(particles, name), pay[:, k])
    if t is not None:
        new["t"] = put(particles.t, frame_float(t))
    n_landed = land.sum()
    return (dataclasses.replace(particles, **new), n_landed,
            eligible.sum() - n_landed)


def occupancy_compact(particles, cfg: MapConfig, origin, future_in,
                      shard=None, with_metrics=True):
    """Cull + per-voxel aggregates + future scatter + systematic resampling
    over the compact set.  One stable sort by cell defragments the array
    (dead rows sort to the tail) and the output IS that sorted view, with
    resample copies placed in the dropped holes.  Returns
    ``(new_particles, weight_sum[Vs], vel_avg[Vs, 3], future[T, Vs],
    stats)``.

    ``shard``: the rows and tables are the slab's (``Vs`` is the slab's
    width, cells are local); the future-status movers are gathered from
    every rank and each rank scatters the contributions whose cell it
    owns.  Without ``with_metrics`` ``stats`` holds ``alive`` alone, and
    the other counters are not summed."""
    P = particles.flags.shape[0]
    S = cfg.slots_per_voxel
    T, Vs = future_in.shape
    m_cap = cfg.mover_capacity
    with_t = bool(cfg.record_particle_time)
    dev = particles.flags.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)

    w = particles.weight
    valid_in = particles.valid
    culled = valid_in & (w < cfg.weight_cull_threshold)
    valid = valid_in & ~culled
    newborn = valid & (particles.flags == FLAG_NEWBORN)
    old = valid & ~newborn
    moving = old & ((particles.vx != 0.0) | (particles.vy != 0.0)
                    | (particles.vz != 0.0))
    wx, wy, wz = geometry.world_voxel_planar(particles.px, particles.py,
                                             particles.pz, cfg)
    cell = geometry.storage_index_planar(wx, wy, wz, cfg) - (
        0 if shard is None else shard.lo)

    # ---- future-status movers (pre-resample weights) -------------------
    m_i, m_ok, n_moving, fm_over = compact_mask(moving, m_cap)
    m_i = m_i.to(torch.int64)
    m = [getattr(particles, n)[m_i] for n in ("px", "py", "pz", "vx", "vy",
                                               "vz")]
    m_w = torch.where(m_ok, w[m_i], zero)
    if shard is not None:
        *m, m_w, m_ok = shard.exchange(m + [m_w, m_ok])

    # ---- the sort (defrag): valid rows first, grouped by cell ----------
    key = torch.where(valid, cell, I32_MAX).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    pay_cols = [particles.px, particles.py, particles.pz, particles.vx,
                particles.vy, particles.vz, w, newborn.to(f32)]
    if with_t:
        pay_cols.append(particles.t)
    spay = torch.stack(pay_cols, dim=-1)[order]  # [P, F]
    valid_s = sorted_key < I32_MAX
    cell_s = torch.where(valid_s, sorted_key, Vs)
    w_s = torch.where(valid_s, spay[:, 6], zero)
    nb_s = valid_s & (spay[:, 7] > 0.0)
    old_s = valid_s & ~nb_s
    mv_s = old_s & ((spay[:, 3] != 0.0) | (spay[:, 4] != 0.0)
                    | (spay[:, 5] != 0.0))

    # ---- run boundaries (sorted: one run per occupied voxel) -----------
    is_start, is_end = _run_bounds(sorted_key)
    is_end = is_end & valid_s

    # one segmented-scan set feeds the per-voxel table (read at run ends)
    # and the resample walk (per-row prefixes)
    cols7 = [valid_s, w_s, old_s,
             torch.where(old_s, spay[:, 3], zero),
             torch.where(old_s, spay[:, 4], zero),
             torch.where(old_s, spay[:, 5], zero),
             torch.where(old_s & ~mv_s, w_s, zero)]
    hi7, (tot_n, tot_w) = seg_scans(cols7, is_start, is_end, 2 * S, 2)
    hi_w = hi7[1]
    weight_sum, n_old, svx, svy, svz, static_contrib = _ends_table(
        hi7[1:], cell_s, is_end, Vs).unbind(0)
    denom = n_old.clamp(min=1.0)
    vel_avg = torch.stack([svx / denom, svy / denom, svz / denom],
                          dim=-1) * (n_old > 0)[:, None]

    # ---- future grid ---------------------------------------------------
    future = future_in + static_contrib[None, :]
    taus = device_constant(cfg.prediction_horizons, f32, dev)[:, None]
    fx = m[0][None, :] + m[3][None, :] * taus
    fy = m[1][None, :] + m[4][None, :] * taus
    fz = m[2][None, :] + m[5][None, :] * taus
    fwx, fwy, fwz = geometry.world_voxel_planar(fx, fy, fz, cfg)
    ok = m_ok[None, :] & geometry.in_window_planar(fwx, fwy, fwz, origin, cfg)
    fcell = geometry.storage_index_planar(fwx, fwy, fwz, cfg)
    if shard is not None:
        ok = ok & shard.owns(fcell, Vs)
        fcell = fcell - shard.lo
    hor = Vs * torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    fidx = torch.where(ok, fcell + hor, T * Vs)
    future = scatter_add(future.reshape(-1), fidx.reshape(-1),
                         m_w[None, :].expand(T, -1).reshape(-1)).view(T, Vs)

    # ---- systematic resampling on run scans ----------------------------
    do_rs = valid_s & (tot_n >= cfg.resample_min_count)
    n_target = tot_n.clamp(max=float(cfg.max_particles_per_voxel))
    wa = torch.where(do_rs, tot_w / n_target.clamp(min=1.0), 1.0)
    lo = hi_w - w_s

    def n_grid(x):  # grid points wa*(k+1/2) strictly below x
        return torch.ceil(x / wa - 0.5).clamp(min=0.0).to(torch.int32)

    copies = torch.where(do_rs, n_grid(hi_w) - n_grid(lo), 0)
    kept = do_rs & (copies >= 1)
    dropped = do_rs & (copies == 0)
    extra = (copies - 1).clamp(min=0)
    survivor = valid_s & ~dropped

    (_, hi_e), (tot_d, _) = seg_scans([dropped, extra], is_start, is_end,
                                      2 * S, 2)
    demand_start = hi_e - extra
    total_free = (S - tot_n + tot_d).clamp(min=0.0)
    placed = torch.minimum((total_free - demand_start).to(torch.int32)
                           .clamp(min=0), extra)
    unplaced = (extra - placed).to(f32)
    new_w = torch.where(kept, wa * (1.0 + unplaced), w_s)

    # ---- in-place output on the sorted view ----------------------------
    n_surv = survivor.sum()
    flags_out = survivor.to(torch.int32)  # FLAG_VALID where it survives
    pay_out = spay.clone()
    pay_out[:, 6] = torch.where(survivor, new_w, zero)

    # resample copies into the dropped holes: one small scatter
    copy_cap = min(m_cap, P)
    copy_start = torch.cumsum(placed, 0, dtype=torch.int32) - placed
    n_copies = placed.sum()
    cp_i, cp_ok, _, _ = compact_mask(placed > 0, copy_cap)
    src0 = scatter_max(
        torch.zeros(copy_cap, dtype=torch.int32, device=dev),
        torch.where(cp_ok, copy_start[cp_i.to(torch.int64)], copy_cap), cp_i)
    src_fill = torch.cummax(src0, 0).values.to(torch.int64)
    hole_i, _, n_holes, _ = compact_mask(~survivor, copy_cap)
    k = torch.arange(copy_cap, dtype=torch.int32, device=dev)
    n_placed = torch.minimum(n_copies, n_holes)  # n_holes <= copy_cap
    target = torch.where(k < n_placed, hole_i, P)
    crow = pay_out[src_fill]  # [copy_cap, F]
    crow[:, 6] = wa[src_fill]
    pay_out = scatter_set(pay_out, target, crow)
    flags_out = scatter_set(flags_out, target, FLAG_VALID)

    planes = pay_out.T.contiguous()  # [F, P]: contiguous rows
    new_particles = dataclasses.replace(
        particles, flags=flags_out, px=planes[0], py=planes[1],
        pz=planes[2], vx=planes[3], vy=planes[4], vz=planes[5],
        weight=planes[6], t=planes[8] if with_t else particles.t)

    if not with_metrics:
        return (new_particles, weight_sum, vel_avg, future,
                {"alive": n_surv + n_placed})
    stats = {
        "alive": n_surv + n_placed,
        "culled": culled.sum(),
        "resampled_voxels": (is_end & do_rs).sum(),
        "resample_dropped": dropped.sum(),
        "resample_copies": n_placed,
        "pool_overflow": n_copies - n_placed,
        "future_moving": n_moving.clamp(max=m_cap),
        "future_overflow": fm_over,
    }
    return new_particles, weight_sum, vel_avg, future, stats
