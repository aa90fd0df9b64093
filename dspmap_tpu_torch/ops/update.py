"""SMC-PHD measurement update (mirrors ``dspmap_tpu/ops/update.py``; see its
docstring for the math and the two-tier layout).

The pdf constant is ``(1/sqrt(pi))^3`` with no ``1/sigma`` (the
reference's ``standardNormalPDF`` quirk, ``dsp_dynamic.h:1282-1301``).

The dense x dense block of each pass -- the pair sums over ``[n_pyr, S_t]``
particles x ``[n_pyr, CK]`` neighbourhood points -- is kernel K3
(``csrc/update.cu``: both passes share one pair term and sum in a fixed
order without atomics, so a call gives the same bits every time) on CUDA
tensors; its plain version
(:func:`update_pass1_plain` / :func:`update_pass2_plain`) is the JAX
package's XLA formulation (``|a|^2 + |b|^2 - 2ab`` with a clamp).  The
spill particles' pair sums (the JAX package's blocks B2 and B4:
:func:`spill_pass1` / :func:`spill_pass2`) are kernels of the same source
on CUDA tensors, bounded by the spill particles that are there; their
plain versions, padded to the spill capacity, run on the CPU.  The spill
points' block against the dense particles (B3) and the one-hot reductions
are plain PyTorch on every device; the float32 matmuls run in full float32
(``ops.common.full_f32_matmul``).
The dense tile is evaluated unchunked (the JAX package's ``lax.map``
chunking bounds TPU memory; at the flagship size one chunk is all it
uses).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import MapConfig
from .. import kernels
from .common import (device_constant, div_frame, frame_float,
                     full_f32_matmul, pool_put)

REF_PDF_CONST = 1.0 / math.sqrt(math.pi)


def _offsets(cfg: MapConfig):
    n = cfg.pyramid_neighbor_radius
    return [(dh, dv) for dh in range(-n, n + 1) for dv in range(-n, n + 1)]


def gather_neighbors(x: torch.Tensor, cfg: MapConfig, fill) -> torch.Tensor:
    """``[n_pyr, K, ...] -> [n_pyr, C*K, ...]``: per-cell copies of the
    (2N+1)^2 neighbouring cells' entries, grid-clipped with ``fill``."""
    H, W, n = cfg.n_pyramids_h, cfg.n_pyramids_v, cfg.pyramid_neighbor_radius
    K, trailing = x.shape[1], tuple(x.shape[2:])
    padded = torch.full((H + 2 * n, W + 2 * n, K) + trailing, fill,
                        dtype=x.dtype, device=x.device)
    padded[n:n + H, n:n + W] = x.reshape((H, W, K) + trailing)
    parts = [padded[n + dh:n + dh + H, n + dv:n + dv + W]
             for dh, dv in _offsets(cfg)]
    return torch.stack(parts, dim=2).reshape((H * W, len(parts) * K) + trailing)


def scatter_neighbor_sum(contrib: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Inverse of :func:`gather_neighbors` for additive reductions."""
    H, W, n = cfg.n_pyramids_h, cfg.n_pyramids_v, cfg.pyramid_neighbor_radius
    offs = _offsets(cfg)
    K = contrib.shape[1] // len(offs)
    cg = contrib.reshape(H, W, len(offs), K)
    total = torch.zeros((H, W, K), dtype=contrib.dtype, device=contrib.device)
    for c, (dh, dv) in enumerate(offs):
        padded = torch.zeros((H + 2 * n, W + 2 * n, K), dtype=contrib.dtype,
                             device=contrib.device)
        padded[n:n + H, n:n + W] = cg[:, :, c]
        total = total + padded[n - dh:n - dh + H, n - dv:n - dv + W]
    return total.reshape(H * W, K)


def neighbor_cells(pyr: torch.Tensor, cfg: MapConfig):
    """``[M]`` pyramid ids -> ``([M, C] neighbour ids, [M, C] valid)``."""
    W, H = cfg.n_pyramids_v, cfg.n_pyramids_h
    offs = _offsets(cfg)
    dh = device_constant([o[0] for o in offs], torch.int32, pyr.device)
    dv = device_constant([o[1] for o in offs], torch.int32, pyr.device)
    nh = (pyr // W)[:, None] + dh[None, :]
    nv = (pyr % W)[:, None] + dv[None, :]
    ok = (nh >= 0) & (nh < H) & (nv >= 0) & (nv < W)
    return torch.where(ok, nh * W + nv, 0), ok


def _pair_g(ppos: torch.Tensor, pts: torch.Tensor, sigma):
    """``g`` for ppos ``[B, S, 3]`` x pts ``[B, M, 3]`` -> ``[B, S, M]``;
    ``sigma`` a 0-d tensor or a host float."""
    a = div_frame(ppos, sigma)
    b = div_frame(pts, sigma)
    d2 = ((a * a).sum(-1)[:, :, None] + (b * b).sum(-1)[:, None, :]
          - 2.0 * torch.bmm(a, b.transpose(1, 2)))
    return (REF_PDF_CONST ** 3) * torch.exp(-0.5 * torch.clamp(d2, min=0.0))


# ------------------------------------------------------- K3: pair passes


def update_pass1_plain(pos, w, nbr_pts, sigma):
    """``C_partial[r, m] = sum_s w[r, s] g(pos[r, s], nbr_pts[r, m])``."""
    g = _pair_g(pos, nbr_pts, sigma)
    return torch.bmm(w[:, None, :], g)[:, 0, :]


def update_pass2_plain(pos, cinv, nbr_pts, sigma):
    """``sum_dense[r, s] = sum_m g(pos[r, s], nbr_pts[r, m]) cinv[r, m]``."""
    g = _pair_g(pos, nbr_pts, sigma)
    return torch.bmm(g, cinv[:, :, None])[:, :, 0]


def _inv_sigma(sigma):
    return (1.0 / sigma if isinstance(sigma, torch.Tensor)
            else float(np.float32(1.0) / np.float32(sigma)))


def prescale_pairs(pos, nbr_pts, sigma):
    """``(pos / sigma, nbr_pts / sigma)`` as contiguous f32 tensors: the
    pair kernels' operands, scaled once for both passes of a frame so that
    sigma never enters the kernel (as the Pallas kernel's caller does).
    ``sigma`` is the frame block's 0-d tensor or a host float."""
    inv = _inv_sigma(sigma)
    return (pos * inv).contiguous(), (nbr_pts * inv).contiguous()


def _pair_cuda(name: str, pos, vec, nbr_pts, sigma, out_cols: int,
               scaled=None):
    rows, st, _ = pos.shape
    ck = nbr_pts.shape[1]
    if pos.dtype != torch.float32 or nbr_pts.dtype != torch.float32:
        raise TypeError("pair kernels take float32 operands")
    if nbr_pts.shape != (rows, ck, 3) or pos.shape[2] != 3:
        raise ValueError(f"bad shapes {tuple(pos.shape)} {tuple(nbr_pts.shape)}")
    if vec.shape != (rows, st if name == "update_pass1" else ck):
        raise ValueError(f"bad row vector shape {tuple(vec.shape)}")
    pos_s, pts_s = scaled or prescale_pairs(pos, nbr_pts, sigma)
    vec = vec.to(torch.float32).contiguous()
    kernels.check_cuda(pos_s, vec, pts_s)
    out = torch.empty((rows, out_cols), dtype=torch.float32, device=pos.device)
    kernels.launch(name, [pos_s, vec, pts_s, out], (), (rows, st, ck))
    return out


def update_pass1(pos, w, nbr_pts, sigma, scaled=None):
    """Pass-1 dense block: kernel K3a on CUDA tensors, plain on the CPU.
    ``scaled`` optionally carries :func:`prescale_pairs` of the same
    operands, shared by both passes."""
    if pos.is_cuda:
        return _pair_cuda("update_pass1", pos, w, nbr_pts, sigma,
                          nbr_pts.shape[1], scaled)
    return update_pass1_plain(pos, w, nbr_pts, sigma)


def update_pass2(pos, cinv, nbr_pts, sigma, scaled=None):
    """Pass-2 dense block: kernel K3b on CUDA tensors, plain on the CPU."""
    if pos.is_cuda:
        return _pair_cuda("update_pass2", pos, cinv, nbr_pts, sigma,
                          pos.shape[1], scaled)
    return update_pass2_plain(pos, cinv, nbr_pts, sigma)


# ------------------------------------------------- the spill tier's pairs


class SpillPairs(NamedTuple):
    """Pass 1's plain pair blocks, which pass 2 reads again."""
    g_pz: torch.Tensor  # [Psp, CK]: each spill particle x its neighbourhood
    g_py: Optional[torch.Tensor]  # [Psp, Yc*Ks], adjacency-masked
    pyr: torch.Tensor  # [Psp] i64 pyramid, clamped into the grid


class SpillScaled(NamedTuple):
    """The spill kernels' operands, scaled by 1/sigma once for both
    passes."""
    pos: torch.Tensor  # [Psp, 3]
    pyr: torch.Tensor  # [Psp] i32
    count: torch.Tensor  # i32: the valid rows, a prefix of the buffer
    pts: torch.Tensor  # [n_pyr, CK, 3]
    cell_pts: Optional[torch.Tensor]  # [Yc, Ks, 3]
    cells: torch.Tensor  # [Yc] i32
    cell_mask: torch.Tensor  # [Yc] u8
    iparams: tuple  # Psp n_pyr CK Yc Ks width radius


def spill_pass1_plain(sp_pos, sp_w, sp_pyr, sp_mask, nbr_pts, cell_pts,
                      cells, cell_mask, cfg: MapConfig, sigma):
    """The spill particles' C(z) partials: ``(c_pyr, c_cell, pairs)`` with
    ``c_pyr[p, m] = sum_{i: sp_pyr[i] = p} sp_w[i] g(sp_pos[i],
    nbr_pts[p, m])`` over the valid rows (B2), and ``c_cell[y, k] =
    sum_{i adjacent to y} sp_w[i] g(sp_pos[i], cell_pts[y, k])`` over the
    valid rows whose pyramid lies within the neighbour radius of the open
    spill cell ``y`` (B4; ``None`` with ``cell_pts`` ``None``, a
    configuration without spill points).  ``pairs`` (:class:`SpillPairs`)
    carries the pair blocks to :func:`spill_pass2_plain`."""
    n_pyr = cfg.n_pyramids
    arange_pyr = torch.arange(n_pyr, dtype=torch.int32, device=sp_pos.device)
    sp_pyr_safe = sp_pyr.clamp(max=n_pyr - 1).to(torch.int64)
    g_pz = _pair_g(sp_pos[:, None, :], nbr_pts[sp_pyr_safe],
                   sigma)[:, 0, :]  # [Psp, CK]
    onehot_p = ((sp_pyr_safe.to(torch.int32)[None, :] == arange_pyr[:, None])
                & sp_mask[None, :])
    c_pyr = onehot_p.to(g_pz.dtype) @ (sp_w[:, None] * g_pz)
    g_py = c_cell = None
    if cell_pts is not None:
        Yc, Ks = cell_pts.shape[:2]
        y_cell_safe = cells.clamp(max=n_pyr - 1)
        W_, n_r = cfg.n_pyramids_v, cfg.pyramid_neighbor_radius
        sp32 = sp_pyr_safe.to(torch.int32)
        dh = sp32[:, None] // W_ - y_cell_safe[None, :] // W_
        dv = sp32[:, None] % W_ - y_cell_safe[None, :] % W_
        adj = ((dh.abs() <= n_r) & (dv.abs() <= n_r)
               & sp_mask[:, None] & cell_mask[None, :])
        g_py = _pair_g(sp_pos[None], cell_pts.reshape(1, Yc * Ks, 3),
                       sigma)[0]
        g_py = g_py * adj.repeat_interleave(Ks, dim=1)  # [Psp, Yc*Ks]
        c_cell = (sp_w @ g_py).reshape(Yc, Ks)
    return c_pyr, c_cell, SpillPairs(g_pz, g_py, sp_pyr_safe)


def spill_pass2_plain(pairs: SpillPairs, nbr_cinv, cell_cinv):
    """The spill particles' weight sums: ``sum_m g(x_i, nbr_pts[p_i, m])
    nbr_cinv[p_i, m]`` plus, with spill points, ``sum_{y adjacent, k}
    g(x_i, cell_pts[y, k]) cell_cinv[y, k]``; ``[Psp]``, meaningful on the
    valid rows."""
    sum_sp = (pairs.g_pz * nbr_cinv[pairs.pyr]).sum(-1)
    if pairs.g_py is not None:
        sum_sp = sum_sp + pairs.g_py @ cell_cinv.reshape(-1)
    return sum_sp


def _spill_pass1_cuda(sp_pos, sp_w, sp_pyr, sp_mask, nbr_pts, cell_pts,
                      cells, cell_mask, cfg: MapConfig, sigma, pts_scaled):
    psp, n_pyr, ck = sp_pos.shape[0], nbr_pts.shape[0], nbr_pts.shape[1]
    if sp_pos.dtype != torch.float32 or nbr_pts.dtype != torch.float32:
        raise TypeError("spill kernels take float32 operands")
    if (sp_pos.shape != (psp, 3) or nbr_pts.shape != (n_pyr, ck, 3)
            or n_pyr != cfg.n_pyramids or sp_w.shape != (psp,)
            or sp_pyr.shape != (psp,) or sp_mask.shape != (psp,)):
        raise ValueError(f"bad spill shapes {tuple(sp_pos.shape)} "
                         f"{tuple(nbr_pts.shape)}")
    inv = _inv_sigma(sigma)
    yc = ks = 0
    cell_s = None
    if cell_pts is not None:
        yc, ks = cell_pts.shape[:2]
        if cell_pts.dtype != torch.float32 or cell_pts.shape != (yc, ks, 3):
            raise ValueError(f"bad spill points {tuple(cell_pts.shape)}")
        cell_s = (cell_pts * inv).contiguous()
    sc = SpillScaled(
        pos=(sp_pos * inv).contiguous(),
        pyr=sp_pyr.to(torch.int32).contiguous(),
        count=sp_mask.sum(dtype=torch.int32),
        pts=(nbr_pts * inv).contiguous() if pts_scaled is None else pts_scaled,
        cell_pts=cell_s, cells=cells.to(torch.int32).contiguous(),
        cell_mask=cell_mask.contiguous().view(torch.uint8),
        iparams=(psp, n_pyr, ck, yc, ks, cfg.n_pyramids_v,
                 cfg.pyramid_neighbor_radius))
    w = sp_w.to(torch.float32).contiguous()
    kernels.check_cuda(sc.pos, w, sc.pyr, sc.count, sc.pts, sc.cells,
                       sc.cell_mask, *([cell_s] if yc else []))
    dev = sp_pos.device
    c_pyr = torch.empty((n_pyr, ck), dtype=torch.float32, device=dev)
    c_cell = (torch.empty((yc, ks), dtype=torch.float32, device=dev)
              if yc else None)
    kernels.launch("spill_pass1", [*_spill_ptrs(sc), w, c_pyr, c_cell], (),
                   sc.iparams)
    return c_pyr, c_cell, sc


def _spill_ptrs(sc: SpillScaled) -> list:
    return [sc.pos, sc.pyr, sc.count, sc.pts, sc.cell_pts, sc.cells,
            sc.cell_mask]


def _spill_pass2_cuda(sc: SpillScaled, nbr_cinv, cell_cinv):
    psp, n_pyr, ck, yc, ks = sc.iparams[:5]
    cinv = nbr_cinv.to(torch.float32).contiguous()
    ccinv = (cell_cinv.to(torch.float32).contiguous() if yc else None)
    kernels.check_cuda(cinv, shape=(n_pyr, ck))
    if yc:
        kernels.check_cuda(ccinv, shape=(yc, ks))
    out = torch.empty(psp, dtype=torch.float32, device=sc.pos.device)
    kernels.launch("spill_pass2", [*_spill_ptrs(sc), cinv, ccinv, out], (),
                   sc.iparams)
    return out


def spill_pass1(sp_pos, sp_w, sp_pyr, sp_mask, nbr_pts, cell_pts, cells,
                cell_mask, cfg: MapConfig, sigma, pts_scaled=None):
    """Pass 1 of the spill tier (see :func:`spill_pass1_plain`): two kernels'
    worth of blocks in one launch on CUDA tensors, whose work is bounded
    by the valid rows -- a prefix of the buffer, as
    ``ops.common.compact_mask`` leaves it -- and the open spill cells;
    plain on the CPU.  ``pts_scaled`` optionally carries ``nbr_pts`` scaled
    by 1/sigma (:func:`prescale_pairs`).  Returns ``(c_pyr, c_cell,
    carry)``, ``carry`` for :func:`spill_pass2`."""
    if sp_pos.is_cuda:
        return _spill_pass1_cuda(sp_pos, sp_w, sp_pyr, sp_mask, nbr_pts,
                                 cell_pts, cells, cell_mask, cfg, sigma,
                                 pts_scaled)
    return spill_pass1_plain(sp_pos, sp_w, sp_pyr, sp_mask, nbr_pts,
                             cell_pts, cells, cell_mask, cfg, sigma)


def spill_pass2(carry, nbr_cinv, cell_cinv):
    """Pass 2 of the spill tier (see :func:`spill_pass2_plain`) from pass
    1's ``carry``: a kernel on CUDA tensors (0 on the rows past the valid
    ones), plain on the CPU."""
    if isinstance(carry, SpillScaled):
        return _spill_pass2_cuda(carry, nbr_cinv, cell_cinv)
    return spill_pass2_plain(carry, nbr_cinv, cell_cinv)


# ------------------------------------------------------ the update stage


@full_f32_matmul()
def measurement_update(particles, fovbin, obs, cfg: MapConfig,
                       expected_newborn: torch.Tensor, update_time, rt,
                       shard=None, with_metrics=True):
    """Returns ``(new_particles, norm_coeff, stats)``; ``rt`` is the
    state's :class:`~dspmap_tpu_torch.state.RuntimeParams` (host floats,
    or the frame block's 0-d tensors) and ``update_time`` a 0-d tensor or
    a host float; ``stats`` is empty without ``with_metrics``.

    ``shard`` (:class:`~.common.ShardCtx`): the C(z) partials of pass 1 and
    of the spill block -- the update's only sums over particles -- are
    summed over the ranks before pass 2 (``all_reduce``), so ``norm_coeff``
    comes out the same on every rank; pass 2 and the weight writeback stay
    on the slab."""
    dev = particles.flags.device
    total = particles.flags.numel()
    n_pyr, S_t = cfg.n_pyramids, cfg.dense_slots
    C = cfg.neighbor_cells
    sigma = frame_float(rt.sigma_ob)
    p_d = frame_float(rt.p_detection)
    one_minus_pd = (1.0 - p_d if isinstance(p_d, torch.Tensor)
                    else float(np.float32(1.0) - np.float32(p_d)))
    e_birth = expected_newborn + frame_float(rt.kappa)
    arange_pyr = torch.arange(n_pyr, dtype=torch.int32, device=dev)

    nbr_pts = gather_neighbors(obs.points, cfg, 0.0)  # [n_pyr, CK, 3]
    nbr_mask = gather_neighbors(obs.mask, cfg, False)  # [n_pyr, CK]
    pw = fovbin.weight * fovbin.mask
    sp_pyr_safe = fovbin.sp_pyr.clamp(max=n_pyr - 1).to(torch.int64)
    y_cell_safe = obs.spill_cells.clamp(max=n_pyr - 1)

    have_psp = cfg.dense_slots < cfg.pyramid_slots
    have_osp = cfg.obs_dense < cfg.max_obs_points_per_pyramid

    if have_osp:
        Yc, Ks = obs.spill_pts_mask.shape
        y_nbr, y_ok = neighbor_cells(y_cell_safe, cfg)  # [Yc, C]
        y_nbr64 = y_nbr.to(torch.int64)
        d_pos = fovbin.pos[y_nbr64]  # [Yc, C, S_t, 3]
        d_w = pw[y_nbr64] * y_ok[:, :, None]
        g_dy = _pair_g(d_pos.reshape(Yc, C * S_t, 3), obs.spill_pts,
                       sigma)  # [Yc, C*S_t, Ks]

    # ---- pass 1: C(z) --------------------------------------------------
    scaled = (prescale_pairs(fovbin.pos, nbr_pts, sigma)
              if fovbin.pos.is_cuda else None)
    c_part = update_pass1(fovbin.pos, pw, nbr_pts, sigma, scaled)
    if have_psp:
        c_pyr, c_cell, sp_carry = spill_pass1(
            fovbin.sp_pos, fovbin.sp_weight * fovbin.sp_mask, fovbin.sp_pyr,
            fovbin.sp_mask, nbr_pts, obs.spill_pts if have_osp else None,
            obs.spill_cells, obs.spill_cell_mask, cfg, sigma,
            scaled[1] if scaled else None)
        c_part = c_part + c_pyr
    if shard is not None:
        c_part = shard.psum(c_part)
    c_grid = scatter_neighbor_sum(c_part, cfg) * p_d + e_birth
    c_grid = torch.where(obs.mask, c_grid, 1.0)

    if have_osp:
        c_sp = torch.bmm(d_w.reshape(Yc, 1, C * S_t), g_dy)[:, 0, :]
        if have_psp:
            c_sp = c_sp + c_cell
        if shard is not None:
            c_sp = shard.psum(c_sp)
        c_spill = torch.where(obs.spill_pts_mask, c_sp * p_d + e_birth, 1.0)

    norm_coeff = torch.where(obs.mask, 1.0 / c_grid, 0.0).sum()
    if have_osp:
        norm_coeff = norm_coeff + torch.where(
            obs.spill_pts_mask, 1.0 / c_spill, 0.0).sum()

    # ---- pass 2: weight factors ---------------------------------------
    nbr_cinv = torch.where(
        nbr_mask, 1.0 / gather_neighbors(c_grid, cfg, 1.0), 0.0)
    sum_dense = update_pass2(fovbin.pos, nbr_cinv, nbr_pts, sigma, scaled)
    if have_osp:
        y_cinv = torch.where(obs.spill_pts_mask, 1.0 / c_spill, 0.0)
        contrib = torch.bmm(g_dy, y_cinv[:, :, None])[:, :, 0]
        contrib = (contrib.reshape(Yc, C, S_t) * y_ok[:, :, None]).reshape(
            Yc * C, S_t)
        onehot_y = ((y_nbr.reshape(-1)[None, :] == arange_pyr[:, None])
                    & (y_ok & obs.spill_cell_mask[:, None]).reshape(-1)[None, :])
        sum_dense = sum_dense + onehot_y.to(contrib.dtype) @ contrib
    factor = one_minus_pd + p_d * sum_dense

    if have_psp:
        sum_sp = spill_pass2(sp_carry, nbr_cinv,
                             y_cinv if have_osp else None)
        factor_sp = one_minus_pd + p_d * sum_sp

    # occlusion: skipped iff the own pyramid has points AND the particle
    # sits beyond their max range + slack (dsp_dynamic.h:759-765)
    mr = obs.max_range[:, None]
    occluded = (mr > 0.0) & (fovbin.rng > mr + cfg.occlusion_slack)
    updated = fovbin.mask & ~occluded
    new_w = torch.where(updated, fovbin.weight * factor, fovbin.weight)

    slot = torch.where(updated, fovbin.slot, total).reshape(-1)
    vals_w = new_w.reshape(-1)
    if have_psp:
        mr_sp = obs.max_range[sp_pyr_safe]
        occ_sp = (mr_sp > 0.0) & (fovbin.sp_rng > mr_sp + cfg.occlusion_slack)
        upd_sp = fovbin.sp_mask & ~occ_sp
        slot = torch.cat([slot, torch.where(upd_sp, fovbin.sp_slot, total)])
        vals_w = torch.cat([vals_w, torch.where(
            upd_sp, fovbin.sp_weight * factor_sp, fovbin.sp_weight)])

    new = {"weight": pool_put(particles.weight, slot, vals_w)}
    if cfg.record_particle_time:
        new["t"] = pool_put(particles.t, slot, frame_float(update_time))
    stats = {}
    if with_metrics:
        n_updated = updated.sum()
        if have_psp:
            n_spilled = upd_sp.sum()
            n_updated = n_updated + n_spilled
        else:
            n_spilled = torch.zeros_like(n_updated)
        stats = {"updated_particles": n_updated,
                 "obs_spill_overflow": obs.spill_overflow,
                 "update_spilled": n_spilled}
    return dataclasses.replace(particles, **new), norm_coeff, stats
