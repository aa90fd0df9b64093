"""Observation ingest: FOV filter and pyramid binning into a dense tier and a
compacted spill tier (mirrors ``dspmap_tpu/ops/project.py``; keep-first
capacity K per pyramid, per-pyramid max range for the occlusion test)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MapConfig
from .. import geometry
from .common import (compact_mask, frame_tensor, scatter_max, scatter_set,
                     segment_counts, sort_by_destination)


class Observation(NamedTuple):
    points: torch.Tensor  # f32 [n_pyr, Ko, 3] world positions (dense tier)
    mask: torch.Tensor  # bool [n_pyr, Ko]
    counts: torch.Tensor  # i32 [n_pyr] (capped at K)
    max_range: torch.Tensor  # f32 [n_pyr]; -1 where empty
    n_valid_points: torch.Tensor  # i32 scalar
    cloud_world: torch.Tensor  # f32 [P, 3]
    cloud_valid: torch.Tensor  # bool [P]
    spill_cells: torch.Tensor  # i32 [Yc]
    spill_cell_mask: torch.Tensor  # bool [Yc]
    spill_pts: torch.Tensor  # f32 [Yc, K-Ko, 3]
    spill_pts_mask: torch.Tensor  # bool [Yc, K-Ko]
    spill_overflow: torch.Tensor  # i32 scalar


def project_points(points_body: torch.Tensor, point_valid: torch.Tensor,
                   sensor_pos, quat, cfg: MapConfig) -> Observation:
    """Bin one frame's body-frame cloud into FOV pyramid cells.
    ``sensor_pos`` / ``quat`` are the frame block's ``[3]`` / ``[4]``
    tensors or host float32 arrays."""
    dev = points_body.device
    n_pyr, K = cfg.n_pyramids, cfg.max_obs_points_per_pyramid
    Ko, Yc = cfg.obs_dense, cfg.obs_spill_capacity

    pyr, in_fov = geometry.pyramid_index(points_body, cfg)
    valid = point_valid & in_fov
    n_valid = valid.sum().to(torch.int32)

    q = frame_tensor(quat, torch.float32, dev)
    s = frame_tensor(sensor_pos, torch.float32, dev)
    world = s + geometry.quaternion_rotate(q, points_body)
    rng = torch.linalg.vector_norm(points_body, dim=-1)

    max_range = scatter_max(
        torch.full((n_pyr,), -1.0, dtype=torch.float32, device=dev),
        torch.where(valid, pyr, n_pyr), torch.where(valid, rng, -1.0))
    counts_all = segment_counts(pyr, valid, n_pyr)

    order, sorted_pyr, ranks = sort_by_destination(pyr, valid)
    world_sorted = world[order.to(torch.int64)]
    in_grid = sorted_pyr < n_pyr
    keep = in_grid & (ranks < Ko)
    slot = torch.where(keep, sorted_pyr * Ko + ranks, n_pyr * Ko)
    grid = scatter_set(torch.zeros((n_pyr * Ko, 3), dtype=torch.float32,
                                   device=dev), slot, world_sorted)
    mask = scatter_set(torch.zeros(n_pyr * Ko, dtype=torch.bool, device=dev),
                       slot, True)

    Ks = K - Ko
    if Ks > 0:
        cell_ids, cell_ok, _, _ = compact_mask(counts_all > Ko, Yc)
        spill_cells = torch.where(cell_ok, cell_ids, n_pyr).to(torch.int32)
        inv = scatter_set(
            torch.full((n_pyr,), Yc, dtype=torch.int32, device=dev),
            spill_cells, torch.arange(Yc, dtype=torch.int32, device=dev))
        sp_sel = in_grid & (ranks >= Ko) & (ranks < K)
        row = torch.where(
            sp_sel, inv[sorted_pyr.clamp(max=n_pyr - 1).to(torch.int64)], Yc)
        tile_slot = torch.where(row < Yc, row * Ks + (ranks - Ko), Yc * Ks)
        spill_pts = scatter_set(
            torch.zeros((Yc * Ks, 3), dtype=torch.float32, device=dev),
            tile_slot, world_sorted).view(Yc, Ks, 3)
        spill_pts_mask = scatter_set(
            torch.zeros(Yc * Ks, dtype=torch.bool, device=dev),
            tile_slot, True).view(Yc, Ks)
        sp_over = (sp_sel & (row >= Yc)).sum().to(torch.int32)
    else:
        spill_cells = torch.full((Yc,), n_pyr, dtype=torch.int32, device=dev)
        cell_ok = torch.zeros(Yc, dtype=torch.bool, device=dev)
        spill_pts = torch.zeros((Yc, 1, 3), dtype=torch.float32, device=dev)
        spill_pts_mask = torch.zeros((Yc, 1), dtype=torch.bool, device=dev)
        sp_over = torch.zeros((), dtype=torch.int32, device=dev)

    return Observation(
        points=grid.view(n_pyr, Ko, 3),
        mask=mask.view(n_pyr, Ko),
        counts=counts_all.clamp(max=K),
        max_range=max_range,
        n_valid_points=n_valid,
        cloud_world=world,
        cloud_valid=valid,
        spill_cells=spill_cells,
        spill_cell_mask=cell_ok,
        spill_pts=spill_pts,
        spill_pts_mask=spill_pts_mask,
        spill_overflow=sp_over,
    )
