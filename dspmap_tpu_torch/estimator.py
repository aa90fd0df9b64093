"""Initial velocity estimator (mirrors ``dspmap_tpu/estimator.py``; see its
docstring for the step-by-step reference parity): ground split,
Euclidean clustering, cluster filtering, cross-frame association and
per-point velocity allocation."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import MapConfig
from .state import EstimatorState
from .ops.assignment import solve_assignment
from .ops.cluster import euclidean_cluster
from .ops.common import (compact_mask, div_frame, frame_float, scatter_set,
                         segment_sum)


class EstimatorOutput(NamedTuple):
    points: torch.Tensor  # [P, 3] world
    vel: torch.Tensor  # [P, 3]; < -100 sentinel = dynamic but unmatched
    dynamic: torch.Tensor  # [P] bool
    valid: torch.Tensor  # [P] bool


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def estimate_velocities(cloud_world: torch.Tensor, cloud_valid: torch.Tensor,
                        est_state: EstimatorState, cfg: MapConfig, dt,
                        fresh_intensity: torch.Tensor | None):
    """Returns ``(EstimatorOutput, new EstimatorState)``.  ``dt`` is the
    frame block's 0-d tensor or a host float; ``fresh_intensity [C]`` is
    the uniform [0.1, 1) draw for new tracks' visualization ids
    (``estimator.py:177-178`` of the JAX package)."""
    if not cfg.estimator_enabled:
        return EstimatorOutput(
            points=cloud_world, vel=torch.zeros_like(cloud_world),
            dynamic=torch.zeros(cloud_world.shape[0], dtype=torch.bool,
                                device=cloud_world.device),
            valid=cloud_valid), est_state

    P = cloud_world.shape[0]
    C = cfg.max_clusters
    dev = cloud_world.device

    ground = cloud_world[:, 2] <= cfg.voxel_filter_resolution
    nonground = cloud_valid & ~ground
    labels = euclidean_cluster(cloud_world, nonground, cfg.cluster_tolerance,
                               cfg.cluster_propagation_iters)
    lab = labels.to(torch.int64)

    ones = nonground.to(torch.float32)
    # the same bits on every call: each rank of the sharded step runs the
    # estimator and must keep the same tracks
    size = segment_sum(ones, lab, P + 1)
    centroid = segment_sum(cloud_world * ones[:, None], lab, P + 1)
    centroid = centroid / size.clamp(min=1.0)[:, None]

    my_size = size[lab]
    my_centroid = centroid[lab]
    big_enough = my_size >= cfg.cluster_min_points
    cluster_static = (my_size > cfg.dynamic_cluster_max_points) | (
        my_centroid[:, 2] > cfg.dynamic_cluster_max_height)
    dyn_point = nonground & big_enough & ~cluster_static
    static_point = (cloud_valid & ground) | (nonground & big_enough
                                             & cluster_static)

    iota = torch.arange(P, dtype=torch.int32, device=dev)
    is_dyn_root = (labels == iota) & nonground & big_enough & ~cluster_static
    root_idx, slot_valid, n_clusters, _ = compact_mask(is_dyn_root, C)
    root64 = root_idx.to(torch.int64)
    c_centers = centroid[root64] * slot_valid[:, None]
    c_sizes = torch.where(slot_valid, size[root64], 0.0).to(torch.int32)
    slot_of_root = scatter_set(
        torch.full((P + 1,), C, dtype=torch.int32, device=dev),
        torch.where(slot_valid, root_idx, P),
        torch.arange(C, dtype=torch.int32, device=dev))
    point_slot = slot_of_root[lab]

    # --- association with the previous frame (dsp_dynamic.h:1449-1475) ----
    prev = est_state
    dist = _norm(c_centers[:, None, :] - prev.prev_centers[None, :, :])
    gate = ((dist < cfg.assoc_distance_gate)
            & ((c_sizes[:, None] - prev.prev_point_num[None, :]).abs()
               <= cfg.assoc_point_num_gate))
    cost = torch.where(gate, dist / cfg.assoc_distance_gate * 1000.0,
                       cfg.assoc_distance_gate * 5000.0)
    dt = frame_float(dt)
    dt_ok = (dt > 1e-5) & (dt < 10.0)
    any_pairs = (n_clusters > 0) & prev.prev_valid.any() & dt_ok
    assigned = torch.where(any_pairs,
                           solve_assignment(cost, slot_valid, prev.prev_valid),
                           -1)

    matched = assigned >= 0
    safe_col = assigned.clamp(min=0).to(torch.int64)
    matched = matched & gate[torch.arange(C, device=dev), safe_col]
    c_vel = torch.where(matched[:, None],
                        div_frame(c_centers - prev.prev_centers[safe_col],
                                  torch.clamp(dt, min=1e-6)
                                  if isinstance(dt, torch.Tensor)
                                  else max(dt, 1e-6)),
                        -10000.0)
    speed = _norm(torch.where(matched[:, None], c_vel, 0.0))
    c_vel = torch.where(((speed > cfg.max_cluster_velocity) & matched)[:, None],
                        0.0, c_vel)
    c_intensity = torch.where(matched, prev.prev_intensity[safe_col],
                              fresh_intensity.to(dev))

    # --- per-point velocity allocation (dsp_dynamic.h:1503-1540) --------
    ext_vel = torch.cat([c_vel, torch.zeros((1, 3), dtype=torch.float32,
                                            device=dev)])
    point_vel = torch.where(dyn_point[:, None],
                            ext_vel[point_slot.clamp(max=C).to(torch.int64)], 0.0)
    out = EstimatorOutput(points=cloud_world, vel=point_vel, dynamic=dyn_point,
                          valid=static_point | dyn_point)
    new_state = EstimatorState(prev_centers=c_centers, prev_point_num=c_sizes,
                               prev_intensity=c_intensity,
                               prev_valid=slot_valid)
    return out, new_state
