"""Frames, voxel addressing and FOV-pyramid geometry (mirrors
``dspmap_tpu/geometry.py``; see its docstring for the world-aligned,
toroidally addressed window).

Every ``jnp.mod`` of the JAX package is ``torch.remainder`` here (a floor
mod): the window origin goes negative once the sensor moves, and
``torch.fmod`` would truncate toward zero.  Angles use ``torch.atan2``.

Host-side helpers (``*_np``) compute the per-frame scalars -- rotation
matrix, window origin -- in numpy float32 with the JAX package's operation
order, so the step never syncs the device for them.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import MapConfig
from .ops.common import frame_ints, frame_tensor, to_device

# ------------------------------------------------------------- host scalars


def rotation_matrix_np(q) -> np.ndarray:
    """3x3 float32 rotation matrix of a unit quaternion (wxyz)."""
    q = np.asarray(q, np.float32)
    w, x, y, z = q[0], q[1], q[2], q[3]
    one, two = np.float32(1), np.float32(2)
    return np.array([
        [one - two * (y * y + z * z), two * (x * y - w * z), two * (x * z + w * y)],
        [two * (x * y + w * z), one - two * (x * x + z * z), two * (y * z - w * x)],
        [two * (x * z - w * y), two * (y * z + w * x), one - two * (x * x + y * y)],
    ], np.float32)


def quaternion_conjugate_np(q) -> np.ndarray:
    return np.asarray(q, np.float32) * np.asarray([1, -1, -1, -1], np.float32)


def quaternion_is_valid_np(q) -> bool:
    """Every component within +-1.001 (dsp_dynamic.h:193-196)."""
    return bool(np.all(np.abs(np.asarray(q, np.float32)) <= np.float32(1.001)))


def window_origin_np(sensor_pos, cfg: MapConfig) -> np.ndarray:
    """World-voxel coordinate of the window's low corner (int32 [3])."""
    half = np.asarray(cfg.half_extent, np.float32)
    s = np.asarray(sensor_pos, np.float32)
    return np.floor(
        (s - half) / np.float32(cfg.voxel_resolution) + np.float32(0.5)
    ).astype(np.int32)


# ------------------------------------------------------------- quaternions


def quaternion_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v[..., 3]`` by unit quaternion ``q[4]`` (wxyz), in the
    JAX package's 2-cross-product form."""
    w = q[..., :1]
    u = q[..., 1:].expand_as(v)
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def frame_rotation(quat=None, R=None):
    """The frame's world-to-sensor rotation, from exactly one of: ``quat``,
    a host wxyz quaternion (the matrix made on the host, numpy float32),
    or ``R``, the frame block's ``[3, 3]`` tensor (returned as it is)."""
    if (quat is None) == (R is None):
        raise TypeError("give the host quaternion quat or the frame "
                        "block's rotation R, one of them")
    if R is not None:
        if not isinstance(R, torch.Tensor) or tuple(R.shape) != (3, 3):
            raise ValueError("R is the frame block's [3, 3] tensor")
        return R
    if isinstance(quat, torch.Tensor):
        raise TypeError("quat is a host quaternion; the frame block's "
                        "rotation goes in as R=")
    return rotation_matrix_np(quaternion_conjugate_np(quat))


def rotate_planar(R, px, py, pz):
    """Apply a 3x3 matrix (numpy, nested floats or a ``[3, 3]`` tensor) to
    coordinate planes."""
    if isinstance(R, torch.Tensor):
        R = [list(row.unbind(0)) for row in R.unbind(0)]
    else:
        R = [[float(R[i][j]) for j in range(3)] for i in range(3)]
    return (
        R[0][0] * px + R[0][1] * py + R[0][2] * pz,
        R[1][0] * px + R[1][1] * py + R[1][2] * pz,
        R[2][0] * px + R[2][1] * py + R[2][2] * pz,
    )


# ------------------------------------------------------- voxel addressing


def world_voxel(pos: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    return torch.floor(pos / cfg.voxel_resolution).to(torch.int32)


def in_window(wv: torch.Tensor, origin, cfg: MapConfig) -> torch.Tensor:
    """Whether world voxels ``wv [..., 3]`` lie in the window at
    ``origin`` (the frame block's ``[3]`` tensor, or a host origin)."""
    rel = wv - frame_tensor(origin, torch.int32, wv.device)
    return ((rel >= 0).all(dim=-1) & (rel[..., 0] < cfg.nx)
            & (rel[..., 1] < cfg.ny) & (rel[..., 2] < cfg.nz))


def storage_index(wv: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    sx = torch.remainder(wv[..., 0], cfg.nx)
    sy = torch.remainder(wv[..., 1], cfg.ny)
    sz = torch.remainder(wv[..., 2], cfg.nz)
    return (sz * cfg.ny + sy) * cfg.nx + sx


def storage_to_world_voxel(origin, cfg: MapConfig, device) -> torch.Tensor:
    v = torch.arange(cfg.voxel_num, dtype=torch.int32, device=device)
    s = torch.stack([v % cfg.nx, (v // cfg.nx) % cfg.ny,
                     v // (cfg.nx * cfg.ny)], dim=-1)
    o = frame_tensor(origin, torch.int32, device)
    dims = to_device([cfg.nx, cfg.ny, cfg.nz], torch.int32, device)
    return o + torch.remainder(s - o, dims)


def voxel_center(wv: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    return (wv.to(torch.float32) + 0.5) * cfg.voxel_resolution


def ego_grid_gather_indices(origin, cfg: MapConfig, device) -> torch.Tensor:
    v = torch.arange(cfg.voxel_num, dtype=torch.int32, device=device)
    e = torch.stack([v % cfg.nx, (v // cfg.nx) % cfg.ny,
                     v // (cfg.nx * cfg.ny)], dim=-1)
    o = frame_tensor(origin, torch.int32, device)
    return storage_index(o + e, cfg)


# ------------------------------------------------------------ FOV pyramids


def pyramid_index_planar(sx, sy, sz, cfg: MapConfig):
    """``(flat_cell, in_fov)`` for sensor-frame coordinate planes."""
    res = cfg.angle_resolution_rad
    az = torch.atan2(sy, sx)
    el = torch.atan2(sz, sx)
    in_fov = (
        (az.abs() <= cfg.half_fov_h_rad)
        & (el.abs() <= cfg.half_fov_v_rad)
        & (sx > 0.0)
    )
    h = torch.clamp(torch.floor((az + cfg.half_fov_h_rad) / res).to(torch.int32),
                    0, cfg.n_pyramids_h - 1)
    v = torch.clamp(torch.floor((cfg.half_fov_v_rad - el) / res).to(torch.int32),
                    0, cfg.n_pyramids_v - 1)
    return h * cfg.n_pyramids_v + v, in_fov


def pyramid_index(p_sensor: torch.Tensor, cfg: MapConfig):
    return pyramid_index_planar(p_sensor[..., 0], p_sensor[..., 1],
                                p_sensor[..., 2], cfg)


def world_voxel_planar(px, py, pz, cfg: MapConfig):
    inv = 1.0 / cfg.voxel_resolution
    return (torch.floor(px * inv).to(torch.int32),
            torch.floor(py * inv).to(torch.int32),
            torch.floor(pz * inv).to(torch.int32))


def in_window_planar(wx, wy, wz, origin, cfg: MapConfig):
    """:func:`in_window` of coordinate planes; ``origin`` the frame
    block's ``[3]`` tensor or a host origin."""
    o = frame_ints(origin)
    rx, ry, rz = wx - o[0], wy - o[1], wz - o[2]
    return ((rx >= 0) & (rx < cfg.nx) & (ry >= 0) & (ry < cfg.ny)
            & (rz >= 0) & (rz < cfg.nz))


def storage_index_planar(wx, wy, wz, cfg: MapConfig):
    return (torch.remainder(wz, cfg.nz) * cfg.ny
            + torch.remainder(wy, cfg.ny)) * cfg.nx + torch.remainder(wx, cfg.nx)


def storage_index_from_rel(rx, ry, rz, origin, cfg: MapConfig,
                           origin_mod=None):
    """Storage cell from window-relative voxel coords (valid where
    0 <= r < dims), by the scalar ``mod(origin, dims)`` fold-back;
    ``origin_mod`` hands in that mod (the frame block's ``[3]`` tensor),
    else it is taken of the host ``origin``."""
    if origin_mod is None:
        o = [int(x) for x in np.asarray(origin)]
        origin_mod = (o[0] % cfg.nx, o[1] % cfg.ny, o[2] % cfg.nz)
    sox, soy, soz = frame_ints(origin_mod)
    cx = sox + torch.clamp(rx, 0, cfg.nx - 1)
    cy = soy + torch.clamp(ry, 0, cfg.ny - 1)
    cz = soz + torch.clamp(rz, 0, cfg.nz - 1)
    cx = torch.where(cx >= cfg.nx, cx - cfg.nx, cx)
    cy = torch.where(cy >= cfg.ny, cy - cfg.ny, cy)
    cz = torch.where(cz >= cfg.nz, cz - cfg.nz, cz)
    return (cz * cfg.ny + cy) * cfg.nx + cx
