"""The fused per-slot sweep: prediction advance + window/rebin masks + FOV
pyramid geometry in one pass over the pool (mirrors
``dspmap_tpu/ops/sweep.py``).

:func:`sweep_reference` is the spec and the plain PyTorch version;
:func:`sweep` runs it for CPU tensors and the CUDA kernel
(``csrc/sweep.cu``) for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import MapConfig
from .. import geometry, kernels, scalars
from .common import frame_float, frame_floats, frame_ints


class SweepOut(NamedTuple):
    px: torch.Tensor  # advanced positions [S, V]
    py: torch.Tensor
    pz: torch.Tensor
    flags: torch.Tensor  # i32: 0 where the particle left the window
    new_cell: torch.Tensor  # i32 storage cell of the advanced position
    #: ``mover | fov<<1 | moving<<2 | moved_out<<3 | pyramid_cell<<4``,
    #: zero when no outcome bit is set
    tags: torch.Tensor

    @property
    def mover(self):
        return (self.tags & 1) != 0

    @property
    def fov(self):
        return (self.tags & 2) != 0

    @property
    def moving(self):
        return (self.tags & 4) != 0

    @property
    def moved_out(self):
        return (self.tags & 8) != 0

    @property
    def pyr(self):
        return self.tags >> 4

    @property
    def candidate(self):
        return (self.tags & 7) != 0


def sweep_reference(particles, cfg: MapConfig, dt, origin, sensor_pos,
                    quat=None, cell_base: int = 0, origin_mod=None, *,
                    R=None) -> SweepOut:
    """Plain PyTorch sweep.  The frame's values come as the step passes
    them -- views of its frame blocks: ``dt`` 0-d, ``origin`` and
    ``origin_mod`` (``origin % (nx, ny, nz)``) int32 ``[3]``,
    ``sensor_pos`` ``[3]`` and the frame's rotation ``R=`` ``[3, 3]`` in
    place of ``quat`` -- or as host values (a float, host arrays and the
    wxyz quaternion ``quat``; ``origin_mod`` then taken of ``origin``).  ``cell_base`` is
    the global storage cell of column 0: nonzero on a slab of the sharded
    step, where the mover test compares ``new_cell`` with ``cell_base +
    column`` (``new_cell`` stays global either way)."""
    S, V = particles.flags.shape
    dev = particles.flags.device
    valid = particles.valid
    dt = frame_float(dt)
    if isinstance(origin, torch.Tensor) and origin_mod is None:
        raise ValueError("a tensor origin comes with its origin_mod")

    if cfg.motion_model == "static":
        px, py, pz = particles.px, particles.py, particles.pz
    else:
        px = torch.where(valid, particles.px + particles.vx * dt, particles.px)
        py = torch.where(valid, particles.py + particles.vy * dt, particles.py)
        pz = torch.where(valid, particles.pz + particles.vz * dt, particles.pz)

    wx, wy, wz = geometry.world_voxel_planar(px, py, pz, cfg)
    o = frame_ints(origin)
    rx, ry, rz = wx - o[0], wy - o[1], wz - o[2]
    inside = ((rx >= 0) & (rx < cfg.nx) & (ry >= 0) & (ry < cfg.ny)
              & (rz >= 0) & (rz < cfg.nz))
    moved_out = valid & ~inside
    flags = torch.where(moved_out, 0, particles.flags)

    new_cell = geometry.storage_index_from_rel(rx, ry, rz, origin, cfg,
                                               origin_mod)
    current = int(cell_base) + torch.arange(V, dtype=torch.int32,
                                            device=dev)[None, :]
    mover = valid & inside & (new_cell != current)

    s = frame_floats(sensor_pos)
    sx, sy, sz = geometry.rotate_planar(geometry.frame_rotation(quat, R),
                                        px - s[0], py - s[1], pz - s[2])
    pyr, in_fov = geometry.pyramid_index_planar(sx, sy, sz, cfg)
    fov = valid & inside & in_fov
    moving = valid & inside & ((particles.vx != 0.0) | (particles.vy != 0.0)
                               | (particles.vz != 0.0))
    packed = (mover.to(torch.int32) | (fov.to(torch.int32) << 1)
              | (moving.to(torch.int32) << 2) | (moved_out.to(torch.int32) << 3)
              | (pyr << 4))
    tags = torch.where(mover | fov | moving | moved_out, packed, 0)
    return SweepOut(px, py, pz, flags, new_cell.to(torch.int32),
                    tags.to(torch.int32))


def _scalar_operands(cfg: MapConfig, dev, dt, origin, sensor_pos, quat, R,
                     origin_mod) -> tuple:
    """The kernel's five per-frame operands on ``dev``: ``(dt [], sensor_pos
    [3], R [3, 3])`` float32 and ``(origin [3], origin_mod [3])`` int32.
    Tensors (the step's frame-block views) are taken as they are; host
    values are copied into frame blocks first."""
    given = (dt, origin, sensor_pos, R, origin_mod)
    if all(isinstance(x, torch.Tensor) for x in given) and quat is None:
        floats, ints = (dt, sensor_pos, R), (origin, origin_mod)
        shapes = ((), (3,), (3, 3), (3,), (3,))
        for x, shape, dtype in zip(floats + ints, shapes,
                                   (torch.float32,) * 3 + (torch.int32,) * 2):
            if tuple(x.shape) != shape or x.dtype != dtype:
                raise ValueError(f"sweep scalar operand {tuple(x.shape)} "
                                 f"{x.dtype}, expected {shape} {dtype}")
        kernels.check_cuda(*floats, *ints)
        return floats + ints
    if any(isinstance(x, torch.Tensor) for x in given + (quat,)):
        raise TypeError("the sweep's per-frame values are all tensors (the "
                        "frame blocks', with R=) or all host values")
    fs = scalars.frame_scalars(cfg, dev, dt=dt, sensor_pos=sensor_pos,
                               quat=quat, origin=origin)
    return fs.dt, fs.sensor_pos, fs.R, fs.origin, fs.origin_mod


def sweep_cuda(particles, cfg: MapConfig, dt, origin, sensor_pos,
               quat=None, cell_base: int = 0, origin_mod=None, *,
               R=None) -> SweepOut:
    """The sweep kernel (``csrc/sweep.cu``) on CUDA tensors; the frame's
    values and ``cell_base`` as in :func:`sweep_reference`.  The kernel
    reads ``dt``, the sensor position, ``R``, the origin and ``origin %
    (nx, ny, nz)`` through pointers into the frame blocks (host values are
    copied into blocks first), as the Pallas kernel reads its scalar refs,
    so a captured launch reads each frame's.  Requires the limit-xy or
    static configurations (vz is never read)."""
    if not (cfg.limit_motion_to_xy_plane or cfg.motion_model == "static"):
        raise ValueError("the fused sweep covers limit-xy / static configs")
    p = particles
    S, V = p.flags.shape
    planes = (p.px, p.py, p.pz, p.vx, p.vy)
    kernels.check_cuda(p.flags, *planes, shape=(S, V))
    if p.flags.dtype != torch.int32 or any(
            x.dtype != torch.float32 for x in planes):
        raise TypeError("sweep kernel takes int32 flags and float32 planes")
    dev = p.flags.device
    scalars = _scalar_operands(cfg, dev, dt, origin, sensor_pos, quat, R,
                               origin_mod)
    opx = torch.empty((S, V), dtype=torch.float32, device=dev)
    opy = torch.empty_like(opx)
    oflags = torch.empty((S, V), dtype=torch.int32, device=dev)
    ocell = torch.empty_like(oflags)
    otags = torch.empty_like(oflags)
    f = [np.float32(1.0 / cfg.voxel_resolution),
         np.float32(cfg.half_fov_h_rad), np.float32(cfg.half_fov_v_rad),
         np.float32(cfg.angle_resolution_rad)]
    i = [S, V, cfg.nx, cfg.ny, cfg.nz, cfg.n_pyramids_h, cfg.n_pyramids_v,
         int(cfg.motion_model != "static"), int(cell_base)]
    kernels.launch("sweep", [p.flags, p.px, p.py, p.pz, p.vx, p.vy,
                             opx, opy, oflags, ocell, otags, *scalars], f, i)
    return SweepOut(opx, opy, p.pz, oflags, ocell, otags)


def sweep(particles, cfg: MapConfig, dt, origin, sensor_pos, quat=None,
          cell_base: int = 0, origin_mod=None, *, R=None) -> SweepOut:
    """Plain version for CPU tensors, the CUDA kernel for CUDA tensors (on
    a slab too: ``cell_base`` is a kernel argument)."""
    if particles.flags.is_cuda:
        return sweep_cuda(particles, cfg, dt, origin, sensor_pos, quat,
                          cell_base, origin_mod, R=R)
    return sweep_reference(particles, cfg, dt, origin, sensor_pos, quat,
                           cell_base, origin_mod, R=R)
