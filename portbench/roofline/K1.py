"""K1, the occupancy pool pass (``csrc/occupancy.cu``): one launch a frame
over the ``[S, V]`` pool.  It reads and writes once each plane it rewrites
-- flags, weight, the carried velocity planes, px, py, pz, and t where the
configuration records particle times -- and writes ``8 + n_vel``
per-voxel vectors; on the multi-camera and noisy steps it also writes a
one-byte moving mask a slot.  About 24 float operations a slot.  The
arithmetic of the port's ``chip_smoke.py`` (``check_kernels``,
``check_moving_mask``)."""

from __future__ import annotations

#: the kernel's name in the profiler's trace holds this
NAME = "occupancy_tile_kernel"
FLOPS_PER_SLOT = 24


def n_vel(cfg: dict) -> int:
    """Velocity planes the pass carries: none in the static model, vx and
    vy under limit-xy, all three otherwise."""
    if cfg["motion_model"] == "static":
        return 0
    return 2 if cfg["limit_motion_to_xy_plane"] else 3


def launch_bytes(S: int, V: int, vel: int, moving: bool,
                 times: bool = False) -> int:
    planes = 5 + vel + (1 if times else 0)
    return 2 * 4 * planes * S * V + 4 * (8 + vel) * V + (S * V if moving
                                                         else 0)


def launches(cfg: dict, shapes: dict, cameras: int) -> list:
    """``[(bytes, flops)]`` of a frame's launches (one), pool layout only."""
    if shapes["layout"] != "pool":
        return []
    S, V = shapes["slots_per_voxel"], shapes["storage_voxels"]
    noisy = not (cfg["limit_motion_to_xy_plane"]
                 or cfg["motion_model"] == "static")
    moving = cameras > 1 or noisy
    return [(launch_bytes(S, V, n_vel(cfg), moving,
                          cfg["record_particle_time"]),
             FLOPS_PER_SLOT * S * V)]
