"""Particle CSV export, format-compatible with the reference recorder
(``include/dsp_dynamic.h:325-350``): one line per valid particle,
``flag,vx,vy,vz,px,py,pz,weight,voxel_index`` -- consumable by the
reference's MATLAB viewer (``display/app1.mlapp``, readme.md:137-145).

Positions are converted from the world frame to the reference's ego frame
(relative to the current sensor position) and the voxel index to the ego
z-major convention.  Flags map {valid -> 1, newborn -> 15} per the
reference encoding.  The file is byte for byte the JAX package's
(``dspmap_tpu/io/particles_csv.py``) for the same state, on either layout
and from a state on any device: the rows are formatted from the host copy
of the state's float32 values.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import MapConfig
from ..state import FLAG_NEWBORN, MapState, state_to_numpy


def export_particles_csv(state: MapState, cfg: MapConfig, path) -> int:
    """Write all valid particles; returns the number written."""
    tree = state_to_numpy(state)
    p = tree["particles"]
    sensor = tree["sensor_pos"]
    origin = tree["origin"]

    valid = p["flags"] != 0
    flags = np.where(p["flags"] == FLAG_NEWBORN, 15.0, 1.0)

    # ego voxel index in the reference convention (z*ny*nx + y*nx + x from the
    # window's low corner, dsp_dynamic.h:1062-1074)
    if valid.ndim == 2:
        # pool layout: the storage cell is the plane column
        S, V = valid.shape
        storage = np.tile(np.arange(V, dtype=np.int64), (S, 1))
        sx = storage % cfg.nx
        sy = (storage // cfg.nx) % cfg.ny
        sz = storage // (cfg.nx * cfg.ny)
        dims = np.array([cfg.nx, cfg.ny, cfg.nz])
        s = np.stack([sx, sy, sz], -1)
        wv = origin + np.mod(s - origin, dims)
        ego = wv - origin
    else:
        # compact layout: cells derive from the world positions, exactly as
        # the step derives them
        pos = np.stack([p["px"], p["py"], p["pz"]], -1)
        wv = np.floor(pos / cfg.voxel_resolution).astype(np.int64)
        ego = wv - origin
    ego_idx = (ego[..., 2] * cfg.ny + ego[..., 1]) * cfg.nx + ego[..., 0]

    rows = np.column_stack(
        [
            flags[valid],
            p["vx"][valid],
            p["vy"][valid],
            p["vz"][valid],
            p["px"][valid] - sensor[0],
            p["py"][valid] - sensor[1],
            p["pz"][valid] - sensor[2],
            p["weight"][valid],
            ego_idx[valid].astype(np.float64),
        ]
    )
    with open(Path(path), "w") as f:
        for r in rows:
            f.write(
                f"{r[0]:g},{r[1]:g},{r[2]:g},{r[3]:g},{r[4]:g},{r[5]:g},"
                f"{r[6]:g},{r[7]:g},{int(r[8])}\n"
            )
    return len(rows)
