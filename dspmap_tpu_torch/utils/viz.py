"""ROS-free visualization exports (the reference's observability surface is
rviz topics, SURVEY.md section 5.5): PLY point clouds for the occupancy map
and the reference node's one-layer future-status display
(``map_sim_example.cpp:398-427``) as a colored cloud.

The port's own copy of ``dspmap_tpu/utils/viz.py``: every public function
also takes tensors on the card or on the CPU, converted to numpy on entry;
``tests/test_torch_io.py`` holds the files to the JAX package's, byte for
byte.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..state import to_numpy as _numpy


def write_ply(path, points: np.ndarray, colors: np.ndarray | None = None):
    """ASCII PLY writer (xyz [+ rgb])."""
    points = np.asarray(_numpy(points), np.float32).reshape(-1, 3)
    n = len(points)
    with open(Path(path), "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        else:
            colors = np.asarray(_numpy(colors), np.uint8).reshape(-1, 3)
            for p, c in zip(points, colors):
                f.write(
                    f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n"
                )


def _color_ramp(w: np.ndarray, w_min: float, w_max: float) -> np.ndarray:
    """Blue->green->red ramp like the node's colorAssign
    (map_sim_example.cpp:200-250 region)."""
    t = np.clip((w - w_min) / max(w_max - w_min, 1e-9), 0.0, 1.0)
    r = np.clip(2 * t - 1, 0, 1)
    g = 1.0 - np.abs(2 * t - 1)
    b = np.clip(1 - 2 * t, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def export_occupancy_ply(path, centers, occupied, weight_sum=None):
    """Occupancy cloud (the /my_map/cloud_ob analogue)."""
    centers = np.asarray(_numpy(centers))
    occ = np.asarray(_numpy(occupied))
    pts = centers[occ]
    colors = None
    if weight_sum is not None:
        w = np.asarray(_numpy(weight_sum))[occ]
        colors = _color_ramp(w, 0.0, max(float(w.max(initial=1.0)), 1e-6))
    write_ply(path, pts, colors)
    return len(pts)


def export_future_layer_ply(path, cfg, centers, future, z_index=None,
                            x_offset_per_horizon=12.0, w_max=0.1):
    """One-z-layer future status, horizons offset along +x, colored by
    weight -- the reference's /my_map/future_status display
    (map_sim_example.cpp:398-427)."""
    centers = np.asarray(_numpy(centers)).reshape(cfg.nz, cfg.ny, cfg.nx, 3)
    future = np.asarray(_numpy(future)).reshape(cfg.nz, cfg.ny, cfg.nx, cfg.n_horizons)
    z = cfg.nz // 2 - 1 if z_index is None else z_index
    layer_c = centers[z].reshape(-1, 3)
    layer_f = future[z].reshape(-1, cfg.n_horizons)
    pts, cols = [], []
    for h in range(cfg.n_horizons):
        p = layer_c.copy()
        p[:, 0] += h * x_offset_per_horizon
        pts.append(p)
        cols.append(_color_ramp(layer_f[:, h], 0.0, w_max))
    write_ply(path, np.concatenate(pts), np.concatenate(cols))
    return cfg.n_horizons * len(layer_c)
