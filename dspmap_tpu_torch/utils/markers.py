"""Visualization marker data matching the reference node's displays
(the reference's ``src/map_sim_example.cpp``): the FOV line-strip
(``showFOV``, :129-183), actor cylinders (``actor_publish``, :69-107), the
rainbow color map for the future-status layer cloud (``colorAssign``,
:201-251) and the mid-height future-status layer itself (:398-427).

These are pure numpy functions: they return plain arrays/dicts so the same
data feeds the optional live ROS bridge (``io/ros_bridge.py``), the PLY
exporters (``utils/viz.py``) or any custom display.  Cluster velocity
arrows (from ``StepOutput.estimator_cloud``) are an addition with no
reference counterpart (the reference only prints its KM cluster result).

The port's own copy of ``dspmap_tpu/utils/markers.py``.  Every public
function also takes what the port's readouts return -- tensors on the card
or on the CPU, ``StepOutput.estimator_cloud`` as a tuple of tensors -- and
converts a tensor argument to numpy on entry; ``tests/test_torch_io.py``
holds the results to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..state import to_numpy as _numpy


def _rotate(points: np.ndarray, quat_wxyz) -> np.ndarray:
    w, x, y, z = [float(v) for v in quat_wxyz]
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return points @ R.T


def fov_marker_points(quat_wxyz, angle_h: float, angle_v: float,
                      length: float = 5.0) -> np.ndarray:
    """The reference's FOV line-strip vertices in ego frame
    (``showFOV``, map_sim_example.cpp:129-183; called with 90/54 deg and
    length 5 at :512).  Returns ``[10, 3]`` points forming LINE_STRIP order
    ``p1, p2, cam, p4, p3, cam, p1, p3, p4, p2``.  The reference's own
    corner definitions are kept verbatim -- including the x sign of
    p2/p4 (:140,:151), which mirrors the frustum through the camera plane.
    ``angle_h``/``angle_v`` in radians (full angles, halved internally like
    the reference)."""
    quat_wxyz = _numpy(quat_wxyz)
    th, tv = np.tan(angle_h / 2.0), np.tan(angle_v / 2.0)
    p1 = np.array([length, length * th, length * tv])
    p2 = np.array([-length, length * th, length * tv])
    p3 = np.array([length, length * th, -length * tv])
    p4 = np.array([-length, length * th, -length * tv])
    cam = np.zeros(3)
    pts = np.stack([p1, p2, p3, p4])
    p1, p2, p3, p4 = _rotate(pts, quat_wxyz)
    return np.stack([p1, p2, cam, p4, p3, cam, p1, p3, p4, p2]).astype(
        np.float32
    )


def color_assign(v: np.ndarray, value_min: float = 0.0,
                 value_max: float = 1.0, reverse_color: bool = False):
    """Vectorized ``colorAssign`` (map_sim_example.cpp:201-251): maps values
    to the reference's 5-section rainbow.  Returns ``[..., 3]`` uint8 RGB."""
    v = np.clip(np.asarray(_numpy(v), np.float32), value_min, value_max)
    value = np.minimum(
        np.floor((v - value_min) / (value_max - value_min) * 240.0), 240
    ).astype(np.int32)
    if reverse_color:
        value = 240 - value
    section = value // 60
    key = np.floor((value % 60) / 60.0 * 255.0).astype(np.int32)
    nkey = 255 - key
    r = np.select([section == 0, section == 1, section >= 2], [255, nkey, 0])
    g = np.select(
        [section == 0, section == 1, section == 2, section == 3,
         section >= 4],
        [key, 255, 255, nkey, 255],
    )
    # section 4 = sky blue (0,255,255); default white handled by >=4 clamp
    b = np.select([section <= 1, section == 2, section >= 3], [0, key, 255])
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def future_layer_cloud(future_ego: np.ndarray, centers_ego: np.ndarray,
                       nz: int, x_offset_step: float = 12.0):
    """The reference's future-status display cloud: ONE z layer
    (``z = nz/2 - 1``), every horizon offset in +x by ``12 * n`` so all
    predictions show side by side in one cloud
    (map_sim_example.cpp:398-427).  ``future_ego [V, T]`` and
    ``centers_ego [V, 3]`` in ego voxel order (``read_occupancy``).
    Returns ``(points [L*T, 3], rgb [L*T, 3])``."""
    future_ego, centers_ego = _numpy(future_ego), _numpy(centers_ego)
    V, T = future_ego.shape
    per_layer = V // nz
    z_index = nz // 2 - 1
    sel = slice(z_index * per_layer, (z_index + 1) * per_layer)
    pts, rgb = [], []
    for n in range(T):
        p = centers_ego[sel].copy()
        p[:, 0] += x_offset_step * n
        pts.append(p)
        rgb.append(color_assign(future_ego[sel, n], 0.0, 0.1, reverse_color=True))
    return (np.concatenate(pts).astype(np.float32), np.concatenate(rgb))


def actor_markers(points_ego: np.ndarray, scale=(0.4, 0.4, 1.7),
                  color=(0.3, 0.3, 0.9, 0.6)):
    """Actor cylinder markers (``actor_publish``,
    map_sim_example.cpp:69-107): one dict per actor position, matching the
    reference's CYLINDER scale/color defaults."""
    return [
        {
            "type": "cylinder",
            "position": np.asarray(p, np.float32),
            "scale": np.asarray(scale, np.float32),
            "color": np.asarray(color, np.float32),
            "id": i,
            "ns": "actors",
        }
        for i, p in enumerate(np.atleast_2d(_numpy(points_ego)))
    ]


def cluster_velocity_arrows(estimator_cloud, min_speed: float = 0.1,
                            arrow_scale: float = 1.0):
    """Velocity arrows from ``StepOutput.estimator_cloud``
    (= getKMClusterResult, dsp_dynamic.h:441-445): one (start, end) segment
    per dynamic point with known cluster velocity.  Returns ``[K, 2, 3]``."""
    points, vel, dynamic, valid = [np.asarray(_numpy(x))
                                   for x in estimator_cloud]
    known = vel[:, 0] > -100.0
    speed = np.linalg.norm(np.where(known[:, None], vel, 0.0), axis=1)
    sel = np.asarray(valid, bool) & np.asarray(dynamic, bool) & known & (
        speed >= min_speed
    )
    starts = points[sel]
    ends = starts + vel[sel] * arrow_scale
    return np.stack([starts, ends], axis=1).astype(np.float32)
