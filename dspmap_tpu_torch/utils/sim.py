"""Synthetic depth-camera scene generator (host-side numpy).

The reference's de-facto test harness replays a recorded Gazebo sequence
(``street.bag``: drone depth camera + MAVROS pose over a street with walking
pedestrians; ``launch/mapping.launch:9-11``, ``readme.md:47-57``).  That bag
is an external download, so this module synthesizes sequences with the same
structure: a ground plane, static structures, and constant-velocity dynamic
obstacles, observed by a moving depth camera with the configured FOV.

This module is the port's own copy of ``dspmap_tpu/utils/sim.py`` (numpy
only); a test holds the two generators to the same frames.

Points are emitted in the sensor *body* frame after the camera-axis remap,
matching what the reference node feeds ``DSPMap::update``
(``map_sim_example.cpp:320-336``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Box:
    center: np.ndarray  # [3] at t=0
    size: np.ndarray  # [3]
    velocity: np.ndarray  # [3]


@dataclasses.dataclass
class Scene:
    boxes: List[Box]
    ground_z: float = 0.0
    ground_extent: float = 12.0


def street_scene(seed: int = 0) -> Scene:
    """A street.bag-like scene: ground, two walls, pillars, 3 pedestrians."""
    rng = np.random.default_rng(seed)
    boxes = [
        # walls flanking a street along +x
        Box(np.array([6.0, 4.0, 1.25]), np.array([14.0, 0.3, 2.5]), np.zeros(3)),
        Box(np.array([6.0, -4.0, 1.25]), np.array([14.0, 0.3, 2.5]), np.zeros(3)),
        # pillars
        Box(np.array([4.0, 1.5, 1.0]), np.array([0.4, 0.4, 2.0]), np.zeros(3)),
        Box(np.array([7.5, -1.8, 1.0]), np.array([0.4, 0.4, 2.0]), np.zeros(3)),
    ]
    for k in range(3):  # pedestrians crossing
        start = np.array([3.0 + 2.5 * k, -3.0 + 2.0 * k, 0.85])
        vel = np.array([0.2 * rng.standard_normal(), 1.0 - 0.4 * k, 0.0])
        boxes.append(Box(start, np.array([0.45, 0.45, 1.7]), vel))
    return Scene(boxes=boxes)


def occlusion_scene(seed: int = 0) -> Scene:
    """Adversarial: a large near-field wall occludes most of the corridor;
    a pedestrian crosses BEHIND it (visible only through the gap) and one
    crosses in front.  Exercises the measurement update's range-occlusion
    skip (``dsp_dynamic.h:759-765``) much harder than the street scene:
    most pyramids see a short max range with live particles beyond it."""
    rng = np.random.default_rng(seed)
    boxes = [
        # near wall with a 1.2 m gap on the right (two segments)
        Box(np.array([2.5, 1.6, 1.25]), np.array([0.3, 4.8, 2.5]), np.zeros(3)),
        Box(np.array([2.5, -3.2, 1.25]), np.array([0.3, 1.6, 2.5]), np.zeros(3)),
        # far wall terminating the corridor
        Box(np.array([7.5, 0.0, 1.25]), np.array([0.3, 8.0, 2.5]), np.zeros(3)),
        # pedestrian behind the near wall, crossing the gap
        Box(np.array([4.5, -3.0, 0.85]), np.array([0.45, 0.45, 1.7]),
            np.array([0.0, 1.2, 0.0])),
        # pedestrian in front of the wall
        Box(np.array([1.2, 1.0, 0.85]), np.array([0.45, 0.45, 1.7]),
            np.array([0.1 * rng.standard_normal(), -0.9, 0.0])),
    ]
    return Scene(boxes=boxes)


def occlusion_sequence(n_frames: int, cfg, seed: int = 0, dt: float = 0.1):
    """Slow approach toward :func:`occlusion_scene` with the 1-degree
    z-buffer on, so the near wall genuinely shadows the corridor."""
    scene = occlusion_scene(seed)
    rng = np.random.default_rng(seed + 1)
    for i in range(n_frames):
        t = i * dt
        pos = np.array([0.15 * t, 0.1 * np.sin(0.4 * t), 1.0])
        quat = np.array([1.0, 0.0, 0.0, 0.0])
        pts, n = render_frame(
            scene, pos, quat, t, rng, cfg.max_input_points,
            fov_h_deg=cfg.half_fov_h_deg, fov_v_deg=cfg.half_fov_v_deg,
            occlude=True,
        )
        yield pts, n, pos.astype(np.float32), quat.astype(np.float32), np.float32(t)


def fast_ego_sequence(n_frames: int, cfg, scene: Scene | None = None,
                      seed: int = 0, dt: float = 0.1, speed: float = 3.0,
                      yaw_rate: float = 0.8):
    """Adversarial ego motion: near the admission-control limits (3 m/s
    translation + strong yaw oscillation) -- large per-frame window shifts
    and FOV churn (rebin/mover stress).  Same tuple stream as
    :func:`generate_sequence`."""
    scene = scene or street_scene(seed)
    rng = np.random.default_rng(seed + 1)
    for i in range(n_frames):
        t = i * dt
        pos = np.array([speed * t, 0.8 * np.sin(0.9 * t), 1.0])
        yaw = yaw_rate * np.sin(1.7 * t)
        quat = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
        pts, n = render_frame(
            scene, pos, quat, t, rng, cfg.max_input_points,
            fov_h_deg=cfg.half_fov_h_deg, fov_v_deg=cfg.half_fov_v_deg,
        )
        yield pts, n, pos.astype(np.float32), quat.astype(np.float32), np.float32(t)


def _sample_box_surface(rng, box: Box, t: float, n: int) -> np.ndarray:
    c = box.center + box.velocity * t
    half = box.size / 2.0
    # sample faces proportionally to area
    u = rng.uniform(-1.0, 1.0, (n, 3))
    face = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    pts = u * half
    pts[np.arange(n), face] = sign * half[face]
    return c + pts


def render_frame(
    scene: Scene,
    sensor_pos: np.ndarray,
    quat_wxyz: np.ndarray,
    t: float,
    rng: np.random.Generator,
    max_points: int,
    points_per_box: int = 600,
    ground_points: int = 800,
    max_range: float = 8.0,
    fov_h_deg: float = 42.0,
    fov_v_deg: float = 24.0,
    noise_std: float = 0.01,
    occlude: bool = False,
) -> np.ndarray:
    """Render one body-frame point cloud ``[max_points, 3]`` (zero-padded)
    plus its valid count, with FOV + range culling.  ``occlude=True`` adds a
    1-degree z-buffer (keep points within 0.4 m of the nearest return per
    angular bin) so near surfaces genuinely shadow far ones -- the
    adversarial occlusion scenes need physical shadowing to exercise the
    reference's per-pyramid range-occlusion skip."""
    world_pts = [
        _sample_box_surface(rng, b, t, points_per_box) for b in scene.boxes
    ]
    g = rng.uniform(-scene.ground_extent, scene.ground_extent, (ground_points, 2))
    world_pts.append(
        np.column_stack([g[:, 0] + sensor_pos[0], g[:, 1] + sensor_pos[1],
                         np.full(ground_points, scene.ground_z)])
    )
    pw = np.concatenate(world_pts, axis=0)
    pw = pw + rng.normal(0.0, noise_std, pw.shape)

    # world -> body: conjugate rotation
    w, x, y, z = quat_wxyz
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    pb = (pw - sensor_pos) @ R  # R^T applied from the right = R^-1 p

    az = np.degrees(np.arctan2(pb[:, 1], pb[:, 0]))
    el = np.degrees(np.arctan2(pb[:, 2], pb[:, 0]))
    rngs = np.linalg.norm(pb, axis=1)
    keep = (
        (np.abs(az) < fov_h_deg)
        & (np.abs(el) < fov_v_deg)
        & (rngs < max_range)
        & (rngs > 0.2)
    )
    pb = pb[keep]
    if occlude and len(pb):
        az_k, el_k, r_k = az[keep], el[keep], rngs[keep]
        bh = np.floor(az_k + fov_h_deg).astype(np.int64)
        bv = np.floor(el_k + fov_v_deg).astype(np.int64)
        bins = bh * int(2 * fov_v_deg + 2) + bv
        nearest = np.full(bins.max() + 1, np.inf)
        np.minimum.at(nearest, bins, r_k)
        pb = pb[r_k <= nearest[bins] + 0.4]
    rng.shuffle(pb)
    pb = pb[:max_points]
    out = np.zeros((max_points, 3), np.float32)
    out[: len(pb)] = pb
    return out, len(pb)


def generate_sequence(
    n_frames: int,
    cfg,
    scene: Scene | None = None,
    seed: int = 0,
    dt: float = 0.1,
    speed: float = 0.5,
):
    """Yield (points[P,3], n, sensor_pos[3], quat[4], t) tuples: a drone
    flying down the street at ``speed`` with slight yaw oscillation."""
    scene = scene or street_scene(seed)
    rng = np.random.default_rng(seed + 1)
    for i in range(n_frames):
        t = i * dt
        pos = np.array([speed * t, 0.3 * np.sin(0.3 * t), 1.0])
        yaw = 0.1 * np.sin(0.5 * t)
        quat = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
        pts, n = render_frame(
            scene, pos, quat, t, rng, cfg.max_input_points,
            fov_h_deg=cfg.half_fov_h_deg, fov_v_deg=cfg.half_fov_v_deg,
        )
        yield pts, n, pos.astype(np.float32), quat.astype(np.float32), np.float32(t)
