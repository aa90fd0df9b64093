"""A surround rig of depth cameras on the synthetic street sequence.

``sim.generate_sequence`` flies one camera down the street.  A robot that
fuses several cameras into one map carries them on one body, each looking
another way: :func:`surround_sequence` mounts ``n_cameras`` cameras at the
body's centre, camera ``k`` turned ``k * 360 / n_cameras`` degrees about
the body's z axis, follows ``generate_sequence``'s ego pose and renders
each camera with ``sim.render_frame`` at the configuration's field of
view.  So camera 0 looks where ``generate_sequence``'s camera looks (its
first frame is that camera's first frame; later frames draw other random
points), and the others at the sides and the back of the street: each
camera loads its own pyramids, as the cameras of a real rig do.
"""

from __future__ import annotations

import numpy as np

from . import sim

#: the ego pose's frame interval (s) and speed along the street (m/s):
#: ``sim.generate_sequence``'s defaults, whose pose formula
#: :func:`surround_sequence` follows
DT, SPEED = 0.1, 0.5


def quat_multiply(a, b) -> np.ndarray:
    """The Hamilton product ``a * b`` of two wxyz quaternions: ``b``'s
    rotation in the body frame that ``a`` gives."""
    aw, ax, ay, az = (float(v) for v in a)
    bw, bx, by, bz = (float(v) for v in b)
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def mounts(n_cameras: int) -> np.ndarray:
    """``[n_cameras, 4]``: camera ``k``'s wxyz mount, a turn of ``k * 360 /
    n_cameras`` degrees about the body's z axis."""
    yaw = 2.0 * np.pi * np.arange(n_cameras) / n_cameras
    return np.stack([np.cos(yaw / 2), np.zeros(n_cameras),
                     np.zeros(n_cameras), np.sin(yaw / 2)], axis=1)


def surround_sequence(n_frames: int, cfg, n_cameras: int, seed: int = 0):
    """Yield ``(points [n, P, 3], n_points [n], sensor_pos [n, 3], quat
    [n, 4], t [n])`` numpy tuples, one a frame, ``n = n_cameras``: the ego
    pose of ``sim.generate_sequence(n_frames, cfg, seed=seed)`` on
    ``sim.street_scene(seed)``, every camera at the ego position with the
    ego's attitude composed with its mount (:func:`mounts`), rendered in
    turn from one generator."""
    scene = sim.street_scene(seed)
    rng = np.random.default_rng(seed + 1)
    mount = mounts(n_cameras)
    for i in range(n_frames):
        t = i * DT
        pos = np.array([SPEED * t, 0.3 * np.sin(0.3 * t), 1.0])
        yaw = 0.1 * np.sin(0.5 * t)
        ego = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
        quats = np.stack([quat_multiply(ego, m) for m in mount])
        clouds = [sim.render_frame(
            scene, pos, q, t, rng, cfg.max_input_points,
            fov_h_deg=cfg.half_fov_h_deg, fov_v_deg=cfg.half_fov_v_deg)
            for q in quats]
        yield (np.stack([c[0] for c in clouds]),
               np.asarray([c[1] for c in clouds], np.int32),
               np.tile(pos.astype(np.float32), (n_cameras, 1)),
               quats.astype(np.float32),
               np.full(n_cameras, t, np.float32))
