"""The one traffic generator: a drone's depth cameras over a street that
repeats along x, rendered from a mix's parameter file and a seed.

It follows the structure of upstream ``street.bag`` (``readme.md:47-57``): a
depth camera on a drone flying down a street between two walls, past
pillars, with pedestrians walking across it.  Two things differ from a
one-off scene:

* the street is periodic along x.  A block of ``block_length`` metres (the
  drone's travel over one lap of ``lap_frames`` frames) holds the same
  pillars and pedestrians, and every pedestrian walks to and fro across the
  street with a period that divides the lap's duration.  So the world seen
  from pose ``p`` at time ``t`` is the world seen from ``p + (L, 0, 0)`` at
  ``t + K * dt``: one lap is rendered, and lap ``l`` replays its body-frame
  clouds with the pose moved by ``l * L`` and the time by ``l * K * dt``.
  Poses and timestamps run on without a jump, however long the window;
* surfaces are sampled at ``density`` points a square metre (the ground at
  ``ground_density``), and each camera keeps at most the node's
  ``max_input_points`` of what it sees, so a street frame fills the budget.

A mix's file (``traffic/<name>.json``) gives every number, and its
``scene_seed`` places the pillars and pedestrians within their block and
sets the pedestrians' phases: every run of a mix sees the same street.  The
run's seed draws the rays' directions and range noise, so every seed
renders the same scene, frames, cameras and blocks, sampled anew.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


def load(name: str, root: pathlib.Path = HERE) -> dict:
    """The parameters of mix ``name`` (``<root>/<name>.json``)."""
    return json.loads((root / f"{name}.json").read_text())


@dataclasses.dataclass
class Lap:
    """One rendered lap: ``K`` frames of ``C`` cameras."""

    points: np.ndarray  # f32 [K, C, P, 3], body frame, zero-padded
    n_points: np.ndarray  # i32 [K, C]
    sensor_pos: np.ndarray  # f64 [K, 3], world
    quat: np.ndarray  # f64 [K, C, 4], wxyz body -> world
    t: np.ndarray  # f64 [K]
    block_length: float
    period: float

    @property
    def frames(self) -> int:
        return int(self.t.shape[0])

    @property
    def cameras(self) -> int:
        return int(self.points.shape[1])

    def frame(self, i: int):
        """Frame ``i`` of the endless sequence: ``(points [C, P, 3], n [C],
        sensor_pos [C, 3], quat [C, 4], t [C])``, float32 numpy."""
        lap, j = divmod(int(i), self.frames)
        pos = self.sensor_pos[j] + np.array([lap * self.block_length, 0.0,
                                             0.0])
        t = self.t[j] + lap * self.period
        c = self.cameras
        return (self.points[j], self.n_points[j],
                np.tile(pos.astype(np.float32), (c, 1)),
                self.quat[j].astype(np.float32),
                np.full(c, np.float32(t), np.float32))


@dataclasses.dataclass
class Box:
    center: np.ndarray  # [3] at t = 0, within block 0
    size: np.ndarray  # [3]
    walk: tuple | None = None  # (y_lo, y_hi, period, phase) of a pedestrian


def _quat_yaw(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def quat_multiply(a, b) -> np.ndarray:
    """The Hamilton product ``a * b`` of two wxyz quaternions."""
    aw, ax, ay, az = (float(v) for v in a)
    bw, bx, by, bz = (float(v) for v in b)
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def rotation(q) -> np.ndarray:
    """The body -> world rotation matrix of a wxyz quaternion."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def block_boxes(mix: dict, rng: np.random.Generator, period: float,
                length: float) -> list:
    """The pillars and pedestrians of one block, placed from ``rng``."""
    boxes = []
    half_street = mix["street_half_width"]
    for k in range(mix["pillars_per_block"]):
        x = (k + rng.uniform(0.2, 0.8)) * length / mix["pillars_per_block"]
        y = rng.choice([-1.0, 1.0]) * rng.uniform(1.0, half_street - 1.0)
        boxes.append(Box(np.array([x, y, 1.0]), np.array([0.4, 0.4, 2.0])))
    lo, hi = -half_street + 0.5, half_street - 0.5
    for k, laps in enumerate(mix["pedestrian_crossings_per_lap"]):
        x = (k + rng.uniform(0.2, 0.8)) * length / len(
            mix["pedestrian_crossings_per_lap"])
        boxes.append(Box(np.array([x, 0.0, 0.85]), np.array([0.45, 0.45, 1.7]),
                         (lo, hi, period / laps, rng.uniform(0.0, 1.0))))
    return boxes


def _walk_y(walk, t: float) -> float:
    """A pedestrian's y at ``t``: to and fro between ``lo`` and ``hi``."""
    lo, hi, period, phase = walk
    u = (t / period + phase) % 1.0
    return lo + (hi - lo) * (2 * u if u < 0.5 else 2 * (1 - u))


def _slab_hits(o, inv, lo, hi) -> np.ndarray:
    """Distance along each ray ``o + s d`` (``inv`` = 1 / d, ``[3, N]``)
    to its entry into the box ``[lo, hi]``; ``inf`` where it misses or
    starts inside."""
    near, far = -np.inf, np.inf
    for k in range(3):
        a = (lo[k] - o[k]) * inv[k]
        b = (hi[k] - o[k]) * inv[k]
        near = np.maximum(near, np.minimum(a, b))
        far = np.minimum(far, np.maximum(a, b))
    return np.where((far >= near) & (near > 0), near, np.inf)


def cast(mix: dict, boxes: list, length: float, pos, q, t: float,
         rng: np.random.Generator, max_points: int, half_fov_h: float,
         half_fov_v: float):
    """One camera's body-frame cloud ``[max_points, 3]`` (zero-padded) and
    its count: ``rays`` rays in random directions within the field of view,
    each returning the nearest surface it meets within ``max_range``, with
    range noise; at most ``max_points`` returns are kept."""
    n = mix["rays"]
    az = np.radians(rng.uniform(-half_fov_h, half_fov_h, n))
    el = np.radians(rng.uniform(-half_fov_v, half_fov_v, n))
    d_body = np.column_stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                              np.sin(el)])
    d = d_body @ rotation(q).T
    o = np.asarray(pos, np.float64)
    hit = np.full(n, np.inf)
    with np.errstate(divide="ignore"):
        inv = 1.0 / d.T
    with np.errstate(divide="ignore", invalid="ignore"):
        ground = -o[2] / d[:, 2]
    hit = np.where(d[:, 2] < 0, np.minimum(hit, ground), hit)
    if mix["walls"]:
        for y in (mix["street_half_width"], -mix["street_half_width"]):
            with np.errstate(divide="ignore", invalid="ignore"):
                s = (y - o[1]) / d[:, 1]
            z = o[2] + s * d[:, 2]
            ok = (s > 0) & (z >= 0.0) & (z <= mix["wall_height"])
            hit = np.where(ok, np.minimum(hit, s), hit)
    reach = mix["max_range"] + 1.0
    first = int(np.floor((o[0] - reach) / length))
    last = int(np.floor((o[0] + reach) / length))
    for b in range(first, last + 1):
        for box in boxes:
            c = box.center + np.array([b * length, 0.0, 0.0])
            if box.walk is not None:
                c[1] = _walk_y(box.walk, t)
            if np.abs(c[:2] - o[:2]).max() > reach:
                continue
            with np.errstate(invalid="ignore"):
                hit = np.minimum(hit, _slab_hits(o, inv, c - box.size / 2,
                                                 c + box.size / 2))
    r = hit + rng.normal(0.0, mix["noise_std"], n)
    keep = np.flatnonzero((hit < mix["max_range"]) & (r > 0.2))[:max_points]
    out = np.zeros((max_points, 3), np.float32)
    out[:len(keep)] = d_body[keep] * r[keep, None]
    return out, len(keep)


def render_lap(mix: dict, seed: int, max_points: int, half_fov_h: float,
               half_fov_v: float) -> Lap:
    """One lap of mix ``mix`` from ``seed``, for cameras of the given field
    of view and point budget: the mix's scene, and camera ``c`` of frame
    ``j`` drawing its rays from a generator of its own, seeded by ``(seed,
    j, c)``."""
    K, dt = mix["lap_frames"], mix["dt"]
    period = K * dt
    length = mix["speed"] * period
    boxes = block_boxes(mix, np.random.default_rng([int(mix["scene_seed"]),
                                                    0]), period, length)
    cams = mix["cameras"]
    mounts = [_quat_yaw(2 * np.pi * k / cams) for k in range(cams)]
    pts = np.zeros((K, cams, max_points, 3), np.float32)
    ns = np.zeros((K, cams), np.int32)
    poss = np.zeros((K, 3))
    quats = np.zeros((K, cams, 4))
    ts = np.arange(K) * dt
    sway = mix["sway"]
    for j in range(K):
        phase = 2 * np.pi * ts[j] / period
        poss[j] = (mix["speed"] * ts[j],
                   sway["y_amplitude"] * np.sin(sway["y_cycles"] * phase),
                   mix["height"])
        ego = _quat_yaw(sway["yaw_amplitude"]
                        * np.sin(sway["yaw_cycles"] * phase))
        for c in range(cams):
            quats[j, c] = quat_multiply(ego, mounts[c])

    for j in range(K):
        for c in range(cams):
            rng = np.random.default_rng([int(seed), 1, j, c])
            pts[j, c], ns[j, c] = cast(mix, boxes, length, poss[j],
                                       quats[j, c], ts[j], rng, max_points,
                                       half_fov_h, half_fov_v)
    return Lap(pts, ns, poss, quats, ts, length, period)
