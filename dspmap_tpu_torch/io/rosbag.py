"""Minimal ROS1 bag (format 2.0) reader: extract PointCloud2 + PoseStamped
streams and convert them to the replay ``.npz`` frame format.

The reference's only test harness replays ``street.bag`` through ROS
(``launch/mapping.launch:9-11``); this module provides the ROS-free
equivalent: ``bag_to_frames('street.bag', cloud_topic='/camera_front/depth/points',
pose_topic='/mavros/local_position/pose')`` yields synchronized frames with
the example node's preprocessing applied (pose interpolation as in
``map_sim_example.cpp:275-302``, voxel-grid downsample ``:314-317``, camera
axis remap ``:320-323``, map-range crop ``:325-336``).

Implements the subset of http://wiki.ros.org/Bags/Format/2.0 needed here:
record framing, connection records, chunk decompression (none/bz2; lz4 if the
lz4 module exists), message data records, and hand-rolled deserialization of
``sensor_msgs/PointCloud2`` and ``geometry_msgs/PoseStamped``.

The port's own copy of ``dspmap_tpu/io/rosbag.py`` (numpy only);
``tests/test_torch_io.py`` holds it to the JAX package's.
"""

from __future__ import annotations

import bz2
import struct
from pathlib import Path

import numpy as np


def _read_header(data: bytes):
    fields = {}
    off = 0
    while off < len(data):
        (flen,) = struct.unpack_from("<I", data, off)
        off += 4
        field = data[off : off + flen]
        off += flen
        k, _, v = field.partition(b"=")
        fields[k.decode()] = v
    return fields


def _records(buf: bytes):
    off = 0
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        header = _read_header(buf[off + 4 : off + 4 + hlen])
        off += 4 + hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        data = buf[off + 4 : off + 4 + dlen]
        off += 4 + dlen
        yield header, data


def read_messages(path, topics=None):
    """Yield ``(topic, timestamp_sec, raw_bytes, msg_type)`` from a v2.0 bag."""
    raw = Path(path).read_bytes()
    magic = b"#ROSBAG V2.0\n"
    if not raw.startswith(magic):
        raise ValueError("not a ROS bag v2.0 file")
    body = raw[len(magic):]

    connections = {}

    def handle_record(header, data):
        op = header.get("op", b"")
        if op == b"\x07":  # connection
            conn = struct.unpack("<I", header["conn"])[0]
            sub = _read_header(data)
            connections[conn] = (
                header["topic"].decode(),
                sub.get("type", b"").decode(),
            )
        elif op == b"\x02":  # message data
            conn = struct.unpack("<I", header["conn"])[0]
            secs, nsecs = struct.unpack("<II", header["time"])
            topic, mtype = connections.get(conn, ("?", "?"))
            if topics is None or topic in topics:
                return topic, secs + nsecs * 1e-9, data, mtype
        return None

    for header, data in _records(body):
        op = header.get("op", b"")
        if op == b"\x05":  # chunk
            compression = header.get("compression", b"none").decode()
            if compression == "bz2":
                data = bz2.decompress(data)
            elif compression == "lz4":
                try:
                    import lz4.frame  # type: ignore

                    data = lz4.frame.decompress(data)
                except ImportError as e:
                    raise RuntimeError("bag uses lz4; lz4 module missing") from e
            for h, d in _records(data):
                item = handle_record(h, d)
                if item is not None:
                    yield item
        else:  # unchunked record (connection / message at top level)
            item = handle_record(header, data)
            if item is not None:
                yield item


def parse_pointcloud2(data: bytes):
    """Deserialize sensor_msgs/PointCloud2 -> (N, 3) float32 xyz."""
    off = 0
    # std_msgs/Header: seq, stamp, frame_id
    off += 4 + 8
    (flen,) = struct.unpack_from("<I", data, off); off += 4 + flen
    height, width = struct.unpack_from("<II", data, off); off += 8
    (nfields,) = struct.unpack_from("<I", data, off); off += 4
    fields = []
    for _ in range(nfields):
        (nlen,) = struct.unpack_from("<I", data, off); off += 4
        name = data[off : off + nlen].decode(); off += nlen
        f_off, dtype, count = struct.unpack_from("<IBI", data, off); off += 9
        fields.append((name, f_off, dtype, count))
    is_bigendian = data[off]; off += 1
    point_step, row_step = struct.unpack_from("<II", data, off); off += 8
    (dlen,) = struct.unpack_from("<I", data, off); off += 4
    payload = np.frombuffer(data, np.uint8, dlen, off)
    n = height * width
    pts = payload[: n * point_step].reshape(n, point_step)
    by_name = {f[0]: f for f in fields}
    out = np.empty((n, 3), np.float32)
    for i, name in enumerate(("x", "y", "z")):
        _, f_off, dtype, _ = by_name[name]
        # datatype 7 = FLOAT32 (sensor_msgs/PointField)
        out[:, i] = pts[:, f_off : f_off + 4].copy().view(np.float32)[:, 0]
    return out


def parse_pose_stamped(data: bytes):
    """Deserialize geometry_msgs/PoseStamped -> (pos[3], quat_wxyz[4], t)."""
    off = 0
    (seq,) = struct.unpack_from("<I", data, off); off += 4
    secs, nsecs = struct.unpack_from("<II", data, off); off += 8
    (flen,) = struct.unpack_from("<I", data, off); off += 4 + flen
    px, py, pz, qx, qy, qz, qw = struct.unpack_from("<7d", data, off)
    return (
        np.asarray([px, py, pz], np.float32),
        np.asarray([qw, qx, qy, qz], np.float32),
        secs + nsecs * 1e-9,
    )


def voxel_downsample(points: np.ndarray, leaf: float) -> np.ndarray:
    """PCL VoxelGrid-equivalent: one centroid per occupied leaf
    (map_sim_example.cpp:314-317)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / leaf).astype(np.int64)
    _, inv, counts = np.unique(
        keys, axis=0, return_inverse=True, return_counts=True
    )
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(np.float32)


def bag_to_frames(
    path,
    cfg,
    cloud_topic="/camera_front/depth/points",
    pose_topic="/mavros/local_position/pose",
):
    """Convert a bag to replay frames with the example node's preprocessing.

    Yields ``(points[P,3], n, sensor_pos[3], quat_wxyz[4], t_rel)`` with
    body-frame points after the camera->body axis remap (x,y,z) <-
    (z_cam,-x_cam,-y_cam) (map_sim_example.cpp:320-323), voxel-downsampled at
    ``cfg.voxel_filter_resolution`` and cropped to the map half-extents.
    Pose is slerp/lerp-interpolated to the cloud stamp (:275-302).
    Timestamps are stream-relative (first cloud = 0).
    """
    poses = []  # (t, pos, quat)
    t0 = None
    half = np.asarray(cfg.half_extent, np.float32)
    P = cfg.max_input_points
    for topic, t, data, mtype in read_messages(path, {cloud_topic, pose_topic}):
        if topic == pose_topic:
            pos, quat, ts = parse_pose_stamped(data)
            poses.append((ts, pos, quat))
            continue
        if not poses:
            continue
        ts = np.asarray([p[0] for p in poses])
        k = int(np.searchsorted(ts, t))
        k = min(max(k, 1), len(poses) - 1)
        (t_a, p_a, q_a), (t_b, p_b, q_b) = poses[k - 1], poses[k]
        f = 0.0 if t_b == t_a else np.clip((t - t_a) / (t_b - t_a), 0.0, 1.0)
        pos = p_a * (1 - f) + p_b * f
        # slerp (shortest arc)
        d = float(np.dot(q_a, q_b))
        q_b2 = q_b if d >= 0 else -q_b
        quat = q_a * (1 - f) + q_b2 * f
        quat = quat / np.linalg.norm(quat)

        cam = parse_pointcloud2(data)
        cam = cam[np.isfinite(cam).all(axis=1)]
        cam = voxel_downsample(cam, cfg.voxel_filter_resolution)
        body = np.column_stack([cam[:, 2], -cam[:, 0], -cam[:, 1]])
        keep = (np.abs(body) < half).all(axis=1)
        body = body[keep][:P]
        out = np.zeros((P, 3), np.float32)
        out[: len(body)] = body
        if t0 is None:
            t0 = t
        yield out, len(body), pos, quat, np.float32(t - t0)
