"""Live ROS2 (rclpy) bridge — the ROS2 counterpart of ``io/ros_bridge.py``,
mirroring the reference example node's topic surface
(the reference's ``src/map_sim_example.cpp``):

* occupancy cloud (``cloud_ob`` analogue; :378-384),
* map-center pose (:386-395),
* mid-layer future-status cloud, rainbow colored (:398-427),
* FOV line-strip marker (``showFOV``; :129-183,512),
* per-frame update time (:434-437).

``rclpy`` is an optional dependency: constructing :class:`DspMapRos2Node`
without a ROS2 environment raises ImportError pointing at the offline path
(``io/replay.py`` + ``utils/viz.py``).  All display geometry/color logic is
shared with the ROS1 node through ``utils/markers.py`` (tested without ROS);
only the message plumbing differs (``sensor_msgs_py.point_cloud2``,
``create_publisher``/``create_subscription``, node clocks).

The port's counterpart of ``dspmap_tpu/io/ros2_bridge.py``, built as the
port's ROS1 node is (``io/ros_bridge.py``).
"""

from __future__ import annotations

import time

import numpy as np

from .. import (Frame, dsp_dynamic, example_node_settings, init_state,
                make_graphed_step, make_step, read_occupancy)


def _require_rclpy():
    try:
        import rclpy  # noqa: F401
        import sensor_msgs_py.point_cloud2  # noqa: F401
        return rclpy
    except ImportError as e:  # pragma: no cover - needs a ROS2 environment
        raise ImportError(
            "io.ros2_bridge needs rclpy (a sourced ROS2 environment); for "
            "offline use feed recorded bags through io.replay / io.rosbag "
            "and export displays with utils.viz + utils.markers"
        ) from e


def _xyz_cloud_msg(points: np.ndarray, frame_id: str, stamp,
                   rgb: np.ndarray | None = None):
    """Build a PointCloud2 from an ``[N, 3]`` float32 array (+ optional
    ``[N, 3]`` uint8 colors packed the rviz way)."""
    from sensor_msgs.msg import PointField
    from sensor_msgs_py.point_cloud2 import create_cloud
    from std_msgs.msg import Header

    header = Header()
    header.frame_id = frame_id
    header.stamp = stamp
    fields = [
        PointField(name=n, offset=4 * i, datatype=PointField.FLOAT32,
                   count=1)
        for i, n in enumerate("xyz")
    ]
    pts = np.asarray(points, np.float32)
    if rgb is None:
        return create_cloud(header, fields, pts)
    packed = (
        rgb[:, 0].astype(np.uint32) << 16
        | rgb[:, 1].astype(np.uint32) << 8
        | rgb[:, 2].astype(np.uint32)
    ).view(np.float32)
    fields.append(PointField(name="rgb", offset=12,
                             datatype=PointField.FLOAT32, count=1))
    return create_cloud(header, fields, np.column_stack([pts, packed]))


class DspMapRos2Node:
    """The reference example node on rclpy and the port: one step per
    synchronized (cloud, pose) pair, all displays published per frame.

    Topics (relative to the node name, matching the ROS1 bridge):
    ``cloud`` + ``pose`` in; ``cloud_ob``, ``future_status``,
    ``map_center``, ``fov``, ``update_time`` out.
    """

    def __init__(self, node, cfg=None, threshold: float = 0.2,
                 device=None):
        _require_rclpy()
        from geometry_msgs.msg import PoseStamped
        from sensor_msgs.msg import PointCloud2
        from std_msgs.msg import Float64
        from visualization_msgs.msg import Marker

        self.node = node
        self.cfg = cfg or example_node_settings(dsp_dynamic())
        self.threshold = threshold
        self.state = init_state(self.cfg, seed=0, device=device)
        # one captured CUDA graph a frame on the card (the JAX node's
        # jax.jit), the eager step on the CPU
        self.step = (make_graphed_step(self.cfg)
                     if self.state.device.type == "cuda"
                     else make_step(self.cfg))
        self._pose = None

        self.pub_cloud = node.create_publisher(PointCloud2, "cloud_ob", 1)
        self.pub_future = node.create_publisher(PointCloud2,
                                                "future_status", 1)
        self.pub_center = node.create_publisher(PoseStamped, "map_center", 1)
        self.pub_fov = node.create_publisher(Marker, "fov", 1)
        self.pub_time = node.create_publisher(Float64, "update_time", 1)
        node.create_subscription(PoseStamped, "pose", self._on_pose, 1)
        node.create_subscription(PointCloud2, "cloud", self._on_cloud, 1)

    # -- callbacks -------------------------------------------------------
    def _on_pose(self, msg):
        q = msg.pose.orientation
        p = msg.pose.position
        self._pose = (
            np.array([p.x, p.y, p.z], np.float32),
            np.array([q.w, q.x, q.y, q.z], np.float32),
        )

    def _on_cloud(self, msg):
        if self._pose is None:
            return
        from sensor_msgs_py.point_cloud2 import read_points_numpy

        cfg = self.cfg
        pos, quat = self._pose
        raw = read_points_numpy(msg, ("x", "y", "z"),
                                skip_nans=True).astype(np.float32)
        from .native import preprocess_frame  # downsample+remap+crop

        pts, n = preprocess_frame(
            raw, cfg.voxel_filter_resolution,
            np.asarray(cfg.half_extent, np.float32), cfg.max_input_points,
        )
        stamp = msg.header.stamp
        t = float(stamp.sec) + 1e-9 * float(stamp.nanosec)
        t0 = time.perf_counter()
        frame = Frame(pts, n, pos, quat, np.float32(t))
        self.state, out = self.step(self.state, frame)
        occ, centers, future, weight, self.state = read_occupancy(
            self.state, cfg, self.threshold
        )
        occ, centers, future = (x.cpu().numpy() for x in (occ, centers, future))
        wall = time.perf_counter() - t0

        self._publish(stamp, pos, quat, occ, centers, future, wall)

    # -- publishing ------------------------------------------------------
    def _publish(self, stamp, pos, quat, occ, centers, future, wall):
        from geometry_msgs.msg import Point, PoseStamped
        from std_msgs.msg import Float64
        from visualization_msgs.msg import Marker

        from ..utils import markers as mk

        self.pub_cloud.publish(_xyz_cloud_msg(centers[occ], "map", stamp))

        ps = PoseStamped()
        ps.header.stamp = stamp
        ps.header.frame_id = "map"
        ps.pose.position.x, ps.pose.position.y, ps.pose.position.z = map(
            float, pos
        )
        (ps.pose.orientation.w, ps.pose.orientation.x,
         ps.pose.orientation.y, ps.pose.orientation.z) = map(float, quat)
        self.pub_center.publish(ps)

        pts, rgb = mk.future_layer_cloud(future, centers, self.cfg.nz)
        self.pub_future.publish(_xyz_cloud_msg(pts, "map", stamp, rgb))

        fov = Marker()
        fov.header.frame_id = "map"
        fov.header.stamp = stamp
        fov.ns, fov.id = "lines_and_points", 999
        fov.type, fov.action = Marker.LINE_STRIP, Marker.ADD
        fov.scale.x = fov.scale.y = fov.scale.z = 0.1
        fov.color.r, fov.color.g, fov.color.b, fov.color.a = (
            0.8, 0.5, 0.5, 0.8)
        for p in mk.fov_marker_points(
            quat, np.radians(2 * self.cfg.half_fov_h_deg),
            np.radians(2 * self.cfg.half_fov_v_deg),
        ):
            fov.points.append(Point(x=float(p[0] + pos[0]),
                                    y=float(p[1] + pos[1]),
                                    z=float(p[2] + pos[2])))
        self.pub_fov.publish(fov)

        self.pub_time.publish(Float64(data=wall))


def main():  # pragma: no cover - needs a ROS2 environment
    rclpy = _require_rclpy()
    rclpy.init()
    node = rclpy.create_node("dspmap_tpu")
    DspMapRos2Node(node)
    rclpy.spin(node)


if __name__ == "__main__":  # pragma: no cover
    main()
