"""Live ROS bridge mirroring the reference example node
(the reference's ``src/map_sim_example.cpp``): subscribe a depth point
cloud + pose, run the map step on the CUDA card, and publish

* the occupancy cloud (``/my_map/cloud_ob`` analogue; :378-384),
* the map-center pose (:386-395),
* the mid-layer future-status cloud with the rainbow color map (:398-427),
* the FOV line-strip marker (``showFOV``; :129-183,512),
* actor cylinder markers for ground-truth pedestrians (:69-107,476),
* the per-frame update time (:434-437).

``rospy`` is an optional dependency: constructing :class:`DspMapRosNode`
without a ROS environment raises ImportError with a pointer to the offline
path (``io/replay.py`` + ``utils/viz.py``), which shares all the marker
functions (``utils/markers.py``).  Point-cloud preprocessing (voxel
down-sample, camera->body axis remap, crop) matches the reference's
callback (:306-336) via ``native/preprocess.cpp`` when built, with the
numpy fallback of ``io/rosbag.py``.

The port's counterpart of ``dspmap_tpu/io/ros_bridge.py``: the same topics
and callbacks; the state is built by ``init_state(cfg, seed=0,
device=device)`` (the card unless ``device`` names another; no card raises)
and the step is ``make_graphed_step(cfg)`` on the card (the JAX node's
``jax.jit``), ``make_step(cfg)`` on the CPU.  The occupancy readout is
copied to the host once a frame for publishing, inside the timed span.
"""

from __future__ import annotations

import time

import numpy as np

from .. import (Frame, dsp_dynamic, example_node_settings, init_state,
                make_graphed_step, make_step, read_occupancy)


def _require_rospy():
    try:
        import rospy  # noqa: F401
        import sensor_msgs.point_cloud2  # noqa: F401
        return rospy
    except ImportError as e:  # pragma: no cover - needs a ROS environment
        raise ImportError(
            "io.ros_bridge needs rospy (a sourced ROS environment); for "
            "offline use feed recorded bags through io.replay / io.rosbag "
            "and export displays with utils.viz + utils.markers"
        ) from e


def _xyz_cloud_msg(rospy, points: np.ndarray, frame_id: str, stamp,
                   rgb: np.ndarray | None = None):
    from sensor_msgs.msg import PointField
    from sensor_msgs.point_cloud2 import create_cloud
    from std_msgs.msg import Header

    header = Header()
    header.frame_id = frame_id
    header.stamp = stamp
    fields = [
        PointField(name=n, offset=4 * i, datatype=PointField.FLOAT32, count=1)
        for i, n in enumerate("xyz")
    ]
    if rgb is None:
        return create_cloud(header, fields, points.tolist())
    packed = (
        rgb[:, 0].astype(np.uint32) << 16
        | rgb[:, 1].astype(np.uint32) << 8
        | rgb[:, 2].astype(np.uint32)
    ).view(np.float32)
    fields.append(PointField(name="rgb", offset=12,
                             datatype=PointField.FLOAT32, count=1))
    data = np.column_stack([points.astype(np.float32), packed])
    return create_cloud(header, fields, data.tolist())


class DspMapRosNode:
    """The reference example node on the port: one step per synchronized
    (cloud, pose) pair, all displays published per frame."""

    def __init__(self, cfg=None, threshold: float = 0.2, device=None):
        rospy = _require_rospy()
        from geometry_msgs.msg import PoseStamped
        from sensor_msgs.msg import PointCloud2
        from std_msgs.msg import Float64
        from visualization_msgs.msg import Marker, MarkerArray

        self.rospy = rospy
        self.cfg = cfg or example_node_settings(dsp_dynamic())
        self.threshold = threshold
        self.state = init_state(self.cfg, seed=0, device=device)
        # one captured CUDA graph a frame on the card (the JAX node's
        # jax.jit), the eager step on the CPU
        self.step = (make_graphed_step(self.cfg)
                     if self.state.device.type == "cuda"
                     else make_step(self.cfg))
        self._pose = None

        self.pub_cloud = rospy.Publisher("~cloud_ob", PointCloud2,
                                         queue_size=1)
        self.pub_future = rospy.Publisher("~future_status", PointCloud2,
                                          queue_size=1)
        self.pub_center = rospy.Publisher("~map_center", PoseStamped,
                                          queue_size=1)
        self.pub_fov = rospy.Publisher("~fov", Marker, queue_size=1)
        self.pub_actors = rospy.Publisher("~actors", MarkerArray,
                                          queue_size=1)
        self.pub_time = rospy.Publisher("~update_time", Float64,
                                        queue_size=1)
        rospy.Subscriber("~pose", PoseStamped, self._on_pose, queue_size=1)
        rospy.Subscriber("~cloud", PointCloud2, self._on_cloud, queue_size=1)

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
        from sensor_msgs.point_cloud2 import read_points

        cfg = self.cfg
        pos, quat = self._pose
        raw = np.array(
            [p[:3] for p in read_points(msg, ("x", "y", "z"),
                                        skip_nans=True)],
            np.float32,
        )
        from .native import preprocess_frame  # downsample+remap+crop

        pts, n = preprocess_frame(
            raw, cfg.voxel_filter_resolution,
            np.asarray(cfg.half_extent, np.float32), cfg.max_input_points,
        )
        t0 = time.perf_counter()
        frame = Frame(pts, n, pos, quat, np.float32(msg.header.stamp.to_sec()))
        self.state, out = self.step(self.state, frame)
        occ, centers, future, weight, self.state = read_occupancy(
            self.state, cfg, self.threshold
        )
        occ, centers, future = (x.cpu().numpy() for x in (occ, centers, future))
        wall = time.perf_counter() - t0

        self._publish(msg.header.stamp, pos, quat, occ, centers, future, out,
                      wall)

    # -- publishing ------------------------------------------------------
    def _publish(self, stamp, pos, quat, occ, centers, future, out, wall):
        rospy = self.rospy
        from geometry_msgs.msg import Point, PoseStamped
        from std_msgs.msg import Float64
        from visualization_msgs.msg import Marker

        from ..utils import markers as mk

        self.pub_cloud.publish(
            _xyz_cloud_msg(rospy, centers[occ], "map", stamp)
        )

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
        self.pub_future.publish(_xyz_cloud_msg(rospy, pts, "map", stamp, rgb))

        fov = Marker()
        fov.header.frame_id = "map"
        fov.header.stamp = stamp
        fov.ns, fov.id, fov.type, fov.action = "lines_and_points", 999, 4, 0
        fov.scale.x = fov.scale.y = fov.scale.z = 0.1
        fov.color.r, fov.color.g, fov.color.b, fov.color.a = 0.8, 0.5, 0.5, 0.8
        for p in mk.fov_marker_points(
            quat, np.radians(2 * self.cfg.half_fov_h_deg),
            np.radians(2 * self.cfg.half_fov_v_deg),
        ):
            fov.points.append(Point(x=float(p[0] + pos[0]),
                                    y=float(p[1] + pos[1]),
                                    z=float(p[2] + pos[2])))
        self.pub_fov.publish(fov)

        self.pub_time.publish(Float64(data=wall))

    def spin(self):  # pragma: no cover - needs a ROS environment
        self.rospy.spin()


def main():  # pragma: no cover - needs a ROS environment
    rospy = _require_rospy()
    rospy.init_node("dspmap_tpu")
    DspMapRosNode().spin()


if __name__ == "__main__":  # pragma: no cover
    main()
