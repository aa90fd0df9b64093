"""The port's ROS1 and ROS2 nodes (``dspmap_tpu_torch/io/ros_bridge.py``,
``ros2_bridge.py``) on the CPU, without ROS: without ``rospy`` / ``rclpy``
each raises the ImportError that points at the offline path (as
``tests/test_markers.py`` requires of the JAX package's nodes); with stub
ROS modules put in ``sys.modules`` each node is built at the replay's
``--tiny`` map, takes one pose and one cloud through its callbacks and
publishes once on each topic it publishes per frame.  The occupancy cloud it
publishes equals ``read_occupancy`` of a plain port step on the same
preprocessed frame, from a state of the same seed (so the same draws)."""

import sys
import types

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch.io import native, ros2_bridge, ros_bridge
from dspmap_tpu_torch.io.replay import TINY
from dspmap_tpu_torch.utils import sim

torch.set_num_threads(2)


class Msg:
    """A message: keyword fields, and an empty message for any field read
    before it was set (``msg.header.stamp = ...``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        child = Msg()
        setattr(self, name, child)
        return child


class Marker(Msg):
    LINE_STRIP, ADD = 4, 0

    def __init__(self, **kw):
        super().__init__(points=[], **kw)


class PointField(Msg):
    FLOAT32 = 7


def _create_cloud(header, fields, points):
    return Msg(header=header, fields=fields, points=np.asarray(points))


class _Stamp:
    """A stamp of both generations: ``to_sec()`` (ROS1), ``sec`` and
    ``nanosec`` (ROS2)."""

    def __init__(self, t):
        self.sec, self.nanosec = int(t), int(round((t - int(t)) * 1e9))

    def to_sec(self):
        return self.sec + 1e-9 * self.nanosec


def _module(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


def _message_modules():
    msgs = dict(PoseStamped=Msg, Point=Msg, Header=Msg, Float64=Msg,
                PointCloud2=Msg, PointField=PointField, Marker=Marker,
                MarkerArray=Msg)
    return {
        "sensor_msgs": _module("sensor_msgs"),
        "sensor_msgs.msg": _module("sensor_msgs.msg", **msgs),
        "std_msgs": _module("std_msgs"),
        "std_msgs.msg": _module("std_msgs.msg", **msgs),
        "geometry_msgs": _module("geometry_msgs"),
        "geometry_msgs.msg": _module("geometry_msgs.msg", **msgs),
        "visualization_msgs": _module("visualization_msgs"),
        "visualization_msgs.msg": _module("visualization_msgs.msg", **msgs),
    }


class Bus:
    """Publishers and subscriptions of one node, by topic."""

    def __init__(self):
        self.published, self.callbacks = {}, {}

    def publisher(self, topic):
        self.published[topic] = []
        return Msg(publish=self.published[topic].append)


def _ros1(monkeypatch, bus):
    def read_points(msg, field_names, skip_nans):
        return [tuple(p) for p in msg.points]

    def subscriber(topic, msg_type, cb, queue_size):
        bus.callbacks[topic] = cb

    mods = _message_modules()
    mods["sensor_msgs.point_cloud2"] = _module(
        "sensor_msgs.point_cloud2", create_cloud=_create_cloud,
        read_points=read_points)
    mods["rospy"] = _module(
        "rospy", Subscriber=subscriber,
        Publisher=lambda topic, msg_type, queue_size: bus.publisher(topic))
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)


def _ros2(monkeypatch, bus):
    def subscription(msg_type, topic, cb, qos):
        bus.callbacks[topic] = cb

    mods = _message_modules()
    mods["sensor_msgs_py"] = _module("sensor_msgs_py")
    mods["sensor_msgs_py.point_cloud2"] = _module(
        "sensor_msgs_py.point_cloud2", create_cloud=_create_cloud,
        read_points_numpy=lambda msg, field_names, skip_nans: msg.points)
    mods["rclpy"] = _module("rclpy")
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return Msg(create_subscription=subscription,
               create_publisher=lambda msg_type, topic, qos:
               bus.publisher(topic))


@pytest.mark.parametrize("bridge", ["ros1", "ros2"])
def test_bridges_need_ros(monkeypatch, bridge):
    """Without ROS, building a node raises the ImportError that points at
    the offline path."""
    for name in ("rospy", "rclpy", "sensor_msgs", "sensor_msgs.point_cloud2",
                 "sensor_msgs_py", "sensor_msgs_py.point_cloud2"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="offline"):
        if bridge == "ros1":
            ros_bridge.DspMapRosNode(device="cpu")
        else:
            ros2_bridge.DspMapRos2Node(Msg(), device="cpu")


#: per bridge: topics published once a frame (the ROS1 node also holds an
#: ``actors`` publisher that no frame uses, as the JAX package's does)
TOPICS = {"ros1": ("~cloud_ob", "~future_status", "~map_center", "~fov",
                   "~update_time"),
          "ros2": ("cloud_ob", "future_status", "map_center", "fov",
                   "update_time")}


@pytest.mark.parametrize("bridge", ["ros1", "ros2"])
def test_bridge_publishes_the_ports_occupancy(monkeypatch, bridge):
    cfg = T.example_node_settings(T.dsp_dynamic(**TINY))
    bus = Bus()
    if bridge == "ros1":
        _ros1(monkeypatch, bus)
        node = ros_bridge.DspMapRosNode(cfg, threshold=0.2, device="cpu")
        prefix = "~"
    else:
        node = ros2_bridge.DspMapRos2Node(_ros2(monkeypatch, bus), cfg,
                                          threshold=0.2, device="cpu")
        prefix = ""
    assert node.state.device.type == "cpu"
    assert set(bus.callbacks) == {prefix + "pose", prefix + "cloud"}

    body, n, pos, quat, t = next(sim.generate_sequence(1, cfg, seed=0))
    # the camera frame the node remaps back to body axes (x, y, z) <-
    # (z_cam, -x_cam, -y_cam)
    cam = np.stack([-body[:n, 1], -body[:n, 2], body[:n, 0]], 1)
    t = 0.25
    pose = Msg(pose=Msg(position=Msg(x=pos[0], y=pos[1], z=pos[2]),
                        orientation=Msg(w=quat[0], x=quat[1], y=quat[2],
                                        z=quat[3])))
    bus.callbacks[prefix + "pose"](pose)
    bus.callbacks[prefix + "cloud"](Msg(header=Msg(stamp=_Stamp(t)),
                                        points=cam))

    for topic in TOPICS[bridge]:
        assert len(bus.published[topic]) == 1, topic
    assert all(not bus.published[k] for k in bus.published
               if k not in TOPICS[bridge])
    cloud = bus.published[prefix + "cloud_ob"][0].points

    pts, n_pts = native.preprocess_frame(
        cam, cfg.voxel_filter_resolution,
        np.asarray(cfg.half_extent, np.float32), cfg.max_input_points)
    state, _ = T.make_step(cfg)(T.init_state(cfg, seed=0, device="cpu"),
                                T.Frame(pts, n_pts, pos, quat, np.float32(t)))
    occ, centers, _, _, _ = T.read_occupancy(state, cfg, 0.2)
    want = centers[occ].numpy()
    assert len(want) > 0
    np.testing.assert_array_equal(np.asarray(cloud, np.float32), want)
    center = bus.published[prefix + "map_center"][0].pose.position
    assert (center.x, center.y, center.z) == tuple(float(v) for v in pos)
    assert bus.published[prefix + "update_time"][0].data > 0
    assert len(bus.published[prefix + "fov"][0].points) == 10
    assert node.state.update_counter == 1


def test_bridge_without_a_device_needs_a_card(monkeypatch):
    """Built without a device where there is no card, a node raises: it
    does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _ros1(monkeypatch, Bus())
    with pytest.raises(RuntimeError, match="CUDA"):
        ros_bridge.DspMapRosNode(T.example_node_settings(T.dsp_dynamic(**TINY)))
