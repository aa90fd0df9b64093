"""The four-camera frames and the weak-scaling maps (CPU): the surround rig
of ``utils/rig.py``, the graph ritual's frames at two and at four cameras
(``utils/graph_ritual.py``), and the weak-scaling mode's grown maps and
efficiency (``utils/shard_probe.py``).

The rig follows ``sim.generate_sequence``'s ego pose: its first camera's
first frame is that sequence's first frame, every camera sits at the ego
position turned k x 360/n degrees about the body's z axis, and each
camera's points lie in its own field of view.  The ritual keeps the two
patterns of one camera at two cameras (the two-camera paths' frames are
unchanged) and at four adds a frame of cameras 0 and 2, so a four-camera
run captures four graphs.  ``graph_ritual.sequence`` gives every path its
frames, stacked for several cameras.  The grown maps keep a rank's slab
the one-rank map: flagship 175,104 / 349,184 / 720,896 storage voxels and
large_urban 5,439,488 / 10,813,440 / 21,626,880 at 1 / 2 / 4 ranks, each
divisible by its rank count, large_urban with 131,072 compact rows a rank
and the update budgets that its check runs at.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch import geometry
from dspmap_tpu_torch.utils import graph_ritual as gr
from dspmap_tpu_torch.utils import rig, shard_probe, sim

torch.set_num_threads(2)

KW = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=512)


def _cfg():
    return T.example_node_settings(T.dsp_dynamic(**KW))


def _rz(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]])


@pytest.mark.parametrize("n_cameras", [2, 4])
def test_rig_follows_the_ego_pose_with_each_camera_turned(n_cameras):
    cfg = _cfg()
    seq = list(sim.generate_sequence(5, cfg, seed=3))
    frames = list(rig.surround_sequence(5, cfg, n_cameras, seed=3))
    pts, n, pos, quat, t = frames[0]
    np.testing.assert_array_equal(pts[0], seq[0][0])
    assert n[0] == seq[0][1]
    for (pts, n, pos, quat, t), (_, _, pos0, quat0, t0) in zip(frames, seq):
        assert pts.shape == (n_cameras, cfg.max_input_points, 3)
        assert pts.dtype == pos.dtype == quat.dtype == t.dtype == np.float32
        assert n.dtype == np.int32 and (n > 0).all()
        np.testing.assert_array_equal(pos, np.tile(pos0, (n_cameras, 1)))
        np.testing.assert_array_equal(t, np.full(n_cameras, t0))
        np.testing.assert_allclose(quat[0], quat0, atol=1e-7)
        ego = geometry.rotation_matrix_np(quat0)
        for k in range(n_cameras):
            np.testing.assert_allclose(
                geometry.rotation_matrix_np(quat[k]),
                ego @ _rz(360.0 * k / n_cameras), atol=1e-6)
            np.testing.assert_allclose(np.linalg.norm(quat[k]), 1, atol=1e-6)


def test_rig_points_lie_in_each_cameras_view():
    cfg = _cfg()
    for pts, n, *_ in rig.surround_sequence(3, cfg, 4, seed=0):
        for k in range(4):
            p = pts[k, :n[k]]
            assert (pts[k, n[k]:] == 0).all()
            az = np.degrees(np.arctan2(p[:, 1], p[:, 0]))
            el = np.degrees(np.arctan2(p[:, 2], p[:, 0]))
            assert (np.abs(az) < cfg.half_fov_h_deg).all(), k
            assert (np.abs(el) < cfg.half_fov_v_deg).all(), k
            assert (np.linalg.norm(p, axis=1) < 8.0).all(), k
        assert len({pts[k].tobytes() for k in range(4)}) == 4


def test_quat_multiply_composes_rotations():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 4))
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    np.testing.assert_allclose(
        geometry.rotation_matrix_np(rig.quat_multiply(a, b)),
        geometry.rotation_matrix_np(a) @ geometry.rotation_matrix_np(b),
        atol=1e-6)


def test_sequence_gives_each_paths_frames():
    """One camera: ``sim.generate_sequence``'s frames; several cameras
    sharing a cloud: each frame stacked once a camera; the rig: its own
    frames, seed 0 throughout."""
    cfg = _cfg()
    seq = [T.Frame(*f) for f in sim.generate_sequence(3, cfg, seed=0)]
    surround = [T.Frame(*f) for f in rig.surround_sequence(3, cfg, 4, seed=0)]
    for got, want in ((gr.sequence(3, cfg), seq),
                      (gr.sequence(3, cfg, 2),
                       [T.stack_frames([f] * 2) for f in seq]),
                      (gr.sequence(3, cfg, 4, rig=True), surround)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert np.asarray(x).shape == np.asarray(y).shape
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_ritual_patterns_at_two_cameras_are_unchanged():
    """The two-camera paths keep their frames: camera 0 alone at frame 2,
    camera 1 alone at frame 6, both on the other frames, as when each
    camera of a frame was skipped before stacking."""
    assert gr.some_cameras(2) == {2: (True, False), 6: (False, True)}
    seq = [T.Frame(*f) for f in sim.generate_sequence(gr.FRAMES, _cfg())]
    frames, patterns = gr.ritual_frames(gr.sequence(gr.FRAMES, _cfg(), 2), 2)
    assert [gr.pattern_label(p) for p in patterns] == [
        "11", "11", "10", "11", "11", "11", "01", "11"]
    jumped = gr.ritual_frames(seq)[0]
    for frame, one, p in zip(frames, jumped, patterns):
        want = T.stack_frames([one if ok else one._replace(
            quat=np.full(4, np.nan, np.float32)) for ok in p])
        for a, b in zip(frame, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ritual_patterns_at_four_cameras():
    """All cameras, camera 0 alone, cameras 0 and 2, the last camera alone:
    four patterns, four captures.  A rig frame keeps its own clouds and
    poses; only the skipped cameras' quaternions change, and the rejected
    frame moves every camera."""
    cfg = _cfg()
    rig_seq = gr.sequence(gr.FRAMES, cfg, 4, rig=True)
    frames, patterns = gr.ritual_frames(rig_seq, 4)
    labels = [gr.pattern_label(p) for p in patterns]
    assert labels == ["1111", "1111", "1000", "1111", "1010", "1111", "0001",
                      "1111"]
    assert {"1111", "1000", "0001"} < set(labels) and len(set(labels)) == 4
    for k, (frame, orig, p) in enumerate(zip(frames, rig_seq, patterns)):
        np.testing.assert_array_equal(frame.points, orig.points)
        np.testing.assert_array_equal(frame.n_points, orig.n_points)
        assert tuple(np.isfinite(frame.quat).all(axis=1)) == p
        ok = np.asarray(p)
        np.testing.assert_array_equal(frame.quat[ok], orig.quat[ok])
        jump = frame.sensor_pos - orig.sensor_pos
        np.testing.assert_array_equal(
            jump, np.tile(np.float32([gr.JUMP_M * (k == gr.REJECTED), 0, 0]),
                          (4, 1)))
    # one camera's frames given to four cameras: the same patterns
    assert gr.ritual_frames(gr.sequence(gr.FRAMES, cfg, 4), 4)[1] == patterns
    with pytest.raises(ValueError, match="4 cameras, 2 patterns"):
        gr.cameras(rig_seq[0], (True, False))


@pytest.mark.parametrize("preset,voxels", [
    ("flagship", (175_104, 349_184, 720_896)),
    ("large_urban", (5_439_488, 10_813_440, 21_626_880))])
def test_weak_configs_keep_a_ranks_slab_the_one_rank_map(preset, voxels):
    one = shard_probe.weak_config(preset, 1)
    for n, v in zip((1, 2, 4), voxels):
        cfg = shard_probe.weak_config(preset, n)
        cfg.validate()
        assert cfg.nz == one.nz * n and cfg.storage_voxels == v
        assert v % n == 0 and cfg.voxel_num == one.voxel_num * n
        assert 0.99 <= (v // n) / one.storage_voxels <= 1.03, (n, v)
        same = {f.name for f in dataclasses.fields(cfg)} - {
            "nz", "particle_capacity"}
        assert all(getattr(cfg, f) == getattr(one, f) for f in same)
        if preset == "large_urban":
            assert cfg.layout == "compact" and cfg.mover_exchange == "ring"
            assert cfg.compact_capacity == 131_072 * n
            assert cfg.compact_capacity // n == one.compact_capacity
            assert cfg == dataclasses.replace(
                T.large_urban(), mover_exchange="ring", nz=60 * n,
                particle_capacity=131_072 * n,
                **shard_probe.WEAK_URBAN_BUDGETS)
        else:
            assert cfg.layout == "pool"
            assert cfg == dataclasses.replace(
                T.example_node_settings(T.dsp_dynamic()), nz=40 * n)
    with pytest.raises(ValueError, match="no weak-scaling preset"):
        shard_probe.weak_config("static", 2)


def test_weak_large_urban_raises_only_its_update_budgets():
    """The weak large_urban runs and their check share one configuration:
    the preset's update budgets raised to the sharded probe's, nothing
    else."""
    raised = shard_probe.WEAK_URBAN_BUDGETS
    assert set(raised) == {"particle_spill_capacity", "pyramid_slot_capacity"}
    assert all(v == shard_probe.UNCONTESTED[k] > getattr(T.large_urban(), k)
               for k, v in raised.items())


def test_weak_summary_efficiency_is_rate_n_over_n_rate_1():
    line = lambda n, p, v: dict(preset="flagship", ranks=n,  # noqa: E731
                                particles_per_s=p, voxel_slots_per_s=v)
    out = shard_probe.weak_summary([line(1, 100.0, 10.0),
                                    line(2, 110.0, 18.0),
                                    line(4, 120.0, 36.0),
                                    dict(line(2, 5.0, 5.0),
                                         preset="large_urban")])
    flag = out["by_preset"]["flagship"]
    assert flag[1]["particles_efficiency"] == 1.0
    assert flag[2]["particles_efficiency"] == pytest.approx(0.55)
    assert flag[4]["particles_efficiency"] == pytest.approx(0.3)
    assert flag[2]["voxel_slots_efficiency"] == pytest.approx(0.9)
    assert flag[4]["voxel_slots_efficiency"] == pytest.approx(0.9)
    # no one-rank run: no efficiency
    assert out["by_preset"]["large_urban"][2]["particles_efficiency"] is None
