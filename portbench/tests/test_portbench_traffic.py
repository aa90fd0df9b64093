"""The traffic generator (``portbench/traffic/``): laps that repeat, poses
and times that run on, frames the program admits, open ground that holds
the ground alone."""

import dataclasses

import numpy as np
import pytest

import dspmap_tpu_torch as dm
from dspmap_tpu_torch.models import pipeline
from portbench.traffic import generator

SEED = 2**31 + 12345


def _lap(name, frames=40, **changes):
    mix = generator.load(name)
    mix.update(lap_frames=frames, **changes)
    cfg = dm.example_node_settings(dm.dsp_dynamic())
    return generator.render_lap(mix, SEED, cfg.max_input_points,
                                cfg.half_fov_h_deg, cfg.half_fov_v_deg), cfg


@pytest.mark.parametrize("name", ["street", "rig4", "open_ground"])
def test_laps_repeat_with_the_lap_point_count(name):
    lap, _ = _lap(name, frames=12, rays=generator.load(name)["rays"] // 4)
    K = lap.frames
    for j in range(K):
        a, b = lap.frame(j), lap.frame(j + K)
        np.testing.assert_array_equal(a[1], b[1])  # the lap's point count
        np.testing.assert_array_equal(a[0], b[0])  # the body-frame clouds
        np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_allclose(b[2] - a[2],
                                   np.tile([lap.block_length, 0, 0],
                                           (lap.cameras, 1)), atol=1e-5)
        np.testing.assert_allclose(b[4] - a[4], lap.period, atol=1e-4)


def test_street_frames_fill_the_point_budget():
    lap, cfg = _lap("street", frames=10)
    assert (lap.n_points == cfg.max_input_points).all()


def test_poses_and_times_run_on_and_pass_admission():
    lap, cfg = _lap("street", frames=20, rays=2000)
    state = dm.init_state(cfg, sensor_pos=lap.frame(0)[2][0], device="cpu")
    last_pos, last_t = None, None
    for i in range(3 * lap.frames + 1):
        pts, n, pos, quat, t = lap.frame(i)
        if last_pos is not None:
            dt = float(t[0] - last_t)
            assert abs(dt - 0.1) < 1e-4
            step = np.abs(pos[0] - last_pos)
            assert step[0] < 0.1 and step[1] < 0.1 and step[2] == 0
        frame = dm.Frame(pts[0], int(n[0]), pos[0], quat[0],
                         np.float32(t[0]))
        pro = pipeline.prologue(state, frame, cfg)
        assert pro.accepted, i
        state = dataclasses.replace(
            state, last_sensor_pos=pro.sensor_pos.copy(),
            last_timestamp=pro.timestamp, update_time=pro.update_time,
            initialized=True)
        last_pos, last_t = pos[0], t[0]


def test_rig_frames_are_admitted_on_every_camera():
    lap, cfg = _lap("rig4", frames=6, rays=2000)
    state = pipeline.init_multisensor_state(cfg, 4,
                                            sensor_pos=lap.frame(0)[2][0],
                                            device="cpu")
    for i in range(6):
        pts, n, pos, quat, t = lap.frame(i)
        frames = dm.stack_frames([dm.Frame(pts[c], int(n[c]), pos[c],
                                           quat[c], np.float32(t[c]))
                                  for c in range(4)])
        pro = pipeline.multisensor_prologue(state, frames, cfg, 4)
        assert pro.accepted and all(pro.admitted)


def test_open_ground_holds_ground_returns_only():
    """The street's camera over ground alone: the returns fall where the
    geometry puts them (some 3,500 a frame), under the point budget."""
    lap, cfg = _lap("open_ground", frames=30)
    assert 3000 <= lap.n_points.min()
    assert lap.n_points.max() < cfg.max_input_points
    for j in range(lap.frames):
        pts, n, pos, quat, _ = lap.frame(j)
        world = pts[0, :n[0]] @ generator.rotation(quat[0]).T + pos[0]
        assert np.abs(world[:, 2]).max() < 0.1


def test_every_seed_sees_the_mix_scene_sampled_anew():
    mix = generator.load("street")
    mix.update(lap_frames=4, rays=3000)
    a = generator.render_lap(mix, 1, 5000, 42, 24)
    b = generator.render_lap(mix, 2, 5000, 42, 24)
    np.testing.assert_array_equal(a.sensor_pos, b.sensor_pos)
    assert not np.array_equal(a.points, b.points)
    mix.update(scene_seed=mix["scene_seed"] + 1)
    c = generator.render_lap(mix, 1, 5000, 42, 24)
    assert not np.array_equal(a.points, c.points)
