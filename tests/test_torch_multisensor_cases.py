"""The four cases of ``tests/test_multisensor.py`` on the port's
multi-sensor step (CPU, the same map): a bad camera is skipped per sensor,
not per frame; an idle second camera is the identity; sensors without
observations never add mass; two cameras looking at opposite halves of a
scene map both.

The JAX package derives each frame's keys from the state's key whatever
the number of sensors, so its idle-sensor case runs each configuration
from its own key.  The port draws from the state's generator in a fixed
order (``make_multisensor_draws``: sensor 0's draws, then sensor 1's), so a
second sensor shifts the next frame's draws; the idle-sensor case
therefore hands both steps the same sensor-0 draws.
"""

import numpy as np
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch.utils import sim

torch.set_num_threads(2)


def _small_cfg():
    return T.example_node_settings(T.dsp_dynamic(
        nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=512,
        mover_capacity=4096, pyramid_slot_capacity=64, max_clusters=8))


def _street_frames(cfg, n_frames, seed=0):
    """Two-sensor frames of the street scene: both sensors share the pose
    and the cloud."""
    return [T.stack_frames([T.Frame(*f)] * 2)
            for f in sim.generate_sequence(n_frames, cfg, seed=seed)]


def test_bad_sensor_quaternion_skipped_per_sensor():
    """A NaN or out-of-range quaternion on sensor 1 leaves the frame
    accepted and the map finite and independent of which garbage it
    holds, and differs from the all-good run (sensor 1 is gated out)."""
    cfg = _small_cfg()
    step = T.make_multisensor_step(cfg, 2)

    def run(poison):
        state = T.init_multisensor_state(cfg, 2, seed=0, device="cpu")
        for f in _street_frames(cfg, 4):
            if poison is not None:
                q = f.quat.copy()
                q[1] = poison
                f = f._replace(quat=q)
            state, out = step(state, f)
            assert out.accepted
        return state.weight_sum.numpy()

    w_nan = run(np.full(4, np.nan, np.float32))
    w_big = run(np.full(4, 7.0, np.float32))
    w_good = run(None)
    assert np.isfinite(w_nan).all()
    np.testing.assert_array_equal(w_nan, w_big)
    assert not np.array_equal(w_nan, w_good)
    assert w_nan.sum() > 0


def test_complementary_idle_sensor_is_identity():
    """A second sensor looking away from every particle with an empty
    cloud is an identity stage: with the same sensor-0 draws the
    two-sensor map equals the one-sensor map exactly."""
    cfg = _small_cfg()
    step1 = T.make_multisensor_step(cfg, 1)
    step2 = T.make_multisensor_step(cfg, 2)
    q_bwd = np.array([0.0, 0.0, 0.0, 1.0], np.float32)  # yaw 180 deg
    s1 = T.init_multisensor_state(cfg, 1, seed=0, device="cpu")
    s2 = T.init_multisensor_state(cfg, 2, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for pts, n, pos, quat, t in sim.generate_sequence(5, cfg, seed=0):
        prop, (d0, d1) = T.make_multisensor_draws(cfg, 2, gen, "cpu")
        s1, o1 = step1(s1, T.stack_frames([T.Frame(pts, n, pos, quat, t)]),
                       (prop, (d0,)))
        s2, o2 = step2(s2, T.stack_frames([
            T.Frame(pts, n, pos, quat, t),
            T.Frame(np.zeros_like(pts), 0, pos, q_bwd, t)]), (prop, (d0, d1)))
        assert o1.accepted and o2.accepted
    w1, w2 = s1.weight_sum.numpy(), s2.weight_sum.numpy()
    assert w1.sum() > 0
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(s1.particles.weight.numpy(),
                                  s2.particles.weight.numpy())


def test_empty_sensors_never_increase_mass():
    """Sensors with no observations only downweight (the miss penalty
    inside the FOV) and never give birth: the total map mass does not
    grow over frames without points."""
    cfg = _small_cfg()
    step = T.make_multisensor_step(cfg, 2)
    state = T.init_multisensor_state(cfg, 2, seed=0, device="cpu")
    frames = _street_frames(cfg, 8)
    for f in frames[:4]:
        state, _ = step(state, f)
    mass = float(state.weight_sum.sum())
    assert mass > 0
    for f in frames[4:]:
        state, out = step(state, f._replace(n_points=np.zeros_like(
            f.n_points)))
        assert out.accepted
        new_mass = float(state.weight_sum.sum())
        assert new_mass <= mass * (1.0 + 1e-5), (new_mass, mass)
        mass = new_mass


def test_two_sensor_fusion_covers_both_halves():
    """Two cameras at one position, one looking forward at a pillar at +x
    and one backward at a pillar at -x: both pillars are mapped."""
    cfg = _small_cfg()
    scene_fwd = sim.Scene(boxes=[sim.Box(np.array([2.0, 0.5, 1.0]),
                                         np.array([0.5, 0.5, 2.0]),
                                         np.zeros(3))], ground_extent=4.0)
    scene_bwd = sim.Scene(boxes=[sim.Box(np.array([-2.0, -0.5, 1.0]),
                                         np.array([0.5, 0.5, 2.0]),
                                         np.zeros(3))], ground_extent=4.0)
    state = T.init_multisensor_state(cfg, 2, seed=0, device="cpu")
    step = T.make_multisensor_step(cfg, 2)
    rng = np.random.default_rng(0)
    pos = np.array([0.0, 0.0, 1.0], np.float32)
    q_fwd = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    q_bwd = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    for i in range(6):
        t = np.float32(0.1 * i)
        views = []
        for scene, q in ((scene_fwd, q_fwd), (scene_bwd, q_bwd)):
            p, n = sim.render_frame(scene, pos, q, float(t), rng,
                                    cfg.max_input_points, points_per_box=150,
                                    ground_points=200,
                                    fov_h_deg=cfg.half_fov_h_deg,
                                    fov_v_deg=cfg.half_fov_v_deg)
            views.append(T.Frame(p, n, pos, q, t))
        state, out = step(state, T.stack_frames(views))
        assert out.accepted
    occ, centers, future, state = T.get_occupancy_map(state, cfg, 0.2)
    c = centers.numpy()[occ.numpy()]
    above = c[c[:, 2] > 0.5]
    near_fwd = np.linalg.norm(above[:, :2] - np.array([2.0, 0.5]), axis=1) < 0.7
    near_bwd = np.linalg.norm(above[:, :2] - np.array([-2.0, -0.5]),
                              axis=1) < 0.7
    assert near_fwd.sum() > 0, above[:20]
    assert near_bwd.sum() > 0, above[:20]
