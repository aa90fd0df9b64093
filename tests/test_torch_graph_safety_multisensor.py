"""The multi-sensor step's device body can be captured as CUDA graphs, one
a pattern of admitted cameras, and replayed frame after frame (CPU): for
each pattern it runs the same operations with the same non-tensor
arguments on every frame, reads no device value on the host and builds no
tensor from host data, so every per-frame value of every camera reaches it
through the stacked frame blocks (``dspmap_tpu_torch/scalars.py``).

On four small configurations -- pool limit-xy, noisy pool, compact and
noisy compact -- and the three patterns of two cameras (both, camera 0
alone, camera 1 alone; a skipped camera's quaternion is NaN), two frames
that differ in each camera's pose, the time step, each camera's point
count and all six runtime parameters run through
``make_multisensor_body`` under ``test_torch_graph_safety.py``'s
recording ``TorchDispatchMode``: the two records are equal op for op.
Each camera's block holds the prologue's host values bit for bit; the
draws made into static buffers are ``make_multisensor_draws``' numbers
from the same generator state; and the graphed multi-sensor step refuses a
CPU state."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch import geometry
from dspmap_tpu_torch import scalars
from dspmap_tpu_torch.models import pipeline
from dspmap_tpu_torch.utils import sim
from test_torch_graph_safety import (CONFIGS as SINGLE_CONFIGS, FORBIDDEN,
                                     _bits, _frames, _Record,
                                     _set_every_param)

torch.set_num_threads(2)

N_SENSORS = 2
CONFIGS = {name: SINGLE_CONFIGS[name]
           for name in ("pool", "noisy", "compact", "noisy_compact")}
PATTERNS = {"both": (True, True), "camera0": (True, False),
            "camera1": (False, True)}
#: camera 1's pose against camera 0's: a shift (world frame) and a yaw
OFFSET, YAW = np.asarray([0.3, -0.2, 0.05], np.float32), 0.2


def _turned(q, yaw):
    """The wxyz quaternion ``q`` followed by a turn of ``yaw`` about its
    body z axis."""
    w, x, y, z = (float(v) for v in q)
    c, s = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.asarray([w * c - z * s, x * c + y * s, y * c - x * s,
                       z * c + w * s], np.float32)


def _two_cameras(frame, admitted=(True, True), fewer=11):
    """A two-camera frame from one camera's: camera 1 shifted by
    :data:`OFFSET`, turned by :data:`YAW` and given ``fewer`` points less;
    a camera not ``admitted`` has a NaN quaternion (admission skips a
    camera whose quaternion has a component outside +-1.001 or NaN)."""
    cam1 = frame._replace(n_points=int(frame.n_points) - fewer,
                          sensor_pos=frame.sensor_pos + OFFSET,
                          quat=_turned(frame.quat, YAW))
    cams = [frame, cam1]
    cams = [c if ok else c._replace(quat=np.full(4, np.nan, np.float32))
            for c, ok in zip(cams, admitted)]
    return T.stack_frames(cams)


@functools.lru_cache(maxsize=None)
def _warm(name):
    """``name``'s configuration, its three frames and the two-camera state
    after the first (a step makes new tensors, so the patterns share it)."""
    cfg = CONFIGS[name]()
    f0, f1, f2 = _frames(cfg)
    state = T.init_multisensor_state(cfg, N_SENSORS, seed=1, device="cpu")
    state, out = T.make_multisensor_step(cfg, N_SENSORS)(
        state, _two_cameras(f0))
    assert out.accepted
    return cfg, f1, f2, state


def _body_run(cfg, state, frames, gen, body, admitted):
    pro = pipeline.multisensor_prologue(state, frames, cfg, N_SENSORS)
    assert pro.accepted and pro.admitted == admitted
    draws = T.make_multisensor_draws(cfg, N_SENSORS, gen, "cpu")
    f, i, points = scalars.stage(scalars.layout(cfg, N_SENSORS), pro.f,
                                 pro.i, frames.points, "cpu")
    with _Record() as rec:
        out = body(state.particles, state.future, state.estimator,
                   scalars.FrameScalars(f, i), points, draws)
    new = pro.advance(state, particles=out.particles,
                      weight_sum=out.weight_sum, vel_avg=out.vel_avg,
                      future=out.future, estimator=out.estimator)
    return new, out, rec.ops


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_multisensor_body_runs_the_same_ops_on_every_frame(name, pattern):
    cfg, f1, f2, state = _warm(name)
    admitted = PATTERNS[pattern]
    gen = torch.Generator()
    gen.manual_seed(5)
    body = pipeline.make_multisensor_body(cfg, N_SENSORS, admitted)
    state, out1, ops1 = _body_run(cfg, state, _two_cameras(f1, admitted),
                                  gen, body, admitted)
    origin1 = state.origin
    state = _set_every_param(state)
    state, out2, ops2 = _body_run(cfg, state,
                                  _two_cameras(f2, admitted, fewer=23), gen,
                                  body, admitted)
    assert (state.origin != origin1).any()

    assert int(out2.metrics["alive"]) > 0
    for ops in (ops1, ops2):
        bad = [op for op in ops if op[0].startswith(FORBIDDEN)]
        assert not bad, bad[:3]
    assert len(ops1) == len(ops2)
    differ = [k for k, (a, b) in enumerate(zip(ops1, ops2)) if a != b]
    assert not differ, (differ[:3], [(ops1[k], ops2[k])
                                     for k in differ[:2]])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_each_cameras_block_holds_the_prologue_host_values(name):
    cfg = CONFIGS[name]()
    _, f1, f2 = _frames(cfg)
    state = T.init_multisensor_state(cfg, N_SENSORS, seed=1, device="cpu")
    state = dataclasses.replace(
        state, initialized=True, last_timestamp=np.float32(f1.timestamp),
        last_sensor_pos=np.asarray(f1.sensor_pos, np.float32),
        update_time=np.float32(3.7))
    state = _set_every_param(state)
    frames = _two_cameras(f2)
    pro = pipeline.multisensor_prologue(state, frames, cfg, N_SENSORS)
    assert pro.accepted and pro.admitted == (True, True)

    dt = np.float32(np.float32(f2.timestamp) - np.float32(f1.timestamp))
    update_time = np.float32(np.float32(3.7) + dt)
    origin = geometry.window_origin_np(frames.sensor_pos[0], cfg)
    layout = scalars.layout(cfg, N_SENSORS)
    sf, si, points = scalars.stage(layout, pro.f, pro.i, frames.points,
                                   "cpu")
    for k in range(N_SENSORS):
        fs = scalars.FrameScalars(sf[k], si[k])
        R = geometry.rotation_matrix_np(geometry.quaternion_conjugate_np(
            frames.quat[k]))
        assert (_bits(fs.dt) == _bits(dt)).all()
        assert (_bits(fs.update_time) == _bits(update_time)).all()
        assert (_bits(fs.sensor_pos) == _bits(frames.sensor_pos[k])).all()
        assert (_bits(fs.quat) == _bits(frames.quat[k])).all()
        assert (_bits(fs.R) == _bits(R)).all()
        for p in scalars.PARAM_NAMES:
            assert (_bits(getattr(fs.params, p))
                    == _bits(getattr(state.params, p))).all(), p
        assert fs.origin.tolist() == origin.tolist()
        assert fs.origin_mod.tolist() == [int(o) % n for o, n in zip(
            origin, (cfg.nx, cfg.ny, cfg.nz))]
        assert int(fs.n_points) == int(frames.n_points[k])
        assert torch.equal(points[k], torch.from_numpy(frames.points[k]))
    assert int(si[0, scalars.I_N_POINTS]) != int(si[1, scalars.I_N_POINTS])

    # what advance writes back: camera 0's pose and the frame's time
    new = pro.advance(state)
    assert (_bits(new.sensor_pos) == _bits(frames.sensor_pos[0])).all()
    assert (_bits(new.last_timestamp) == _bits(f2.timestamp)).all()
    assert (_bits(new.update_time) == _bits(update_time)).all()
    assert new.update_counter == state.update_counter + 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_multisensor_draws_into_static_buffers_equal_make_multisensor_draws(
        name):
    cfg = CONFIGS[name]()
    a, b = torch.Generator(), torch.Generator()
    a.manual_seed(11)
    b.manual_seed(11)
    want = T.make_multisensor_draws(cfg, N_SENSORS, a, "cpu")
    prop, sensors = want
    got = (None if prop is None else torch.full_like(prop, -7.0),
           tuple(tuple(torch.full_like(x, -7.0) for x in s)
                 for s in sensors))
    out = T.make_multisensor_draws(cfg, N_SENSORS, b, "cpu", out=got)
    assert (out[0] is None) == (prop is None) == (not pipeline.is_noisy(cfg))
    if prop is not None:
        assert out[0] is got[0] and torch.equal(got[0], prop)
    assert len(out[1]) == N_SENSORS
    for o, g, w in zip(out[1], got[1], sensors):
        assert len(o) == len(w)
        assert all(x is y for x, y in zip(o, g))
        assert all(torch.equal(x, y) for x, y in zip(g, w))
    assert torch.equal(a.get_state(), b.get_state())


def test_graphed_multisensor_step_refuses_a_cpu_state():
    cfg = CONFIGS["pool"]()
    state = T.init_multisensor_state(cfg, N_SENSORS, seed=0, device="cpu")
    frame = T.Frame(*next(sim.generate_sequence(1, cfg, seed=0)))
    step = T.make_graphed_multisensor_step(cfg, N_SENSORS)
    with pytest.raises(ValueError, match="CUDA card"):
        step(state, _two_cameras(frame))
    assert step.captures == 0 and not step.capture_ms
