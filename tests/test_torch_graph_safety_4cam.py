"""The multi-sensor step's device body at four cameras can be captured as
CUDA graphs, one a pattern of admitted cameras (CPU): the form of
``tests/test_torch_graph_safety_multisensor.py`` on the frames of
``utils/rig.py``'s surround rig.

On the pool and the compact layout (limit-xy), for every camera admitted
and for a partial pattern (cameras 0 and 2, the front and the back camera:
cameras 1 and 3 skipped by a NaN quaternion, ``graph_ritual.cameras``),
two frames that differ in the pose, the time step, every camera's point
count and all six runtime parameters run through
``make_multisensor_body(cfg, 4, admitted)`` under
``test_torch_graph_safety.py``'s recording ``TorchDispatchMode``: the two
records are equal op for op, and neither reads a device value on the host
or builds a tensor of host data.  Each camera's frame block holds its own
pose and point count."""

import functools

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch import scalars
from dspmap_tpu_torch.models import pipeline
from dspmap_tpu_torch.utils import rig
from dspmap_tpu_torch.utils.graph_ritual import cameras
from test_torch_graph_safety import (CONFIGS as SINGLE_CONFIGS, FORBIDDEN,
                                     _bits, _Record, _set_every_param)

torch.set_num_threads(2)

N_SENSORS = 4
CONFIGS = {name: SINGLE_CONFIGS[name] for name in ("pool", "compact")}
PATTERNS = {"all": (True,) * N_SENSORS, "front_back": (True, False, True,
                                                       False)}
#: the second frame's shift (world frame), extra time step and the points
#: each camera drops
SHIFT, LATER, FEWER = (np.asarray([0.6, -0.35, 0.1], np.float32), 0.05,
                       np.asarray([37, 5, 3, 11], np.int32))


def _frames(cfg):
    """A warm-up frame and two frames of the rig that differ in pose (the
    second moved so that the window origin moves too), time step (0.1 and
    0.15 s) and every camera's point count."""
    f0, f1, f2 = (T.Frame(*f) for f in rig.surround_sequence(
        3, cfg, N_SENSORS, seed=7))
    f2 = f2._replace(n_points=np.maximum(f2.n_points - FEWER, 1),
                     sensor_pos=f2.sensor_pos + SHIFT,
                     timestamp=f2.timestamp + np.float32(LATER))
    return f0, f1, f2


@functools.lru_cache(maxsize=None)
def _warm(name):
    """``name``'s configuration, its frames and the four-camera state after
    the first (a step makes new tensors, so the patterns share it)."""
    cfg = CONFIGS[name]()
    f0, f1, f2 = _frames(cfg)
    state = T.init_multisensor_state(cfg, N_SENSORS, seed=1, device="cpu")
    state, out = T.make_multisensor_step(cfg, N_SENSORS)(state, f0)
    assert out.accepted
    return cfg, f1, f2, state


def _body_run(cfg, state, frames, gen, body, admitted):
    pro = pipeline.multisensor_prologue(state, frames, cfg, N_SENSORS)
    assert pro.accepted and pro.admitted == admitted
    draws = T.make_multisensor_draws(cfg, N_SENSORS, gen, "cpu")
    f, i, points = scalars.stage(scalars.layout(cfg, N_SENSORS), pro.f,
                                 pro.i, frames.points, "cpu")
    for k in range(N_SENSORS):
        fs = scalars.FrameScalars(f[k], i[k])
        assert int(fs.n_points) == int(frames.n_points[k])
        assert (_bits(fs.sensor_pos) == _bits(frames.sensor_pos[k])).all()
    with _Record() as rec:
        out = body(state.particles, state.future, state.estimator,
                   scalars.FrameScalars(f, i), points, draws)
    new = pro.advance(state, particles=out.particles,
                      weight_sum=out.weight_sum, vel_avg=out.vel_avg,
                      future=out.future, estimator=out.estimator)
    return new, out, rec.ops


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_four_camera_body_runs_the_same_ops_on_every_frame(name, pattern):
    cfg, f1, f2, state = _warm(name)
    admitted = PATTERNS[pattern]
    gen = torch.Generator()
    gen.manual_seed(5)
    body = pipeline.make_multisensor_body(cfg, N_SENSORS, admitted)
    state, out1, ops1 = _body_run(cfg, state, cameras(f1, admitted), gen,
                                  body, admitted)
    origin1 = state.origin
    state = _set_every_param(state)
    state, out2, ops2 = _body_run(cfg, state, cameras(f2, admitted), gen,
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


def test_a_partial_pattern_runs_fewer_ops_than_every_camera():
    """The skipped cameras' stages are left out of the pattern's body, not
    run and discarded."""
    cfg, f1, _, state = _warm("pool")
    counts = {}
    for pattern, admitted in PATTERNS.items():
        gen = torch.Generator()
        gen.manual_seed(5)
        body = pipeline.make_multisensor_body(cfg, N_SENSORS, admitted)
        counts[pattern] = len(_body_run(cfg, state, cameras(f1, admitted),
                                        gen, body, admitted)[2])
    assert counts["front_back"] < 0.75 * counts["all"], counts
