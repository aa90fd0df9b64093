"""The step's device body can be captured as one CUDA graph and replayed
frame after frame (CPU): it runs the same operations with the same
non-tensor arguments on every frame, reads no device value on the host and
builds no tensor from host data, so every per-frame value reaches it
through the frame blocks (``dspmap_tpu_torch/scalars.py``).

On five small configurations -- pool limit-xy, static, noisy, compact and
noisy compact -- two frames that differ in pose, time step and point count,
with a live setter between them, run through ``make_body`` under a
``TorchDispatchMode`` that records each aten op with its non-tensor
arguments and its tensors' shapes and dtypes: the two records are equal op
for op.  The frame blocks the prologue builds hold the host values they
replace, bit for bit; the graphed step's draws, made into static buffers,
are ``make_draws``' numbers from the same generator state; and the graphed
step refuses a CPU state."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dspmap_tpu_torch as T
from dspmap_tpu_torch import geometry
from dspmap_tpu_torch import scalars
from dspmap_tpu_torch.models import pipeline
from dspmap_tpu_torch.utils import sim

torch.set_num_threads(2)

KW = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=1024,
          mover_capacity=8192, pyramid_slot_capacity=96, max_clusters=16)
CONFIGS = {
    "pool": lambda: T.example_node_settings(T.dsp_dynamic(**KW)),
    "static": lambda: T.example_node_settings(T.dsp_static(**KW)),
    "noisy": lambda: T.example_node_settings(
        T.dsp_dynamic(**KW, limit_motion_to_xy_plane=False)),
    "compact": lambda: T.example_node_settings(
        T.dsp_dynamic(**KW, layout="compact")),
    "noisy_compact": lambda: T.example_node_settings(
        T.dsp_dynamic(**KW, layout="compact",
                      limit_motion_to_xy_plane=False)),
}
#: ops that read a device value on the host, or make a tensor of host data
FORBIDDEN = ("aten._local_scalar_dense", "aten.lift_fresh")


def _describe(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return type(x).__name__, tuple(_describe(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _describe(v)) for k, v in x.items()))
    return repr(x)


class _Record(TorchDispatchMode):
    """Each aten op run inside it, with its arguments described."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), _describe(args), _describe(kwargs)))
        return func(*args, **kwargs)


def _frames(cfg):
    """A warm-up frame and two frames that differ in pose (the second moved
    so that the window origin moves too), time step (0.1 and 0.15 s) and
    point count."""
    f0, f1, f2 = (T.Frame(*f) for f in sim.generate_sequence(3, cfg, seed=7))
    shift = np.asarray([0.6, -0.35, 0.1], np.float32)
    f2 = f2._replace(n_points=int(f2.n_points) - 37,
                     sensor_pos=f2.sensor_pos + shift,
                     timestamp=np.float32(f2.timestamp + 0.05))
    return f0, f1, f2


def _set_every_param(state):
    """A new value of each of the six runtime parameters (live setters)."""
    state = T.set_prediction_variance(state, 0.07, 0.3)
    state = T.set_observation_stddev(state, 0.17)
    state = T.set_newborn_particle_weight(state, 0.0123)
    state = T.set_detection_probability(state, 0.83)
    return T.set_clutter_intensity(state, 0.011)


def _body_run(cfg, state, frame, gen, body):
    pro = pipeline.prologue(state, frame, cfg)
    assert pro.accepted
    draws = T.make_draws(cfg, gen, "cpu")
    f, i, points = scalars.stage(scalars.layout(cfg),
                                 *pro.blocks(cfg, state, frame.n_points),
                                 frame.points, "cpu")
    with _Record() as rec:
        out = body(state.particles, state.future, state.estimator,
                   scalars.FrameScalars(f[0], i[0]), points[0], draws)
    new = pro.advance(state, particles=out.particles,
                      weight_sum=out.weight_sum, vel_avg=out.vel_avg,
                      future=out.future, estimator=out.estimator)
    return new, out, rec.ops


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_body_runs_the_same_ops_on_every_frame(name):
    cfg = CONFIGS[name]()
    f0, f1, f2 = _frames(cfg)
    state = T.init_state(cfg, seed=1, device="cpu", init_particle_num=2000)
    state, out = T.make_step(cfg)(state, f0)
    assert out.accepted
    gen = torch.Generator()
    gen.manual_seed(5)
    body = pipeline.make_body(cfg)
    state, out1, ops1 = _body_run(cfg, state, f1, gen, body)
    origin1 = state.origin
    state = _set_every_param(state)
    state, out2, ops2 = _body_run(cfg, state, f2, gen, body)
    assert (state.origin != origin1).any()

    assert int(out2.metrics["alive"]) > 0
    assert int(out2.metrics["valid_points"]) != int(out1.metrics[
        "valid_points"])
    for ops in (ops1, ops2):
        bad = [op for op in ops if op[0].startswith(FORBIDDEN)]
        assert not bad, bad[:3]
    assert len(ops1) == len(ops2)
    differ = [k for k, (a, b) in enumerate(zip(ops1, ops2)) if a != b]
    assert not differ, (differ[:3], [(ops1[k], ops2[k])
                                     for k in differ[:2]])


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frame_blocks_hold_the_prologue_host_values(name):
    cfg = CONFIGS[name]()
    f0, f1, f2 = _frames(cfg)
    state = T.init_state(cfg, seed=1, device="cpu")
    state, _ = T.make_step(cfg)(state, f0)
    state = _set_every_param(state)
    pro = pipeline.prologue(state, f2, cfg)

    dt = np.float32(np.float32(f2.timestamp)
                    - np.float32(state.last_timestamp))
    update_time = np.float32(np.float32(state.update_time) + dt)
    origin = geometry.window_origin_np(f2.sensor_pos, cfg)
    R = geometry.rotation_matrix_np(geometry.quaternion_conjugate_np(
        f2.quat))
    f, i = pro.blocks(cfg, state, f2.n_points)
    fs = scalars.FrameScalars(torch.from_numpy(f), torch.from_numpy(i))
    assert (_bits(fs.dt) == _bits(dt)).all()
    assert (_bits(fs.update_time) == _bits(update_time)).all()
    assert (_bits(fs.sensor_pos) == _bits(f2.sensor_pos)).all()
    assert (_bits(fs.quat) == _bits(f2.quat)).all()
    assert (_bits(fs.R) == _bits(R)).all()
    for k in scalars.PARAM_NAMES:
        assert (_bits(getattr(fs.params, k))
                == _bits(getattr(state.params, k))).all(), k
    assert fs.origin.tolist() == origin.tolist()
    assert fs.origin_mod.tolist() == [int(o) % n for o, n in zip(
        origin, (cfg.nx, cfg.ny, cfg.nz))]
    assert int(fs.n_points) == int(f2.n_points)

    # the staged frame: the same blocks and the points, zero past the rows
    layout = scalars.layout(cfg)
    sf, si, points = scalars.stage(layout, f, i, f2.points[:900], "cpu")
    assert torch.equal(sf[0], fs.f) and torch.equal(si[0], fs.i)
    assert torch.equal(points[0, :900], torch.from_numpy(f2.points[:900]))
    assert not points[0, 900:].any()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_draws_into_static_buffers_equal_make_draws(name):
    cfg = CONFIGS[name]()
    a, b = torch.Generator(), torch.Generator()
    a.manual_seed(11)
    b.manual_seed(11)
    want = T.make_draws(cfg, a, "cpu")
    got = tuple(torch.full_like(x, -7.0) for x in want)
    out = T.make_draws(cfg, b, "cpu", out=got)
    assert all(x is y for x, y in zip(out, got))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(a.get_state(), b.get_state())


def test_graphed_step_refuses_a_cpu_state():
    cfg = CONFIGS["pool"]()
    state = T.init_state(cfg, seed=0, device="cpu")
    frame = T.Frame(*next(sim.generate_sequence(1, cfg, seed=0)))
    step = T.make_graphed_step(cfg)
    with pytest.raises(ValueError, match="CUDA card"):
        step(state, frame)
    assert step.captures == 0
