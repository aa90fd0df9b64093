"""Checkpoints of the port (``dspmap_tpu_torch/io/checkpoint.py``) in the
JAX package's file format, on the CPU: a JAX checkpoint loads into the port
and a port checkpoint into JAX, every leaf but the random key bit for bit,
on the pool layout, the compact layout and the two-sensor state (whose
estimator leaves carry ``[n, C, ...]``); a port save, load and resume is
bit-equal to the run it interrupted, its generator included; a save draws
nothing; the config-switch sanitizer mirrors ``tests/test_io.py``'s.

The map is the replay's ``--tiny`` one.  Bars: bit equality throughout
(float32 leaves compared as their bit patterns)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu.io import checkpoint as jckpt
from dspmap_tpu.models.pipeline import (init_multisensor_state,
                                        make_multisensor_step)
from dspmap_tpu.utils import sim
from dspmap_tpu_torch.io import checkpoint, load_state, save_state
from torch_parity import assert_bits_equal, two_camera_frames

torch.set_num_threads(2)

#: the replay's ``--tiny`` map (``dspmap_tpu/io/replay.py``), which the
#: street scene's pillars and pedestrians reach from the first frame
SMALL = dict(nx=16, ny=16, nz=8, voxel_resolution=0.6, max_input_points=256,
             mover_capacity=2048, pyramid_slot_capacity=32, max_clusters=8)
#: case -> (configuration overrides, sensors: None for make_step)
CASES = {"pool": ({}, None), "compact": (dict(layout="compact"), None),
         "two_sensor": ({}, 2)}
N_FRAMES = 3


def configs(case, **kw):
    over = {**SMALL, **CASES[case][0], **kw}
    return (J.example_node_settings(J.dsp_dynamic(**over)),
            T.example_node_settings(T.dsp_dynamic(**over)))


def frames(case, cfg, n):
    """``n`` frames of the street sequence (seed 0) as numpy, two cameras'
    for the two-sensor case."""
    if CASES[case][1]:
        return two_camera_frames(cfg, n, seed=0)
    return list(sim.generate_sequence(n, cfg, seed=0))


def port_run(case, seed=0):
    """The port's state, step and frames of ``case`` on the CPU."""
    _, tcfg = configs(case)
    n = CASES[case][1]
    if n:
        state = T.init_multisensor_state(tcfg, n, seed=seed, device="cpu")
        step = T.make_multisensor_step(tcfg, n)
    else:
        state = T.init_state(tcfg, seed=seed, device="cpu")
        step = T.make_step(tcfg)
    return tcfg, state, step


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the JAX configuration, its jitted step, the frames and the
    state after the first ``N_FRAMES`` of them."""
    runs = {}
    for case, (_, n) in CASES.items():
        jcfg, _ = configs(case)
        if n:
            state = init_multisensor_state(jcfg, n, jax.random.key(0))
            step = jax.jit(make_multisensor_step(jcfg, n))
        else:
            state = J.init_state(jcfg, jax.random.key(0))
            step = jax.jit(J.make_step(jcfg))
        fr = frames(case, jcfg, N_FRAMES + 1)
        for f in fr[:N_FRAMES]:
            state, out = step(state, J.Frame(*(jnp.asarray(x) for x in f)))
            assert bool(out.accepted)
        assert int(out.metrics["alive"]) > 0
        runs[case] = (jcfg, step, fr, state)
    return runs


def leaves_of(tree):
    """The 30 leaves of a port ``state_to_numpy`` tree in file order (the
    key's slot ``None``)."""
    return [None if name == "rng" else checkpoint._get(tree, name)
            for name, _ in checkpoint.LEAVES]


def assert_states_bit_equal(a, b):
    for name, x, y in zip((n for n, _ in checkpoint.LEAVES),
                          leaves_of(T.state_to_numpy(a)),
                          leaves_of(T.state_to_numpy(b))):
        if name != "rng":
            assert_bits_equal(np.asarray(x, dtype=np.asarray(y).dtype), y,
                              name)


def test_leaf_table_is_the_jax_flatten_order(jax_runs):
    """:data:`checkpoint.LEAVES` against ``jax.tree.flatten`` of a JAX state:
    the same count, and each leaf's dtype and shape."""
    for case in CASES:
        _, _, _, jstate = jax_runs[case]
        tcfg, tstate, _ = port_run(case)
        want = jax.tree.leaves(jstate)
        assert len(want) == len(checkpoint.LEAVES) == 30
        ours = leaves_of(T.state_to_numpy(tstate))
        for (name, dtype), w, o in zip(checkpoint.LEAVES, want, ours):
            if name == "rng":
                w = jax.random.key_data(w)
            else:
                assert np.shape(o) == w.shape, (case, name)
            assert np.dtype(w.dtype) == dtype, (case, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_checkpoint_loads_into_the_port(jax_runs, tmp_path, case):
    """A JAX ``save_state`` after three JAX frames, loaded by the port,
    equals ``state_from_numpy`` of the same state leaf for leaf, bit for
    bit; the generator is seeded from the key's data."""
    jcfg, _, _, jstate = jax_runs[case]
    path = tmp_path / "jax.npz"
    jckpt.save_state(jstate, path)
    tcfg, template, _ = port_run(case, seed=1)
    got = load_state(template, path)
    want = T.state_from_numpy(jax.device_get(jstate), tcfg, device="cpu")
    assert got.device.type == "cpu" and got.update_counter == N_FRAMES
    assert_states_bit_equal(got, want)
    k0, k1 = (int(x) for x in np.asarray(jax.random.key_data(jstate.rng)))
    seeded = torch.Generator().manual_seed(k0 << 32 | k1)
    assert torch.equal(got.gen.get_state(), seeded.get_state())


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_loads_into_jax(jax_runs, tmp_path, case):
    """A port ``save_state`` after three port frames, loaded by JAX's
    ``load_state``: every JAX leaf but ``rng`` bit-equal to
    ``state_to_numpy``, the key holding the file's two words, and the JAX
    step takes the result."""
    jcfg, jstep, fr, jstate = jax_runs[case]
    _, state, step = port_run(case)
    for f in fr[:N_FRAMES]:
        state, out = step(state, T.Frame(*f))
        assert out.accepted
    path = tmp_path / "port.npz"
    save_state(state, path)
    loaded = jckpt.load_state(jstate, path)
    ours = leaves_of(T.state_to_numpy(state))
    for (name, dtype), got, want in zip(checkpoint.LEAVES,
                                        jax.tree.leaves(loaded), ours):
        if name == "rng":
            np.testing.assert_array_equal(jax.random.key_data(got),
                                          np.load(path)["leaf_12"])
            continue
        # the port's host scalars are Python numbers holding float32 values
        assert np.asarray(got).dtype == dtype, name
        assert_bits_equal(np.asarray(got), np.asarray(want, dtype), name)
    new, out = jstep(loaded, J.Frame(*(jnp.asarray(x) for x in fr[N_FRAMES])))
    assert bool(out.accepted)
    assert int(new.update_counter) == N_FRAMES + 1
    assert bool(jnp.all(jnp.isfinite(new.weight_sum)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_save_load_resume_is_bit_equal(tmp_path, case):
    """Save after three frames, load into a template of another seed, and
    step both the restored and the uninterrupted state two more frames with
    their generators' own draws: every leaf and the generator's state
    bit-equal after the load and after each frame."""
    tcfg, state, step = port_run(case)
    fr = frames(case, tcfg, N_FRAMES + 2)
    for f in fr[:N_FRAMES]:
        state, _ = step(state, T.Frame(*f))
    path = tmp_path / "ckpt.npz"
    save_state(state, path)
    restored = load_state(port_run(case, seed=1)[1], path)
    assert_states_bit_equal(restored, state)
    assert torch.equal(restored.gen.get_state(), state.gen.get_state())
    for f in fr[N_FRAMES:]:
        state, out_a = step(state, T.Frame(*f))
        restored, out_b = step(restored, T.Frame(*f))
        assert out_a.accepted and out_b.accepted
        assert_states_bit_equal(restored, state)
        assert torch.equal(restored.gen.get_state(), state.gen.get_state())
    assert int(out_a.metrics["alive"]) > 0


def test_save_state_draws_nothing(tmp_path):
    """A state stepped with a ``save_state`` between two frames gives the
    same bits as one stepped without."""
    tcfg, state, step = port_run("pool")
    fr = frames("pool", tcfg, 2)
    state, _ = step(state, T.Frame(*fr[0]))
    twin = dataclasses.replace(state, gen=torch.Generator().set_state(
        state.gen.get_state()))
    before = state.gen.get_state()
    save_state(state, tmp_path / "mid.npz")
    assert torch.equal(state.gen.get_state(), before)
    a, _ = step(state, T.Frame(*fr[1]))
    b, _ = step(twin, T.Frame(*fr[1]))
    assert_states_bit_equal(a, b)


@pytest.mark.parametrize("model", ["limit_xy", "static"])
def test_checkpoint_config_switch_sanitizer(tmp_path, model):
    """Mirror of ``tests/test_io.py::test_checkpoint_config_switch_sanitizer``:
    a state written under free motion and restored under a clamped
    configuration gets the clamp re-applied on load, on the template's
    device (vz = 0 under limit-xy, v = 0 under the static model); without
    ``cfg``, or with ``sanitize=False``, the restore is bit-exact."""
    _, cfg_free = configs("pool", limit_motion_to_xy_plane=False)
    state = T.init_state(cfg_free, seed=5, init_particle_num=500,
                         init_weight=0.05, device="cpu")
    assert float(state.particles.vz.abs().max()) > 0.0
    path = tmp_path / "free.npz"
    save_state(state, path)

    if model == "static":
        _, cfg = configs("pool", motion_model="static")
    else:
        _, cfg = configs("pool")
    template = T.init_state(cfg, seed=0, device="cpu")
    restored = load_state(template, path, cfg=cfg)
    p, q = restored.particles, state.particles
    assert p.vz.device == template.device
    assert float(p.vz.abs().max()) == 0.0
    if model == "static":
        assert float(p.vx.abs().max()) == float(p.vy.abs().max()) == 0.0
    else:
        assert torch.equal(p.vx, q.vx) and torch.equal(p.vy, q.vy)
    for raw in (load_state(template, path, sanitize=False),
                load_state(template, path)):
        assert torch.equal(raw.particles.vz, q.vz)


def test_mismatched_template_raises(tmp_path):
    """A template of another shape, or a leaf of another dtype, raises."""
    _, cfg = configs("pool")
    path = tmp_path / "c.npz"
    save_state(T.init_state(cfg, device="cpu"), path)
    _, other = configs("pool", nx=20)
    with pytest.raises(ValueError, match="leaf_0"):
        load_state(T.init_state(other, device="cpu"), path)
    with np.load(path) as data:
        arrays = dict(data)
    arrays["leaf_9"] = arrays["leaf_9"].astype(np.float64)
    np.savez(tmp_path / "f64.npz", **arrays)
    with pytest.raises(ValueError, match="leaf_9"):
        load_state(T.init_state(cfg, device="cpu"), tmp_path / "f64.npz")


def test_orbax_backend_raises(tmp_path):
    _, cfg = configs("pool")
    state = T.init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="npz"):
        save_state(state, tmp_path / "o", backend="orbax")
    with pytest.raises(ValueError, match="npz"):
        load_state(state, tmp_path / "o", backend="orbax")
