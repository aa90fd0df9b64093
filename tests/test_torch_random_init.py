"""Random initial particles (``state.add_random_particles`` and
``init_state(init_particle_num=...)``) against the JAX package's, and the
float32 matmul flag scoped to the port's matmuls (CPU).

The JAX function draws ``pos`` and ``vel`` uniform on [-1, 1) from
``split(state.rng, 4)[1]`` and ``[2]``; the tests rebuild those draws and
hand them to the port, whose planes must then equal JAX's bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu_torch.models import pipeline
from dspmap_tpu_torch.ops import assignment, cluster, update
from dspmap_tpu_torch.utils import sim
from torch_parity import KW, PLANES, preset_configs

torch.set_num_threads(2)

SENSOR = (0.3, -0.2, 1.0)


def _configs(name):
    if name == "static":
        return preset_configs(name)
    kw = dict(KW, layout="compact") if name.startswith("compact") else KW
    if name == "compact_recorded":
        kw = dict(kw, record_particle_time=True)
    return (J.example_node_settings(J.dsp_dynamic(**kw)),
            T.example_node_settings(T.dsp_dynamic(**kw)))


def _jax_draws(key, num):
    """The JAX function's draws for ``state.rng == key``, as numpy."""
    _, k1, k2, _ = jax.random.split(key, 4)
    return tuple(np.array(jax.random.uniform(k, (num, 3), jnp.float32, -1.0, 1.0))
                 for k in (k1, k2))


def _assert_planes_equal(tp, jp):
    for n in PLANES:
        a, b = getattr(tp, n).numpy(), np.asarray(getattr(jp, n))
        assert a.shape == b.shape and a.dtype == b.dtype, n
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=n)


@pytest.mark.parametrize("name", ["flagship", "static", "compact",
                                  "compact_recorded"])
def test_add_random_particles_matches_jax(name):
    """Into a fresh map and again into the filled one (the second call
    finds voxels partly full), at update time 2.5 so that the time plane
    the pool layout always writes, and the compact layout writes under
    ``record_particle_time``, holds a value."""
    jcfg, tcfg = _configs(name)
    key = jax.random.key(3)
    jstate = J.init_state(jcfg, key, sensor_pos=SENSOR)
    jstate = dataclasses.replace(jstate, update_time=jnp.float32(2.5))
    tstate = T.init_state(tcfg, seed=0, sensor_pos=SENSOR, device="cpu")
    tstate = dataclasses.replace(tstate, update_time=np.float32(2.5))
    for num, weight in ((3000, 0.02), (5000, 0.5)):
        draws = _jax_draws(jstate.rng, num)
        jstate = J.add_random_particles(jstate, jcfg, num, weight)
        tstate = T.add_random_particles(tstate, tcfg, num, weight, draws=draws)
        _assert_planes_equal(tstate.particles, jax.device_get(jstate.particles))
    alive = int((tstate.particles.flags != 0).sum())
    assert 3000 < alive < 8000  # some voxels filled up on the second call
    if name == "static":
        assert float(tstate.particles.vx.abs().sum()) == 0.0
    else:
        assert float(tstate.particles.vx.abs().sum()) > 0.0
    assert float(tstate.particles.vz.abs().sum()) == 0.0  # limit-xy, static
    if name != "compact":
        assert float(tstate.particles.t.max()) == 2.5


@pytest.mark.parametrize("name", ["flagship", "compact"])
def test_init_state_with_particles(name):
    """``init_state(init_particle_num=N)`` equals JAX's given the same
    draws; without draws it takes them from the state's generator: a valid
    pool of up to N particles of the given weight inside the window, and
    another seed scatters them elsewhere."""
    jcfg, tcfg = _configs(name)
    key = jax.random.key(5)
    want = J.init_state(jcfg, key, sensor_pos=SENSOR, init_particle_num=4000,
                        init_weight=0.03)
    got = T.add_random_particles(
        T.init_state(tcfg, seed=0, sensor_pos=SENSOR, device="cpu"), tcfg,
        4000, 0.03, draws=_jax_draws(key, 4000))
    _assert_planes_equal(got.particles, jax.device_get(want.particles))

    own = [T.init_state(tcfg, seed=s, sensor_pos=SENSOR, init_particle_num=4000,
                        init_weight=0.03, device="cpu") for s in (0, 1)]
    p = own[0].particles
    live = p.flags != 0
    assert 3600 < int(live.sum()) <= 4000
    assert bool((p.flags[live] == T.state.FLAG_VALID).all())
    assert bool((p.weight[live] == np.float32(0.03)).all())
    lo = np.asarray(SENSOR, np.float32) - np.asarray(tcfg.half_extent, np.float32)
    hi = np.asarray(SENSOR, np.float32) + np.asarray(tcfg.half_extent, np.float32)
    for k, c in enumerate(("px", "py", "pz")):
        x = getattr(p, c)[live]
        assert float(x.min()) >= lo[k] and float(x.max()) <= hi[k], c
    assert float(p.vz.abs().sum()) == 0.0 and float(p.vx.abs().max()) > 0.5
    assert not torch.equal(p.px, own[1].particles.px)


def _frame(cfg, i=1):
    return T.Frame(*list(sim.generate_sequence(i + 1, cfg, seed=7))[i])


def test_matmul_flag_is_the_callers_after_each_call(monkeypatch):
    """With ``allow_tf32`` set to True by the caller, the clustering, the
    assignment, the measurement update and one step leave it True; inside
    the update's pair sums it is False; the results equal those of a run
    with the flag False."""
    _, tcfg = _configs("flagship")
    flag = torch.backends.cuda.matmul
    seen = []
    pair_g = update._pair_g

    def spy(*a, **kw):
        seen.append(flag.allow_tf32)
        return pair_g(*a, **kw)

    monkeypatch.setattr(update, "_pair_g", spy)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(0, 1, (64, 3)).astype(np.float32))
    ok = torch.from_numpy(rng.random(64) < 0.8)
    cost = torch.from_numpy(rng.random((16, 16)).astype(np.float32))
    rows, cols = torch.arange(16) < 11, torch.arange(16) < 9
    state = T.init_state(tcfg, seed=0, init_particle_num=3000, device="cpu")
    draws = pipeline.make_draws(tcfg, torch.Generator().manual_seed(4), "cpu")
    step = T.make_step(tcfg)
    runs = {}
    saved = flag.allow_tf32
    try:
        for value in (True, False):
            flag.allow_tf32 = value
            labels = cluster.euclidean_cluster(pts, ok, 0.4)
            assert flag.allow_tf32 is value
            assign = assignment.solve_assignment(cost, rows, cols)
            assert flag.allow_tf32 is value
            new, out = step(state, _frame(tcfg), draws)
            assert flag.allow_tf32 is value
            runs[value] = (labels, assign, new, out)
    finally:
        flag.allow_tf32 = saved
    assert seen and not any(seen)
    (l1, a1, s1, o1), (l0, a0, s0, o0) = runs[True], runs[False]
    assert torch.equal(l1, l0) and torch.equal(a1, a0)
    assert int(o1.metrics["updated_particles"]) > 0
    for k in o0.metrics:
        assert torch.equal(o1.metrics[k], o0.metrics[k]), k
    for n in PLANES:
        assert torch.equal(getattr(s1.particles, n), getattr(s0.particles, n)), n
    assert torch.equal(s1.weight_sum, s0.weight_sum)
