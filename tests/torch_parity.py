"""Shared pieces of the port-vs-JAX step tests (``tests/test_torch_step.py``,
``tests/test_torch_compact.py``): the JAX step's random draws, a recorded
JAX run, the newborn-weight pin and the teacher-forced bars.  The bars and
their reasons are stated in ``tests/test_torch_step.py``'s docstring."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu.utils import sim

KW = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=1024,
          mover_capacity=8192, pyramid_slot_capacity=96, max_clusters=16)
N_FRAMES = 12
RESAMPLE_COUNTERS = ("alive", "resample_dropped", "resample_copies")


def _sensor_draws(k_est, k_birth, cfg):
    """The estimator's uniform from ``split(k_est)[1]``, the birth table's
    normal/normal/uniform from ``split(k_birth, 3)``."""
    _, sub = jax.random.split(k_est)
    fresh = jax.random.uniform(sub, (cfg.max_clusters,), jnp.float32, 0.1, 1.0)
    kp, kv, ku = jax.random.split(k_birth, 3)
    shape = (cfg.max_input_points, cfg.newborn_particles_per_point, 3)
    return tuple(np.array(x) for x in (
        fresh, jax.random.normal(kp, shape, jnp.float32),
        jax.random.normal(kv, shape, jnp.float32),
        jax.random.uniform(ku, shape, jnp.float32, -1.0, 1.0)))


def noisy(cfg):
    return not (cfg.limit_motion_to_xy_plane or cfg.motion_model == "static")


def particle_shape(cfg):
    if cfg.layout == "compact":
        return (cfg.compact_capacity,)
    return (cfg.slots_per_voxel, cfg.storage_voxels)


def _normal(key, n, cfg):
    return np.array(jax.random.normal(key, (n,) + particle_shape(cfg),
                                      jnp.float32))


def jax_draws(rng, cfg):
    """The JAX step's draws for key ``rng``, as numpy: ``keys =
    split(rng, 6)``; the estimator's draw from ``keys[0]`` and birth's from
    ``keys[3]`` (``_sensor_draws``); on a noisy configuration also the
    propagation noise ``normal(keys[1], (3, S, V))`` and the FOV noise
    ``normal(keys[2], (2, S, V))`` (``[P]``-shaped in the compact
    layout)."""
    keys = jax.random.split(rng, 6)
    draws = _sensor_draws(keys[0], keys[3], cfg)
    if noisy(cfg):
        draws += (_normal(keys[1], 3, cfg), _normal(keys[2], 2, cfg))
    return draws


def jax_multisensor_draws(rng, cfg, n_sensors):
    """The JAX multi-sensor step's draws for key ``rng``, in the port's
    form ``(prop_noise | None, per-sensor tuples)``: ``keys = split(rng,
    4)``, the propagation noise ``normal(keys[0], (3, ...))``; the scan key
    ``keys[1]`` split per sensor as ``key, k_est, k_fov, k_birth =
    split(key, 4)``, the FOV noise ``normal(k_fov, (2, ...))``."""
    keys = jax.random.split(rng, 4)
    prop = _normal(keys[0], 3, cfg) if noisy(cfg) else None
    key, sensors = keys[1], []
    for _ in range(n_sensors):
        key, k_est, k_fov, k_birth = jax.random.split(key, 4)
        d = _sensor_draws(k_est, k_birth, cfg)
        sensors.append(d + (_normal(k_fov, 2, cfg),) if noisy(cfg) else d)
    return prop, tuple(sensors)


def record(jcfg, step, state, n_frames=N_FRAMES):
    """Run the jitted JAX ``step`` over the street sequence (seed 7) from
    ``state``: per frame the state before, the draws, the frame inputs,
    the state after and the metrics (all numpy), and the JAX state after
    (``live``).  Returns ``(frames, final state)``."""
    frames = []
    for pts, n, pos, quat, t in sim.generate_sequence(n_frames, jcfg, seed=7):
        before = jax.device_get(state)
        draws = jax_draws(state.rng, jcfg)
        state, out = step(state, J.Frame(jnp.asarray(pts), jnp.int32(n),
                                         jnp.asarray(pos), jnp.asarray(quat),
                                         jnp.asarray(t)))
        frames.append(dict(
            before=before, draws=draws, frame=(pts, n, pos, quat, t),
            after=jax.device_get(state), live=state,
            accepted=bool(out.accepted),
            metrics={k: np.asarray(v) for k, v in out.metrics.items()}))
    return frames, state


def pin_newborn_weight(monkeypatch, birth_name, jax_weight):
    """Make the port's birth stage (``pipeline.<birth_name>``) use the JAX
    newborn weight's exact bits: ``norm_coeff`` is replaced by the f32
    value ``c`` with ``w_b * c == jax_weight["value"]``; a list there
    gives one value a call, consumed in order (one a sensor)."""
    import dspmap_tpu_torch.models.pipeline as pipeline

    orig = getattr(pipeline, birth_name)

    def birth(p, cfg, draws, **kw):
        w_b = np.float32(kw["rt"].newborn_particle_weight)
        value = jax_weight["value"]
        target = np.float32(value.pop(0) if isinstance(value, list)
                            else value)
        c = np.float32(target / w_b)
        for _ in range(8):
            if np.float32(w_b * c) == target:
                break
            c = np.nextafter(c, np.float32(np.inf) if np.float32(w_b * c) < target
                             else np.float32(-np.inf))
        assert np.float32(w_b * c) == target
        kw["norm_coeff"] = torch.tensor(float(c), dtype=torch.float32)
        return orig(p, cfg, draws, **kw)

    monkeypatch.setattr(pipeline, birth_name, birth)


def check_frame(i, new, out, f, pinned, share=None):
    """The teacher-forced bars for one frame; returns the share of equal
    flags (held per frame here, and on average by the caller).  ``share
    (new, want)`` measures that share where rows are not comparable one
    by one (default: the flags, slot by slot)."""
    assert out.accepted == f["accepted"]
    want = f["after"]
    frac = (np.mean(new.particles.flags.numpy()
                    == np.asarray(want.particles.flags)) if share is None
            else share(new, want))
    assert frac >= (0.999 if pinned else 0.995), (i, frac)
    for name in ("weight_sum", "future"):
        close = np.isclose(getattr(new, name).numpy(),
                           np.asarray(getattr(want, name)),
                           rtol=1e-4, atol=1e-7)
        assert close.mean() >= 0.999, (i, name, close.mean())
    assert set(out.metrics) == set(f["metrics"]), i
    for k, v in f["metrics"].items():
        got = float(out.metrics[k])
        if k == "newborn_weight":
            np.testing.assert_allclose(got, float(v), rtol=1e-5)
            continue
        slack = 0.1 if k in RESAMPLE_COUNTERS and not pinned else 0.005
        assert abs(got - int(v)) <= max(2, slack * abs(int(v))), (i, k, got, v)
    np.testing.assert_array_equal(new.origin, np.asarray(want.origin))
    assert new.update_counter == int(want.update_counter)
    return frac


def check_setters(jstep, tcfg, frames, monkeypatch, birth_name):
    """Change ``sigma_ob`` and ``p_detection`` between frames on both
    packages and hold the next frame to the JAX frame with the pinned
    teacher-forced bars."""
    f = frames[4]
    jstate = J.set_detection_probability(
        J.set_observation_stddev(f["live"], 0.13), 0.8)
    pts, n, pos, quat, t = frames[5]["frame"]
    want_state, want_out = jstep(jstate, J.Frame(
        jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos), jnp.asarray(quat),
        jnp.asarray(t)))
    nxt = dict(frames[5], before=jax.device_get(jstate),
               after=jax.device_get(want_state),
               accepted=bool(want_out.accepted),
               metrics={k: np.asarray(v) for k, v in want_out.metrics.items()})
    state = T.state_from_numpy(f["after"], tcfg, device="cpu")
    state = T.set_detection_probability(T.set_observation_stddev(state, 0.13),
                                        0.8)
    assert state.params.sigma_ob == float(np.float32(0.13))
    assert state.params.p_detection == float(np.float32(0.8))
    jax_weight = {"value": nxt["metrics"]["newborn_weight"]}
    pin_newborn_weight(monkeypatch, birth_name, jax_weight)
    new, out = T.make_step(tcfg)(state, T.Frame(*nxt["frame"]), nxt["draws"])
    check_frame(5, new, out, nxt, pinned=True)
    # the setters moved the result: the unchanged JAX frame differs
    assert not np.array_equal(np.asarray(frames[5]["after"].weight_sum),
                              np.asarray(nxt["after"].weight_sum))


# --- shared by the preset tests (tests/test_torch_presets*.py) -------------

PLANES = ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")
#: per preset: the pyramid slot capacity the full-size preset derives (the
#: cut map would derive 8), so the cut keeps the preset's two update tiers
PRESETS = {
    "static": ("dsp_static", dict(pyramid_slot_capacity=240)),
    "multi": ("dsp_dynamic_multi_neighbors", dict(pyramid_slot_capacity=72)),
}


def preset_configs(name, node=True, **overrides):
    """``(JAX config, port config)`` of preset ``name`` cut as ``KW`` cuts
    the flagship, with the preset's own pyramid slot capacity."""
    fn, keep = PRESETS[name]
    kw = {**KW, **keep, **overrides}
    jcfg, tcfg = getattr(J, fn)(**kw), getattr(T, fn)(**kw)
    if node:
        jcfg, tcfg = J.example_node_settings(jcfg), T.example_node_settings(tcfg)
    return jcfg, tcfg


def both(arrays):
    """(JAX Particles, port Particles on the CPU) over the same numpy
    planes."""
    jp = J.Particles(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tp = T.Particles(**{k: torch.from_numpy(v.copy())
                        for k, v in arrays.items()})
    return jp, tp


def tparts(p):
    """Port Particles (CPU tensors, copies) of a numpy Particles."""
    return T.Particles(**{k: torch.from_numpy(np.array(getattr(p, k)))
                          for k in PLANES})


def jparts(p):
    """JAX Particles of a numpy Particles."""
    return J.Particles(**{k: jnp.asarray(getattr(p, k)) for k in PLANES})


def bits(x):
    """float32 arrays as their int32 bit patterns (others as they are)."""
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits_equal(got, want, name=""):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=name)


def ulps(got, want):
    """Largest distance of two float32 arrays in units in the last place."""
    return int(np.abs(bits(got).astype(np.int64)
                      - bits(want).astype(np.int64)).max())


def given_normals(monkeypatch, *arrays):
    """Make ``jax.random.normal`` return the array of the asked shape among
    ``arrays``: a normal drawn inside a fused program differs in the last
    bits of a few elements from the same key's normal drawn alone, so a
    stage test hands both sides the same array."""
    by_shape = {a.shape: jnp.asarray(a) for a in arrays}
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        by_shape[tuple(shape)])


def empty_planes(cfg):
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    a = {k: np.zeros((S, V), np.float32) for k in PLANES}
    a["flags"] = np.zeros((S, V), np.int32)
    return a


def occupancy_pool(cfg, seed, n_voxels=300):
    """A pool like ``tests/test_pallas.py``'s occupancy pool: ``n_voxels``
    voxels of 1..S valid or newborn particles with uniform weights;
    velocities obey the configuration's clamp (none under the static
    model, vz = 0 under limit-xy)."""
    rng = np.random.default_rng(seed)
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    a = empty_planes(cfg)
    for c in rng.choice(cfg.voxel_num, size=n_voxels, replace=False):
        k = rng.integers(1, S + 1)
        slots = rng.choice(S, size=k, replace=False)
        a["flags"][slots, c] = rng.choice([1, 1, 1, 3], size=k)
        a["weight"][slots, c] = rng.uniform(0.0005, 1.0, size=k)
        if cfg.motion_model != "static":
            a["vx"][slots, c] = np.where(rng.random(k) < 0.3, 1.0, 0.0)
            a["vy"][slots, c] = np.where(rng.random(k) < 0.2, -0.5, 0.0)
    for k in ("px", "py", "pz"):
        a[k] = rng.normal(0, 1, (S, V)).astype(np.float32)
    a["t"] = rng.uniform(0, 5, (S, V)).astype(np.float32)
    return a


def tie_pool(cfg, seed, n_voxels=1500):
    """Voxels holding ``resample_min_count..S`` newborns of one weight each:
    the resample's ``ceil(x/wa - 1/2)`` thresholds fall exactly on the
    grid, where the last bit of the slot-axis cumsum decides."""
    rng = np.random.default_rng(seed)
    S = cfg.slots_per_voxel
    a = empty_planes(cfg)
    cols = rng.choice(cfg.voxel_num, size=n_voxels, replace=False)
    k = rng.integers(cfg.resample_min_count, S + 1, size=cols.size)
    occ = np.arange(S)[:, None] < k[None, :]
    a["flags"][:, cols] = np.where(occ, 3, 0)
    a["weight"][:, cols] = np.where(
        occ, rng.uniform(0.002, 0.2, cols.size)[None, :], 0).astype(np.float32)
    return a


def teacher_forced(frames, tcfg, monkeypatch, pinned, birth_name="particle_birth"):
    """Every recorded frame through the port's step from the JAX state
    before it, held to ``check_frame``; returns the per-frame flag shares."""
    jax_weight = {}
    if pinned:
        pin_newborn_weight(monkeypatch, birth_name, jax_weight)
    step = T.make_step(tcfg)
    fracs = []
    for i, f in enumerate(frames):
        jax_weight["value"] = f["metrics"]["newborn_weight"]
        state = T.state_from_numpy(f["before"], tcfg, device="cpu")
        new, out = step(state, T.Frame(*f["frame"]), f["draws"])
        fracs.append(check_frame(i, new, out, f, pinned))
    return fracs


# --- shared by the multi-sensor tests (tests/test_torch_multisensor*.py) ---

#: the map of ``tests/test_multisensor.py::_small_cfg``: fewer points and
#: clusters than ``KW`` keep two cameras a frame inside the time budget
MS_KW = dict(KW, max_input_points=512, mover_capacity=4096,
             pyramid_slot_capacity=64, max_clusters=8)


def two_camera_frames(cfg, n_frames, seed=7, offset=(0.3, -0.2, 0.0)):
    """Two-sensor frames of the street sequence: sensor 0 as generated,
    sensor 1 at a pose shifted by ``offset`` (world frame, same attitude)
    seeing the same world points, so the two overlap without being equal.
    Each item is ``(points [2, P, 3], n [2], pos [2, 3], quat [2, 4],
    t [2])`` in numpy."""
    from dspmap_tpu_torch.geometry import rotation_matrix_np

    out = []
    for pts, n, pos, quat, t in sim.generate_sequence(n_frames, cfg,
                                                      seed=seed):
        shift = np.asarray(offset, np.float32)
        body = (rotation_matrix_np(quat).T @ shift).astype(np.float32)
        pts_b = np.where(np.arange(pts.shape[0])[:, None] < n, pts - body,
                         pts).astype(np.float32)
        out.append((np.stack([pts, pts_b]), np.asarray([n, n], np.int32),
                    np.stack([pos, pos + shift]), np.stack([quat, quat]),
                    np.asarray([t, t], np.float32)))
    return out


def capture_newborn_weights(monkeypatch, sink):
    """Patch the JAX package's birth stages so that each call appends its
    newborn weight to ``sink`` (a host callback inside the jitted step;
    patch before the step is traced)."""
    import dspmap_tpu.models.pipeline as jpipe
    import dspmap_tpu.ops.birth as jbirth

    def wrap(orig):
        def birth(*a, **kw):
            p, stats = orig(*a, **kw)
            jax.debug.callback(lambda v: sink.append(np.float32(v)),
                               stats["newborn_weight"], ordered=True)
            return p, stats
        return birth

    monkeypatch.setattr(jpipe, "particle_birth", wrap(jpipe.particle_birth))
    monkeypatch.setattr(jbirth, "particle_birth_compact",
                        wrap(jbirth.particle_birth_compact))


def record_multi(jcfg, step, state, frames, sink):
    """Run the jitted JAX multi-sensor ``step`` over ``frames`` (items of
    :func:`two_camera_frames`) from ``state``; per frame the state before,
    the draws in the port's form, the frame, the state after, the metrics
    and the newborn weights of its birth calls (from ``sink``, see
    :func:`capture_newborn_weights`)."""
    out = []
    for fr in frames:
        before = jax.device_get(state)
        draws = jax_multisensor_draws(state.rng, jcfg, fr[0].shape[0])
        del sink[:]
        state, res = step(state, J.Frame(*(jnp.asarray(x) for x in fr)))
        jax.block_until_ready(state)
        jax.effects_barrier()
        out.append(dict(
            before=before, draws=draws, frame=fr, after=jax.device_get(state),
            live=state, accepted=bool(res.accepted), newborn=list(sink),
            metrics={k: np.asarray(v) for k, v in res.metrics.items()}))
    return out


def record_multisensor(jcfg, n_sensors, n_frames):
    """The jitted JAX multi-sensor step of ``jcfg`` over ``n_frames`` of
    :func:`two_camera_frames` from ``init_multisensor_state(key 0)``, with
    each frame's newborn weights captured (:func:`record_multi`)."""
    import pytest
    from dspmap_tpu.models.pipeline import (init_multisensor_state,
                                            make_multisensor_step)

    sink = []
    with pytest.MonkeyPatch.context() as mp:
        capture_newborn_weights(mp, sink)
        step = jax.jit(make_multisensor_step(jcfg, n_sensors))
        frames = record_multi(
            jcfg, step, init_multisensor_state(jcfg, n_sensors,
                                               jax.random.key(0)),
            two_camera_frames(jcfg, n_frames), sink)
    assert all(len(f["newborn"]) == n_sensors for f in frames)
    return frames


def run_multi(frames, tcfg, monkeypatch, pinned, teacher_forced):
    """The port's multi-sensor step over recorded frames, from each frame's
    JAX state (``teacher_forced``) or carrying its own state, with the JAX
    newborn weights pinned one a sensor (``pinned``); yields ``(i, new
    state, output, recorded frame)``."""
    birth = ("particle_birth_compact" if tcfg.layout == "compact"
             else "particle_birth")
    jax_weight = {}
    if pinned:
        pin_newborn_weight(monkeypatch, birth, jax_weight)
    n_sensors = frames[0]["frame"][0].shape[0]
    step = T.make_multisensor_step(tcfg, n_sensors)
    state = T.state_from_numpy(frames[0]["before"], tcfg, device="cpu")
    for i, f in enumerate(frames):
        jax_weight["value"] = list(f["newborn"])
        if teacher_forced:
            state = T.state_from_numpy(f["before"], tcfg, device="cpu")
        state, out = step(state, T.Frame(*f["frame"]), f["draws"])
        if pinned:
            assert jax_weight["value"] == []  # one pinned birth a sensor
        yield i, state, out, f


def check_multi_free_run(frames, tcfg, monkeypatch, pinned):
    """Free-running bars: with the newborn weights pinned flags >= 99.9%
    and alive within 0.5% in every frame; free, alive within 2% (and the
    compact layout's flags >= 99.5%); alive within 2 particles passes
    either way, as ``check_frame``'s counters do (the first frames hold
    some 40)."""
    for i, state, out, f in run_multi(frames, tcfg, monkeypatch, pinned,
                                      False):
        a_t, a_j = int(out.metrics["alive"]), int(f["metrics"]["alive"])
        assert abs(a_t - a_j) <= max(2, (0.005 if pinned else 0.02) * a_j), (
            i, a_t, a_j)
        frac = np.mean(state.particles.flags.numpy()
                       == np.asarray(f["after"].particles.flags))
        bar = 0.999 if pinned else (0.995 if tcfg.layout == "compact" else 0)
        assert frac >= bar, (i, frac)


# --- shared by the sharded tests (tests/test_torch_shard_*.py) -------------

def port_cfg(jcfg):
    """The port's copy of a JAX configuration."""
    import dataclasses

    return T.MapConfig(**dataclasses.asdict(jcfg))


def jax_shard_draws(rng, cfg, n):
    """The draws of the JAX ``make_shardmap_step`` on ``n`` shards for key
    ``rng``, in the form ``tests/torch_shard.py`` hands each rank:
    ``(replicated, per_rank)``.  The replicated draws are the single-device
    step's first four (``_sensor_draws``); on a noisy configuration rank
    ``r`` draws its own propagation and FOV noise at the slab's shape from
    ``fold_in(keys[1], r)`` and ``fold_in(keys[2], r)``."""
    keys = jax.random.split(rng, 6)
    replicated = _sensor_draws(keys[0], keys[3], cfg)
    if not noisy(cfg):
        return replicated, None
    shape = particle_shape(cfg)
    slab = shape[:-1] + (shape[-1] // n,)
    return replicated, [tuple(
        np.array(jax.random.normal(jax.random.fold_in(keys[k], r),
                                   (m,) + slab, jnp.float32))
        for k, m in ((1, 3), (2, 2))) for r in range(n)]


def record_shardmap(jcfg, n, state, seq):
    """Run JAX's ``make_shardmap_step`` on ``n`` of the virtual CPU devices
    over ``seq`` (items of ``sim.generate_sequence``) from the whole state
    ``state``: per frame the whole state before and after (numpy), the
    draws (:func:`jax_shard_draws`), the frame and the metrics."""
    from dspmap_tpu.parallel import make_mesh, shard_state
    from dspmap_tpu.parallel.shard_step import make_shardmap_step

    mesh = make_mesh(n)
    step = make_shardmap_step(jcfg, mesh)
    state = shard_state(state, mesh)
    frames = []
    for pts, npts, pos, quat, t in seq:
        before = jax.device_get(state)
        draws = jax_shard_draws(state.rng, jcfg, n)
        state, out = step(state, J.Frame(jnp.asarray(pts), jnp.int32(npts),
                                         jnp.asarray(pos), jnp.asarray(quat),
                                         jnp.asarray(t)))
        frames.append(dict(
            before=before, draws=draws, frame=(pts, npts, pos, quat, t),
            after=jax.device_get(state), accepted=bool(out.accepted),
            metrics={k: np.asarray(v) for k, v in out.metrics.items()}))
    return frames


def voxel_flag_counts(flags):
    """Per voxel, the number of slots holding each flag value 1, 2, 3."""
    f = np.asarray(flags)
    return np.stack([(f == k).sum(axis=0) for k in (1, 2, 3)])


def port_result(tcfg, res):
    """``(state, StepOutput)`` on the CPU from one frame's ``(accepted,
    metrics, gathered numpy state, ...)`` of ``tests/torch_shard.py``'s
    ``steps`` or ``multisensor_steps``."""
    from torch_shard import tree

    accepted, metrics, whole = res[:3]
    state = T.state_from_numpy(tree(whole), tcfg, device="cpu")
    return state, T.StepOutput(accepted, state.weight_sum, metrics, None)


#: the counters ``tests/test_shard_step.py`` holds equal
SHARD_COUNTERS = ("alive", "born", "movers", "in_fov", "updated_particles",
                  "culled", "mover_overflow_killed", "voxel_full_killed")


def whole_draws(draws):
    """A sharded frame's draws for the single-device step: the replicated
    ones, then each pool-shaped draw joined from the ranks' slabs (the
    noise every slot saw)."""
    replicated, per_rank = draws
    if per_rank is None:
        return replicated
    return replicated + tuple(np.concatenate(parts, axis=-1)
                              for parts in zip(*per_rank))


def shard_cases(base, exchanges, tmp_path_factory, overrides=None,
                extra=()):
    """Per exchange, on ``tests/test_shard_step.py``'s ``cfg_for(4, base)``
    (with ``overrides``) and its frames: the JAX sharded run, the port's
    single-device run with the same draws, and the ranks' teacher-forced
    and free runs; the ranks' results of the ``extra`` cases under
    ``"extra"`` (one start of the ranks for all)."""
    import dataclasses

    from test_shard_step import cfg_for
    from torch_shard import N_RANKS, run_ranks, tree

    runs, cases = {}, []
    for exchange in exchanges:
        jcfg = dataclasses.replace(cfg_for(N_RANKS, base),
                                   mover_exchange=exchange,
                                   **(overrides or {})).validate()
        seq = list(sim.generate_sequence(4, jcfg, seed=5))
        frames = record_shardmap(jcfg, N_RANKS,
                                 J.init_state(jcfg, jax.random.key(0)), seq)
        tcfg = port_cfg(jcfg)
        init = tree(frames[0]["before"])
        common = dict(kind="steps", cfg=tcfg,
                      frames=[f["frame"] for f in frames],
                      draws=[f["draws"] for f in frames])
        cases.append(dict(common, teacher=[tree(f["before"]) for f in frames],
                          pin=[f["metrics"]["newborn_weight"] for f in frames]))
        cases.append(dict(common, init=init, keep=[len(frames) - 1]))
        runs[exchange] = dict(frames=frames, tcfg=tcfg)
    # the port's one-device run (the mover exchange plays no part there; the
    # exchanges' JAX runs give it the same draws)
    frames, tcfg = runs[exchanges[0]]["frames"], runs[exchanges[0]]["tcfg"]
    step = T.make_step(tcfg)
    state = T.state_from_numpy(tree(frames[0]["before"]), tcfg, device="cpu")
    for f in frames:
        state, out = step(state, T.Frame(*f["frame"]), whole_draws(f["draws"]))
    for exchange in exchanges:
        runs[exchange]["single"] = (state, out)
    got = run_ranks(cases + list(extra), tmp_path_factory.mktemp("ranks"))
    for k, exchange in enumerate(exchanges):
        runs[exchange]["teacher"] = [r[2 * k] for r in got]
        runs[exchange]["free"] = [r[2 * k + 1] for r in got]
    runs["extra"] = [r[2 * len(exchanges):] for r in got]
    return runs


def check_teacher_forced(run):
    """Every frame of every rank: the same metrics on every rank; rank 0's
    gathered state against the JAX sharded step's (pinned bars)."""
    from torch_shard import N_RANKS

    tcfg, frames = run["tcfg"], run["frames"]
    by_rank = run["teacher"]
    for i, f in enumerate(frames):
        for r in range(1, N_RANKS):
            for k, v in by_rank[0][i][1].items():
                assert np.array_equal(v, by_rank[r][i][1][k]), (i, r, k)
        new, out = port_result(tcfg, by_rank[0][i])
        check_frame(i, new, out, f, pinned=True)
    last = frames[-1]["metrics"]
    assert int(last["born"]) > 0 and int(last["updated_particles"]) > 0
    # the dynamic model moves particles between voxels, the static never
    dynamic = run["tcfg"].motion_model != "static"
    assert (int(last["movers"]) > 0) == dynamic


def check_free_running(run, counters=SHARD_COUNTERS):
    """The last frame of the free run against the port's single-device
    run (``tests/test_shard_step.py``'s bars)."""
    s1, o1 = run["single"]
    s2, o2 = port_result(run["tcfg"], run["free"][0][-1])
    assert o1.accepted and o2.accepted
    assert int(o1.metrics["alive"]) > 0
    np.testing.assert_allclose(s1.weight_sum.numpy(), s2.weight_sum.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(s1.future.numpy(), s2.future.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(voxel_flag_counts(s1.particles.flags),
                                  voxel_flag_counts(s2.particles.flags))
    for k in counters:
        assert int(o1.metrics[k]) == int(o2.metrics[k]), k




# --- shared by the sharded multi-sensor tests ------------------------------

#: the occupancy counters, which are the multi-sensor step's metrics
MS_COUNTERS = ("alive", "culled", "resampled_voxels", "resample_dropped",
               "resample_copies", "future_moving", "future_overflow")


def slab_draws(draws, n):
    """A multi-sensor frame's draws ``(prop_noise, per-sensor tuples)`` for
    each of ``n`` ranks: the per-sensor four replicated, and each
    pool-shaped normal (the propagation noise, a sensor's FOV noise) cut to
    the rank's slab on its last axis -- the noise every slot of the slab
    sees on one device."""
    prop, sensors = draws

    def cut(x, r):
        m = x.shape[-1] // n
        return np.ascontiguousarray(x[..., r * m:(r + 1) * m])

    return [(None if prop is None else cut(prop, r),
             tuple(tuple(s[:4]) + tuple(cut(x, r) for x in s[4:])
                   for s in sensors)) for r in range(n)]


def multisensor_shard_cases(cases, tmp_path_factory, n_sensors=2,
                            init_particles=0):
    """For each ``name: (JAX config, frames)`` of ``cases`` (items of
    :func:`two_camera_frames`, edited as a case needs): the JAX one-device
    multi-sensor run from ``init_multisensor_state(key 0)`` with
    ``init_particles`` random particles added (``add_random_particles``:
    velocities in [-1, 1]) and each frame's newborn weights
    (:func:`record_multi`; one jitted step a configuration), the port's
    one-device run on the same draws, and the ranks' teacher-forced run
    (each frame from JAX's state before it, the newborn weights pinned)
    and free run (``tests/torch_shard.py``'s ``multisensor_steps``), each
    rank given its slab of the pool-shaped draws (:func:`slab_draws`).  One
    start of the ranks for all: they take each case as soon as it is
    recorded, and a thread makes the one-device runs meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    import pytest
    from dspmap_tpu.models.pipeline import (init_multisensor_state,
                                            make_multisensor_step)
    from dspmap_tpu.state import add_random_particles
    from torch_shard import (N_RANKS, post_jobs, start_ranks, stop_ranks,
                             tree, wait_ranks)

    def one_device(rec, tcfg):
        step = T.make_multisensor_step(tcfg, n_sensors)
        state = T.state_from_numpy(tree(rec[0]["before"]), tcfg,
                                   device="cpu")
        for f in rec:
            state, out = step(state, T.Frame(*f["frame"]), f["draws"])
        return state, out

    runs, sink, built = {}, [], {}
    scatter = jax.jit(add_random_particles, static_argnums=(1, 2, 3))
    ranks = start_ranks(tmp_path_factory.mktemp("ranks"))
    # the one-device runs overlap the recording of the next configuration
    worker = ThreadPoolExecutor(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            capture_newborn_weights(mp, sink)
            for name, (jcfg, frames) in cases.items():
                if jcfg not in built:  # one initial state and step a config
                    init = init_multisensor_state(jcfg, n_sensors,
                                                  jax.random.key(0))
                    built[jcfg] = (
                        scatter(init, jcfg, init_particles, 0.01)
                        if init_particles else init,
                        jax.jit(make_multisensor_step(jcfg, n_sensors)))
                init, step = built[jcfg]
                rec = record_multi(jcfg, step, init, frames, sink)
                tcfg = port_cfg(jcfg)
                common = dict(kind="multisensor_steps", cfg=tcfg,
                              n_sensors=n_sensors,
                              frames=[f["frame"] for f in rec],
                              draws=[slab_draws(f["draws"], N_RANKS)
                                     for f in rec])
                post_jobs(ranks, [
                    dict(common, pin=[f["newborn"] for f in rec],
                         teacher=[rows_by_slab(tree(f["before"]), tcfg,
                                               N_RANKS) for f in rec]),
                    dict(common, keep=[len(rec) - 1], init=rows_by_slab(
                        tree(rec[0]["before"]), tcfg, N_RANKS))])
                runs[name] = dict(frames=rec, tcfg=tcfg,
                                  single=worker.submit(one_device, rec,
                                                       tcfg))
        for run in runs.values():
            run["single"] = run["single"].result()
    except BaseException:
        stop_ranks(ranks)
        raise
    finally:
        worker.shutdown(cancel_futures=True)
    got = wait_ranks(ranks)
    for k, run in enumerate(runs.values()):
        run["teacher"] = [r[2 * k] for r in got]
        run["free"] = [r[2 * k + 1] for r in got]
    return runs


def population(state, cfg):
    """Per storage cell, the particles holding each flag value 1, 2, 3
    (``[3, V]``): pool slots by their column, compact rows by the cell of
    their position, so that it reads alike whatever the row order."""
    flags = np.asarray(state.particles.flags)
    if cfg.layout != "compact":
        return voxel_flag_counts(flags)
    cell = _row_cells(state.particles, cfg)
    return np.stack([np.bincount(cell[flags == k],
                                 minlength=cfg.storage_voxels)
                     for k in (1, 2, 3)])


def _row_cells(p, cfg):
    """The storage cell of each compact row's position (numpy)."""
    g = T.geometry
    return g.storage_index_planar(*g.world_voxel_planar(*(
        torch.tensor(np.asarray(getattr(p, k))) for k in ("px", "py",
                                                             "pz")), cfg),
        cfg).numpy()


def placed_alike(cfg):
    """``check_frame``'s ``share`` for the compact layout, whose rows the
    sharded step keeps by slab and the one-device step by cell: the share
    of the reference's particles placed in the same cells with the same
    flag, one minus the summed count differences over its count."""
    def share(new, want):
        a, b = population(new, cfg), population(want, cfg)
        return 1.0 - np.abs(a - b).sum() / max(b.sum(), 1)
    return share


def rows_by_slab(tree, cfg, n):
    """A one-device compact state (a :func:`torch_shard.tree`) with its
    live rows moved to the block of rows of their cell's slab, in their
    order, as ``shard_state`` expects it for ``n`` ranks (dead rows
    zeroed); a pool state as it is."""
    if cfg.layout != "compact":
        return tree
    from types import SimpleNamespace

    p = tree.particles
    P, V = cfg.compact_capacity, cfg.storage_voxels
    slab = np.where(p.flags != 0, _row_cells(p, cfg) // (V // n), n)
    rows = np.full(P, P)  # the source row of each row, P: a dead row
    for r in range(n):
        mine = np.nonzero(slab == r)[0]
        assert mine.size <= P // n, (r, mine.size)
        rows[r * (P // n):r * (P // n) + mine.size] = mine
    planes = {k: np.concatenate([v, np.zeros(1, v.dtype)])[rows]
              for k, v in vars(p).items()}
    return SimpleNamespace(**dict(vars(tree),
                                  particles=SimpleNamespace(**planes)))


def check_ranks_agree(by_rank):
    """Every frame: the same acceptance, metrics and replicated leaves
    (estimator tracks, host scalars, the generator) on every rank, bit for
    bit -- the JAX package's invariant for replicated quantities."""
    for i, (acc, metrics, _, leaves, _) in enumerate(by_rank[0]):
        for r, mine in enumerate(by_rank[1:], 1):
            assert mine[i][0] == acc, (i, r)
            assert mine[i][1].keys() == metrics.keys(), (i, r)
            for k, v in metrics.items():
                assert np.array_equal(v, mine[i][1][k]), (i, r, k)
            assert mine[i][3].keys() == leaves.keys(), (i, r)
            for k, v in leaves.items():
                w = mine[i][3][k]
                assert v.dtype == w.dtype, (i, r, k)
                assert np.array_equal(bits(v), bits(w)), (i, r, k)


def check_multisensor_teacher_forced(run):
    """Every frame from JAX's state before it, the newborn weights pinned:
    the ranks agree (:func:`check_ranks_agree`) and rank 0's gathered state
    holds ``check_frame``'s pinned bars against JAX's one-device step (the
    compact layout's flags by :func:`placed_alike`), its estimator tracks
    those of ``tests/test_torch_multisensor.py``."""
    tcfg, frames = run["tcfg"], run["frames"]
    check_ranks_agree(run["teacher"])
    share = placed_alike(tcfg) if tcfg.layout == "compact" else None
    for i, f in enumerate(frames):
        new, out = port_result(tcfg, run["teacher"][0][i][:3])
        check_frame(i, new, out, f, pinned=True, share=share)
        est, want = new.estimator, f["after"].estimator
        for name in ("prev_point_num", "prev_valid"):
            np.testing.assert_array_equal(getattr(est, name).numpy(),
                                          np.asarray(getattr(want, name)))
        for name in ("prev_centers", "prev_intensity"):
            np.testing.assert_allclose(getattr(est, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def check_multisensor_free_running(run):
    """The free run: the ranks agree (:func:`check_ranks_agree`), and the
    last gathered state holds :func:`check_free_running`'s bars against
    the port's one-device multi-sensor step on the same draws --
    ``weight_sum`` and ``future`` within rtol 1e-5, the same particles of
    each flag in every cell (:func:`population`), the occupancy counters
    equal -- and its estimator tracks are bit-equal (the same frames
    through the same replicated computation)."""
    check_ranks_agree(run["free"])
    tcfg = run["tcfg"]
    (s1, o1), (s2, o2) = run["single"], port_result(tcfg, run["free"][0][-1])
    assert o1.accepted and o2.accepted
    assert int(o1.metrics["alive"]) > 0
    for name in ("weight_sum", "future"):
        np.testing.assert_allclose(getattr(s2, name).numpy(),
                                   getattr(s1, name).numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(population(s2, tcfg), population(s1, tcfg))
    for k in MS_COUNTERS:
        assert int(o1.metrics[k]) == int(o2.metrics[k]), k
    for f in dataclasses.fields(T.EstimatorState):
        assert_bits_equal(getattr(s2.estimator, f.name).numpy(),
                          getattr(s1.estimator, f.name).numpy(), f.name)
