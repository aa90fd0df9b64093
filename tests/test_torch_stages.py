"""The port's pipeline stages one at a time against the JAX package's, each
fed the JAX package's own inputs for that stage (CPU).

One JAX frame is run stage by stage on a map that earlier frames have
populated (``example_node_settings(dsp_dynamic(...))`` on 24x24x12 at
0.25 m, dense tiers cut to 8 so both spill tiers carry data), keeping every intermediate.  Each port
stage then starts from the JAX intermediates, so a difference is that
stage's own.  The random draws are the JAX step's, rebuilt from its key
tree (``keys = split(rng, 6)``; the estimator's uniform from
``split(keys[0])[1]``, the birth table's from ``split(keys[3], 3)``).
The tolerance of each comparison is stated at its test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu import geometry as jg
from dspmap_tpu.estimator import estimate_velocities as jax_estimate
from dspmap_tpu.ops.birth import particle_birth as jax_birth
from dspmap_tpu.ops.fov import rebin_and_register as jax_rebin
from dspmap_tpu.ops.occupancy import occupancy_and_resample as jax_occupancy
from dspmap_tpu.ops.project import project_points as jax_project
from dspmap_tpu.ops.sweep import sweep as jax_sweep
from dspmap_tpu.ops.update import measurement_update as jax_update
from dspmap_tpu.state import flatten_pool, ravel_plane
from dspmap_tpu.utils import sim
from dspmap_tpu_torch.estimator import EstimatorOutput, estimate_velocities
from dspmap_tpu_torch.ops.birth import particle_birth
from dspmap_tpu_torch.ops.fov import FovBinning
from dspmap_tpu_torch.ops.occupancy import occupancy_and_resample
from dspmap_tpu_torch.ops.project import Observation
from dspmap_tpu_torch.ops.update import measurement_update

torch.set_num_threads(2)

KW = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=1024,
          mover_capacity=8192, pyramid_slot_capacity=96, max_clusters=16,
          pyramid_dense_slots=8, obs_dense_points=8)  # small dense tiers:
#                                             both spill tiers carry data
WARM_FRAMES = 4  # JAX frames that populate the map before the staged one
PLANES = ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")


def _t(x):
    """numpy/JAX array -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def _tree(nt, cls):
    """A JAX NamedTuple as the port's NamedTuple of the same fields."""
    return cls(**{k: _t(getattr(nt, k)) for k in cls._fields})


def _pool(p, shape):
    """JAX particles (flat or [S, V]) -> the port's [S, V] Particles."""
    return T.Particles(**{k: _t(getattr(p, k)).reshape(shape) for k in PLANES})


def _staged(cfg, state, frame):
    """``make_step``'s pool branch (fused-sweep arm) for an accepted frame,
    keeping every stage's inputs and outputs."""
    pts, n, pos, quat, ts = frame
    dt = ts - jnp.where(state.initialized, state.last_timestamp, ts)
    origin = jg.window_origin(pos, cfg)
    keys = jax.random.split(state.rng, 6)
    update_time = state.update_time + dt
    rt = state.params
    obs = jax_project(pts, jnp.arange(pts.shape[0]) < n, pos, quat, cfg)
    expected = (rt.newborn_particle_weight
                * obs.n_valid_points.astype(jnp.float32)
                * cfg.newborn_particles_per_point)
    est_out, est_state = jax_estimate(obs.cloud_world, obs.cloud_valid,
                                      state.estimator, cfg, dt, keys[0])
    p = dataclasses.replace(state.particles,
                            vz=jnp.zeros_like(state.particles.vz))
    sw = jax_sweep(p, cfg, dt, origin, pos, quat)
    p = flatten_pool(dataclasses.replace(p, px=sw.px, py=sw.py, pz=sw.pz,
                                         flags=sw.flags), skip=("t",))
    sw_flat = sw._replace(tags=ravel_plane(sw.tags),
                          new_cell=ravel_plane(sw.new_cell))
    p_fov, fovbin, movers, _, pending = jax_rebin(p, cfg, sw_flat, pos,
                                                  update_time)
    p_upd, norm_coeff, upd_stats = jax_update(p_fov, fovbin, obs, cfg,
                                              expected, update_time, rt=rt)
    p_born, birth_stats = jax_birth(
        p_upd, cfg, keys[3], est_points=est_out.points, est_vel=est_out.vel,
        est_dynamic=est_out.dynamic, est_valid=est_out.valid,
        norm_coeff=norm_coeff, origin=origin, update_time=update_time,
        rt=rt, pending=pending)
    occ = jax_occupancy(p_born, cfg, origin, state.future, movers)
    new_state = dataclasses.replace(
        state, particles=occ[0], weight_sum=occ[1], vel_avg=occ[2],
        future=occ[3], rng=keys[5], sensor_pos=pos, last_sensor_pos=pos,
        origin=origin, update_time=update_time, last_timestamp=ts,
        update_counter=state.update_counter + 1,
        initialized=jnp.asarray(True), estimator=est_state)
    return dict(state=new_state, dt=dt, origin=origin,
                update_time=update_time, keys=keys, obs=obs, expected=expected, est_out=est_out,
                est_state=est_state, p_fov=p_fov, fovbin=fovbin,
                movers=movers, p_upd=p_upd, norm_coeff=norm_coeff,
                upd_stats=upd_stats, p_born=p_born, birth_stats=birth_stats,
                occ=occ)


@pytest.fixture(scope="module")
def staged():
    cfg = J.example_node_settings(J.dsp_dynamic(**KW))
    assert cfg.dense_slots < cfg.pyramid_slots
    assert cfg.obs_dense < cfg.max_obs_points_per_pyramid
    state = J.init_state(cfg, jax.random.key(0))
    staged_step = jax.jit(lambda s, f: _staged(cfg, s, f))
    for f in sim.generate_sequence(WARM_FRAMES + 1, cfg, seed=7):
        before = state
        out = staged_step(state, tuple(map(jnp.asarray, f)))
        state = out["state"]
    return cfg, jax.device_get(before), jax.device_get(out)


def _tcfg():
    return T.example_node_settings(T.dsp_dynamic(**KW))


def _rt(before):
    return T.state_from_numpy(before, _tcfg(), device="cpu").params


def test_estimate_velocities_matches_jax(staged):
    """Clusters, velocities and the next estimator state: integer and bool
    fields exact, floats to 1e-5 relative (centroids are f32 segment
    sums)."""
    cfg, before, out = staged
    tcfg = _tcfg()
    obs, keys = out["obs"], out["keys"]
    fresh = jax.random.uniform(jax.random.split(keys[0])[1], (cfg.max_clusters,),
                               jnp.float32, 0.1, 1.0)
    est_state = T.state_from_numpy(before, tcfg, device="cpu").estimator
    got, got_state = estimate_velocities(
        _t(obs.cloud_world), _t(obs.cloud_valid), est_state, tcfg,
        float(out["dt"]), _t(fresh))
    want, want_state = out["est_out"], out["est_state"]
    assert int(np.asarray(want.dynamic).sum()) > 0
    assert int(np.asarray(want_state.prev_valid).sum()) > 0
    for a, b in ((want, got), (want_state, got_state)):
        names = (a._fields if hasattr(a, "_fields")
                 else [f.name for f in dataclasses.fields(a)])
        for name in names:
            x, y = np.asarray(getattr(a, name)), getattr(b, name).numpy()
            if x.dtype == np.float32:
                np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(y, x, err_msg=name)


def test_measurement_update_matches_jax(staged):
    """Pass 1, pass 2 and the writeback over both tiers: the updated
    weight plane to rtol 2e-4, ``norm_coeff`` to 1e-5, the counters exact.
    Both evaluate the pair terms in the ``|a|^2 + |b|^2 - 2ab`` form and
    sum in other orders; at |x|/sigma ~ 40 that form loses ~1e-4 absolute
    in d2, ~5e-5 relative in a pair term (52 of the 243 updated slots
    differ by more than 1e-5, the largest by 9.4e-5)."""
    cfg, before, out = staged
    tcfg = _tcfg()
    shape = (tcfg.slots_per_voxel, tcfg.storage_voxels)
    got, norm, stats = measurement_update(
        _pool(out["p_fov"], shape), _tree(out["fovbin"], FovBinning),
        _tree(out["obs"], Observation), tcfg, _t(out["expected"]),
        float(out["update_time"]), _rt(before))
    want = np.asarray(out["p_upd"].weight).reshape(shape)
    changed = want != np.asarray(out["p_fov"].weight).reshape(shape)
    assert changed.sum() > 100
    np.testing.assert_allclose(got.weight.numpy(), want, rtol=2e-4, atol=1e-12)
    np.testing.assert_allclose(float(norm), float(out["norm_coeff"]), rtol=1e-5)
    assert int(np.asarray(out["fovbin"].sp_mask).sum()) > 0
    assert int(np.asarray(out["obs"].spill_cell_mask).sum()) > 0
    for k, v in out["upd_stats"].items():
        assert int(stats[k]) == int(v), k


def test_particle_birth_matches_jax(staged):
    """DS classification, quotas and jitter with the JAX draws: flags
    exact, positions and velocities to 1e-6 (the same f32 operations),
    the counters exact."""
    cfg, before, out = staged
    tcfg = _tcfg()
    shape = (tcfg.slots_per_voxel, tcfg.storage_voxels)
    kp, kv, ku = jax.random.split(out["keys"][3], 3)
    dshape = (cfg.max_input_points, cfg.newborn_particles_per_point, 3)
    draws = tuple(_t(x) for x in (
        jax.random.normal(kp, dshape, jnp.float32),
        jax.random.normal(kv, dshape, jnp.float32),
        jax.random.uniform(ku, dshape, jnp.float32, -1.0, 1.0)))
    est = _tree(out["est_out"], EstimatorOutput)
    got, stats = particle_birth(
        _pool(out["p_upd"], shape), tcfg, draws, est_points=est.points,
        est_vel=est.vel, est_dynamic=est.dynamic, est_valid=est.valid,
        norm_coeff=_t(out["norm_coeff"]), origin=np.asarray(out["origin"]),
        update_time=float(out["update_time"]), rt=_rt(before))
    want = out["p_born"]
    assert int(out["birth_stats"]["born"]) > 100
    np.testing.assert_array_equal(got.flags.numpy(),
                                  np.asarray(want.flags).reshape(shape))
    for k in ("px", "py", "pz", "vx", "vy", "vz", "weight"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)).reshape(shape),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k, v in out["birth_stats"].items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-6,
                                   err_msg=k)


def test_occupancy_and_resample_matches_jax(staged):
    """The pool pass, vel_avg and the future grid on the JAX post-birth
    pool: flags exact, weights, weight_sum and vel_avg to rtol 1e-6, the
    future grid to rtol 1e-5 (duplicate-cell scatter-adds in another
    order), every counter exact."""
    cfg, before, out = staged
    tcfg = _tcfg()
    shape = (tcfg.slots_per_voxel, tcfg.storage_voxels)
    movers = tuple(_t(x) for x in out["movers"])
    got = occupancy_and_resample(_pool(out["p_born"], shape), tcfg,
                                 np.asarray(out["origin"]),
                                 _t(before.future), movers)
    want = out["occ"]
    for k in ("future_moving", "culled", "resample_dropped"):
        assert int(want[4][k]) > 0, k
    np.testing.assert_array_equal(got[0].flags.numpy(),
                                  np.asarray(want[0].flags))
    for k in ("weight", "px", "py", "pz", "vx", "vy"):
        np.testing.assert_allclose(getattr(got[0], k).numpy(),
                                   np.asarray(getattr(want[0], k)),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    for i, name in ((1, "weight_sum"), (2, "vel_avg")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=1e-9)
    for k, v in want[4].items():
        assert int(got[4][k]) == int(v), k
