"""The static and multi-neighbor presets of the port against the JAX package
(CPU): the modules that hold a kernel at the presets' shapes, the branches
only these presets take, and the static step.  The multi-neighbor step is
in ``tests/test_torch_presets_multi.py``.

* K1's plain version against ``ops/occupancy.py::_pool_pass_xla`` at
  S = 50 (static: no velocity planes, 10 particles a voxel) and S = 60
  (multi: two velocity planes, 30 a voxel): flags exact, weights rtol 1e-6,
  and exact on voxels of equal-weight newborns (the slot-axis cumsum and
  the slot-axis totals associate as XLA's at these depths too).
* K3's plain versions against the Pallas pair kernels in interpret mode at
  (56 rows, 16, 400) -- multi's tile, rows cut -- and (504, 32, 288),
  static's: in float64 within the kernels' own bar (rtol 2e-5, atol 1e-6,
  ``tests/test_pallas.py``); in float32 within rtol 1e-3, because the plain
  version's ``|a|^2 + |b|^2 - 2ab`` loses ~|a|^2 2^-24 in d2 (|a| ~ 35
  here, so ~1e-4 absolute in d2 and a few 1e-4 relative in a pair sum;
  the kernels form coordinate differences and lose nothing there).
* K5's plain versions are held against the Pallas relayout kernels in
  ``tests/test_torch_presets_relayout.py``.
* the neighbourhood helpers at radius 2, the sweep without advance, the
  estimator's pass-through and the static birth table: exact (floats of the
  sweep atol 1e-5).
* the static step, teacher-forced against the jitted JAX step for 8 frames
  with the JAX draws injected, at the bars of ``tests/test_torch_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu.estimator import estimate_velocities as jax_estimate
from dspmap_tpu.ops import update as jax_update
from dspmap_tpu.ops.birth import birth_table as jax_birth_table
from dspmap_tpu.ops.occupancy import _pool_pass_xla
from dspmap_tpu.ops.pallas import update as jax_pair
from dspmap_tpu.ops.sweep import sweep_reference as jax_sweep
from dspmap_tpu_torch import state as tstate
from dspmap_tpu_torch.estimator import estimate_velocities
from dspmap_tpu_torch.ops import birth, occupancy, sweep, update
from torch_parity import (both, occupancy_pool, preset_configs, record,
                          teacher_forced, tie_pool)

torch.set_num_threads(2)

SMALL = dict(nx=16, ny=16, nz=8, max_input_points=128, mover_capacity=1024,
             max_clusters=4)
N_FRAMES = 8


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("preset,slots,n_vel", [("static", 50, 0),
                                                ("multi", 60, 2)])
def test_pool_pass_plain_matches_xla_at_deep_slots(preset, slots, n_vel, seed):
    jcfg, tcfg = preset_configs(preset, node=False, **SMALL)
    assert tcfg.slots_per_voxel == slots and occupancy._n_vel(tcfg) == n_vel
    assert slots in occupancy.KERNEL_SLOTS
    jp, tp = both(occupancy_pool(jcfg, seed))
    ref, ws_r, n_old_r, vsum_r, static_r, moving_r = _pool_pass_xla(jp, jcfg)
    (fields, ws, n_old, vsum, static_c, moving,
     counters) = occupancy.pool_pass_plain(tp, tcfg, with_moving=True)
    np.testing.assert_array_equal(_n(fields["flags"]), _n(ref.flags))
    np.testing.assert_allclose(_n(fields["weight"]), _n(ref.weight),
                               rtol=1e-6, atol=1e-9)
    for f in ("px", "py", "pz", "vx", "vy", "vz"):
        np.testing.assert_array_equal(_n(fields[f]), _n(getattr(ref, f)), f)
    np.testing.assert_allclose(_n(ws), _n(ws_r), rtol=1e-6)
    np.testing.assert_allclose(_n(static_c), _n(static_r), rtol=1e-6)
    for got, want in zip(vsum, vsum_r):
        np.testing.assert_allclose(_n(got), _n(want), rtol=1e-6)
    np.testing.assert_array_equal(_n(n_old), _n(n_old_r))
    np.testing.assert_array_equal(_n(moving), _n(moving_r))
    n_valid, _, do_rs, n_dropped, n_filled = (_n(c) for c in counters)
    new_valid = _n(ref.flags) != 0
    assert (n_valid - n_dropped + n_filled).sum() == new_valid.sum()
    assert do_rs.sum() > 100 and n_dropped.sum() > 0 and n_filled.sum() > 0


@pytest.mark.parametrize("preset", ["static", "multi"])
def test_pool_pass_plain_matches_xla_on_ties_at_deep_slots(preset):
    """Equal-weight newborn voxels at S = 50 and 60: flags and weights
    equal bit for bit.  That needs the cumsum's block-of-16 association
    and, beyond 32 slots, the weight sum in two halves as XLA's CPU reduce
    forms it (``occupancy.sum_split``); summed in plain slot order, 0.3% of
    the flags differ at S = 50 and 1% at S = 60."""
    jcfg, tcfg = preset_configs(preset, node=False, **SMALL)
    jp, tp = both(tie_pool(jcfg, 11))
    ref = _pool_pass_xla(jp, jcfg)[0]
    got = occupancy.pool_pass_plain(tp, tcfg)[0]
    np.testing.assert_array_equal(_n(got["flags"]), _n(ref.flags))
    np.testing.assert_array_equal(_n(got["weight"]), _n(ref.weight))
    assert (_n(ref.flags) != 0).sum() > 10000


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("rows,s_t,ck", [(56, 16, 400), (504, 32, 288)],
                         ids=["multi_tile_rows_cut", "static_tile"])
def test_pair_passes_plain_match_pallas_interpret(rows, s_t, ck):
    rng = np.random.default_rng(rows)
    sigma = 0.1
    pos = rng.normal(0, 2, (rows, s_t, 3)).astype(np.float32)
    pts = rng.normal(0, 2, (rows, ck, 3)).astype(np.float32)
    pts[:, :s_t] = pos + rng.normal(0, 0.2, pos.shape).astype(np.float32)
    w = (rng.random((rows, s_t)) * (rng.random((rows, s_t)) > 0.3)).astype(
        np.float32)
    cinv = (rng.random((rows, ck)) * (rng.random((rows, ck)) > 0.5)).astype(
        np.float32)
    want1 = np.asarray(jax_pair.update_pass1(
        jnp.asarray(pos), jnp.asarray(w), jnp.asarray(pts), sigma,
        interpret=True))
    want2 = np.asarray(jax_pair.update_pass2(
        jnp.asarray(pos), jnp.asarray(cinv), jnp.asarray(pts), sigma,
        interpret=True))
    assert want1.shape == (rows, ck) and want2.shape == (rows, s_t)
    assert np.abs(want1).max() > 1e-2 and np.abs(want2).max() > 1e-2
    t = [torch.from_numpy(x) for x in (pos, w, pts, cinv)]
    d = [x.double() for x in t]
    np.testing.assert_allclose(
        _n(update.update_pass1_plain(d[0], d[1], d[2], sigma)), want1,
        rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(
        _n(update.update_pass2_plain(d[0], d[3], d[2], sigma)), want2,
        rtol=2e-5, atol=1e-6)
    # the wrappers on CPU tensors run the f32 plain version
    np.testing.assert_allclose(
        _n(update.update_pass1(t[0], t[1], t[2], sigma)), want1,
        rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(
        _n(update.update_pass2(t[0], t[3], t[2], sigma)), want2,
        rtol=1e-3, atol=1e-6)


# ------------------------------------------------- neighbourhoods, radius 2


def test_neighbor_helpers_at_radius_two_match_jax():
    """``gather_neighbors``, ``scatter_neighbor_sum`` and ``neighbor_cells``
    over the 84 x 54 grid of 1-degree cells with 25 offsets: the offsets'
    order is the JAX package's, so everything is equal bit for bit
    (the scatter adds its 25 terms in that order)."""
    jcfg, tcfg = preset_configs("multi")
    assert (tcfg.n_pyramids, tcfg.neighbor_cells) == (4536, 25)
    assert update._offsets(tcfg) == [tuple(o) for o in
                                     jax_update._neighbor_offsets(jcfg)]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4536, 3, 2)).astype(np.float32)
    m = rng.random((4536, 3)) < 0.5
    np.testing.assert_array_equal(
        _n(update.gather_neighbors(torch.from_numpy(x), tcfg, 0.0)),
        _n(jax_update.gather_neighbors(jnp.asarray(x), jcfg, 0.0)))
    np.testing.assert_array_equal(
        _n(update.gather_neighbors(torch.from_numpy(m), tcfg, False)),
        _n(jax_update.gather_neighbors(jnp.asarray(m), jcfg, False)))
    c = rng.random((4536, 25 * 4)).astype(np.float32)
    np.testing.assert_array_equal(
        _n(update.scatter_neighbor_sum(torch.from_numpy(c), tcfg)),
        _n(jax_update.scatter_neighbor_sum(jnp.asarray(c), jcfg)))
    pyr = rng.integers(0, 4536, 200).astype(np.int32)
    pyr[:4] = (0, 53, 4535 - 53, 4535)  # the grid's corners
    got, got_ok = update.neighbor_cells(torch.from_numpy(pyr), tcfg)
    want, want_ok = jax_update.neighbor_cells(jnp.asarray(pyr), jcfg)
    np.testing.assert_array_equal(_n(got_ok), _n(want_ok))
    np.testing.assert_array_equal(_n(got)[_n(got_ok)], _n(want)[_n(want_ok)])
    assert not _n(got_ok).all() and got.shape == (200, 25)


# ----------------------------------------------------- the static branches


def _static_pool(cfg, seed, sensor):
    rng = np.random.default_rng(seed)
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    half = np.asarray(cfg.half_extent, np.float32)
    a = {k: np.zeros((S, V), np.float32) for k in
         ("px", "py", "pz", "vx", "vy", "vz", "weight", "t")}
    a["flags"] = np.where(rng.random((S, V)) < 0.3,
                          rng.choice([1, 3], size=(S, V)), 0).astype(np.int32)
    for i, k in enumerate(("px", "py", "pz")):
        a[k] = (sensor[i] + rng.uniform(-1.2, 1.2, (S, V)) * half[i]).astype(
            np.float32)
    a["weight"] = rng.uniform(0.001, 0.5, (S, V)).astype(np.float32)
    return a


def test_sweep_plain_without_advance_matches_reference():
    """The static model's sweep: positions pass through untouched, the
    masks and pyramid cells follow the JAX reference, no slot is tagged
    moving."""
    jcfg, tcfg = preset_configs("static", node=False, **SMALL)
    sensor = np.asarray([-3.3, 2.1, 0.4], np.float32)
    quat = np.asarray([np.cos(0.35), 0, 0, np.sin(0.35)], np.float32)
    origin = T.geometry.window_origin_np(sensor, tcfg)
    jp, tp = both(_static_pool(jcfg, 3, sensor))
    ref = jax_sweep(jp, jcfg, jnp.float32(0.3), jnp.asarray(origin),
                    jnp.asarray(sensor), jnp.asarray(quat))
    got = sweep.sweep(tp, tcfg, np.float32(0.3), origin, sensor, quat)
    for name in ("px", "py", "pz"):
        assert torch.equal(getattr(got, name), getattr(tp, name))
        np.testing.assert_array_equal(_n(getattr(got, name)),
                                      _n(getattr(ref, name)))
    for name in ("flags", "new_cell", "tags"):
        a, b = _n(getattr(ref, name)), _n(getattr(got, name))
        assert np.mean(a != b) < 1e-3, name
    assert got.fov.any() and got.moved_out.any() and not got.moving.any()


def test_estimator_pass_through_matches_jax():
    """``estimator_enabled=False``: the cloud passes through with zero
    velocity, nothing dynamic, and the estimator state is returned as it
    was."""
    jcfg, tcfg = preset_configs("static")
    assert not tcfg.estimator_enabled
    rng = np.random.default_rng(2)
    cloud = rng.normal(0, 2, (tcfg.max_input_points, 3)).astype(np.float32)
    valid = rng.random(tcfg.max_input_points) < 0.8
    jstate = J.init_state(jcfg, jax.random.key(0)).estimator
    want, want_state = jax_estimate(jnp.asarray(cloud), jnp.asarray(valid),
                                    jstate, jcfg, jnp.float32(0.1),
                                    jax.random.key(1))
    tstate_ = tstate.init_estimator_state(tcfg, device="cpu")
    got, got_state = estimate_velocities(
        torch.from_numpy(cloud), torch.from_numpy(valid), tstate_, tcfg, 0.1,
        None)
    assert got_state is tstate_
    for name in want._fields:
        np.testing.assert_array_equal(_n(getattr(got, name)),
                                      _n(getattr(want, name)), name)
    assert not _n(got.dynamic).any() and not _n(got.vel).any()
    for name in ("prev_centers", "prev_point_num", "prev_intensity",
                 "prev_valid"):
        np.testing.assert_array_equal(_n(getattr(got_state, name)),
                                      _n(getattr(want_state, name)), name)


def test_static_birth_table_matches_jax():
    """The static model's newborn table: positions jittered by the JAX
    draws, every velocity zero, whatever the class weights say; the static
    floor of the preset is 0.2 (4 of 20 newborns)."""
    jcfg, tcfg = preset_configs("static")
    assert tcfg.min_static_newborns == 4 == jcfg.min_static_newborns
    P, n_b = tcfg.max_input_points, tcfg.newborn_particles_per_point
    rng = np.random.default_rng(9)
    pts = rng.normal(0, 2, (P, 3)).astype(np.float32)
    cls = [rng.random(P).astype(np.float32) for _ in range(3)]
    key = jax.random.key(4)
    rt = J.init_state(jcfg, jax.random.key(0)).params
    want_pos, want_vel = jax_birth_table(
        jcfg, key, jnp.asarray(pts), jnp.zeros((P, 3)), jnp.zeros(P, bool),
        *map(jnp.asarray, cls), rt=rt)
    kp, kv, ku = jax.random.split(key, 3)
    draws = [torch.from_numpy(np.array(x)) for x in (
        jax.random.normal(kp, (P, n_b, 3), jnp.float32),
        jax.random.normal(kv, (P, n_b, 3), jnp.float32),
        jax.random.uniform(ku, (P, n_b, 3), jnp.float32, -1.0, 1.0))]
    got_pos, got_vel = birth.birth_table(
        tcfg, torch.from_numpy(pts), torch.zeros((P, 3)),
        torch.zeros(P, dtype=torch.bool), *map(torch.from_numpy, cls),
        tstate.RuntimeParams.from_config(tcfg), *draws)
    np.testing.assert_array_equal(_n(got_pos), _n(want_pos))
    np.testing.assert_array_equal(_n(got_vel), _n(want_vel))
    assert not _n(got_vel).any()


# ------------------------------------------------------- the static step


@pytest.fixture(scope="module")
def static_run():
    jcfg, tcfg = preset_configs("static")
    assert (tcfg.slots_per_voxel, tcfg.n_pyramids, tcfg.dense_slots,
            tcfg.pyramid_slots, tcfg.neighbor_cells) == (50, 504, 32, 240, 9)
    step = jax.jit(J.make_step(jcfg))
    frames, _ = record(jcfg, step, J.init_state(jcfg, jax.random.key(0)),
                       n_frames=N_FRAMES)
    return tcfg, frames


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_static_step_matches_jax(static_run, monkeypatch, pinned):
    tcfg, frames = static_run
    fracs = teacher_forced(frames, tcfg, monkeypatch, pinned)
    assert np.mean(fracs) >= 0.999, fracs
    last = frames[-1]["metrics"]
    assert int(last["born"]) > 0 and int(last["updated_particles"]) > 0
    assert int(last["movers"]) == 0 and int(last["future_moving"]) == 0
    # every velocity the static step leaves behind is exactly zero
    state = T.state_from_numpy(frames[-1]["before"], tcfg, device="cpu")
    new, _ = T.make_step(tcfg)(state, T.Frame(*frames[-1]["frame"]),
                               frames[-1]["draws"])
    for name in ("vx", "vy", "vz"):
        assert not getattr(new.particles, name).any(), name
