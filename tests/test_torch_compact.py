"""The port's compact layout (``cfg.layout == "compact"``) against the JAX
package's, on the CPU.

* **Segmented scans.**  ``seg_cumsum_plain`` / ``fill_from_end_plain`` /
  ``seg_scans`` bit-equal (``assert_array_equal``) to JAX's
  ``_seg_cumsum`` / ``_fill_from_end`` on every row, and to
  ``seg_scans_pallas`` run in interpret mode -- ``hi`` on every row,
  ``tot`` on live rows, the rows that kernel's own test compares.
* **Stages.**  One frame of ``example_node_settings(dsp_dynamic(layout=
  "compact", ...))`` on a 24x24x12 map at 0.25 m, run stage by stage in
  JAX after five frames of the JAX step; each port stage starts from the
  JAX inputs of that stage.  Flags, cells, ranks, counts, row order and
  every counter exact; floats equal where the operations are the same
  and to rtol 1e-6 where the two frameworks order a sum differently
  (stated at each test); the measurement update to rtol 2e-4, the bar of
  ``tests/test_torch_stages.py``.
* **The step.**  Teacher-forced and free-running for 12 frames against
  the JAX compact step with the JAX draws injected, with the bars of
  ``tests/test_torch_step.py`` (its docstring gives their reasons):
  teacher-forced flags >= 99.9% with the newborn weight pinned (>= 99.5%
  free), weight_sum and future within rtol 1e-4 on >= 99.9%, counters
  within max(2, 0.5%) (10% for the resample counters when free);
  free-running alive within 5% before frame 6 and 2% after, mass within
  3%, occupied-voxel IoU >= 0.9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu.ops.pallas.segscan as sg
import dspmap_tpu_torch as T
from dspmap_tpu import geometry as jg
from dspmap_tpu.estimator import estimate_velocities as jax_estimate
from dspmap_tpu.ops import compact as jc
from dspmap_tpu.ops.birth import particle_birth_compact as jax_birth
from dspmap_tpu.ops.project import project_points as jax_project
from dspmap_tpu.ops.update import measurement_update as jax_update
from dspmap_tpu_torch.estimator import EstimatorOutput
from dspmap_tpu_torch.ops import compact as tc
from dspmap_tpu_torch.ops.birth import particle_birth_compact
from dspmap_tpu_torch.ops.fov import FovBinning
from dspmap_tpu_torch.ops.project import Observation
from dspmap_tpu_torch.ops.update import measurement_update
from dspmap_tpu_torch.utils import sim
from torch_parity import (KW, N_FRAMES, check_frame, check_setters,
                          pin_newborn_weight, record)

torch.set_num_threads(2)

PLANES = ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")
STAGED_FRAME = 5  # the JAX step's frames before the staged one


def _t(x):
    """numpy/JAX array -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def _parts(p):
    return T.Particles(**{k: _t(getattr(p, k)) for k in PLANES})


def _tcfg():
    return T.example_node_settings(T.dsp_dynamic(layout="compact", **KW))


def _eq(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


# ------------------------------------------------------- segmented scans


def _scan_inputs(P, max_run, seed):
    """Sorted runs of 1..max_run rows, five rows of one run repeated
    further on (mid-frame disorder), a dead tail of one long run, nonzero
    values everywhere and a few -0.0 values."""
    rng = np.random.default_rng(seed)
    key = np.repeat(np.arange(P), rng.integers(1, max_run + 1, P))[:P]
    key[P // 3:P // 3 + 5] = key[7]
    key[-P // 10:] = 10**6
    is_start = np.concatenate([[True], key[1:] != key[:-1]])
    is_end = np.concatenate([key[1:] != key[:-1], [True]]) & (key < 10**6)
    cols = rng.uniform(0, 1, (3, P)).astype(np.float32)
    cols[:, ::97] = -0.0
    return key < 10**6, is_start, is_end, cols


SCAN_CASES = [(1000, 10, 0), (1000, 20, 2), (1024, 16, 2), (1024, 32, 0),
              (1024, 32, 2)]


@pytest.mark.parametrize("P,max_run,n_tot", SCAN_CASES,
                         ids=[f"P{p}-run{r}-tot{n}" for p, r, n in SCAN_CASES])
def test_seg_scans_bit_equal_to_jax(P, max_run, n_tot):
    """Reach 16 and 32, ``n_tot`` 0 and 2, P = 1000 (not a multiple of 128)
    and 1024; bit-equal, see the module docstring."""
    live, is_start, is_end, cols = _scan_inputs(P, max_run, seed=P + max_run)
    X = np.stack(cols, -1)
    hi_x = np.asarray(jc._seg_cumsum(jnp.asarray(X), jnp.asarray(is_start),
                                     max_run))
    tot_x = np.asarray(jc._fill_from_end(jnp.asarray(hi_x[:, :2]),
                                         jnp.asarray(is_end), max_run))
    st, en = torch.from_numpy(is_start), torch.from_numpy(is_end)
    _eq(tc.seg_cumsum_plain(torch.from_numpy(X), st, max_run), hi_x)
    _eq(tc.fill_from_end_plain(_t(hi_x[:, :2]), en, max_run),
        tot_x)
    _eq(tc.seg_cumsum_plain(torch.from_numpy(X[:, 0]), st, max_run),
        hi_x[:, 0])
    his, tots = tc.seg_scans([torch.from_numpy(c) for c in cols], st, en,
                             max_run, n_tot)
    assert len(his) == 3 and len(tots) == n_tot
    for c in range(3):
        _eq(his[c], hi_x[:, c], f"hi{c}")
    for c in range(n_tot):
        _eq(tots[c], tot_x[:, c], f"tot{c}")
    if P % 128:
        return  # the Pallas kernel tiles P by 128
    old = sg.INTERPRET
    sg.INTERPRET = True
    try:
        his_p, tots_p = sg.seg_scans_pallas(
            [jnp.asarray(c) for c in cols], jnp.asarray(is_start),
            jnp.asarray(is_end), max_run, n_tot)
    finally:
        sg.INTERPRET = old
    for c in range(3):
        _eq(his[c], his_p[c], f"pallas hi{c}")
    for c in range(n_tot):
        _eq(tots[c][live], np.asarray(tots_p[c])[live], f"pallas tot{c}")


def test_reach_and_scatter_add_cols_match_jax():
    """``_reach`` equal for 1..200; ``_scatter_add_cols`` bit-equal
    (duplicates add in row order on both)."""
    for r in range(1, 200):
        assert tc._reach(r) == jc._reach(r)
    rng = np.random.default_rng(5)
    cell = rng.integers(0, 50, 600).astype(np.int32)
    valid = rng.random(600) < 0.8
    cols = [rng.normal(size=600).astype(np.float32), valid]
    want = jc._scatter_add_cols(jnp.asarray(cell), jnp.asarray(valid),
                                [jnp.asarray(c) for c in cols], 50)
    got = tc._scatter_add_cols(_t(cell), _t(valid), [_t(c) for c in cols], 50)
    for g, w in zip(got, want):
        _eq(g, w)


# ---------------------------------------------------------------- stages


def _staged(cfg, state, frame):
    """``_make_step_compact``'s body on one accepted frame, keeping every
    stage's inputs and outputs."""
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
    est_out, _ = jax_estimate(obs.cloud_world, obs.cloud_valid,
                              state.estimator, cfg, dt, keys[0])
    p0 = dataclasses.replace(state.particles,
                             vz=jnp.zeros_like(state.particles.vz))
    p_sw, sw = jc.sweep_compact(p0, cfg, dt, origin, pos, quat, keys[1],
                                rt=rt)
    p_rb, stay, rebin_stats = jc.rebin_compact(p_sw, sw, cfg)
    p_fov, fovbin, fov_stats = jc.register_fov_compact(
        p_rb, cfg, sw.pyr, sw.fov, pos, key=keys[2], rt=rt)
    p_upd, norm, upd_stats = jax_update(p_fov, fovbin, obs, cfg, expected,
                                        update_time, rt=rt)
    p_born, birth_stats = jax_birth(
        p_upd, cfg, keys[3], est_points=est_out.points, est_vel=est_out.vel,
        est_dynamic=est_out.dynamic, est_valid=est_out.valid,
        norm_coeff=norm, origin=origin, update_time=update_time, rt=rt)
    occ = jc.occupancy_compact(p_born, cfg, origin, state.future)
    return dict(dt=dt, origin=origin, update_time=update_time, keys=keys,
                obs=obs, expected=expected, est_out=est_out, p0=p0,
                p_sw=p_sw, sw=sw, p_rb=p_rb, stay=stay,
                rebin_stats=rebin_stats, p_fov=p_fov, fovbin=fovbin,
                fov_stats=fov_stats, p_upd=p_upd, norm=norm,
                upd_stats=upd_stats, p_born=p_born, birth_stats=birth_stats,
                occ=occ)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX compact step over 12 frames (``torch_parity.record``), its
    occupancy at 0.2, the jitted step, and frame 5 run stage by stage."""
    jcfg = J.example_node_settings(J.dsp_dynamic(layout="compact", **KW))
    assert jcfg.layout == "compact"
    step = jax.jit(J.make_step(jcfg))
    frames, state = record(jcfg, step, J.init_state(jcfg, jax.random.key(0)))
    occ = J.get_occupancy_map(state, jcfg, 0.2)[0]
    f = frames[STAGED_FRAME]
    staged = jax.jit(lambda s, fr: _staged(jcfg, s, fr))(
        frames[STAGED_FRAME - 1]["live"], tuple(map(jnp.asarray, f["frame"])))
    return dict(cfg=jcfg, frames=frames, occ=np.asarray(occ), step=step,
                staged=jax.device_get(staged), before=f["before"])


def test_sweep_compact_matches_jax(jax_run):
    """Advanced positions, flags and every per-row outcome exact."""
    out = jax_run["staged"]
    got_p, got = tc.sweep_compact(_parts(out["p0"]), _tcfg(), out["dt"],
                                  np.asarray(out["origin"]),
                                  jax_run["frames"][STAGED_FRAME]["frame"][2],
                                  jax_run["frames"][STAGED_FRAME]["frame"][3])
    for k in ("flags", "px", "py", "pz"):
        _eq(getattr(got_p, k), getattr(out["p_sw"], k), k)
    want = out["sw"]
    assert int(np.asarray(want.mover).sum()) > 0
    assert int(np.asarray(want.fov).sum()) > 0
    for k in ("cell", "mover", "fov", "moving", "moved_out"):
        _eq(getattr(got, k), getattr(want, k), k)
    fov = np.asarray(want.fov)
    _eq(got.pyr.numpy()[fov], np.asarray(want.pyr)[fov], "pyr")


def test_rebin_compact_matches_jax(jax_run):
    """Flags, the stayer counts and every counter exact."""
    out = jax_run["staged"]
    sw = tc.CompactSweep(**{k: _t(getattr(out["sw"], k))
                            for k in tc.CompactSweep._fields})
    got_p, stay, stats = tc.rebin_compact(_parts(out["p_sw"]), sw, _tcfg())
    _eq(got_p.flags, out["p_rb"].flags)
    _eq(stay, out["stay"])
    for k, v in out["rebin_stats"].items():
        assert int(stats[k]) == int(v), k


def test_register_fov_compact_and_update_match_jax(jax_run):
    """Kill flags, the binning (compact rows, sentinel P) and the counters
    exact, the ranges to rtol 1e-6 (``sqrt`` of a sum of squares that XLA
    fuses: 25 of 28672 entries differ in the last bit); the measurement
    update over the compact binning (its drop
    sentinel is ``flags.numel() == P``) to rtol 2e-4."""
    out = jax_run["staged"]
    tcfg = _tcfg()
    P = tcfg.compact_capacity
    got_p, fovbin, stats = tc.register_fov_compact(
        _parts(out["p_rb"]), tcfg, _t(out["sw"].pyr), _t(out["sw"].fov),
        jax_run["frames"][STAGED_FRAME]["frame"][2])
    want = out["fovbin"]
    _eq(got_p.flags, out["p_fov"].flags)
    for k in FovBinning._fields:
        if k in ("rng", "sp_rng"):
            np.testing.assert_allclose(getattr(fovbin, k).numpy(),
                                       getattr(want, k), rtol=1e-6, atol=0)
        else:
            _eq(getattr(fovbin, k), getattr(want, k), k)
    assert int(fovbin.mask.sum()) > 0
    assert int(fovbin.slot[~fovbin.mask].min()) == P == got_p.flags.numel()
    for k, v in out["fov_stats"].items():
        assert int(stats[k]) == int(v), k
    upd, norm, ustats = measurement_update(
        got_p, fovbin, Observation(
            **{k: _t(getattr(out["obs"], k)) for k in Observation._fields}),
        tcfg, _t(out["expected"]), float(out["update_time"]),
        T.state_from_numpy(jax_run["before"], tcfg, device="cpu").params)
    changed = np.asarray(out["p_upd"].weight) != np.asarray(out["p_fov"].weight)
    assert changed.sum() > 20
    np.testing.assert_allclose(upd.weight.numpy(), out["p_upd"].weight,
                               rtol=2e-4, atol=1e-12)
    np.testing.assert_allclose(float(norm), float(out["norm"]), rtol=1e-5)
    for k, v in out["upd_stats"].items():
        assert int(ustats[k]) == int(v), k


def _draws(keys, cfg):
    kp, kv, ku = jax.random.split(keys[3], 3)
    shape = (cfg.max_input_points, cfg.newborn_particles_per_point, 3)
    return tuple(_t(x) for x in (
        jax.random.normal(kp, shape, jnp.float32),
        jax.random.normal(kv, shape, jnp.float32),
        jax.random.uniform(ku, shape, jnp.float32, -1.0, 1.0)))


def test_particle_birth_compact_matches_jax(jax_run):
    """DS tables, quotas, jitter and the free-row insert with the JAX
    draws: flags (and so the rows the newborns landed in) and the counters
    exact, the other planes to 1e-6 relative or absolute, the bar of
    ``tests/test_torch_stages.py`` (XLA fuses the jitter into
    multiply-adds: 2 of 65536 positions and velocities differ in the last
    bit)."""
    out = jax_run["staged"]
    tcfg = _tcfg()
    est = EstimatorOutput(**{k: _t(getattr(out["est_out"], k))
                             for k in EstimatorOutput._fields})
    got, stats = particle_birth_compact(
        _parts(out["p_upd"]), tcfg, _draws(out["keys"], jax_run["cfg"]),
        est_points=est.points, est_vel=est.vel, est_dynamic=est.dynamic,
        est_valid=est.valid, norm_coeff=_t(out["norm"]),
        origin=np.asarray(out["origin"]),
        update_time=float(out["update_time"]),
        rt=T.state_from_numpy(jax_run["before"], tcfg, device="cpu").params)
    assert int(out["birth_stats"]["born"]) > 100
    _eq(got.flags, out["p_born"].flags)
    for k in PLANES[1:]:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   getattr(out["p_born"], k), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k, v in out["birth_stats"].items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=0,
                                   err_msg=k)


def test_segment_table_matches_jax(jax_run):
    """Per-cell sums over the post-birth array (cell-sorted rows, then the
    newborn tail: fragmented runs) bit-equal, for S- and 2S-row reach."""
    p = jax_run["staged"]["p_born"]
    cfg = jax_run["cfg"]
    cell = jg.storage_index_planar(
        *jg.world_voxel_planar(p.px, p.py, p.pz, cfg), cfg)
    alive = p.flags != 0
    cols = (p.weight, p.vx, alive)
    for max_run in (cfg.slots_per_voxel, 2 * cfg.slots_per_voxel):
        want = jax.jit(lambda c, v, *xs: jc.segment_table(
            c, v, xs, cfg.storage_voxels, max_run=max_run))(cell, alive, *cols)
        got = tc.segment_table(_t(cell), _t(alive), [_t(c) for c in cols],
                               cfg.storage_voxels, max_run=max_run)
        for g, w in zip(got, want):
            _eq(g, w)
    assert int(np.asarray(want[2]).sum()) == int(np.asarray(alive).sum())


def test_insert_compact_matches_jax(jax_run):
    """Candidates on occupied voxels (capacity drops), fresh voxels,
    outside the window and invalid: every plane equal row by row and
    ``(n_born, n_dropped)`` exact."""
    out = jax_run["staged"]
    cfg = jax_run["cfg"]
    p = out["p_upd"]
    rng = np.random.default_rng(9)
    alive = np.flatnonzero(np.asarray(p.flags) != 0)
    src = rng.choice(alive, 3000)
    pos = np.stack([np.asarray(getattr(p, k))[src] for k in ("px", "py",
                                                             "pz")], -1)
    pos[1500:] += rng.normal(0, 1.5, (1500, 3)).astype(np.float32)
    vel = rng.normal(0, 1, (3000, 3)).astype(np.float32)
    weight = rng.uniform(0.001, 0.1, 3000).astype(np.float32)
    valid = rng.random(3000) < 0.9
    cell = jg.storage_index_planar(
        *jg.world_voxel_planar(p.px, p.py, p.pz, cfg), cfg)
    (count_v,) = jc._scatter_add_cols(cell, p.flags != 0, (p.flags != 0,),
                                      cfg.storage_voxels)
    args = dict(pos=pos, vel=vel, weight=weight, valid=valid,
                origin=np.asarray(out["origin"]))
    want, w_born, w_drop = jax.jit(lambda pp, cv, **kw: jc.insert_compact(
        pp, cfg, flag=3, t=None, count_v=cv, **kw))(
            p, count_v, **{k: jnp.asarray(v) for k, v in args.items()})
    got, born, drop = tc.insert_compact(
        _parts(p), _tcfg(), flag=3, t=None, count_v=_t(count_v),
        **{k: v if k == "origin" else _t(v) for k, v in args.items()})
    assert int(w_born) > 100 and int(w_drop) >= 0
    for k in PLANES:
        _eq(getattr(got, k), getattr(want, k), k)
    assert (int(born), int(drop)) == (int(w_born), int(w_drop))


def test_occupancy_compact_matches_jax(jax_run):
    """The sort, aggregates, resample and copy placement: the output rows
    (the cell-sorted view) equal plane by plane, weight_sum and vel_avg
    equal (the same run-local sums), the future grid to rtol 1e-6 (the
    mover scatter-add), every counter exact."""
    out = jax_run["staged"]
    got = tc.occupancy_compact(_parts(out["p_born"]), _tcfg(),
                               np.asarray(out["origin"]),
                               _t(jax_run["before"].future))
    want = out["occ"]
    for k in ("culled", "resample_dropped", "resample_copies",
              "future_moving"):
        assert int(want[4][k]) > 0, k
    for k in PLANES:
        _eq(getattr(got[0], k), getattr(want[0], k), k)
    _eq(got[1], want[1], "weight_sum")
    _eq(got[2], want[2], "vel_avg")
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-6, atol=0)
    assert set(got[4]) == set(want[4])
    for k, v in want[4].items():
        assert int(got[4][k]) == int(v), k


# ------------------------------------------------------------------ step


def test_init_state_and_carriers(jax_run):
    """Fresh compact state: 1-D ``[P]`` planes, grids ``[V]``, ``[V, 3]``,
    ``[T, V]``, equal to the JAX state's; a JAX state round-trips through
    ``state_from_numpy`` / ``state_to_numpy`` bit for bit."""
    tcfg = _tcfg()
    fresh = T.init_state(tcfg, seed=0, device="cpu")
    want = jax.device_get(J.init_state(jax_run["cfg"], jax.random.key(0)))
    for k in PLANES:
        _eq(getattr(fresh.particles, k), getattr(want.particles, k), k)
        assert getattr(fresh.particles, k).shape == (tcfg.compact_capacity,)
    for k in ("weight_sum", "vel_avg", "future", "origin"):
        _eq(getattr(fresh, k), getattr(want, k), k)
    after = jax_run["frames"][5]["after"]
    got = T.state_to_numpy(T.state_from_numpy(after, tcfg, device="cpu"))
    for k in PLANES:
        _eq(got["particles"][k], getattr(after.particles, k), k)
    for k in ("weight_sum", "vel_avg", "future"):
        _eq(got[k], getattr(after, k), k)


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_compact_teacher_forced_frames_match_jax(jax_run, monkeypatch,
                                                 pinned):
    frames = jax_run["frames"]
    tcfg = _tcfg()
    jax_weight = {}
    if pinned:
        pin_newborn_weight(monkeypatch, "particle_birth_compact", jax_weight)
    step = T.make_step(tcfg)
    fracs = []
    for i, f in enumerate(frames[:6]):
        jax_weight["value"] = f["metrics"]["newborn_weight"]
        new, out = step(T.state_from_numpy(f["before"], tcfg, device="cpu"),
                        T.Frame(*f["frame"]), f["draws"])
        fracs.append(check_frame(i, new, out, f, pinned))
    assert np.mean(fracs) >= 0.999, fracs
    last = frames[5]["metrics"]
    for k in ("born", "updated_particles", "movers", "resample_copies"):
        assert int(last[k]) > 0, k


def test_compact_free_running_matches_jax(jax_run):
    frames = jax_run["frames"]
    tcfg = _tcfg()
    step = T.make_step(tcfg)
    state = T.state_from_numpy(frames[0]["before"], tcfg, device="cpu")
    for i, f in enumerate(frames):
        state, out = step(state, T.Frame(*f["frame"]), f["draws"])
        a_t, a_j = int(out.metrics["alive"]), int(f["metrics"]["alive"])
        bar = 0.02 if i >= 6 else 0.05
        assert abs(a_t - a_j) <= bar * a_j, (i, a_t, a_j)
    assert len(frames) == N_FRAMES
    mass = float(state.weight_sum.sum())
    jax_mass = float(np.asarray(frames[-1]["after"].weight_sum).sum())
    assert abs(mass - jax_mass) <= 0.03 * jax_mass, (mass, jax_mass)
    occ = T.get_occupancy_map(state, tcfg, 0.2)[0].numpy()
    jax_occ = jax_run["occ"]
    iou = (occ & jax_occ).sum() / max((occ | jax_occ).sum(), 1)
    assert jax_occ.sum() > 20 and iou >= 0.9, (iou, occ.sum(), jax_occ.sum())


def test_compact_readouts_match_jax(jax_run):
    """``read_occupancy`` / ``get_occupancy_map`` / ``clear_future_prediction``
    on a compact state: occupied mask, centers, future and weights equal to
    the JAX readout of the same state; the returned state's future is 0."""
    jcfg, tcfg = jax_run["cfg"], _tcfg()
    after = jax_run["frames"][-1]["after"]
    want = J.read_occupancy(jax.device_put(after), jcfg, 0.2)
    state = T.state_from_numpy(after, tcfg, device="cpu")
    got = T.read_occupancy(state, tcfg, 0.2)
    for g, w, name in zip(got[:4], want[:4], ("occupied", "centers",
                                              "future", "weight")):
        _eq(g, w, name)
    assert int(got[0].sum()) > 20
    occ, centers, future, cleared = T.get_occupancy_map(state, tcfg, 0.2)
    _eq(occ, want[0])
    assert float(cleared.future.abs().sum()) == 0.0
    assert float(state.future.abs().sum()) > 0.0  # the input is untouched
    assert float(T.clear_future_prediction(state).future.abs().sum()) == 0.0


def test_compact_live_setters_match_jax(jax_run, monkeypatch):
    """``set_observation_stddev`` and ``set_detection_probability`` between
    frames on both packages: the next frame within the pinned
    teacher-forced bars."""
    check_setters(jax_run["step"], _tcfg(), jax_run["frames"], monkeypatch,
                  "particle_birth_compact")


def test_compact_rejected_frame_and_noisy_arm():
    """A rejected frame returns the state unchanged with every compact
    metric (``pool_overflow`` included) zero; the noisy-prediction arm
    runs a frame (``tests/test_torch_noisy_compact.py`` holds it against
    JAX), and its sweep refuses to run without its normal draw."""
    tcfg = _tcfg()
    state = T.init_state(tcfg, seed=0, device="cpu")
    step = T.make_step(tcfg)
    new, out = step(state, T.Frame(np.zeros((1024, 3), np.float32), 0,
                                   np.zeros(3, np.float32),
                                   np.asarray([2, 0, 0, 0], np.float32),
                                   np.float32(0)))
    assert not out.accepted and new is state
    assert "pool_overflow" in out.metrics
    assert all(int(v) == 0 for v in out.metrics.values())
    noisy = T.example_node_settings(T.dsp_dynamic(
        layout="compact", limit_motion_to_xy_plane=False, **KW))
    pts, n, pos, quat, t = next(iter(sim.generate_sequence(1, noisy, seed=7)))
    new, out = T.make_step(noisy)(T.init_state(noisy, seed=0, device="cpu"),
                                  T.Frame(pts, n, pos, quat, t))
    assert out.accepted and int(out.metrics["alive"]) > 0
    assert set(out.metrics) == set(T.models.pipeline.COMPACT_METRIC_NAMES)
    with pytest.raises(ValueError):
        tc.sweep_compact(state.particles, noisy, 0.1, np.zeros(3, np.int32),
                         np.zeros(3, np.float32),
                         np.asarray([1, 0, 0, 0], np.float32))
