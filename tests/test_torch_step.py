"""The port's step against the JAX package's step under
``example_node_settings(dsp_dynamic(...))`` on a 24x24x12 map at 0.25 m,
with the JAX random draws injected (CPU).

Draws: ``keys = split(state.rng, 6)``; the estimator's uniform comes from
``split(keys[0])[1]``, the birth table's normal/normal/uniform from
``split(keys[3], 3)`` -- rebuilt here from the JAX key tree and handed to
the port's step.

Bars (chosen from the data; see each test):

* teacher-forced (each frame starts from the JAX state): ``accepted``
  equal; ``weight_sum`` and ``future`` within rtol 1e-4 / atol 1e-7 on
  >= 99.9% of entries; every JAX metric present under the same name;
  every counter within max(2, 0.5%); flags equal on >= 99.9% of slots in
  every frame -- with the newborn weight pinned to the JAX value's bits.
  Left free, the newborn weight ``w_b * sum 1/C(z)`` comes out of f32
  reductions taken in another order and differs from the JAX value in its
  last bit; voxels filled with equal-weight newborns sit exactly on the
  resample's ``ceil(x/wa - 1/2)`` grid, so that bit decides which copies
  are kept.  The free case therefore holds flags >= 99.5% in every frame
  (>= 99.9% over the six) and the resample's own counters (alive,
  dropped, copies) within max(2, 10%); every other bar is unchanged.
* free-running (the port carries its own state for 12 frames): alive
  within 2% from frame 6 on (within 5% before, for the newborn-weight bit
  above: 385 against 369 at frame 3), total occupancy weight within 3%,
  and the occupied-voxel IoU at threshold 0.2 >= 0.9.  Once one resample
  decision differs, the two filters draw different copies and drift apart
  voxel by voxel: 7 of 114 occupied voxels differ after 12 frames (IoU
  0.939), some by a factor of four in weight, so the IoU bar is 0.9.
"""

import jax
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from torch_parity import (KW, check_frame, check_setters, pin_newborn_weight,
                          record)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX reference run (see ``torch_parity.record``), its config, the
    final occupancy at 0.2 and the jitted step."""
    jcfg = J.example_node_settings(J.dsp_dynamic(**KW))
    step = jax.jit(J.make_step(jcfg))
    frames, state = record(jcfg, step, J.init_state(jcfg, jax.random.key(0)))
    occ = J.get_occupancy_map(state, jcfg, 0.2)[0]
    return jcfg, frames, np.asarray(occ), step


def _tcfg():
    return T.example_node_settings(T.dsp_dynamic(**KW))


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_teacher_forced_frames_match_jax(jax_run, monkeypatch, pinned):
    _, frames, _, _ = jax_run
    tcfg = _tcfg()
    jax_weight = {}
    if pinned:
        pin_newborn_weight(monkeypatch, "particle_birth", jax_weight)
    step = T.make_step(tcfg)
    flag_fracs = []
    for i, f in enumerate(frames[:6]):
        jax_weight["value"] = f["metrics"]["newborn_weight"]
        state = T.state_from_numpy(f["before"], tcfg, device="cpu")
        new, out = step(state, T.Frame(*f["frame"]), f["draws"])
        flag_fracs.append(check_frame(i, new, out, f, pinned))
    assert np.mean(flag_fracs) >= 0.999, flag_fracs
    # the run exercised births, the measurement update and movers
    last = frames[5]["metrics"]
    assert int(last["born"]) > 0 and int(last["updated_particles"]) > 0
    assert int(last["movers"]) > 0


def test_free_running_matches_jax(jax_run):
    _, frames, jax_occ, _ = jax_run
    tcfg = _tcfg()
    step = T.make_step(tcfg)
    state = T.state_from_numpy(frames[0]["before"], tcfg, device="cpu")
    for i, f in enumerate(frames):
        state, out = step(state, T.Frame(*f["frame"]), f["draws"])
        a_t, a_j = int(out.metrics["alive"]), int(f["metrics"]["alive"])
        # 5% in the early frames, where one newborn-weight bit decides the
        # resample of voxels full of equal-weight newborns (module doc)
        bar = 0.02 if i >= 6 else 0.05
        assert abs(a_t - a_j) <= bar * a_j, (i, a_t, a_j)
    mass = float(state.weight_sum.sum())
    jax_mass = float(np.asarray(frames[-1]["after"].weight_sum).sum())
    assert abs(mass - jax_mass) <= 0.03 * jax_mass, (mass, jax_mass)
    occ, centers, future, state = T.get_occupancy_map(state, tcfg, 0.2)
    occ = occ.numpy()
    iou = (occ & jax_occ).sum() / max((occ | jax_occ).sum(), 1)
    assert jax_occ.sum() > 20 and iou >= 0.9, (iou, occ.sum(), jax_occ.sum())
    assert float(state.future.abs().sum()) == 0.0  # the readout clears it
    assert torch.isfinite(centers).all() and future.shape == (tcfg.voxel_num,
                                                               tcfg.n_horizons)


def test_state_carriers_round_trip(jax_run):
    """``state_from_numpy`` then ``state_to_numpy`` returns the JAX state's
    arrays bit for bit, under the JAX ``MapState``'s field names."""
    _, frames, _, _ = jax_run
    want = frames[5]["after"]
    got = T.state_to_numpy(T.state_from_numpy(want, _tcfg(), device="cpu"))
    for name in ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t"):
        np.testing.assert_array_equal(got["particles"][name],
                                      np.asarray(getattr(want.particles, name)))
    for name in ("weight_sum", "vel_avg", "future", "sensor_pos",
                 "last_sensor_pos", "origin", "update_time", "last_timestamp",
                 "update_counter", "initialized"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name, v in got["estimator"].items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want.estimator, name)))
    for name, v in got["params"].items():
        assert np.float32(v) == np.asarray(getattr(want.params, name)), name


def test_rejected_frame_leaves_state(jax_run):
    """Admission control: a >10 m jump and a bad quaternion are rejected on
    the host and return the input state unchanged."""
    _, frames, _, _ = jax_run
    tcfg = _tcfg()
    step = T.make_step(tcfg)
    state = T.state_from_numpy(frames[3]["after"], tcfg, device="cpu")
    pts, n, pos, quat, t = frames[4]["frame"]
    for bad in (T.Frame(pts, n, pos + np.float32(11.0), quat, t),
                T.Frame(pts, n, pos, quat * np.float32(2.0), t),
                T.Frame(pts, n, pos, quat, np.float32(t - 1.0))):
        new, out = step(state, bad)
        assert not out.accepted and new is state
        assert int(out.metrics["alive"]) == 0


def test_live_setters_match_jax(jax_run, monkeypatch):
    """``set_observation_stddev`` and ``set_detection_probability`` between
    frames on both packages: the next frame within the pinned
    teacher-forced bars (``torch_parity.check_setters``)."""
    _, frames, _, jstep = jax_run
    check_setters(jstep, _tcfg(), frames, monkeypatch, "particle_birth")
