"""The port's noisy prediction path (``limit_motion_to_xy_plane=False``, a
dynamic model) in the pool layout against the JAX package's, on the CPU:
``example_node_settings(dsp_dynamic(limit_motion_to_xy_plane=False, ...))``
on a 24x24x12 map at 0.25 m.

* **Stages.**  ``propagate``, ``rebin``, ``register_fov`` and the
  ``future_movers=None`` arm of ``occupancy_and_resample`` on a pool the
  JAX step built over five frames, each JAX stage jitted as the step runs
  it.  Both sides take the same standard normals: JAX's
  ``jax.random.normal`` is patched to return the port's array, because a
  normal drawn inside a fused program differs in the last bits of a few
  elements from the same draw taken alone.  Given the same normals, the
  jittered velocities and the in-FOV jitter are bit-equal; the advanced
  positions are within 1 ulp: XLA's CPU fusion contracts ``p + v * dt``
  into a fused multiply-add (a few valid particles differ) where the port
  rounds the product first.  Rebin is exact in flags, payload and
  counters; the occupancy stage exact in flags and counters, weight_sum to
  rtol 1e-6 and the future grid to rtol 1e-4.
* **The step.**  Eight frames of the JAX step with its draws injected
  (``torch_parity.jax_draws``: the propagation noise from ``keys[1]``, the
  FOV noise from ``keys[2]``), teacher-forced with the bars of
  ``tests/test_torch_step.py`` (flags >= 99.9% with the newborn weight
  pinned, >= 99.5% free) and free-running (the port's own state through
  the eight frames: with the newborn weight pinned flags >= 99.9% and
  alive within 0.5% in every frame; free, alive within 5%, see the test).
* **Draws.**  ``make_draws`` on a deterministic configuration consumes the
  generator as it did before the noisy arm existed; on a noisy one it
  appends the two pool-shaped normals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
from dspmap_tpu import geometry as jg
from dspmap_tpu.ops.fov import register_fov as jax_register_fov
from dspmap_tpu.ops.occupancy import occupancy_and_resample as jax_occupancy
from dspmap_tpu.ops.propagate import propagate as jax_propagate
from dspmap_tpu.ops.rebin import rebin as jax_rebin
import dspmap_tpu_torch as T
from dspmap_tpu_torch.ops.fov import register_fov
from dspmap_tpu_torch.ops.insert import insert_sorted
from dspmap_tpu_torch.ops.occupancy import occupancy_and_resample
from dspmap_tpu_torch.ops.propagate import propagate
from dspmap_tpu_torch.ops.rebin import rebin
from torch_parity import (KW, PLANES, assert_bits_equal as _eq, check_frame,
                          given_normals, jparts, pin_newborn_weight, record,
                          tparts, ulps)

torch.set_num_threads(2)

N_FRAMES = 8
STAGED = 5  # the recorded frame whose input pool the stage tests take


def _kw():
    return dict(KW, limit_motion_to_xy_plane=False)


def _tcfg():
    return T.example_node_settings(T.dsp_dynamic(**_kw()))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX noisy step over eight frames (``torch_parity.record``)."""
    jcfg = J.example_node_settings(J.dsp_dynamic(**_kw()))
    assert not jcfg.limit_motion_to_xy_plane
    step = jax.jit(J.make_step(jcfg))
    frames, _ = record(jcfg, step, J.init_state(jcfg, jax.random.key(0)),
                       N_FRAMES)
    return dict(cfg=jcfg, frames=frames)


def _stage_inputs(jax_run):
    """The staged frame's pool (numpy), dt, origin, update time, pose and
    the normals the stages draw (``keys`` of a fixed seed)."""
    f = jax_run["frames"][STAGED]
    before = f["before"]
    pts, n, pos, quat, ts = f["frame"]
    dt = np.float32(ts - before.last_timestamp)
    S, V = jax_run["cfg"].slots_per_voxel, jax_run["cfg"].storage_voxels
    k_prop, k_fov = jax.random.split(jax.random.key(11))
    return dict(p=before.particles, dt=dt, pos=pos, quat=quat,
                origin=np.asarray(jg.window_origin(jnp.asarray(pos),
                                                   jax_run["cfg"])),
                t=np.float32(before.update_time + dt), k_prop=k_prop,
                k_fov=k_fov,
                prop_noise=np.array(jax.random.normal(k_prop, (3, S, V))),
                fov_noise=np.array(jax.random.normal(k_fov, (2, S, V))))


def test_propagate_is_bit_equal_to_jax(jax_run, monkeypatch):
    """Velocities jittered under the keep-still test bit for bit, positions
    advanced within 1 ulp; the run holds particles on both sides of the
    test."""
    jcfg, s = jax_run["cfg"], _stage_inputs(jax_run)
    given_normals(monkeypatch, s["prop_noise"])
    want = jax.device_get(jax.jit(lambda p, k, dt: jax_propagate(
        p, jcfg, k, dt))(jparts(s["p"]), s["k_prop"], jnp.float32(s["dt"])))
    got = propagate(tparts(s["p"]), _tcfg(), torch.from_numpy(s["prop_noise"]),
                    s["dt"])
    for k in ("flags", "vx", "vy", "vz", "weight", "t"):
        _eq(getattr(got, k), getattr(want, k), k)
    for k in ("px", "py", "pz"):  # XLA's multiply-add (module docstring)
        assert ulps(getattr(got, k), getattr(want, k)) <= 1, k
    p = s["p"]
    valid = np.asarray(p.flags) != 0
    jittered = valid & (np.abs(p.vx * p.vy * p.vz) >= 1e-6)
    assert jittered.sum() > 0 and (valid & ~jittered).sum() > 0
    assert not np.array_equal(got.vx.numpy()[jittered], p.vx[jittered])


def test_rebin_is_exact(jax_run, monkeypatch):
    """Flags, every payload plane and every counter exact, from the
    propagated pool."""
    jcfg, s = jax_run["cfg"], _stage_inputs(jax_run)
    given_normals(monkeypatch, s["prop_noise"])
    advanced = jax.jit(lambda p, k, dt: jax_propagate(p, jcfg, k, dt))(
        jparts(s["p"]), s["k_prop"], jnp.float32(s["dt"]))
    want_p, want = jax.device_get(jax.jit(lambda p, o, t: jax_rebin(
        p, jcfg, o, t))(advanced, jnp.asarray(s["origin"]),
                        jnp.float32(s["t"])))
    got_p, got = rebin(tparts(jax.device_get(advanced)), _tcfg(), s["origin"],
                       s["t"])
    for k in PLANES:
        _eq(getattr(got_p, k), getattr(want_p, k), k)
    assert set(got) == set(want)
    for k, v in want.items():
        assert int(got[k]) == int(v), k
    assert int(want["movers"]) > 0 and int(want["moved_out"]) >= 0


def test_register_fov_matches_jax(jax_run, monkeypatch):
    """The pyramid-full kill, every binning field and the in-FOV jitter
    (vx, vy jittered, vz set to 0 on jittered particles) bit-equal; the
    ranges to rtol 1e-6 (``sqrt`` of a sum of squares that XLA fuses, as
    in ``tests/test_torch_compact.py``)."""
    jcfg, s = jax_run["cfg"], _stage_inputs(jax_run)
    given_normals(monkeypatch, s["fov_noise"])
    want_p, want_bin, want = jax.device_get(jax.jit(
        lambda p, pos, q, k: jax_register_fov(p, jcfg, pos, q, k))(
            jparts(s["p"]), jnp.asarray(s["pos"]), jnp.asarray(s["quat"]),
            s["k_fov"]))
    got_p, got_bin, got = register_fov(tparts(s["p"]), _tcfg(), s["pos"],
                                       s["quat"],
                                       torch.from_numpy(s["fov_noise"]))
    for k in PLANES:
        _eq(getattr(got_p, k), getattr(want_p, k), k)
    for k in want_bin._fields:
        if k in ("rng", "sp_rng"):  # sqrt of a sum of squares XLA fuses
            np.testing.assert_allclose(getattr(got_bin, k).numpy(),
                                       getattr(want_bin, k), rtol=1e-6, atol=0)
        else:
            _eq(getattr(got_bin, k), getattr(want_bin, k), k)
    assert set(got) == set(want)
    for k, v in want.items():
        assert int(got[k]) == int(v), k
    moved = np.asarray(want_p.vz) != np.asarray(s["p"].vz)
    assert int(want["in_fov"]) > 0 and moved.sum() > 0
    assert not np.asarray(want_p.vz)[moved].any()


def test_occupancy_without_future_movers_matches_jax(jax_run):
    """``future_movers=None``: the pool pass's moving mask compacted to the
    mover budget.  Flags, payload and counters exact, weight_sum within
    rtol 1e-6, the future grid within rtol 1e-4."""
    jcfg, s = jax_run["cfg"], _stage_inputs(jax_run)
    before = jax_run["frames"][STAGED]["before"]
    want_p, want_ws, want_va, want_fut, want = jax.device_get(jax.jit(
        lambda p, o, fut: jax_occupancy(p, jcfg, o, fut, None))(
            jparts(s["p"]), jnp.asarray(s["origin"]),
            jnp.asarray(before.future)))
    got_p, got_ws, got_va, got_fut, got = occupancy_and_resample(
        tparts(s["p"]), _tcfg(), s["origin"], torch.from_numpy(before.future),
        None)
    for k in PLANES:
        _eq(getattr(got_p, k), getattr(want_p, k), k)
    assert set(got) == set(want)
    for k, v in want.items():
        assert int(got[k]) == int(v), k
    assert int(want["future_moving"]) > 0
    np.testing.assert_allclose(got_ws.numpy(), want_ws, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_va.numpy(), want_va, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_fut.numpy(), want_fut, rtol=1e-4, atol=1e-7)


def test_insert_sorted_returns_positions_and_keep_mask():
    """Destination-sorted candidates fill their voxel's first free slots in
    rank order; a full voxel drops the rest at the ``S*V`` sentinel."""
    cfg = _tcfg()
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    z = lambda: torch.zeros((S, V))  # noqa: E731
    flags = torch.zeros((S, V), dtype=torch.int32)
    flags[: S - 1, 5] = 1  # one free slot left in voxel 5
    flags[0, 7] = 1
    p = T.Particles(flags=flags, px=z(), py=z(), pz=z(), vx=z(), vy=z(),
                    vz=z(), weight=z(), t=z())
    cell = torch.tensor([5, 5, 7, 7, V], dtype=torch.int32)
    ranks = torch.tensor([0, 1, 0, 1, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False])
    payload = torch.arange(35, dtype=torch.float32).view(5, 7)
    new, flat, keep = insert_sorted(p, cfg, cell=cell, ranks=ranks,
                                    payload=payload, valid=valid, flag=1,
                                    t=None)
    assert keep.tolist() == [True, False, True, True, False]
    assert flat.tolist() == [(S - 1) * V + 5, S * V, V + 7, 2 * V + 7, S * V]
    assert int(new.flags.sum()) == int(flags.sum()) + 3
    assert float(new.weight[S - 1, 5]) == 6.0 and float(new.vz[2, 7]) == 26.0


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_noisy_teacher_forced_frames_match_jax(jax_run, monkeypatch, pinned):
    frames = jax_run["frames"]
    jax_weight = {}
    if pinned:
        pin_newborn_weight(monkeypatch, "particle_birth", jax_weight)
    step = T.make_step(_tcfg())
    fracs = []
    for i, f in enumerate(frames):
        assert len(f["draws"]) == 6
        jax_weight["value"] = f["metrics"]["newborn_weight"]
        state = T.state_from_numpy(f["before"], _tcfg(), device="cpu")
        new, out = step(state, T.Frame(*f["frame"]), f["draws"])
        fracs.append(check_frame(i, new, out, f, pinned))
    assert np.mean(fracs) >= 0.999, fracs
    last = frames[-1]["metrics"]
    assert int(last["movers"]) > 0 and int(last["future_moving"]) > 0


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_noisy_free_running_matches_jax(jax_run, monkeypatch, pinned):
    """The port carries its own state over the eight frames.  With the
    newborn weight pinned it stays on the JAX trajectory: flags >= 99.9%
    and alive within 0.5% in every frame.  Left free, the newborn
    weight's last bit flips resample decisions at frame 3, as on the
    deterministic flagship (``tests/test_torch_step.py``), and from there
    the two filters draw different copies: alive within 5% (more than the
    2% that the flagship's free run holds from frame 6 on)."""
    frames = jax_run["frames"]
    tcfg = _tcfg()
    jax_weight = {}
    if pinned:
        pin_newborn_weight(monkeypatch, "particle_birth", jax_weight)
    step = T.make_step(tcfg)
    state = T.state_from_numpy(frames[0]["before"], tcfg, device="cpu")
    for i, f in enumerate(frames):
        jax_weight["value"] = f["metrics"]["newborn_weight"]
        state, out = step(state, T.Frame(*f["frame"]), f["draws"])
        a_t, a_j = int(out.metrics["alive"]), int(f["metrics"]["alive"])
        assert abs(a_t - a_j) <= (0.005 if pinned else 0.05) * a_j, (i, a_t,
                                                                     a_j)
        if pinned:
            frac = np.mean(state.particles.flags.numpy()
                           == np.asarray(f["after"].particles.flags))
            assert frac >= 0.999, (i, frac)
    vz = state.particles.vz.numpy()[state.particles.flags.numpy() != 0]
    assert (vz != 0).any()  # the pool really moves in z


def test_make_draws_keeps_the_deterministic_stream():
    """A deterministic configuration draws exactly the four tensors it drew
    before the noisy arm (same generator, same order); a noisy one draws
    those four first and then the two pool-shaped normals."""
    det = T.example_node_settings(T.dsp_dynamic(**KW))
    gen = torch.Generator().manual_seed(3)
    got = T.make_draws(det, gen, "cpu")
    ref = torch.Generator().manual_seed(3)
    shape = (det.max_input_points, det.newborn_particles_per_point, 3)
    want = (torch.rand(det.max_clusters, generator=ref) * 0.9 + 0.1,
            torch.randn(shape, generator=ref),
            torch.randn(shape, generator=ref),
            torch.rand(shape, generator=ref) * 2.0 - 1.0)
    assert len(got) == 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    noisy = _tcfg()
    got = T.make_draws(noisy, torch.Generator().manual_seed(3), "cpu")
    assert len(got) == 6
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    S, V = noisy.slots_per_voxel, noisy.storage_voxels
    assert got[4].shape == (3, S, V) and got[5].shape == (2, S, V)
