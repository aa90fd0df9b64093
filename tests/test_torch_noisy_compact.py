"""The port's noisy prediction path in the compact layout against the JAX
package's, on the CPU: ``example_node_settings(dsp_dynamic(layout=
"compact", limit_motion_to_xy_plane=False, ...))`` on a 24x24x12 map at
0.25 m.

* **Stages.**  ``sweep_compact`` (velocity noise ``[3, P]`` under the
  keep-still test, then the advance and the geometry),
  ``fov_geometry_compact`` and ``register_fov_compact`` (the in-FOV jitter
  ``[2, P]``) on the compact set the JAX step built over five frames, each
  JAX stage jitted, both sides given the same normals (JAX's
  ``jax.random.normal`` patched, as in ``tests/test_torch_noisy.py``, whose
  docstring gives the reason).  Jittered velocities, flags, cells and
  masks exact; positions within 1 ulp (XLA's fused multiply-add, see that
  file); pyramid cells exact on in-FOV rows; the FOV ranges to rtol 1e-6.
* **The step.**  Eight frames of the JAX compact step with its draws
  injected (``[P]``-shaped noise from ``keys[1]`` and ``keys[2]``):
  teacher-forced flags >= 99.9% with the newborn weight pinned and
  >= 99.5% free (the compact flag bar of ``tests/test_torch_compact.py``),
  the other bars of ``torch_parity.check_frame``; free-running with the
  newborn weight pinned flags >= 99.9% and alive within 0.5% in every
  frame, free alive within 2% and flags >= 99.5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
from dspmap_tpu import geometry as jg
from dspmap_tpu.ops import compact as jc
import dspmap_tpu_torch as T
from dspmap_tpu_torch.ops import compact as tc
from torch_parity import (KW, PLANES, assert_bits_equal as _eq, check_frame,
                          given_normals, jparts, pin_newborn_weight, record,
                          tparts, ulps)

torch.set_num_threads(2)

N_FRAMES = 8
STAGED = 5


def _kw():
    return dict(KW, layout="compact", limit_motion_to_xy_plane=False)


def _tcfg():
    return T.example_node_settings(T.dsp_dynamic(**_kw()))


@pytest.fixture(scope="module")
def jax_run():
    jcfg = J.example_node_settings(J.dsp_dynamic(**_kw()))
    assert jcfg.layout == "compact" and not jcfg.limit_motion_to_xy_plane
    step = jax.jit(J.make_step(jcfg))
    frames, _ = record(jcfg, step, J.init_state(jcfg, jax.random.key(0)),
                       N_FRAMES)
    return dict(cfg=jcfg, frames=frames)


def _inputs(jax_run, monkeypatch):
    """The staged frame's compact set, pose, time step and origin, with
    ``jax.random.normal`` patched to hand JAX the port's normals."""
    f = jax_run["frames"][STAGED]
    before = f["before"]
    _, _, pos, quat, ts = f["frame"]
    P = jax_run["cfg"].compact_capacity
    k_sweep, k_fov = jax.random.split(jax.random.key(12))
    noise = {3: np.array(jax.random.normal(k_sweep, (3, P))),
             2: np.array(jax.random.normal(k_fov, (2, P)))}
    given_normals(monkeypatch, noise[3], noise[2])
    return dict(p=before.particles, pos=pos, quat=quat,
                dt=np.float32(ts - before.last_timestamp),
                origin=np.asarray(jg.window_origin(jnp.asarray(pos),
                                                   jax_run["cfg"])),
                noise=noise, k_sweep=k_sweep, k_fov=k_fov)


def test_noisy_sweep_compact_matches_jax(jax_run, monkeypatch):
    jcfg, s = jax_run["cfg"], _inputs(jax_run, monkeypatch)
    want_p, want = jax.device_get(jax.jit(
        lambda p, dt, o, pos, q, k: jc.sweep_compact(p, jcfg, dt, o, pos, q,
                                                     k))(
        jparts(s["p"]), jnp.float32(s["dt"]), jnp.asarray(s["origin"]),
        jnp.asarray(s["pos"]), jnp.asarray(s["quat"]), s["k_sweep"]))
    got_p, got = tc.sweep_compact(tparts(s["p"]), _tcfg(), s["dt"],
                                  s["origin"], s["pos"], s["quat"],
                                  torch.from_numpy(s["noise"][3]))
    for k in ("flags", "vx", "vy", "vz", "weight", "t"):
        _eq(getattr(got_p, k), getattr(want_p, k), k)
    for k in ("px", "py", "pz"):
        assert ulps(getattr(got_p, k), getattr(want_p, k)) <= 1, k
    for k in ("cell", "mover", "fov", "moving", "moved_out"):
        _eq(getattr(got, k), getattr(want, k), k)
    fov = np.asarray(want.fov)
    _eq(got.pyr.numpy()[fov], np.asarray(want.pyr)[fov], "pyr")
    jittered = np.asarray(want_p.vz) != np.asarray(s["p"].vz)
    assert jittered.sum() > 0 and int(np.asarray(want.mover).sum()) > 0


def test_fov_geometry_and_noisy_register_fov_compact_match_jax(jax_run,
                                                               monkeypatch):
    """One sensor pose's geometry exact (pyramid cells on in-FOV rows), then
    registration: kill flags, the binning and the counters exact, the
    jitter (vx, vy jittered, vz set to 0) bit-equal, ranges to rtol 1e-6."""
    jcfg, s = jax_run["cfg"], _inputs(jax_run, monkeypatch)
    jp = jparts(s["p"])
    pos, quat = jnp.asarray(s["pos"]), jnp.asarray(s["quat"])
    w_pyr, w_fov = jax.device_get(jax.jit(
        lambda p, pos, q: jc.fov_geometry_compact(p, jcfg, pos, q))(
        jp, pos, quat))
    g_pyr, g_fov = tc.fov_geometry_compact(tparts(s["p"]), _tcfg(), s["pos"],
                                           s["quat"])
    _eq(g_fov, w_fov, "fov")
    _eq(g_pyr.numpy()[w_fov], np.asarray(w_pyr)[w_fov], "pyr")
    assert w_fov.sum() > 0
    want_p, want_bin, want = jax.device_get(jax.jit(
        lambda p, pyr, m, pos, k: jc.register_fov_compact(p, jcfg, pyr, m,
                                                          pos, key=k))(
        jp, jnp.asarray(w_pyr), jnp.asarray(w_fov), pos, s["k_fov"]))
    got_p, got_bin, got = tc.register_fov_compact(
        tparts(s["p"]), _tcfg(), g_pyr, g_fov, s["pos"],
        torch.from_numpy(s["noise"][2]))
    for k in PLANES:
        _eq(getattr(got_p, k), getattr(want_p, k), k)
    for k in want_bin._fields:
        if k in ("rng", "sp_rng"):
            np.testing.assert_allclose(getattr(got_bin, k).numpy(),
                                       getattr(want_bin, k), rtol=1e-6, atol=0)
        else:
            _eq(getattr(got_bin, k), getattr(want_bin, k), k)
    for k, v in want.items():
        assert int(got[k]) == int(v), k
    moved = np.asarray(want_p.vz) != np.asarray(s["p"].vz)
    assert moved.sum() > 0 and not np.asarray(want_p.vz)[moved].any()


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_noisy_compact_teacher_forced_frames_match_jax(jax_run, monkeypatch,
                                                       pinned):
    frames = jax_run["frames"]
    jax_weight = {}
    if pinned:
        pin_newborn_weight(monkeypatch, "particle_birth_compact", jax_weight)
    tcfg = _tcfg()
    step = T.make_step(tcfg)
    fracs = []
    for i, f in enumerate(frames):
        assert f["draws"][4].shape == (3, tcfg.compact_capacity)
        jax_weight["value"] = f["metrics"]["newborn_weight"]
        state = T.state_from_numpy(f["before"], tcfg, device="cpu")
        new, out = step(state, T.Frame(*f["frame"]), f["draws"])
        fracs.append(check_frame(i, new, out, f, pinned))
    assert np.mean(fracs) >= (0.999 if pinned else 0.995), fracs
    assert int(frames[-1]["metrics"]["movers"]) > 0


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_noisy_compact_free_running_matches_jax(jax_run, monkeypatch, pinned):
    frames = jax_run["frames"]
    tcfg = _tcfg()
    jax_weight = {}
    if pinned:
        pin_newborn_weight(monkeypatch, "particle_birth_compact", jax_weight)
    step = T.make_step(tcfg)
    state = T.state_from_numpy(frames[0]["before"], tcfg, device="cpu")
    for i, f in enumerate(frames):
        jax_weight["value"] = f["metrics"]["newborn_weight"]
        state, out = step(state, T.Frame(*f["frame"]), f["draws"])
        a_t, a_j = int(out.metrics["alive"]), int(f["metrics"]["alive"])
        assert abs(a_t - a_j) <= (0.005 if pinned else 0.02) * a_j, (i, a_t,
                                                                     a_j)
        frac = np.mean(state.particles.flags.numpy()
                       == np.asarray(f["after"].particles.flags))
        assert frac >= (0.999 if pinned else 0.995), (i, frac)
