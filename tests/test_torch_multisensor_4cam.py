"""The port's multi-sensor step at four cameras (``make_multisensor_step(cfg,
4)``) against the JAX package's ``jax.jit(make_multisensor_step(jcfg, 4))``
on the CPU, on ``tests/test_multisensor.py``'s map
(``torch_parity.MS_KW``) and the frames of ``utils/rig.py``'s surround
rig: four cameras at the ego pose, camera k turned k x 90 degrees about
the body's z axis, each rendering its own cloud (the back camera sees a
few dozen points, the front one hundreds).

Frame :data:`SKIPPED` skips camera 1 (its quaternion NaN: both packages'
admission skip that camera alone, so JAX's scan runs three births) and
frame :data:`REJECTED` jumps 20 m (both reject the frame).  Draws and
newborn weights as in ``tests/test_torch_multisensor.py``
(``torch_parity.record_multi``, ``run_multi``), held to that file's bars:
teacher-forced flags >= 99.9% with the newborn weights pinned and >= 99.5%
free, weight_sum and future within rtol 1e-4 on >= 99.9%, the occupancy
counters within max(2, 0.5%); free-running flags >= 99.9% and alive within
0.5% pinned, alive within 2% free.
"""

import jax
import numpy as np
import pytest
import torch

import dspmap_tpu as J
from dspmap_tpu.models.pipeline import (init_multisensor_state,
                                        make_multisensor_step)
import dspmap_tpu_torch as T
from dspmap_tpu_torch.models import pipeline
from dspmap_tpu_torch.utils import rig
from torch_parity import (MS_KW, capture_newborn_weights, check_frame,
                          check_multi_free_run, record_multi, run_multi)

torch.set_num_threads(2)

N_FRAMES = 6
N_SENSORS = 4
#: the frame whose camera 1 is skipped, and the frame that jumps 20 m
SKIPPED, REJECTED = 2, 4


def _tcfg():
    return T.example_node_settings(T.dsp_dynamic(**MS_KW))


def rig_frames(cfg, n_frames=N_FRAMES):
    """The rig's frames (seed 7) with camera 1 of frame :data:`SKIPPED`
    given a NaN quaternion and frame :data:`REJECTED` moved 20 m."""
    frames = list(rig.surround_sequence(n_frames, cfg, N_SENSORS, seed=7))
    pts, n, pos, quat, t = frames[SKIPPED]
    quat = quat.copy()
    quat[1] = np.nan
    frames[SKIPPED] = (pts, n, pos, quat, t)
    pts, n, pos, quat, t = frames[REJECTED]
    frames[REJECTED] = (pts, n, pos + np.float32(20.0), quat, t)
    return frames


@pytest.fixture(scope="module")
def jax_frames():
    jcfg = J.example_node_settings(J.dsp_dynamic(**MS_KW))
    sink = []
    with pytest.MonkeyPatch.context() as mp:
        capture_newborn_weights(mp, sink)
        step = jax.jit(make_multisensor_step(jcfg, N_SENSORS))
        return record_multi(
            jcfg, step, init_multisensor_state(jcfg, N_SENSORS,
                                               jax.random.key(0)),
            rig_frames(jcfg), sink)


def test_four_cameras_are_admitted_alike(jax_frames):
    """JAX runs a birth for each admitted camera: four, three on the frame
    with camera 1 skipped, none on the rejected frame; the port's prologue
    admits the same cameras and rejects the same frame."""
    births = [len(f["newborn"]) for f in jax_frames]
    want = [N_SENSORS] * N_FRAMES
    want[SKIPPED], want[REJECTED] = N_SENSORS - 1, 0
    assert births == want
    assert [f["accepted"] for f in jax_frames] == [
        k != REJECTED for k in range(N_FRAMES)]
    cfg = _tcfg()
    for k, f in enumerate(jax_frames):
        state = T.state_from_numpy(f["before"], cfg, device="cpu")
        pro = pipeline.multisensor_prologue(state, T.Frame(*f["frame"]), cfg,
                                            N_SENSORS)
        assert pro.accepted == f["accepted"], k
        assert pro.admitted == tuple(c != 1 or k != SKIPPED
                                     for c in range(N_SENSORS)), k


def test_rig_cameras_see_their_own_clouds(jax_frames):
    """Every camera sees points, each its own cloud (the rig, not four
    copies of one camera)."""
    n = np.stack([f["frame"][1] for f in jax_frames])
    assert (n > 0).all(), n
    pts = jax_frames[0]["frame"][0]
    for a in range(N_SENSORS):
        for b in range(a):
            assert not np.array_equal(pts[a], pts[b]), (a, b)


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_four_cameras_teacher_forced_frames_match_jax(jax_frames, monkeypatch,
                                                      pinned):
    fracs = []
    for i, new, out, f in run_multi(jax_frames, _tcfg(), monkeypatch, pinned,
                                    True):
        fracs.append(check_frame(i, new, out, f, pinned))
        est, want = new.estimator, f["after"].estimator
        assert est.prev_valid.shape[0] == N_SENSORS
        for name in ("prev_point_num", "prev_valid"):
            np.testing.assert_array_equal(getattr(est, name).numpy(),
                                          np.asarray(getattr(want, name)))
        for name in ("prev_centers", "prev_intensity"):
            np.testing.assert_allclose(getattr(est, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    assert np.mean(fracs) >= 0.999, fracs


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_four_cameras_free_running_matches_jax(jax_frames, monkeypatch,
                                               pinned):
    check_multi_free_run(jax_frames, _tcfg(), monkeypatch, pinned)
