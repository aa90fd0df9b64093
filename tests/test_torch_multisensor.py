"""The port's multi-sensor step (``make_multisensor_step``) in the pool
layout against the JAX package's, on the CPU: two cameras on
``example_node_settings(dsp_dynamic(...))`` on the 24x24x12 map at 0.25 m
of ``tests/test_multisensor.py`` (``torch_parity.MS_KW``),
sensor 1 shifted 0.36 m from sensor 0 and seeing the same world points
(``torch_parity.two_camera_frames``).

Draws: ``torch_parity.jax_multisensor_draws`` rebuilds the JAX key tree
(``keys = split(rng, 4)``; per sensor ``key, k_est, k_fov, k_birth =
split(key, 4)`` from ``keys[1]``).  The JAX step reports only the
occupancy stage's metrics, so its newborn weights (one a sensor) are
taken from its birth calls by a host callback
(``torch_parity.capture_newborn_weights``) and pinned in the port in the
same order.

Bars, those of ``tests/test_torch_step.py``: teacher-forced flags >= 99.9%
with the newborn weights pinned and >= 99.5% free, weight_sum and future
within rtol 1e-4 on >= 99.9%, every occupancy counter within max(2, 0.5%)
(10% for the resample counters when free); free-running with the newborn
weights pinned flags >= 99.9% and alive within 0.5% in every frame, free
alive within 2%.  Also: the state of the JAX multi-sensor step (estimator
leaves ``[n, C, ...]``) round-trips through ``state_from_numpy`` /
``state_to_numpy``, and the multi-sensor entry points build on the card
by default.
"""

import jax
import numpy as np
import pytest
import torch

import dspmap_tpu as J
from dspmap_tpu.models.pipeline import (init_multisensor_state as
                                        jax_init_multisensor_state)
import dspmap_tpu_torch as T
from torch_parity import (MS_KW, check_frame, check_multi_free_run,
                          record_multisensor, run_multi)

torch.set_num_threads(2)

N_FRAMES = 8
N_SENSORS = 2


def _tcfg():
    return T.example_node_settings(T.dsp_dynamic(**MS_KW))


@pytest.fixture(scope="module")
def jax_run():
    jcfg = J.example_node_settings(J.dsp_dynamic(**MS_KW))
    return dict(cfg=jcfg,
                frames=record_multisensor(jcfg, N_SENSORS, N_FRAMES))


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_multisensor_teacher_forced_frames_match_jax(jax_run, monkeypatch,
                                                     pinned):
    fracs = []
    for i, new, out, f in run_multi(jax_run["frames"], _tcfg(), monkeypatch,
                                    pinned, True):
        assert out.estimator_cloud == ()
        fracs.append(check_frame(i, new, out, f, pinned))
        est, want = new.estimator, f["after"].estimator
        for name in ("prev_point_num", "prev_valid"):
            np.testing.assert_array_equal(getattr(est, name).numpy(),
                                          np.asarray(getattr(want, name)))
        for name in ("prev_centers", "prev_intensity"):
            np.testing.assert_allclose(getattr(est, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    assert np.mean(fracs) >= 0.999, fracs
    assert int(jax_run["frames"][-1]["metrics"]["future_moving"]) > 0


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_multisensor_free_running_matches_jax(jax_run, monkeypatch, pinned):
    check_multi_free_run(jax_run["frames"], _tcfg(), monkeypatch, pinned)


def test_multisensor_state_round_trips(jax_run):
    """A JAX multi-sensor state (estimator leaves ``[n, C, ...]``) through
    ``state_from_numpy`` and ``state_to_numpy``, bit for bit; and the
    port's own ``init_multisensor_state`` has the same leaves."""
    want = jax_run["frames"][5]["after"]
    got = T.state_to_numpy(T.state_from_numpy(want, _tcfg(), device="cpu"))
    for name, v in got["estimator"].items():
        w = np.asarray(getattr(want.estimator, name))
        assert v.shape[0] == N_SENSORS and v.dtype == w.dtype, name
        np.testing.assert_array_equal(v, w, err_msg=name)
    for name in ("flags", "px", "vx", "vz", "weight"):
        np.testing.assert_array_equal(got["particles"][name],
                                      np.asarray(getattr(want.particles, name)))
    mine = T.state_to_numpy(T.init_multisensor_state(_tcfg(), N_SENSORS,
                                                     device="cpu"))
    fresh = jax.device_get(jax_init_multisensor_state(
        jax_run["cfg"], N_SENSORS, jax.random.key(0)))
    for name, v in mine["estimator"].items():
        w = np.asarray(getattr(fresh.estimator, name))
        assert v.shape == w.shape and v.dtype == w.dtype, name
        np.testing.assert_array_equal(v, w, err_msg=name)


def test_multisensor_entry_points_default_to_the_card():
    cfg = T.dsp_dynamic(nx=16, ny=16, nz=8, max_input_points=128)
    assert T.init_multisensor_state(cfg, 2, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert T.init_multisensor_state(cfg, 2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_multisensor_state(cfg, 2)
