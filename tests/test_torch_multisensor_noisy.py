"""The port's multi-sensor step on the noisy prediction arm
(``limit_motion_to_xy_plane=False``) against the JAX package's, on the
CPU, in both layouts: the propagation noise once a frame and the in-FOV
jitter once a sensor (``torch_parity.jax_multisensor_draws``: the
propagation noise from ``keys[0]``, each sensor's FOV noise from its
``k_fov``).  Two cameras (``torch_parity.two_camera_frames``) on the map
of ``tests/test_multisensor.py``; eight frames teacher-forced with the
newborn weights pinned and free-running, under the bars of
``tests/test_torch_multisensor.py``.
"""

import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from torch_parity import (MS_KW, check_frame, check_multi_free_run,
                          record_multisensor, run_multi)

torch.set_num_threads(2)


def _kw(layout):
    return dict(MS_KW, layout=layout, limit_motion_to_xy_plane=False)


@pytest.fixture(scope="module", params=["pool", "compact"])
def run(request):
    jcfg = J.example_node_settings(J.dsp_dynamic(**_kw(request.param)))
    tcfg = T.example_node_settings(T.dsp_dynamic(**_kw(request.param)))
    frames = record_multisensor(jcfg, 2, 8)
    prop, sensors = frames[0]["draws"]
    assert prop.shape[0] == 3 and all(len(s) == 5 for s in sensors)
    return tcfg, frames


def test_noisy_multisensor_teacher_forced_frames_match_jax(run, monkeypatch):
    tcfg, frames = run
    for i, new, out, f in run_multi(frames, tcfg, monkeypatch, True, True):
        check_frame(i, new, out, f, True)
    assert int(frames[-1]["metrics"]["future_moving"]) > 0


def test_noisy_multisensor_free_running_matches_jax(run, monkeypatch):
    tcfg, frames = run
    check_multi_free_run(frames, tcfg, monkeypatch, False)
