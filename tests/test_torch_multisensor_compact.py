"""The port's multi-sensor step in the compact layout against the JAX
package's ``_make_multisensor_step_compact``, on the CPU: two cameras
(``torch_parity.two_camera_frames``) on ``example_node_settings(
dsp_dynamic(layout="compact", ...))`` on the map of
``tests/test_multisensor.py`` (``torch_parity.MS_KW``).  One sweep and
rebin a frame, then per sensor ``fov_geometry_compact``,
``register_fov_compact``, the update and ``particle_birth_compact``, then
one occupancy pass.

Draws and the newborn-weight pin as in ``tests/test_torch_multisensor.py``;
bars those of ``tests/test_torch_compact.py``: teacher-forced flags
>= 99.9% pinned and >= 99.5% free, the other bars of
``torch_parity.check_frame``; free-running pinned flags >= 99.9% and
alive within 0.5% in every frame, free alive within 2% and flags
>= 99.5%.
"""

import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from torch_parity import (MS_KW, check_frame, check_multi_free_run,
                          record_multisensor, run_multi)

torch.set_num_threads(2)

N_FRAMES = 8


def _tcfg():
    return T.example_node_settings(T.dsp_dynamic(layout="compact", **MS_KW))


@pytest.fixture(scope="module")
def frames():
    jcfg = J.example_node_settings(J.dsp_dynamic(layout="compact", **MS_KW))
    assert jcfg.layout == "compact"
    return record_multisensor(jcfg, 2, N_FRAMES)


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_multisensor_compact_teacher_forced_frames_match_jax(frames,
                                                             monkeypatch,
                                                             pinned):
    fracs = [check_frame(i, new, out, f, pinned)
             for i, new, out, f in run_multi(frames, _tcfg(), monkeypatch,
                                             pinned, True)]
    assert np.mean(fracs) >= (0.999 if pinned else 0.995), fracs
    assert "pool_overflow" in frames[-1]["metrics"]
    assert int(frames[-1]["metrics"]["future_moving"]) > 0


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_multisensor_compact_free_running_matches_jax(frames, monkeypatch,
                                                      pinned):
    check_multi_free_run(frames, _tcfg(), monkeypatch, pinned)
