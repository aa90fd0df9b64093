"""The port's sharded multi-sensor step at four cameras
(``make_shardmap_step(..., n_sensors=4)``) on 4 gloo ranks, on
``tests/test_multisensor.py``'s map (``torch_parity.MS_KW``) and the frames
of ``utils/rig.py``'s surround rig, three frames a case from a state with
random particles (velocities in [-1, 1]):

* ``pool``: the pool layout, limit-xy, ``all_gather`` mover exchange,
  frame 1 with camera 3 skipped (its quaternion NaN);
* ``compact``: the compact layout with the ``ring`` exchange.

As in ``tests/test_torch_shard_multisensor.py`` (the same helpers of
``tests/torch_parity.py`` and ``tests/torch_shard.py``, one start of the
ranks): teacher-forced against JAX's one-device ``make_multisensor_step(
cfg, 4)`` with the newborn weights pinned (``check_frame``'s pinned bars,
the estimator tracks to ``tests/test_torch_multisensor.py``'s), and free
against the port's one-device four-camera step on the same draws
(``weight_sum`` and ``future`` within rtol 1e-5, the same particles of
each flag in every cell, the occupancy counters equal, the estimator
tracks bit-equal); every rank reports the same acceptance, metrics and
replicated leaves bit for bit.
"""

import numpy as np
import pytest
import torch

import dspmap_tpu as J
from dspmap_tpu_torch.utils import rig
from torch_parity import (MS_KW, check_multisensor_free_running,
                          check_multisensor_teacher_forced,
                          multisensor_shard_cases)

torch.set_num_threads(2)

N_FRAMES, N_SENSORS = 3, 4
SKIPPED = (1, 3)  # frame 1 skips camera 3
INIT_PARTICLES = 2000
CASES = ("pool", "compact")


def _cfg(**kw):
    return J.example_node_settings(J.dsp_dynamic(**MS_KW, **kw))


def _frames(cfg, skip):
    frames = list(rig.surround_sequence(N_FRAMES, cfg, N_SENSORS, seed=7))
    if skip:
        k, cam = SKIPPED
        pts, n, pos, quat, t = frames[k]
        quat = quat.copy()
        quat[cam] = np.nan
        frames[k] = (pts, n, pos, quat, t)
    return frames


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pool = _cfg()
    compact = _cfg(layout="compact", mover_exchange="ring")
    return multisensor_shard_cases(
        {"pool": (pool, _frames(pool, True)),
         "compact": (compact, _frames(compact, False))},
        tmp_path_factory, n_sensors=N_SENSORS,
        init_particles=INIT_PARTICLES)


@pytest.mark.parametrize("case", CASES)
def test_sharded_four_cameras_match_jax(runs, case):
    check_multisensor_teacher_forced(runs[case])


@pytest.mark.parametrize("case", CASES)
def test_sharded_four_cameras_match_single_device(runs, case):
    check_multisensor_free_running(runs[case])


def test_sharded_four_cameras_skip_the_same_camera(runs):
    """JAX runs a birth for each admitted camera (four, three on the frame
    that skips camera 3, four) and every rank accepts every frame."""
    frames = runs["pool"]["frames"]
    assert [len(f["newborn"]) for f in frames] == [4, 3, 4]
    for rank in runs["pool"]["teacher"] + runs["pool"]["free"]:
        assert [f[0] for f in rank] == [True] * N_FRAMES
