"""The port's sharded multi-sensor step (``make_shardmap_step(...,
n_sensors=2)``, ``make_multisensor_step(cfg, 2, shard=)``) on 4 gloo ranks
against the JAX package's one-device ``make_multisensor_step``, on
``tests/test_multisensor.py``'s map (``torch_parity.MS_KW``, 24x24x12 at
0.25 m) with two cameras (``torch_parity.two_camera_frames``), three
frames a case, from a state with random particles (velocities in [-1, 1],
so that particles move from the second frame on):

* ``pool``: the pool layout, limit-xy, ``all_gather`` mover exchange;
* ``pool_noisy``: the pool layout with ``limit_motion_to_xy_plane=False``
  (each rank its slab of the propagation and FOV noise);
* ``compact``: the compact layout with the ``ring`` exchange
  (``rebin_exchange_compact``; at four ranks the ring reaches one
  neighbour each way);
* ``skipped_camera``: the pool case with camera 1's quaternion invalid in
  frame 1, which every rank skips alike;
* ``rejected_frame``: the pool case with frame 1's pose 20 m away, which
  every rank rejects alike.

JAX's GSPMD multi-sensor step is this same program over sharded operands,
held bit-identical to one device by the JAX package itself
(``tests/test_sharding.py``), so the reference is the one-device step.
Each rank gets the replicated draws and its slab of JAX's pool-shaped
normals; the port's one-device step gets the whole arrays.  The ranks
start once for the file (``tests/torch_shard.py``) and run each case twice:

* teacher-forced: every frame from JAX's state before it, the newborn
  weights (one an admitted camera) pinned, rank 0's gathered state held to
  ``torch_parity.check_frame``'s pinned bars and the estimator tracks to
  ``tests/test_torch_multisensor.py``'s;
* free-running with the same draws, the last gathered state held to the
  port's one-device multi-sensor step by ``check_free_running``'s bars
  (``weight_sum`` and ``future`` within rtol 1e-5, per-voxel flag counts
  and the occupancy counters equal), its estimator tracks bit-equal.

In both, every rank reports the same acceptance, metrics and replicated
leaves (estimator tracks, host scalars, generator) bit for bit, and the
dynamic cases move particles across the slabs' boundaries.
"""

import numpy as np
import pytest
import torch

import dspmap_tpu as J
from torch_parity import (MS_KW, check_multisensor_free_running,
                          check_multisensor_teacher_forced,
                          multisensor_shard_cases, two_camera_frames)

torch.set_num_threads(2)

N_FRAMES = 3
EDITED = 1  # the frame the skipped_camera and rejected_frame cases edit
#: random particles in the initial state: the street scene's own movers
#: appear only from the fifth frame
INIT_PARTICLES = 2000
EDITED_CASES = ("skipped_camera", "rejected_frame")
CASES = ("pool", "pool_noisy", "compact") + EDITED_CASES


def _cfg(**kw):
    return J.example_node_settings(J.dsp_dynamic(**MS_KW, **kw))


def _edited(frames, case):
    pts, n, pos, quat, t = frames[EDITED]
    if case == "skipped_camera":  # components past +-1.001
        quat = quat.copy()
        quat[1] = 2.0
    else:  # a pose jump of 20 m rejects the frame
        pos = pos + np.float32(20.0)
    return frames[:EDITED] + [(pts, n, pos, quat, t)] + frames[EDITED + 1:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pool = _cfg()
    cfgs = dict(pool_noisy=_cfg(limit_motion_to_xy_plane=False),
                compact=_cfg(layout="compact", mover_exchange="ring"))
    frames = two_camera_frames(pool, N_FRAMES)
    return multisensor_shard_cases(
        {name: (cfgs.get(name, pool), _edited(frames, name)
                if name in EDITED_CASES else frames) for name in CASES},
        tmp_path_factory, init_particles=INIT_PARTICLES)


@pytest.mark.parametrize("case", CASES)
def test_sharded_multisensor_matches_jax(runs, case):
    check_multisensor_teacher_forced(runs[case])


@pytest.mark.parametrize("case", CASES)
def test_sharded_multisensor_matches_single_device(runs, case):
    check_multisensor_free_running(runs[case])


@pytest.mark.parametrize("case", CASES)
def test_sharded_multisensor_moves_particles_across_slabs(runs, case):
    """Movers on every case, some of them bound for another rank's slab,
    in both runs; JAX's frames carry moving particles too."""
    for run in ("teacher", "free"):
        movers = np.array([[f[4] for f in rank] for rank in runs[case][run]])
        assert movers[..., 0].sum() > 0 and movers[..., 1].sum() > 0, (
            run, movers)
    assert int(runs[case]["frames"][-1]["metrics"]["future_moving"]) > 0


def test_skipped_camera_and_rejected_frame_are_the_same_on_every_rank(runs):
    """Frame 1 of ``skipped_camera`` runs camera 0 alone (one birth in JAX,
    one pinned on every rank), and frame 1 of ``rejected_frame`` is
    rejected by JAX and every rank, its movers untouched."""
    skip = runs["skipped_camera"]
    assert [len(f["newborn"]) for f in skip["frames"]] == [2, 1, 2]
    assert all(f["accepted"] for f in skip["frames"])
    rej = runs["rejected_frame"]
    assert [f["accepted"] for f in rej["frames"]] == [True, False, True]
    for rank in rej["teacher"] + rej["free"]:
        assert [f[0] for f in rank] == [True, False, True]
        assert rank[EDITED][4] == (0, 0)
