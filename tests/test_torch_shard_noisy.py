"""The sharded step on the noisy prediction arm (``propagate`` -> ``rebin``
-> ``register_fov``; ``limit_motion_to_xy_plane=False``) on 4 gloo ranks,
on ``tests/test_shard_step.py``'s map and frames.

* At sigma_v = 0 (``test_shardmap_noisy_path_matches_single_device_at_zero_
  sigma``'s case), each frame teacher-forced from the JAX sharded step's
  state, with its draws and its newborn weight pinned, is held to the
  pinned bars of ``torch_parity.check_frame``; the free run is held to the
  port's single-device step by that JAX test's bars: the C(z) partials are
  summed over the ranks, so the newborn weight can differ in its last bits
  and flip a particle on a resample threshold -- at most 4 voxels whose
  weight or flag counts differ, total mass within 1e-3, counters within 4.
* At sigma_v = 0.1 (``test_shardmap_noisy_path_runs_with_noise``), each
  rank draws its own pool-shaped noise (``make_draws``, the counterpart of
  the JAX package's ``fold_in(key, axis_index)``): three frames run, stay
  finite and keep particles -- on the pool and on the compact layout.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu_torch.utils import sim
from test_shard_step import cfg_for
from torch_parity import (SHARD_COUNTERS, check_teacher_forced, port_cfg,
                          port_result, shard_cases, voxel_flag_counts)
from torch_shard import N_RANKS, tree

torch.set_num_threads(2)

ZERO_SIGMA = dict(limit_motion_to_xy_plane=False, velocity_noise_std=0.0)


def _noise_case(layout):
    tcfg = port_cfg(dataclasses.replace(
        cfg_for(N_RANKS), limit_motion_to_xy_plane=False,
        velocity_noise_std=0.1, layout=layout, particle_capacity=8192))
    init = T.state_to_numpy(T.init_state(tcfg, device="cpu"))
    return dict(kind="steps", cfg=tcfg, init=tree(init),
                frames=list(sim.generate_sequence(3, tcfg, seed=5)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shard_cases(J.dsp_dynamic, ("all_gather",), tmp_path_factory,
                       overrides=ZERO_SIGMA,
                       extra=[_noise_case("pool"), _noise_case("compact")])


def test_noisy_sharded_step_matches_jax_shardmap_at_zero_sigma(runs):
    check_teacher_forced(runs["all_gather"])


def test_noisy_sharded_step_matches_single_device_at_zero_sigma(runs):
    run = runs["all_gather"]
    s1, o1 = run["single"]
    s2, o2 = port_result(run["tcfg"], run["free"][0][-1])
    assert o1.accepted and o2.accepted
    assert int(o1.metrics["alive"]) > 0
    w1, w2 = s1.weight_sum.numpy(), s2.weight_sum.numpy()
    flipped = ~np.isclose(w1, w2, rtol=1e-5, atol=1e-7)
    assert flipped.sum() <= 4, (np.nonzero(flipped)[0], w1[flipped],
                                w2[flipped])
    np.testing.assert_allclose(w1.sum(), w2.sum(), rtol=1e-3)
    c1 = voxel_flag_counts(s1.particles.flags)
    c2 = voxel_flag_counts(s2.particles.flags)
    assert (c1 != c2).any(axis=0).sum() <= 4
    for k in SHARD_COUNTERS:
        assert abs(int(o1.metrics[k]) - int(o2.metrics[k])) <= 4, k


@pytest.mark.parametrize("layout", ["pool", "compact"])
def test_noisy_sharded_step_runs_with_noise(runs, layout):
    by_rank = [r[("pool", "compact").index(layout)] for r in runs["extra"]]
    tcfg = _noise_case(layout)["cfg"]
    for i in range(3):  # every rank reports the same summed counters
        for r in range(1, N_RANKS):
            for k, v in by_rank[0][i][1].items():
                assert np.array_equal(v, by_rank[r][i][1][k]), (i, r, k)
    state, out = port_result(tcfg, by_rank[0][-1])
    assert out.accepted and int(out.metrics["alive"]) > 0
    assert torch.isfinite(state.weight_sum).all()
    assert torch.isfinite(state.future).all()
    assert torch.isfinite(state.particles.vx).all()
