"""The port's sharded step (``dspmap_tpu_torch.parallel``) on 4 gloo ranks
against the JAX package's ``make_shardmap_step`` on 4 of the virtual CPU
devices, on ``tests/test_shard_step.py``'s map, frames and cases: the
dynamic model (limit-xy: the fused sweep), with the ``all_gather`` and the
``ring`` mover exchange.  ``tests/test_torch_shard_static.py`` holds the
static model's two cases.

Each case runs the ranks twice over the four frames
(``tests/torch_shard.py``):

* teacher-forced: every frame from the JAX sharded step's state before it,
  with the JAX draws and its newborn weight pinned, held to the bars the
  port's single-device step tests hold against JAX
  (``torch_parity.check_frame``, pinned): flags equal on >= 99.9% of
  slots, ``weight_sum`` and ``future`` within rtol 1e-4 on >= 99.9%, every
  counter within max(2, 0.5%);
* free-running from the initial state with the same draws, held to the
  port's single-device step by ``tests/test_shard_step.py``'s bars:
  ``weight_sum`` and ``future`` within rtol 1e-5 / atol 1e-7, the same
  particle count of each flag in every voxel (slot order may differ:
  arrivals from other slabs land behind the local movers), and the same
  counters.
"""

import pytest
import torch

import dspmap_tpu as J
from torch_parity import check_free_running, check_teacher_forced, shard_cases

torch.set_num_threads(2)

BASE = J.dsp_dynamic
EXCHANGES = ("all_gather", "ring")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shard_cases(BASE, EXCHANGES, tmp_path_factory)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_sharded_step_matches_jax_shardmap(runs, exchange):
    check_teacher_forced(runs[exchange])


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_sharded_step_matches_single_device(runs, exchange):
    check_free_running(runs[exchange])
