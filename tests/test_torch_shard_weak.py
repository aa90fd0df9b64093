"""The weak-scaling mode's check on two gloo ranks (CPU): a small map grown
for two ranks (``utils/shard_probe.py::grown``: twice the z extent, twice
the compact rows) through the port's sharded step, and
``shard_probe.weak_check`` holding each of its last
:data:`~dspmap_tpu_torch.utils.shard_probe.CHECK_FRAMES` frames, from the
gathered state before it, to the same grown map on one device: phase 5's
bars (``shard_probe.sharded_bars``) with no budget dropping a particle on
either side.  The pool layout with the ``all_gather`` exchange and the
compact layout with the ``ring`` exchange (at two ranks the ring reaches
no neighbour).  The timed graphed run of the mode needs NCCL and the card.
"""

import dataclasses

import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch.utils import shard_probe
from torch_shard import run_ranks

torch.set_num_threads(2)

N_RANKS = 2
KW = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=512,
          mover_capacity=4096, pyramid_slot_capacity=64, max_clusters=8)
CASES = {
    "pool": T.example_node_settings(T.dsp_dynamic(**KW)),
    "compact": T.example_node_settings(T.dsp_dynamic(
        **KW, layout="compact", mover_exchange="ring",
        particle_capacity=8192)),
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    cases = [dict(kind="weak", cfg=shard_probe.grown(cfg, N_RANKS))
             for cfg in CASES.values()]
    got = run_ranks(cases, tmp_path_factory.mktemp("ranks"), n=N_RANKS)
    return {name: [r[k] for r in got] for k, name in enumerate(CASES)}


def test_grown_map_splits_into_slabs_of_the_small_map():
    for cfg in CASES.values():
        big = shard_probe.grown(cfg, N_RANKS)
        assert big.nz == 2 * cfg.nz
        assert big.storage_voxels % N_RANKS == 0
        assert big.storage_voxels // N_RANKS >= cfg.voxel_num
        if cfg.layout == "compact":
            assert big.compact_capacity == N_RANKS * cfg.compact_capacity
        assert dataclasses.replace(big, nz=cfg.nz, particle_capacity=(
            cfg.particle_capacity)) == cfg


@pytest.mark.parametrize("case", list(CASES))
def test_weak_check_holds_the_grown_map_to_one_device(records, case):
    rank0, rank1 = records[case]
    assert rank0["failed"] == [] and rank1["failed"] == []
    frames = rank0["against_unsharded"]
    assert [f["frame"] for f in frames] == list(range(
        shard_probe.CHECK_WARM,
        shard_probe.CHECK_WARM + shard_probe.CHECK_FRAMES))
    for f in frames:
        assert f["missed"] == [] and f["contested"] == [], f
        assert f["teacher_forced"]["alive_sharded"] > 0
        assert "update_spill_overflow" in f["dropped"]
    cfg = shard_probe.grown(CASES[case], N_RANKS)
    worst = rank0["teacher_forced_worst"]
    assert shard_probe.missed_bars(worst, shard_probe.sharded_bars(cfg)) == []
    assert "against_unsharded" not in rank1
