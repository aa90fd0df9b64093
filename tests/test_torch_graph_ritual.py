"""The tools with which the graphed steps are held to the eager ones on the
card (CPU): ``utils/graph_ritual.py``'s frames and bit comparison, and the
budget counters that ``utils/shard_probe.py`` requires to be 0 on both
sides of a sharded-against-unsharded comparison.

``parity.counters_recorded`` adds up every counter of dropped particles
that a step's stages return, the two-camera step's per-camera stages
included (the step itself discards theirs): on a small map whose update
spill tier overflows, the single-camera step's counters equal its own
metrics, and recording changes neither step's state nor output by a bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch.utils import graph_ritual as gr
from dspmap_tpu_torch.utils import sim
from dspmap_tpu_torch.utils.parity import (counters_recorded,
                                           differing_leaves,
                                           differing_outputs)
from dspmap_tpu_torch.utils.shard_probe import contested

torch.set_num_threads(2)

#: a small map whose update spill tier (a dense tier of 2 slots a pyramid
#: cell, 32 spill slots) overflows from the second frame on
KW = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=1024,
          mover_capacity=8192, pyramid_slot_capacity=96, max_clusters=16,
          pyramid_dense_slots=2, particle_spill_capacity=32)
FRAMES = 3


def _cfg(**kw):
    return T.example_node_settings(T.dsp_dynamic(**KW, **kw))


def _dropped(metrics) -> dict:
    return {k: int(v) for k, v in metrics.items()
            if "overflow" in k or "killed" in k}


def test_ritual_frames_jump_and_one_camera_patterns():
    cfg = _cfg()
    seq = [T.Frame(*f) for f in sim.generate_sequence(gr.FRAMES, cfg, seed=0)]
    one, patterns = gr.ritual_frames(seq)
    assert patterns == [(True,)] * gr.FRAMES
    jump = one[gr.REJECTED].sensor_pos - seq[gr.REJECTED].sensor_pos
    np.testing.assert_array_equal(jump, np.float32([gr.JUMP_M, 0, 0]))
    assert all(one[k] is seq[k] for k in range(gr.FRAMES) if k != gr.REJECTED)

    two, patterns = gr.ritual_frames([T.stack_frames([f] * 2) for f in seq],
                                     2)
    assert len(set(patterns)) == 3
    for k, (frame, admitted) in enumerate(zip(two, patterns)):
        assert admitted == gr.some_cameras(2).get(k, (True, True))
        finite = np.isfinite(np.asarray(frame.quat)).all(axis=1)
        assert tuple(finite) == admitted
        np.testing.assert_array_equal(np.asarray(frame.points)[0],
                                      np.asarray(frame.points)[1])
    with pytest.raises(ValueError, match="takes 8"):
        gr.ritual_frames(seq[:-1])


def test_differing_on_card_names_each_leaf_that_differs():
    cfg = _cfg()
    a = T.init_state(cfg, seed=0, device="cpu")
    b = dataclasses.replace(a, particles=dataclasses.replace(
        a.particles, px=a.particles.px.clone()))
    assert gr.differing_on_card(a, b) == []
    b.particles.px.view(-1)[7] = torch.nan
    c = T.set_detection_probability(b, 0.5)
    assert gr.differing_on_card(a, c) == ["particles.px", "params"]


@pytest.mark.parametrize("layout", ["pool", "compact"])
def test_counters_recorded_single_camera_match_the_step_metrics(layout):
    cfg = _cfg(layout=layout)
    step = T.make_step(cfg)
    frames = [T.Frame(*f) for f in sim.generate_sequence(FRAMES, cfg, seed=0)]
    a = T.init_state(cfg, seed=0, device="cpu")
    b = dataclasses.replace(a, gen=torch.Generator().manual_seed(3))
    a = dataclasses.replace(a, gen=torch.Generator().manual_seed(3))
    spilled = 0
    for frame in frames:
        a, out_a = step(a, frame)
        sink = {}
        with counters_recorded(sink):
            b, out_b = step(b, frame)
        assert {k: int(v) for k, v in sink.items()} == _dropped(out_b.metrics)
        spilled += int(sink["update_spill_overflow"])
        assert differing_leaves(a, b) == []
        assert differing_outputs(out_a, out_b) == []
    assert spilled > 0


def test_counters_recorded_two_cameras_count_what_the_step_discards():
    cfg = _cfg()
    step = T.make_multisensor_step(cfg, 2)
    frames = [T.stack_frames([T.Frame(*f)] * 2)
              for f in sim.generate_sequence(FRAMES, cfg, seed=0)]
    a = T.init_multisensor_state(cfg, 2, seed=0, device="cpu")
    b = dataclasses.replace(a, gen=torch.Generator().manual_seed(3))
    a = dataclasses.replace(a, gen=torch.Generator().manual_seed(3))
    spilled = 0
    for frame in frames:
        a, out_a = step(a, frame)
        sink = {}
        with counters_recorded(sink):
            b, out_b = step(b, frame)
        assert "update_spill_overflow" not in out_b.metrics
        assert {"update_spill_overflow", "pyramid_full_killed",
                "mover_overflow_killed", "voxel_full_killed"} <= set(sink)
        spilled += int(sink["update_spill_overflow"])
        assert differing_leaves(a, b) == []
        assert differing_outputs(out_a, out_b) == []
    assert spilled > 0


def test_contested_reads_both_sides():
    calm = {"update_spill_overflow": 0, "voxel_full_killed": 3}
    assert contested(calm, dict(calm)) == []
    assert contested(calm, dict(calm, update_spill_overflow=870)) == [
        "update_spill_overflow: 0 sharded, 870 unsharded"]
    assert contested(dict(calm, pool_overflow=2), dict(calm)) == [
        "pool_overflow: 2 sharded, None unsharded"]
    assert contested(calm, dict(calm, voxel_full_killed=4)) == [
        "voxel_full_killed: 3 sharded, 4 unsharded"]
    assert contested({}, {}) == ["no update counted: []"]
