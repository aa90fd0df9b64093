"""The update's ``update_spilled`` counter, the port's own (the JAX package
has no such counter): the particles the update's spill tier updated in a
frame, counted by hand from the frame's FOV binning on a small static map
and a small flagship map, and 0 where the dense tier holds every pyramid's
capacity.  Its card test (``cuda`` marker) holds the graphed step to the
eager one on it."""

import dataclasses

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch.models import pipeline
from dspmap_tpu_torch.utils import sim

#: small maps of the two pool-layout models, the pyramids' capacity 48
MAPS = {
    "static": lambda **kw: T.example_node_settings(T.dsp_static(
        nx=20, ny=20, nz=10, voxel_resolution=0.4, max_input_points=512,
        pyramid_slot_capacity=48, **kw)),
    "flagship": lambda **kw: T.example_node_settings(T.dsp_dynamic(
        nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=512,
        pyramid_slot_capacity=48, max_clusters=8, **kw)),
}
#: the dense tier's slots a pyramid: small (most in-FOV particles spill),
#: and the pyramid's whole capacity (no spill tier)
DENSE = {"spilling": 4, "all_dense": 48}


def _spy(monkeypatch) -> list:
    """Record each frame's FOV binning and observation as the update is
    handed them."""
    seen = []
    real = pipeline.measurement_update

    def spy(particles, fovbin, obs, *args, **kwargs):
        seen.append((fovbin, obs))
        return real(particles, fovbin, obs, *args, **kwargs)

    monkeypatch.setattr(pipeline, "measurement_update", spy)
    return seen


def _updated_by_hand(fovbin, obs, cfg) -> tuple:
    """``(dense, spill)``: the binned particles of each tier that the update
    writes, those not beyond their pyramid's farthest point by more than
    the occlusion slack (a pyramid without points occludes nothing)."""
    far = obs.max_range.numpy()
    slack = np.float32(cfg.occlusion_slack)
    mask, rng = fovbin.mask.numpy(), fovbin.rng.numpy()
    dense = 0
    for pyr in range(mask.shape[0]):
        for k in np.flatnonzero(mask[pyr]):
            dense += not (far[pyr] > 0 and rng[pyr, k] > far[pyr] + slack)
    spill = 0
    sp_pyr, sp_rng = fovbin.sp_pyr.numpy(), fovbin.sp_rng.numpy()
    for i in np.flatnonzero(fovbin.sp_mask.numpy()):
        pyr = sp_pyr[i]
        spill += not (far[pyr] > 0 and sp_rng[i] > far[pyr] + slack)
    return dense, spill


@pytest.mark.parametrize("dense", sorted(DENSE))
@pytest.mark.parametrize("model", sorted(MAPS))
def test_update_spilled_counts_the_spill_tier(monkeypatch, model, dense):
    """Six frames of the street: ``update_spilled`` is each frame's
    spill-tier particles that the update wrote, ``updated_particles`` less
    it the dense tier's; with the dense tier at the pyramids' capacity the
    configuration has no spill tier and the counter reads 0."""
    cfg = MAPS[model](pyramid_dense_slots=DENSE[dense])
    assert (cfg.dense_slots < cfg.pyramid_slots) == (dense == "spilling")
    seen = _spy(monkeypatch)
    step = T.make_step(cfg)
    state = T.init_state(cfg, seed=0, device="cpu")
    spilled = []
    for f in sim.generate_sequence(6, cfg, seed=3):
        state, out = step(state, T.Frame(*f))
        assert out.accepted
        fovbin, obs = seen[-1]
        want_dense, want_spill = _updated_by_hand(fovbin, obs, cfg)
        got = int(out.metrics["update_spilled"])
        assert out.metrics["update_spilled"].dtype == torch.int64
        assert got == want_spill
        assert int(out.metrics["updated_particles"]) - got == want_dense
        spilled.append(got)
    assert int(out.metrics["updated_particles"]) > 0
    if dense == "spilling":
        assert max(spilled) > 0, spilled
    else:
        assert spilled == [0] * 6


def test_a_rejected_frame_reports_update_spilled_as_zero():
    """Every counter of a rejected frame reads 0, the port's own too, and
    the step reports the JAX package's names and the port's."""
    cfg = MAPS["static"](pyramid_dense_slots=4)
    step = T.make_step(cfg)
    frames = [T.Frame(*f) for f in sim.generate_sequence(2, cfg, seed=3)]
    state, out = step(T.init_state(cfg, seed=0, device="cpu"), frames[0])
    assert set(out.metrics) == set(pipeline.METRIC_NAMES)
    jump = frames[1]._replace(
        sensor_pos=frames[1].sensor_pos + np.float32([12, 0, 0]))
    new, out = step(state, jump)
    assert not out.accepted and new is state
    assert set(out.metrics) == set(pipeline.METRIC_NAMES)
    assert int(out.metrics["update_spilled"]) == 0
    assert pipeline.METRIC_NAMES[-len(pipeline.PORT_METRIC_NAMES):] == (
        pipeline.PORT_METRIC_NAMES)
    assert "update_spilled" in pipeline.COMPACT_METRIC_NAMES


def test_update_spilled_in_the_compact_layout():
    """The compact layout's step reports it too, from the same update."""
    cfg = MAPS["flagship"](pyramid_dense_slots=4, layout="compact",
                           particle_capacity=1 << 14)
    step = T.make_step(cfg)
    state = T.init_state(cfg, seed=0, device="cpu")
    spilled = []
    for f in sim.generate_sequence(4, cfg, seed=3):
        state, out = step(state, T.Frame(*f))
        spilled.append(int(out.metrics["update_spilled"]))
        assert spilled[-1] <= int(out.metrics["updated_particles"])
    assert set(out.metrics) == set(pipeline.COMPACT_METRIC_NAMES)
    assert max(spilled) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(MAPS))
def test_graphed_and_eager_steps_agree_on_update_spilled(model):
    """On the card, the graphed step and the eager one from the same state
    with the same draws report the same ``update_spilled``, above 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernels are built for sm_90a")
    device = torch.device("cuda", 0)
    cfg = MAPS[model](pyramid_dense_slots=4)
    frames = [T.Frame(*f) for f in sim.generate_sequence(6, cfg, seed=3)]
    eager, graphed = T.make_step(cfg), T.make_graphed_step(cfg)
    state = T.init_state(cfg, seed=0)
    for f in frames[:2]:
        state, _ = eager(state, f)
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    a, b = state, dataclasses.replace(state)
    spilled = []
    for f in frames[2:]:
        draws = T.make_draws(cfg, gen, device)
        a, out_a = eager(a, f, draws)
        b, out_b = graphed(b, f, draws)
        assert torch.equal(out_a.metrics["update_spilled"],
                           out_b.metrics["update_spilled"])
        assert torch.equal(out_a.metrics["updated_particles"],
                           out_b.metrics["updated_particles"])
        spilled.append(int(out_b.metrics["update_spilled"]))
    assert max(spilled) > 0, spilled
    graphed.release()
