"""The multi-neighbor preset's step of the port against the JAX package's
(CPU): ``example_node_settings(dsp_dynamic_multi_neighbors(...))`` on the
24x24x12 map at 0.25 m of ``tests/torch_parity.py::KW`` -- S = 60 slots,
4536 one-degree pyramid cells, 25 neighbour cells, dense tiers 16 of 72
particle slots and 16 of 100 observation slots, so the pair passes run at
(4536, 16, 400) and all three spill blocks of the update are compiled in.

* teacher-forced against the jitted JAX step for 8 frames with the JAX
  draws injected, newborn weight pinned and free, at the bars of
  ``tests/test_torch_step.py``;
  (``tests/test_torch_presets_relayout.py`` repeats it with both dense
  tiers cut to 2, which fills the spill tiers with data);
* the flat mid-frame phase: with ``state._DMA_RELAYOUT_BYTES`` set to 0
  every pool plane goes through one ``to_flat_many`` call into a working
  buffer that the scatters write in place; the pool pass reads those
  buffers as views, and the one plane it hands through comes back through
  ``from_flat_many``.  One frame that way equals the same frame without it
  bit for bit, plane by plane, and leaves the input state's tensors as
  they were.
"""

import jax
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu_torch import kernels, state as tstate
from dspmap_tpu_torch.ops import relayout
from torch_parity import PLANES, preset_configs, record, teacher_forced

torch.set_num_threads(2)

N_FRAMES = 8


def _record(**overrides):
    jcfg, tcfg = preset_configs("multi", **overrides)
    step = jax.jit(J.make_step(jcfg))
    frames, _ = record(jcfg, step, J.init_state(jcfg, jax.random.key(0)),
                       n_frames=N_FRAMES)
    return tcfg, frames


@pytest.fixture(scope="module")
def multi_run():
    tcfg, frames = _record()
    assert (tcfg.slots_per_voxel, tcfg.n_pyramids, tcfg.neighbor_cells,
            tcfg.dense_slots, tcfg.pyramid_slots, tcfg.obs_dense,
            tcfg.max_obs_points_per_pyramid) == (60, 4536, 25, 16, 72, 16, 100)
    assert tcfg.obs_dense * tcfg.neighbor_cells == 400
    return tcfg, frames


@pytest.mark.parametrize("pinned", [True, False],
                         ids=["newborn_weight_pinned", "free_newborn_weight"])
def test_multi_step_matches_jax(multi_run, monkeypatch, pinned):
    tcfg, frames = multi_run
    fracs = teacher_forced(frames, tcfg, monkeypatch, pinned)
    assert np.mean(fracs) >= 0.999, fracs
    last = frames[-1]["metrics"]
    assert int(last["born"]) > 0 and int(last["updated_particles"]) > 0
    assert int(last["movers"]) > 0 and int(last["future_moving"]) > 0


def test_flat_phase_frame_is_bit_equal_and_leaves_its_input(multi_run,
                                                            monkeypatch):
    tcfg, frames = multi_run
    f = frames[-1]
    step = T.make_step(tcfg)
    calls = {"to_flat_many": [], "from_flat_many": []}  # planes of each call

    def counted(name):
        orig = getattr(relayout, name)

        def fn(planes, *a):
            calls[name].append(len(planes))
            return orig(planes, *a)
        return fn

    for name in calls:
        monkeypatch.setattr(relayout, name, counted(name))

    plain_state = T.state_from_numpy(f["before"], tcfg, device="cpu")
    want, want_out = step(plain_state, T.Frame(*f["frame"]), f["draws"])
    # 1.7 MB planes: views
    assert calls == {"to_flat_many": [], "from_flat_many": []}

    monkeypatch.setattr(tstate, "_DMA_RELAYOUT_BYTES", 0)
    state = T.state_from_numpy(f["before"], tcfg, device="cpu")
    kept = {n: getattr(state.particles, n) for n in PLANES}
    snapshot = {n: t.clone() for n, t in kept.items()}
    n0 = dict(kernels.LAUNCHES)
    got, got_out = step(state, T.Frame(*f["frame"]), f["draws"])
    # flags, px, py, pz, vx, vy and weight are copied in by one call; vz is
    # made anew as zeros and t is skipped; the pool pass reads the seven as
    # views and writes them anew, and vz, which it hands through, is
    # copied back out
    assert calls == {"to_flat_many": [7], "from_flat_many": [1]}
    assert kernels.LAUNCHES == n0  # CPU tensors launch no kernel

    S, V = tcfg.slots_per_voxel, tcfg.storage_voxels
    for n in PLANES:
        a, b = getattr(got.particles, n), getattr(want.particles, n)
        assert a.shape == (S, V) and torch.equal(a, b), n
        assert torch.equal(kept[n], snapshot[n]), n  # the input is untouched
        if n != "t":  # fresh planes of the exact size, no padded buffer
            assert a.untyped_storage().nbytes() == S * V * 4, n
            assert a.data_ptr() != kept[n].data_ptr(), n
    for n in ("weight_sum", "vel_avg", "future"):
        assert torch.equal(getattr(got, n), getattr(want, n)), n
    for k, v in want_out.metrics.items():
        assert torch.equal(got_out.metrics[k], v), k
    assert int(want_out.metrics["movers"]) > 0
    assert int(want_out.metrics["born"]) > 0
    assert int(want_out.metrics["updated_particles"]) > 0
