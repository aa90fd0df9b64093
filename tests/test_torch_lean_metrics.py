"""``make_step(cfg, with_metrics=False)`` does less work than the full
step and gives the same state (CPU): the stages skip the reductions that
only the dropped counters read, as the JAX step leaves them to its
compiler.

One frame from the same state with the same draws, through the full step
and the lean one, each under a ``TorchDispatchMode`` that counts the aten
ops it runs: the lean step runs fewer, its state equals the full step's
bit for bit, and its metrics are ``{"alive"}`` with the full step's
value.  Pool and compact layouts, and the noisy pool arm (``rebin`` and
``register_fov`` on ``[S, V]`` planes); the JAX comparison of the lean
step is ``tests/test_torch_step_options.py``'s."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dspmap_tpu_torch as T
from dspmap_tpu_torch.utils import sim
from dspmap_tpu_torch.utils.parity import differing_leaves
from torch_parity import KW

torch.set_num_threads(2)

ARMS = {
    "pool": {},
    "compact": dict(layout="compact"),
    "noisy": dict(limit_motion_to_xy_plane=False),
}


class _CountOps(TorchDispatchMode):
    """Counts the aten ops run inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_step_without_metrics_runs_fewer_ops_and_the_same_state(arm):
    cfg = T.example_node_settings(T.dsp_dynamic(**KW, **ARMS[arm]))
    frames = [T.Frame(*f) for f in sim.generate_sequence(3, cfg, seed=7)]
    state = T.init_state(cfg, seed=1, device="cpu", init_particle_num=2000)
    full, lean = T.make_step(cfg), T.make_step(cfg, with_metrics=False)
    for f in frames[:2]:
        state, out = full(state, f)
        assert out.accepted
    gen = torch.Generator()
    gen.manual_seed(3)
    draws = T.make_draws(cfg, gen, "cpu")
    runs = {}
    for name, step in (("full", full), ("lean", lean)):
        with _CountOps() as ops:
            runs[name] = step(state, frames[2], draws)
        runs[name] += (ops.n,)
    (s_full, out_full, n_full), (s_lean, out_lean, n_lean) = (
        runs["full"], runs["lean"])
    assert n_lean < n_full, (n_lean, n_full)
    assert not differing_leaves(s_lean, s_full)
    assert set(out_lean.metrics) == {"alive"}
    assert len(out_full.metrics) > 20
    assert int(out_lean.metrics["alive"]) == int(out_full.metrics["alive"]) > 0
    assert int(out_full.metrics["updated_particles"]) > 0
    assert torch.equal(out_lean.weight_sum, out_full.weight_sum)
