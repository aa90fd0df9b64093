"""``make_step``'s options against the JAX package's on the small
flagship configuration of ``tests/torch_parity.py``, pool and compact
layout (CPU): ``with_metrics=False`` returns ``alive`` alone,
``admission_control=False`` runs a frame that admission control would
reject and still reports it as not accepted, ``shard`` takes a
``ShardCtx`` and nothing else (the sharded step itself:
``tests/test_torch_shard_*.py``).

The JAX step is built with both options off and run from a random-init
state (``init_state(init_particle_num=...)``) over the street sequence,
the last frame with its quaternion doubled; each frame goes through the
port's step from the JAX state before it with the JAX draws, held to the
teacher-forced bars of ``torch_parity.check_frame`` for a free newborn
weight (the step without metrics reports none to pin)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from torch_parity import KW, PLANES, check_frame, jax_draws

torch.set_num_threads(2)

N_FRAMES = 2


def _cfgs(layout):
    return (J.example_node_settings(J.dsp_dynamic(**KW, layout=layout)),
            T.example_node_settings(T.dsp_dynamic(**KW, layout=layout)))


@pytest.fixture(scope="module", params=["pool", "compact"])
def lean_run(request):
    """``(layout, recorded frames)`` of the JAX step without metrics and
    without admission control; the last frame's quaternion is doubled."""
    jcfg, _ = _cfgs(request.param)
    step = jax.jit(J.make_step(jcfg, with_metrics=False,
                               admission_control=False))
    state = J.init_state(jcfg, jax.random.key(1), init_particle_num=2000)
    frames = []
    seq = list(J.utils.sim.generate_sequence(N_FRAMES, jcfg, seed=7))
    for i, (pts, n, pos, quat, t) in enumerate(seq):
        if i == N_FRAMES - 1:
            quat = quat * np.float32(2.0)
        before = jax.device_get(state)
        draws = jax_draws(state.rng, jcfg)
        state, out = step(state, J.Frame(jnp.asarray(pts), jnp.int32(n),
                                         jnp.asarray(pos), jnp.asarray(quat),
                                         jnp.asarray(t)))
        frames.append(dict(
            before=before, draws=draws, frame=(pts, n, pos, quat, t),
            after=jax.device_get(state), accepted=bool(out.accepted),
            metrics={k: np.asarray(v) for k, v in out.metrics.items()}))
    return request.param, frames


def test_step_without_metrics_or_admission_matches_jax(lean_run):
    layout, frames = lean_run
    _, tcfg = _cfgs(layout)
    step = T.make_step(tcfg, with_metrics=False, admission_control=False)
    full = T.make_step(tcfg)
    assert [f["accepted"] for f in frames] == [True] * (N_FRAMES - 1) + [False]
    for i, f in enumerate(frames):
        state = T.state_from_numpy(f["before"], tcfg, device="cpu")
        new, out = step(state, T.Frame(*f["frame"]), f["draws"])
        assert set(out.metrics) == {"alive"} == set(f["metrics"])
        check_frame(i, new, out, f, pinned=False)
        assert int(out.metrics["alive"]) > 0
        if f["accepted"]:
            # the metrics alone differ from the full step's
            ref, ref_out = full(state, T.Frame(*f["frame"]), f["draws"])
            assert len(ref_out.metrics) > 1
            assert torch.equal(out.metrics["alive"], ref_out.metrics["alive"])
            for n in PLANES:
                assert torch.equal(getattr(new.particles, n),
                                   getattr(ref.particles, n)), n
    # the doubled quaternion was stepped: the map moved on
    assert new is not state and new.update_counter == state.update_counter + 1


def test_rejected_frame_without_metrics(lean_run):
    """With admission control on (the default) the same frame is rejected:
    the state comes back unchanged, the metrics hold ``alive`` alone."""
    layout, frames = lean_run
    _, tcfg = _cfgs(layout)
    f = frames[-1]
    state = T.state_from_numpy(f["before"], tcfg, device="cpu")
    new, out = T.make_step(tcfg, with_metrics=False)(
        state, T.Frame(*f["frame"]), f["draws"])
    assert not out.accepted and new is state
    assert set(out.metrics) == {"alive"} and int(out.metrics["alive"]) == 0


def test_sharded_step_is_not_ported():
    """The sharded step is ported (``parallel``): ``shard`` must be a
    ``ShardCtx``; anything else is refused when the step is built."""
    _, tcfg = _cfgs("pool")
    with pytest.raises(TypeError, match="ShardCtx"):
        T.make_step(tcfg, shard=object())


def test_sharded_multisensor_step_takes_a_shard_ctx_only():
    """``make_multisensor_step``'s ``shard`` is a ``ShardCtx`` too; anything
    else is refused when the step is built."""
    _, tcfg = _cfgs("pool")
    with pytest.raises(TypeError, match="ShardCtx"):
        T.make_multisensor_step(tcfg, 2, shard=object())
