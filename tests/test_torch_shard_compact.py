"""The sharded step on the compact layout (``rebin_exchange_compact``) on 4
gloo ranks, on ``tests/test_compact_shard.py``'s configurations and frames.

* The behavioural band of ``test_shardmap_compact_behavioral_band``, for
  both mover exchanges: six frames of the port's sharded step, with the
  JAX single-device step's draws, against the JAX single-device step and
  against the port's own -- alive within max(10, 5%), total occupancy
  weight within max(0.5, 5%) -- and the ownership invariant: every live
  row of rank r's block of rows lies in rank r's slab.
* ``test_shardmap_compact_multi_neighbor_variant``: the multi-neighbor
  preset (1-degree pyramids, a 25-cell neighborhood) runs four frames with
  the port's own draws and keeps particles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu_torch.utils import sim
from test_compact_shard import cfg_compact
from torch_parity import _sensor_draws, port_cfg, port_result
from torch_shard import N_RANKS, run_ranks, tree

torch.set_num_threads(2)

EXCHANGES = ("all_gather", "ring")
N_FRAMES = 6


def _multi_cfg():
    return port_cfg(J.example_node_settings(J.dsp_dynamic_multi_neighbors(
        nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=512,
        mover_capacity=4096, pyramid_slot_capacity=64, max_clusters=8,
        layout="compact", particle_capacity=16384)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = cfg_compact()
    seq = list(sim.generate_sequence(N_FRAMES, jcfg, seed=0, speed=0.5))
    step = jax.jit(J.make_step(jcfg))
    state = J.init_state(jcfg, jax.random.key(0))
    init = tree(jax.device_get(state))
    draws = []
    for pts, n, pos, quat, t in seq:
        keys = jax.random.split(state.rng, 6)
        draws.append((_sensor_draws(keys[0], keys[3], jcfg), None))
        state, out = step(state, J.Frame(jnp.asarray(pts), jnp.int32(n),
                                         jnp.asarray(pos), jnp.asarray(quat),
                                         jnp.asarray(t)))
    jax_out = (int(out.metrics["alive"]), float(jnp.sum(out.weight_sum)))
    # the port's one-device step (the mover exchange plays no part there)
    tcfg = port_cfg(jcfg)
    s, tstep = T.state_from_numpy(init, tcfg, device="cpu"), T.make_step(tcfg)
    for f, d in zip(seq, draws):
        s, o = tstep(s, T.Frame(*f), d[0])
    single = (int(o.metrics["alive"]), float(s.weight_sum.sum()))
    cases = [dict(kind="steps", cfg=port_cfg(cfg_compact(mover_exchange=e)),
                  init=init, frames=seq, draws=draws, keep=[N_FRAMES - 1])
             for e in EXCHANGES]
    mcfg = _multi_cfg()
    cases.append(dict(kind="steps", cfg=mcfg,
                      init=tree(T.state_to_numpy(T.init_state(mcfg,
                                                              device="cpu"))),
                      frames=list(sim.generate_sequence(4, mcfg, seed=0,
                                                        speed=0.5))))
    got = run_ranks(cases, tmp_path_factory.mktemp("ranks"))
    return dict(jax=jax_out, single=single,
                sharded={e: got[0][k][-1] for k, e in enumerate(EXCHANGES)},
                multi=got[0][-1])


def _within_band(ref, got):
    (a0, w0), (a1, w1) = ref, got
    assert abs(a0 - a1) <= max(10, 0.05 * a0), (a0, a1)
    assert abs(w0 - w1) <= max(0.5, 0.05 * w0), (w0, w1)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_sharded_compact_behavioral_band(runs, exchange):
    tcfg = port_cfg(cfg_compact(mover_exchange=exchange))
    state, out = port_result(tcfg, runs["sharded"][exchange])
    got = (int(out.metrics["alive"]), float(state.weight_sum.sum()))
    assert got[0] > 0
    _within_band(runs["jax"], got)
    _within_band(runs["single"], got)

    # ownership invariant: every live row's cell lies in its rank's slab
    p = state.particles
    p_loc = tcfg.compact_capacity // N_RANKS
    v_loc = tcfg.storage_voxels // N_RANKS
    wv = np.floor(np.stack([p.px.numpy(), p.py.numpy(), p.pz.numpy()], -1)
                  / np.float32(tcfg.voxel_resolution)).astype(np.int64)
    cells = ((wv[:, 2] % tcfg.nz) * tcfg.ny + wv[:, 1] % tcfg.ny) * tcfg.nx \
        + wv[:, 0] % tcfg.nx
    flags = p.flags.numpy()
    for r in range(N_RANKS):
        rows = slice(r * p_loc, (r + 1) * p_loc)
        live = flags[rows] != 0
        assert live.any(), r
        assert (cells[rows][live] // v_loc == r).all(), r


def test_sharded_compact_multi_neighbor_variant(runs):
    state, out = port_result(_multi_cfg(), runs["multi"][-1])
    assert out.accepted
    assert int(out.metrics["alive"]) > 0
    assert torch.isfinite(state.weight_sum).all()
