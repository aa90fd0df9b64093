"""Movers between slabs on the compact layout, port against the JAX
package, on 4 gloo ranks against 4 of the virtual CPU devices.

* ``test_ring_exchange_kills_beyond_hops_movers`` as
  ``tests/test_compact_shard.py`` writes it: one particle in slab 0 moves
  eight z-rows (two slabs) in a frame.  The ring exchange of one hop
  cannot deliver it and kills and counts it; the ``all_gather`` exchange
  delivers it; the ring run ends with one particle fewer.  The port's
  counts are JAX's, the sharded step given the JAX draws.
* ``rebin_exchange_compact`` alone, after ``sweep_compact``, on a state
  with movers across slabs and free rows whose ``t`` is marked: every
  plane of every rank's rows bit-equal to the JAX stage's under
  ``shard_map``, and the stats equal.  With ``record_particle_time`` the
  arrivals keep the ``t`` of the free row they land in: the exchange
  carries no ``t`` (a defect of the JAX package that the port keeps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import dspmap_tpu as J
from dspmap_tpu import geometry
from dspmap_tpu.utils import sim
from torch_parity import PLANES, port_cfg, port_result, record_shardmap
from torch_shard import N_RANKS, run_ranks, tree

torch.set_num_threads(2)

EXCHANGES = ("ring", "all_gather")


def _ring_cfg(**kw):
    """``test_ring_exchange_kills_beyond_hops_movers``'s configuration."""
    base = dict(nx=16, ny=16, nz=16, voxel_resolution=0.25,
                max_input_points=256, mover_capacity=1024,
                pyramid_slot_capacity=32, max_clusters=8, layout="compact",
                particle_capacity=4096, limit_motion_to_xy_plane=False,
                mover_exchange="ring", ring_hops=1, estimator_enabled=False)
    return J.example_node_settings(J.dsp_dynamic(**{**base, **kw}))


def _seeded_state(cfg, seq):
    """``test_ring_exchange_kills_beyond_hops_movers``'s state: row 0 (slab
    0's first row) holds a particle at a window z-row of slab 0 moving +8
    z-rows in a 0.1 s frame."""
    origin = np.asarray(geometry.window_origin(jnp.asarray(seq[0][2]), cfg))
    rel_z = next(r for r in range(8)
                 if ((origin[2] + r) % cfg.nz) // 4 == 0)
    state = J.init_state(cfg, jax.random.key(0))
    p = {k: np.asarray(getattr(state.particles, k)).copy()
         for k in ("flags", "px", "py", "pz", "vz", "weight")}
    p["flags"][0] = 1
    p["px"][0] = (origin[0] + 8.5) * cfg.voxel_resolution
    p["py"][0] = (origin[1] + 8.5) * cfg.voxel_resolution
    p["pz"][0] = (origin[2] + rel_z + 0.5) * cfg.voxel_resolution
    p["vz"][0] = 8 * cfg.voxel_resolution / 0.1
    p["weight"][0] = 5.0
    return dataclasses.replace(state, particles=dataclasses.replace(
        state.particles, **{k: jnp.asarray(v) for k, v in p.items()}))


def _exchange_input(cfg):
    """A compact state of scattered stayers and, in slab 0, movers bound
    one, two and three slabs up (and one within the slab), with every
    row's ``t`` marked by its index; the frame's pose and time step."""
    rng = np.random.default_rng(3)
    Pn, res = cfg.compact_capacity, cfg.voxel_resolution
    a = {k: np.zeros(Pn, np.float32) for k in PLANES}
    a["flags"] = np.zeros(Pn, np.int32)
    a["t"] = np.arange(Pn, dtype=np.float32) * np.float32(0.5)
    sensor = np.asarray([0.1, -0.2, 2.0], np.float32)
    origin = np.asarray(geometry.window_origin(jnp.asarray(sensor), cfg))
    p_loc = Pn // N_RANKS
    for r in range(N_RANKS):  # stayers: 40 in each slab, z-rows of slab r
        rows = r * p_loc + np.arange(40)
        z = (4 * r + rng.integers(0, 4, 40) - origin[2]) % cfg.nz + origin[2]
        a["flags"][rows] = 1
        a["px"][rows] = (origin[0] + rng.integers(0, cfg.nx, 40) + 0.5) * res
        a["py"][rows] = (origin[1] + rng.integers(0, cfg.ny, 40) + 0.5) * res
        a["pz"][rows] = (z + 0.5) * res
        a["weight"][rows] = rng.uniform(0.01, 1.0, 40)
    z0 = (0 - origin[2]) % cfg.nz + origin[2]  # storage z-row 0: slab 0
    for k, rows_up in enumerate((4, 8, 12, 1) * 3):
        row = 40 + k
        a["flags"][row] = 1
        a["px"][row] = (origin[0] + 2 + k + 0.5) * res
        a["py"][row] = (origin[1] + 3 + 0.5) * res
        a["pz"][row] = (z0 + 0.5) * res
        a["vz"][row] = rows_up * res / 0.1
        a["weight"][row] = 0.5 + k
    return a, dict(dt=np.float32(0.1), origin=origin, sensor_pos=sensor,
                   quat=np.asarray([1, 0, 0, 0], np.float32))


def _jax_exchange(cfg, a, frame):
    """The JAX package's ``sweep_compact`` + ``rebin_exchange_compact``
    under ``shard_map`` on 4 devices: the new rows and each shard's stats
    (``[n]`` per stat)."""
    from dspmap_tpu.ops.common import ShardCtx
    from dspmap_tpu.ops.compact import rebin_exchange_compact, sweep_compact
    from dspmap_tpu.parallel import make_mesh

    v_local = cfg.storage_voxels // N_RANKS

    def body(p):
        lo = jax.lax.axis_index("map").astype(jnp.int32) * v_local
        shard = ShardCtx(axis="map", n_shards=N_RANKS, lo=lo)
        p, sw = sweep_compact(p, cfg, frame["dt"],
                              jnp.asarray(frame["origin"]),
                              jnp.asarray(frame["sensor_pos"]),
                              jnp.asarray(frame["quat"]), jax.random.key(1))
        new, stats = rebin_exchange_compact(p, sw, cfg, shard)
        return new, {k: v[None] for k, v in stats.items()}

    fn = jax.jit(jax.shard_map(body, mesh=make_mesh(N_RANKS),
                               in_specs=(P("map"),),
                               out_specs=(P("map"), P("map")),
                               check_vma=False))
    new, stats = fn(J.Particles(**{k: jnp.asarray(v) for k, v in a.items()}))
    return ({k: np.asarray(getattr(new, k)) for k in PLANES},
            {k: np.asarray(v) for k, v in stats.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, jax_runs = [], {}
    for exchange in EXCHANGES:
        jcfg = _ring_cfg(mover_exchange=exchange)
        seq = list(sim.generate_sequence(2, jcfg, seed=0, speed=0.0))
        frames = record_shardmap(jcfg, N_RANKS, _seeded_state(jcfg, seq), seq)
        jax_runs[exchange] = frames
        cases.append(dict(kind="steps", cfg=port_cfg(jcfg),
                          init=tree(frames[0]["before"]),
                          frames=[f["frame"] for f in frames],
                          draws=[f["draws"] for f in frames]))
    xcfg = _ring_cfg(mover_exchange="all_gather", velocity_noise_std=0.0,
                     record_particle_time=True)
    a, frame = _exchange_input(xcfg)
    zero = np.zeros((N_RANKS, 3, xcfg.compact_capacity // N_RANKS),
                    np.float32)
    cases.append(dict(kind="rebin_exchange", cfg=port_cfg(xcfg), particles=a,
                      noise=zero, **frame))
    got = run_ranks(cases, tmp_path_factory.mktemp("ranks"))
    return dict(jax=jax_runs, port={e: got[0][k] for k, e in
                                    enumerate(EXCHANGES)},
                exchange=([r[-1] for r in got], _jax_exchange(xcfg, a, frame),
                          a, xcfg))


def _counts(frames_or_result, port):
    if port:
        _, metrics, _ = frames_or_result[-1]
    else:
        metrics = frames_or_result[-1]["metrics"]
    return dict(killed=int(metrics["mover_overflow_killed"]),
                alive=int(metrics["alive"]))


def test_ring_exchange_kills_beyond_hops_movers(runs):
    results = {e: _counts(runs["port"][e], True) for e in EXCHANGES}
    # ring: the 2-slab mover is undeliverable -> killed and counted
    assert results["ring"]["killed"] >= 1, results
    # all_gather: the same mover is delivered (no overflow kill)
    assert results["all_gather"]["killed"] == 0, results
    # and the ring run holds one fewer live particle than the all_gather run
    assert results["all_gather"]["alive"] == results["ring"]["alive"] + 1, \
        results
    # the JAX package's counts, exactly
    assert results == {e: _counts(runs["jax"][e], False) for e in EXCHANGES}


def test_ring_exchange_state_matches_jax(runs):
    """The gathered state after the second frame: flags equal to the JAX
    sharded step's, weights within rtol 1e-5."""
    for e in EXCHANGES:
        jcfg = _ring_cfg(mover_exchange=e)
        state, _ = port_result(port_cfg(jcfg), runs["port"][e][-1])
        want = runs["jax"][e][-1]["after"]
        np.testing.assert_array_equal(state.particles.flags.numpy(),
                                      np.asarray(want.particles.flags))
        np.testing.assert_allclose(state.weight_sum.numpy(),
                                   np.asarray(want.weight_sum), rtol=1e-5,
                                   atol=1e-7)


def test_rebin_exchange_compact_matches_jax_and_keeps_stale_t(runs):
    by_rank, (want, want_stats), before, cfg = runs["exchange"]
    for k in PLANES:
        got = np.concatenate([r[0][k] for r in by_rank])
        np.testing.assert_array_equal(got.view(np.int32),
                                      want[k].view(np.int32), err_msg=k)
    for r, (_, stats) in enumerate(by_rank):
        assert stats == {k: int(v[r]) for k, v in want_stats.items()}, r
    p_loc = cfg.compact_capacity // N_RANKS
    flags = np.concatenate([r[0]["flags"] for r in by_rank])
    landed = (flags != 0) & (before["flags"] == 0)
    # arrivals landed in slabs 1, 2 and 3, in rows that were free
    assert {int(i) // p_loc for i in np.nonzero(landed)[0]} == {1, 2, 3}
    # ... and kept those rows' marked t: the exchange carries no t
    t = np.concatenate([r[0]["t"] for r in by_rank])
    np.testing.assert_array_equal(t[landed], before["t"][landed])
    assert sum(s["movers"] for _, s in by_rank) == 12
