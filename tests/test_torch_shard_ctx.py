"""The pieces of the port's map parallelism on 4 gloo ranks, against the
JAX package's where it has them: ``ShardCtx`` (``gather_flat`` in rank
order, ``gather_ring`` by both transports against JAX's under
``shard_map``, ``ring_reachable`` and ``owns`` against JAX's, the packed
``exchange``, ``psum``), ``state_shardings`` against JAX's specs leaf by
leaf, the ``shard_state`` / ``gather_state`` round trip, the layout
``make_sharded_step`` pins over chained steps, the per-rank draws of
``make_draws``, and ``sweep_reference`` on a slab (``cell_base``) against
JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu_torch.parallel import distributed, make_mesh, state_shardings
from dspmap_tpu_torch.utils import sim
from test_shard_step import cfg_for
from torch_parity import PLANES, both, occupancy_pool, port_cfg
from torch_shard import N_RANKS, run_ranks, tree

torch.set_num_threads(2)

V_LOCAL = 1024
CELLS = np.arange(-1, N_RANKS * V_LOCAL + 2, 37, dtype=np.int32)


def _layout_cfg(layout):
    return port_cfg(dataclasses.replace(
        cfg_for(N_RANKS), layout=layout, particle_capacity=8192,
        limit_motion_to_xy_plane=layout == "compact"))


def _by_slab(state, tcfg):
    """A compact state with each rank's particles moved into its block of
    rows (the row layout ``shard_state`` takes, as the JAX package's)."""
    a = state["particles"]
    res = np.float32(tcfg.voxel_resolution)
    wv = [np.floor(a[k] / res).astype(np.int64) for k in ("px", "py", "pz")]
    cell = ((wv[2] % tcfg.nz) * tcfg.ny + wv[1] % tcfg.ny) * tcfg.nx \
        + wv[0] % tcfg.nx
    owner = cell // (tcfg.storage_voxels // N_RANKS)
    p_loc = tcfg.compact_capacity // N_RANKS
    order = []
    for r in range(N_RANKS):
        rows = np.nonzero((a["flags"] != 0) & (owner == r))[0]
        assert rows.size <= p_loc
        free = np.nonzero(a["flags"] == 0)[0][:p_loc - rows.size]
        order.append(np.concatenate([rows, free]))
    order = np.concatenate(order)
    state["particles"] = {k: v[order] for k, v in a.items()}
    return state


def _layout_case(layout):
    tcfg = _layout_cfg(layout)
    state = T.state_to_numpy(T.init_state(
        tcfg, seed=3, init_particle_num=3000, init_weight=0.05, device="cpu"))
    if layout == "compact":
        state = _by_slab(state, tcfg)
    return dict(kind="layout", cfg=tcfg, init=tree(state),
                frames=list(sim.generate_sequence(3, tcfg, seed=5)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [dict(kind="ctx", v_local=V_LOCAL, cells=CELLS),
             _layout_case("pool"), _layout_case("compact")]
    return run_ranks(cases, tmp_path_factory.mktemp("ranks"))


def _rank_x(r):
    return np.arange(6, dtype=np.int32) + 100 * r


def test_gather_flat_is_in_rank_order(ranks):
    want = np.concatenate([_rank_x(r) for r in range(N_RANKS)])
    for r in range(N_RANKS):
        np.testing.assert_array_equal(ranks[r][0]["flat"], want)
        np.testing.assert_array_equal(ranks[r][0]["psum"], [6, N_RANKS])


@pytest.fixture(scope="module")
def jax_ring():
    from dspmap_tpu.ops.common import ShardCtx
    from dspmap_tpu.parallel import make_mesh as jmesh

    def body(x):
        lo = jax.lax.axis_index("map").astype(jnp.int32) * V_LOCAL
        return ShardCtx("map", N_RANKS, lo).gather_ring(x, 1)

    fn = jax.jit(jax.shard_map(body, mesh=jmesh(N_RANKS), in_specs=P("map"),
                               out_specs=P("map"), check_vma=False))
    got = np.asarray(fn(jnp.asarray(np.concatenate(
        [_rank_x(r) for r in range(N_RANKS)]))))
    # at n = 4 JAX clamps hops to (n-1)//2 = 1, so hops 2 gives the same
    return {1: got.reshape(N_RANKS, -1), 2: got.reshape(N_RANKS, -1)}


@pytest.mark.parametrize("hops", [1, 2])
def test_gather_ring_both_transports_match_jax(ranks, jax_ring, hops):
    """Both transports deliver JAX's ``gather_ring`` (``ppermute``) result
    on every rank, for hops 1 and 2 (clamped to (n-1)//2 = 1 at n = 4)."""
    for r in range(N_RANKS):
        ring = ranks[r][0]["ring"]
        np.testing.assert_array_equal(ring[("p2p", hops)],
                                      ring[("all_gather", hops)])
        np.testing.assert_array_equal(ring[("p2p", hops)], jax_ring[hops][r])
    # rank 0: itself, then rank 3 (r - 1) and rank 1 (r + 1)
    np.testing.assert_array_equal(
        ranks[0][0]["ring"][("p2p", hops)],
        np.concatenate([_rank_x(0), _rank_x(3), _rank_x(1)]))


def test_ring_reachable_and_owns_match_jax(ranks):
    from dspmap_tpu.ops.common import ShardCtx

    for r in range(N_RANKS):
        j = ShardCtx("map", N_RANKS, jnp.int32(r * V_LOCAL))
        got = ranks[r][0]
        for h in (1, 2):
            np.testing.assert_array_equal(
                got["reach"][h],
                np.asarray(j.ring_reachable(jnp.asarray(CELLS), V_LOCAL, h)))
        np.testing.assert_array_equal(
            got["owns"], np.asarray(j.owns(jnp.asarray(CELLS), V_LOCAL)))
        assert got["reach"][1].any() and not got["reach"][1].all()


def test_exchange_packs_columns_exactly(ranks):
    """Float, integer and bool columns through one exchange: each comes
    back in its dtype, bit for bit, in rank order (the ring form: the
    rank's own, then r - 1, then r + 1)."""
    for r in range(N_RANKS):
        f = [np.linspace(0, 1, 6, dtype=np.float32) + np.float32(k)
             for k in range(N_RANKS)]
        x = [_rank_x(k) for k in range(N_RANKS)]
        b = [(np.arange(6) % (k + 2)) == 0 for k in range(N_RANKS)]
        got = ranks[r][0]["exchange"]
        for g, w in zip(got, (f, x, b)):
            assert g.dtype == w[0].dtype
            np.testing.assert_array_equal(g, np.concatenate(w))
        order = [r, (r - 1) % N_RANKS, (r + 1) % N_RANKS]
        for g, w in zip(ranks[r][0]["exchange_ring"], (f, x, b)):
            np.testing.assert_array_equal(g, np.concatenate([w[k]
                                                             for k in order]))


def _jax_axes(jstate):
    """JAX's ``state_shardings`` as ``{path: axis or None}``."""
    from dspmap_tpu.parallel import make_mesh as jmesh
    from dspmap_tpu.parallel import state_shardings as jshardings

    specs = jshardings(jmesh(N_RANKS), jstate)
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(specs):
        name = ".".join(str(getattr(k, "name", getattr(k, "key", k)))
                        for k in path)
        spec = tuple(s.spec)
        out[name] = spec.index("map") if "map" in spec else None
    return out


@pytest.mark.parametrize("kind", ["pool", "compact", "two_sensor"])
def test_state_shardings_match_jax(kind):
    jcfg = dataclasses.replace(cfg_for(N_RANKS), particle_capacity=8192,
                               layout="compact" if kind == "compact"
                               else "pool")
    tcfg = port_cfg(jcfg)
    if kind == "two_sensor":
        from dspmap_tpu.models.pipeline import init_multisensor_state

        jstate = init_multisensor_state(jcfg, 2, jax.random.key(0))
        tstate = T.init_multisensor_state(tcfg, 2, device="cpu")
    else:
        jstate = J.init_state(jcfg, jax.random.key(0))
        tstate = T.init_state(tcfg, device="cpu")
    want = _jax_axes(jstate)
    got = state_shardings(tstate)
    assert set(got) == set(want) - {"rng"} - {k for k in want
                                               if k.startswith("params.")}
    for k, axis in got.items():
        assert axis == want[k], k
    split = {k for k, a in got.items() if a is not None}
    assert split == {f"particles.{p}" for p in PLANES} | {
        "weight_sum", "vel_avg", "future"}


@pytest.mark.parametrize("layout", ["pool", "compact"])
def test_shard_and_gather_state_round_trip(ranks, layout):
    """``gather_state(shard_state(s))`` is ``s`` bit for bit on every rank,
    and each rank's particle planes have the slab's shape."""
    res = [r[1 + ("pool", "compact").index(layout)] for r in ranks]
    want = T.state_to_numpy(T.state_from_numpy(
        _layout_case(layout)["init"], _layout_cfg(layout), device="cpu"))
    tcfg = _layout_cfg(layout)
    slab = ((tcfg.compact_capacity // N_RANKS,) if layout == "compact" else
            (tcfg.slots_per_voxel, tcfg.storage_voxels // N_RANKS))
    for r in range(N_RANKS):
        back = res[r]["back"]
        for k in PLANES:
            np.testing.assert_array_equal(back["particles"][k],
                                          want["particles"][k], err_msg=k)
        for k in ("weight_sum", "vel_avg", "future", "origin",
                  "update_counter"):
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)
        assert set(res[r]["slab_shapes"].values()) == {slab}
    assert int((want["particles"]["flags"] != 0).sum()) > 1000


@pytest.mark.parametrize("layout", ["pool", "compact"])
def test_make_sharded_step_pins_the_slab_layout(ranks, layout):
    """Three chained frames of ``make_sharded_step``: bit-equal to
    ``make_shardmap_step``'s, every split leaf at the slab's shape in
    every frame; a whole state is refused."""
    tcfg = _layout_cfg(layout)
    v = tcfg.storage_voxels // N_RANKS
    flags = ((tcfg.compact_capacity // N_RANKS,) if layout == "compact"
             else (tcfg.slots_per_voxel, v))
    for r in range(N_RANKS):
        res = ranks[r][1 + ("pool", "compact").index(layout)]
        for same, alive, shapes, axes in res["chain"]:
            assert same and alive > 0
            assert shapes == {"flags": flags, "weight_sum": (v,),
                              "future": (tcfg.n_horizons, v),
                              "vel_avg": (v, 3)}
            assert axes["particles.flags"] == len(flags) - 1
        assert "step input" in res["refused"]


def test_make_draws_per_rank(ranks):
    """On the noisy arm: the four replicated draws are the same on every
    rank, the two pool-shaped ones are the rank's own, at the slab's
    shape; the same generator state gives the same draws."""
    tcfg = _layout_cfg("pool")
    draws = [ranks[r][1]["draws"] for r in range(N_RANKS)]
    assert all(ranks[r][1]["draws_again"] for r in range(N_RANKS))
    slab = (tcfg.slots_per_voxel, tcfg.storage_voxels // N_RANKS)
    for r in range(1, N_RANKS):
        for k in range(4):
            np.testing.assert_array_equal(draws[r][k], draws[0][k])
        for k, m in ((4, 3), (5, 2)):
            assert draws[r][k].shape == (m,) + slab
            assert not np.array_equal(draws[r][k], draws[0][k])


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "limit_xy"])
def test_make_multisensor_draws_per_rank(noisy):
    """``make_multisensor_draws(..., shard=)`` for each of four ranks from
    one generator state: each camera's four draws the same on every rank;
    on the noisy arm the propagation noise and each camera's FOV noise the
    rank's own at the slab's shape (none under limit-xy, where the draws
    are the unsharded step's); the same state gives the same draws."""
    from dspmap_tpu_torch.ops.common import ShardCtx

    tcfg = dataclasses.replace(_layout_cfg("pool"),
                               limit_motion_to_xy_plane=not noisy)
    v_loc = tcfg.storage_voxels // N_RANKS
    slab = (tcfg.slots_per_voxel, v_loc)

    def draws(rank):
        gen = torch.Generator()
        gen.manual_seed(5)
        shard = ShardCtx(n_shards=N_RANKS, rank=rank, lo=rank * v_loc,
                         group=None)
        return T.make_multisensor_draws(tcfg, 2, gen, "cpu", shard)

    got = [draws(r) for r in range(N_RANKS)]
    prop_b, sensors_b = draws(1)  # the same state, the same draws
    assert all(torch.equal(x, y) for s, t in zip(got[1][1], sensors_b)
               for x, y in zip(s, t))
    assert prop_b is None if not noisy else torch.equal(prop_b, got[1][0])
    for r in range(N_RANKS):
        prop, sensors = got[r]
        assert len(sensors) == 2
        for i in range(2):
            assert len(sensors[i]) == (5 if noisy else 4)
            for x, y in zip(sensors[i][:4], got[0][1][i][:4]):
                assert torch.equal(x, y)
        if not noisy:
            assert prop is None
            continue
        assert prop.shape == (3,) + slab
        assert all(s[4].shape == (2,) + slab for s in sensors)
        assert not torch.equal(sensors[0][4], sensors[1][4])
        if r:
            assert not torch.equal(prop, got[0][0])
            assert not torch.equal(sensors[1][4], got[0][1][1][4])
    if not noisy:
        gen = torch.Generator()
        gen.manual_seed(5)
        whole = T.make_multisensor_draws(tcfg, 2, gen, "cpu")
        assert whole[0] is None and all(
            torch.equal(x, y) for s, t in zip(whole[1], got[0][1])
            for x, y in zip(s, t))


def test_sweep_reference_on_a_slab_matches_jax():
    """``sweep_reference(..., cell_base=V/2)`` on the upper half of a pool:
    every output bit-equal to JAX's, and the movers are the slots whose new
    cell is not ``V/2 + column``."""
    from dspmap_tpu.ops.sweep import sweep_reference as jsweep
    from dspmap_tpu_torch.ops.sweep import sweep_reference as tsweep

    jcfg = J.example_node_settings(J.dsp_dynamic(
        nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=1024))
    tcfg = port_cfg(jcfg)
    a = occupancy_pool(tcfg, seed=4, n_voxels=1500)
    V = tcfg.storage_voxels
    base = V // 2
    slab = {k: np.ascontiguousarray(v[:, base:]) for k, v in a.items()}
    jp, tp = both(slab)
    sensor = np.asarray([0.35, -0.2, 1.0], np.float32)
    quat = np.asarray([np.cos(0.15), 0, 0, np.sin(0.15)], np.float32)
    origin = np.asarray(J.geometry.window_origin(jnp.asarray(sensor), jcfg))
    want = jsweep(jp, jcfg, jnp.float32(0.1), jnp.asarray(origin),
                  jnp.asarray(sensor), jnp.asarray(quat), cell_base=base)
    got = tsweep(tp, tcfg, np.float32(0.1), origin, sensor, quat,
                 cell_base=base)
    for name in want._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy().view(np.int32),
            np.asarray(getattr(want, name)).view(np.int32), err_msg=name)
    moved = got.mover.numpy()
    col = base + np.arange(V - base)[None, :]
    valid = slab["flags"] != 0
    assert moved.any() and (moved <= valid).all()
    np.testing.assert_array_equal(
        moved[valid & (got.moved_out.numpy() == 0)],
        (got.new_cell.numpy() != col)[valid & (got.moved_out.numpy() == 0)])


def test_one_process_mesh_and_init_without_a_group():
    """Without a process group: ``distributed.init()`` with nothing
    configured leaves it so, the mesh is of one process, and
    ``make_shardmap_step`` on it gives the unsharded step's result."""
    distributed.init()
    assert not torch.distributed.is_initialized()
    assert distributed.is_coordinator()
    mesh = make_mesh()
    assert (mesh.size, mesh.rank) == (1, 0)
    with pytest.raises(ValueError):
        make_mesh(2)
    tcfg = _layout_cfg("pool")
    tcfg = dataclasses.replace(tcfg, limit_motion_to_xy_plane=True)
    a, b = (T.init_state(tcfg, device="cpu") for _ in range(2))
    step, sharded = T.make_step(tcfg), T.make_shardmap_step(tcfg, mesh,
                                                            device="cpu")
    for f in sim.generate_sequence(3, tcfg, seed=5):
        a, out_a = step(a, T.Frame(*f))
        b, out_b = sharded(b, T.Frame(*f))
    for k in PLANES:
        assert torch.equal(getattr(a.particles, k), getattr(b.particles, k))
    assert {k: float(v) for k, v in out_a.metrics.items()} == {
        k: float(v) for k, v in out_b.metrics.items()}
    assert int(out_a.metrics["alive"]) > 0


def test_sharded_multisensor_step_pins_the_sensor_axis():
    """``make_sharded_step(..., n_sensors=2)`` on a one-process mesh steps a
    two-camera state and keeps its estimator's ``[2, C, ...]`` leaves; it
    refuses a state whose estimator lacks the sensor axis, and a
    ``with_metrics`` the multi-sensor step does not have."""
    tcfg = _layout_cfg("pool")
    mesh = make_mesh()
    step = T.make_sharded_step(tcfg, mesh, device="cpu", n_sensors=2)
    state = T.shard_state(T.init_multisensor_state(tcfg, 2, device="cpu"),
                          mesh)
    f = next(iter(sim.generate_sequence(1, tcfg, seed=5)))
    frames = T.stack_frames([T.Frame(*f)] * 2)
    state, out = step(state, frames)
    assert out.accepted
    assert tuple(state.estimator.prev_centers.shape) == (
        2, tcfg.max_clusters, 3)
    with pytest.raises(ValueError, match="estimator.prev_centers"):
        step(T.init_state(tcfg, device="cpu"), frames)
    with pytest.raises(ValueError, match="with_metrics"):
        T.make_sharded_step(tcfg, mesh, with_metrics=False, device="cpu",
                            n_sensors=2)


def _birth_case(layout):
    """A birth stage's inputs: particles in every slab, the first and last
    column (pool) or voxel layer of each slab populated -- where a point
    that a rank does not own would read if the ownership test were
    dropped -- and estimator points over the window, some in each slab."""
    tcfg = _layout_cfg(layout)
    rng = np.random.default_rng(11)
    state = T.state_to_numpy(T.init_state(
        tcfg, seed=4, init_particle_num=6000, init_weight=0.2, device="cpu"))
    a = state["particles"]
    a["flags"] = np.where(a["flags"] != 0, 1, 0).astype(np.int32)
    if layout == "pool":
        v_loc = tcfg.storage_voxels // N_RANKS
        edges = [c for r in range(N_RANKS) for c in (r * v_loc,
                                                     (r + 1) * v_loc - 1)]
        a["flags"][:3, edges] = 1
        a["weight"][:3, edges] = 0.7
        a["vx"][:3, edges] = 1.0
    else:
        state = _by_slab(state, tcfg)
    P = tcfg.max_input_points
    half = np.asarray(tcfg.half_extent, np.float32)
    points = (rng.uniform(-0.95, 0.95, (P, 3)) * half).astype(np.float32)
    vel = np.where(rng.random((P, 1)) < 0.5, rng.normal(0, 1, (P, 3)),
                   -200.0).astype(np.float32)
    shape = (P, tcfg.newborn_particles_per_point, 3)
    draws = (rng.normal(0, 1, shape), rng.normal(0, 1, shape),
             rng.uniform(-1, 1, shape))
    origin = T.geometry.window_origin_np(np.zeros(3, np.float32), tcfg)
    return dict(kind="birth", cfg=tcfg, particles=state["particles"],
                est=dict(points=points, vel=vel,
                         dynamic=rng.random(P) < 0.6,
                         valid=np.arange(P) < 900),
                draws=tuple(d.astype(np.float32) for d in draws),
                norm_coeff=np.float32(3.5), origin=origin,
                update_time=np.float32(1.5))


@pytest.fixture(scope="module")
def births(tmp_path_factory):
    cases = [_birth_case("pool"), _birth_case("compact")]
    return cases, run_ranks(cases, tmp_path_factory.mktemp("births"))


@pytest.mark.parametrize("layout", ["pool", "compact"])
def test_sharded_birth_matches_one_device(births, layout):
    """Birth on four slabs against birth on the whole map, the same inputs:
    the pool's planes bit-equal, the compact layout's live particles equal
    as a set (rows are arranged by slab there); the same counters."""
    from dspmap_tpu_torch.ops.birth import (particle_birth,
                                            particle_birth_compact)

    cases, ranks_out = births
    idx = ("pool", "compact").index(layout)
    case, res = cases[idx], [r[idx] for r in ranks_out]
    tcfg = case["cfg"]
    fn = particle_birth_compact if layout == "compact" else particle_birth
    est = {k: torch.from_numpy(v) for k, v in case["est"].items()}
    new, stats = fn(
        T.Particles(**{k: torch.from_numpy(v.copy())
                       for k, v in case["particles"].items()}), tcfg,
        tuple(torch.from_numpy(d) for d in case["draws"]),
        est_points=est["points"], est_vel=est["vel"],
        est_dynamic=est["dynamic"], est_valid=est["valid"],
        norm_coeff=torch.tensor(case["norm_coeff"]), origin=case["origin"],
        update_time=case["update_time"],
        rt=T.state.RuntimeParams.from_config(tcfg))
    got = {k: np.concatenate([r[0][k] for r in res], axis=-1)
           for k in PLANES}
    want = {k: getattr(new, k).numpy() for k in PLANES}
    if layout == "pool":
        for k in PLANES:
            np.testing.assert_array_equal(got[k].view(np.int32),
                                          want[k].view(np.int32), err_msg=k)
    else:
        def live(a):
            keep = a["flags"] != 0
            rows = np.stack([a[k][keep].view(np.int32) for k in PLANES], 1)
            return rows[np.lexsort(rows.T[::-1])]
        np.testing.assert_array_equal(live(got), live(want))
    for _, s in res:
        assert s["newborn_weight"] == float(stats["newborn_weight"])
        assert s["birth_candidates"] == float(stats["birth_candidates"])
    assert sum(s["born"] for _, s in res) == float(stats["born"]) > 0
