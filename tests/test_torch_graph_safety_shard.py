"""The sharded step's device body can be captured as one CUDA graph a rank
and replayed frame after frame (CPU, four gloo ranks): on every rank it
runs the same operations with the same non-tensor arguments on every
frame, reads no device value on the host, and every rank makes the same
collectives in the same order with the same shapes -- so the ranks' graphs
hold matching collectives and none waits on a peer that captured another
sequence.

The ranks (``tests/torch_shard.py``, started once for the whole file) run
``make_body`` / ``make_multisensor_body`` with their ``ShardCtx`` under
``test_torch_graph_safety.py``'s recording ``TorchDispatchMode``, with
``ShardCtx.psum``, ``_all_gather`` and ``gather_ring`` wrapped to record
each collective, on two frames that differ in pose, time step, point
count and all six runtime parameters: the pool flagship's form
(``all_gather``), the compact layout with the ring, and the two-camera
pool step in each pattern of admitted cameras.  They also draw the sharded
draws into given buffers (the graphed step's static ones), noisy rank
generator included, and hand the graphed sharded constructors a gloo group."""

import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch.models.pipeline import _particle_shape, is_noisy
from dspmap_tpu_torch.parallel import (make_graphed_sharded_step,
                                       make_graphed_shardmap_step, make_mesh)
from dspmap_tpu_torch.utils import sim
from test_torch_graph_safety import CONFIGS, FORBIDDEN
from torch_shard import N_RANKS, run_ranks

torch.set_num_threads(2)

#: what no graphed body may run: a read of a device value on the host, a
#: tensor of host data, or an op whose output shape depends on the data
HOST_READS = FORBIDDEN + ("aten.item", "aten.nonzero")
#: (configuration of test_torch_graph_safety.py, mover exchange, admitted
#: cameras or None for the single-camera body)
BODIES = {
    "pool": ("pool", "all_gather", None),
    "compact_ring": ("compact", "ring", None),
    "two_cameras_both": ("pool", "all_gather", (True, True)),
    "two_cameras_camera0": ("pool", "all_gather", (True, False)),
    "two_cameras_camera1": ("pool", "all_gather", (False, True)),
}
#: (configuration, sensors or None)
DRAWS = {
    "pool": ("pool", None),
    "noisy": ("noisy", None),
    "noisy_compact": ("noisy_compact", None),
    "two_cameras": ("pool", 2),
    "two_cameras_noisy": ("noisy", 2),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = ([dict(kind="graph_safety", name=name, exchange=exchange,
                   pattern=pattern, forbidden=HOST_READS)
              for name, exchange, pattern in BODIES.values()]
             + [dict(kind="shard_draws", name=name, n_sensors=n)
                for name, n in DRAWS.values()]
             + [dict(kind="graphed_refusals")])
    out = run_ranks(cases, tmp_path_factory.mktemp("graph_safety_shard"))
    n_bodies, n_draws = len(BODIES), len(DRAWS)
    return dict(
        bodies={k: [r[i] for r in out] for i, k in enumerate(BODIES)},
        draws={k: [r[n_bodies + i] for r in out]
               for i, k in enumerate(DRAWS)},
        refusals=[r[n_bodies + n_draws] for r in out])


@pytest.mark.parametrize("case", sorted(BODIES))
def test_sharded_body_runs_the_same_ops_on_every_frame(ranks, case):
    for r, got in enumerate(ranks["bodies"][case]):
        assert got["origin_moved"] and got["alive"] > 0, (r, got["alive"])
        assert not got["forbidden"], (r, got["forbidden"])
        n1, n2 = got["n_ops"]
        assert n1 == n2 and n1 > 0, (r, got["n_ops"])
        assert not got["differ"], (r, got["differ"])


@pytest.mark.parametrize("case", sorted(BODIES))
def test_every_rank_makes_the_same_collectives(ranks, case):
    by_rank = ranks["bodies"][case]
    first, second = by_rank[0]["collectives"]
    names = {c[0] for c in first}
    assert "psum" in names and "_all_gather" in names, names
    if BODIES[case][1] == "ring":  # the compact mover exchange's ring
        assert "gather_ring" in names, names
    assert first == second  # frame to frame
    for r, got in enumerate(by_rank[1:], 1):
        assert got["collectives"] == (first, second), r


@pytest.mark.parametrize("case", sorted(DRAWS))
def test_sharded_draws_into_static_buffers_equal_the_sharded_draws(ranks,
                                                                   case):
    name, n_sensors = DRAWS[case]
    cfg = CONFIGS[name]()
    by_rank = ranks["draws"][case]
    noisy = is_noisy(cfg)
    for r, got in enumerate(by_rank):
        assert got["same"] and got["buffers"] and got["gen_same"], (r, got)
        assert got["replicated"] == by_rank[0]["replicated"], r
    own = [got["own_shapes"] for got in by_rank]
    if not noisy:
        assert own == [[]] * N_RANKS
        return
    slab = _particle_shape(cfg, N_RANKS)
    m = 1 if n_sensors is None else n_sensors
    assert own[0] == [(3,) + slab] + [(2,) + slab] * m
    # each rank's pool-shaped noise is its own
    assert len({got["own"] for got in by_rank}) == N_RANKS


def test_graphed_sharded_constructors_refuse_a_gloo_group_and_the_cpu(ranks):
    for said in ranks["refusals"]:
        assert len(said) == 8
        for (fn, device, n_sensors), msg in said.items():
            assert msg is not None, (fn, device, n_sensors)
            if device.startswith("cuda"):
                assert "NCCL" in msg and "gloo" in msg, msg
            else:
                assert "CUDA card" in msg, msg


@pytest.mark.parametrize("pinned", [False, True],
                         ids=["shardmap", "sharded"])
@pytest.mark.parametrize("n_sensors", [None, 2], ids=["one", "two"])
def test_graphed_sharded_step_refuses_a_cpu_state(pinned, n_sensors):
    """A mesh of one process without a process group builds (no card is
    touched until a frame comes), and a slab on the CPU is refused."""
    cfg = CONFIGS["pool"]()
    build = make_graphed_sharded_step if pinned else make_graphed_shardmap_step
    step = build(cfg, make_mesh(), device=torch.device("cuda", 0),
                 n_sensors=n_sensors)
    frame = T.Frame(*next(sim.generate_sequence(1, cfg, seed=0)))
    if n_sensors is None:
        state = T.init_state(cfg, seed=0, device="cpu")
    else:
        state = T.init_multisensor_state(cfg, n_sensors, seed=0,
                                         device="cpu")
        frame = T.stack_frames([frame] * n_sensors)
    with pytest.raises(ValueError, match="CUDA card.*make_shardmap_step"):
        step(state, frame)
    assert step.captures == 0 and not step.capture_ms
