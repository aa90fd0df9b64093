"""The references (``portbench/reference/``: the pool layout's and the
compact layout's) against the port's CPU step, the control against the
reference, and what the benchmark imports."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from portbench import harness, judge, program, spec as spec_mod
from portbench.reference import compact as compact_ref, step as ref
from portbench.traffic import generator

import tiny

FOLDER = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "dspmap_tpu"}


def _imports(path: pathlib.Path) -> set:
    """Top-level names of the modules a file imports absolutely."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(FOLDER.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        found = _imports(f) & FORBIDDEN
        assert not found, f"{f} imports {found}"
    # whole names: the port's own name begins with the JAX package's
    assert "dspmap_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "itertools", "math", "types", "numpy"}
    for f in sorted((FOLDER / "reference").rglob("*.py")):
        got = _imports(f)
        assert got <= allowed, f"{f} imports {got - allowed}"


def _tiny(cameras=1, builder=tiny.BUILDER, reference=ref):
    cfg = program.build_config(builder)
    rcfg = reference.config(program.config_values(cfg))
    assert (rcfg.S, rcfg.V) == (cfg.slots_per_voxel, cfg.storage_voxels)
    assert reference.shapes(rcfg) == tiny.shapes_of(cfg)
    mix = generator.load("street" if cameras == 1 else "rig4")
    mix.update(rays=1500, lap_frames=12)
    lap = generator.render_lap(mix, 77, cfg.max_input_points,
                               cfg.half_fov_h_deg, cfg.half_fov_v_deg)
    return cfg, rcfg, lap


def _limits(reference: str, cameras: int) -> dict:
    """The limits of the benchmark's cells whose configuration names
    ``reference`` and whose traffic has one camera (``cameras == 1``) or
    more, by cell."""
    spec = spec_mod.Spec()
    out = {}
    for w in spec.bench["workloads"]:
        if (spec.reference_name(w["config"]) == reference
                and (spec.traffic(w["traffic"])["cameras"] == 1)
                == (cameras == 1)):
            out[w["name"]] = spec.workload(w["name"])["limits"]
    return out


def _against_the_port(builder, reference, cameras, frames=6, seed=100):
    """Frames of the port's CPU step, each held against ``reference`` run
    from the port's state before it with the same draws; returns each
    frame's numbers and the last state."""
    cfg, rcfg, lap = _tiny(cameras, builder, reference)
    pos = lap.frame(0)[2][0]
    state = program.init_state(cfg, cameras, 0, pos, "cpu")
    step = program.make_step(cfg, cameras, "cpu")
    readings = []
    for i in range(frames):
        rendered = lap.frame(i)
        draws = harness.make_draws(rcfg, cameras, seed + i, "cpu")
        before = (program.to_tree(state) if i else
                  reference.init_tree(rcfg, cameras, pos))
        state, _ = step(state, program.frame(cameras, *rendered), draws)
        occ, centers, future, cleared = program.readout(state, cfg, 0.2)
        mine = (program.to_tree(state),
                {"occupied": occ.numpy(), "centers": centers.numpy(),
                 "future": future.numpy()})
        theirs = reference.run(rcfg, cameras, before, rendered, draws, 0.2)
        readings.append(judge.compare(mine, theirs, cfg.voxel_resolution,
                                      start=i == 0))
        state = cleared
    return readings, state


@pytest.mark.parametrize("cameras", [1, 4])
def test_reference_agrees_with_the_port_cpu_step(cameras):
    """Frames of the port's CPU step, each held against the reference run
    from the port's state before it with the same draws: the voxels'
    state, the future, the readout and the estimator's tracks to the
    judge's tolerances, and every number within the limits of the cells of
    that many cameras."""
    readings, state = _against_the_port(tiny.BUILDER, ref, cameras)
    for i, got in enumerate(readings):
        for k in ("voxel_state_off", "future_off", "readout_off",
                  "estimator_off"):
            assert got[k] == 0, (i, got)
    assert int((state.particles.flags != 0).sum()) > 100
    worst = judge.worst(readings)
    cells = _limits("step", cameras)
    assert cells
    for name, limits in cells.items():
        ok, lines = judge.verdict(worst, limits)
        assert ok, (name, lines)


#: the tiny compact map with every budget binding: the rows, the movers
#: and the copies they cap, the FOV buffer, the pyramids and the spill tier
TIGHT = dict(particle_capacity=640, mover_capacity=24, fov_capacity=300,
             pyramid_slot_capacity=8, particle_spill_capacity=40)


@pytest.mark.parametrize("cameras,budgets", [(1, {}), (1, TIGHT), (4, {})],
                         ids=["one_camera", "budgets_binding", "four_cameras"])
def test_compact_reference_agrees_with_the_port_cpu_step(cameras, budgets):
    """The compact layout: frames of the port's CPU step each held against
    the compact reference from the port's state before it, the voxels'
    state, the future, the readout and the tracks to the judge's
    tolerances, with the budgets binding too, and every number within the
    limits of the one-camera street cells of the pool layout.

    The particle numbers turn on ties in the resample: where a voxel's
    weights are equal (its newborns), the side a comb point falls on turns
    on their last bit, and the newborn weight differs in it between the
    two sides (the update's sum, float32 in the port, float64 here).  On
    this map of 2,048 voxels one such voxel is some 2% of the map, at the
    compact cell's 5.4 M voxels some 1e-5 of it: the numbers are held to
    the limits set at the flagship's 175,104 voxels."""
    builder = dict(tiny.COMPACT_BUILDER, overrides=dict(
        tiny.COMPACT_BUILDER["overrides"], **budgets))
    readings, state = _against_the_port(builder, compact_ref, cameras,
                                        frames=8)
    for i, got in enumerate(readings):
        for k in ("voxel_state_off", "future_off", "readout_off",
                  "estimator_off"):
            assert got[k] == 0, (i, got)
    alive = int((state.particles.flags != 0).sum())
    assert alive > 300 and state.particles.flags.shape == (
        program.build_config(builder).compact_capacity,)
    worst = judge.worst(readings)
    cells = _limits("step", 1)
    assert cells
    for name, limits in cells.items():
        ok, lines = judge.verdict(worst, limits)
        assert ok, (name, lines)


def test_the_compact_reference_walks_in_the_specified_order():
    """The resample walk's sums: a voxel's rows add the 1, 2, 4, ... rows
    before them, voxel by voxel, in float32."""
    w = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 1.0, 2.0], np.float32)
    start = np.array([1, 0, 0, 0, 0, 1, 0], bool)
    got = compact_ref.walk_sums(w, start, 8)
    f = np.float32
    want = [w[0], w[0] + w[1], (w[1] + w[2]) + w[0],
            (w[2] + w[3]) + (w[0] + w[1]),
            (w[3] + w[4]) + ((w[1] + w[2]) + w[0]), w[5], w[5] + w[6]]
    np.testing.assert_array_equal(got, np.array(want, f))


def test_the_control_fails_the_limits():
    """The control (the reference in bfloat16 with TF32 products) from the
    same states and draws comes out not correct under every cell's
    limits."""
    cfg, rcfg, lap = _tiny()
    pos = lap.frame(0)[2][0]
    state = program.init_state(cfg, 1, 0, pos, "cpu")
    step = program.make_step(cfg, 1, "cpu")
    readings = []
    for i in range(6):
        rendered = lap.frame(i)
        draws = harness.make_draws(rcfg, 1, 200 + i, "cpu")
        before = program.to_tree(state) if i else ref.init_tree(rcfg, 1, pos)
        state, _ = step(state, program.frame(1, *rendered), draws)
        _, _, _, state = program.readout(state, cfg, 0.2)
        if i < 3:
            continue
        mine = ref.run(rcfg, 1, before, rendered, draws, 0.2)
        low = ref.run(rcfg, 1, before, rendered, draws, 0.2, control=True)
        readings.append(judge.compare(low, mine, cfg.voxel_resolution))
    worst = judge.worst(readings)
    cells = _limits("step", 1) | _limits("step", 4)
    assert len(cells) >= 3
    for name, limits in cells.items():
        ok, lines = judge.verdict(worst, limits)
        assert not ok, (name, lines)


def test_the_compact_control_fails_the_limits():
    """The compact reference's control from the port's states and the same
    draws comes out not correct under the compact cells' limits and under
    the one-camera pool cells' ones."""
    cfg, rcfg, lap = _tiny(1, tiny.COMPACT_BUILDER, compact_ref)
    pos = lap.frame(0)[2][0]
    state = program.init_state(cfg, 1, 0, pos, "cpu")
    step = program.make_step(cfg, 1, "cpu")
    readings = []
    for i in range(6):
        rendered = lap.frame(i)
        draws = harness.make_draws(rcfg, 1, 200 + i, "cpu")
        before = (program.to_tree(state) if i
                  else compact_ref.init_tree(rcfg, 1, pos))
        state, _ = step(state, program.frame(1, *rendered), draws)
        _, _, _, state = program.readout(state, cfg, 0.2)
        if i < 3:
            continue
        mine = compact_ref.run(rcfg, 1, before, rendered, draws, 0.2)
        low = compact_ref.run(rcfg, 1, before, rendered, draws, 0.2,
                              control=True)
        readings.append(judge.compare(low, mine, cfg.voxel_resolution))
    worst = judge.worst(readings)
    cells = _limits("compact", 1) | _limits("step", 1)
    assert len(cells) >= 3
    for name, limits in cells.items():
        ok, lines = judge.verdict(worst, limits)
        assert not ok, (name, lines)


def test_rounding_helpers():
    x = np.array([1.0 + 2**-12, -3.0 - 2**-9, 1e-3], np.float32)
    assert ref.to_tf32(x)[0] == 1.0
    assert ref.to_tf32(x)[1] == np.float32(-3.0 - 2**-9)
    np.testing.assert_array_equal(
        ref.to_bf16(x), torch.from_numpy(x).to(torch.bfloat16).float().numpy())
