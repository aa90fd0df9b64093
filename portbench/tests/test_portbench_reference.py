"""The reference (``portbench/reference/``) against the port's CPU step,
the control against the reference, and what the benchmark imports."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench import harness, judge, program
from portbench.reference import step as ref
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


def _tiny(cameras=1):
    cfg = program.build_config(tiny.BUILDER)
    rcfg = ref.config(program.config_values(cfg))
    assert (rcfg.S, rcfg.V) == (cfg.slots_per_voxel, cfg.storage_voxels)
    mix = generator.load("street" if cameras == 1 else "rig4")
    mix.update(rays=1500, lap_frames=12)
    lap = generator.render_lap(mix, 77, cfg.max_input_points,
                               cfg.half_fov_h_deg, cfg.half_fov_v_deg)
    return cfg, rcfg, lap


@pytest.mark.parametrize("cameras", [1, 4])
def test_reference_agrees_with_the_port_cpu_step(cameras):
    """Frames of the port's CPU step, each held against the reference run
    from the port's state before it with the same draws: the voxels'
    state, the future, the readout and the estimator's tracks to the
    judge's tolerances, and every number within the limits of the cells of
    that many cameras."""
    cfg, rcfg, lap = _tiny(cameras)
    pos = lap.frame(0)[2][0]
    state = program.init_state(cfg, cameras, 0, pos, "cpu")
    step = program.make_step(cfg, cameras, "cpu")
    readings = []
    for i in range(6):
        rendered = lap.frame(i)
        draws = harness.make_draws(rcfg, cameras, 100 + i, "cpu")
        before = (program.to_tree(state) if i else
                  ref.init_tree(rcfg, cameras, pos))
        state, _ = step(state, program.frame(cameras, *rendered), draws)
        occ, centers, future, cleared = program.readout(state, cfg, 0.2)
        mine = (program.to_tree(state),
                {"occupied": occ.numpy(), "centers": centers.numpy(),
                 "future": future.numpy()})
        theirs = ref.run(rcfg, cameras, before, rendered, draws, 0.2)
        got = judge.compare(mine, theirs, cfg.voxel_resolution, start=i == 0)
        for k in ("voxel_state_off", "future_off", "readout_off",
                  "estimator_off"):
            assert got[k] == 0, (i, got)
        readings.append(got)
        state = cleared
    assert int((state.particles.flags != 0).sum()) > 100
    worst = judge.worst(readings)
    for f in sorted((FOLDER / "workloads").glob("*.json")):
        wl = json.loads(f.read_text())
        if (f.stem.endswith("rig4")) == (cameras == 4):
            ok, lines = judge.verdict(worst, wl["limits"])
            assert ok, (f.name, lines)


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
    for f in sorted((FOLDER / "workloads").glob("*.json")):
        limits = json.loads(f.read_text())["limits"]
        ok, lines = judge.verdict(worst, limits)
        assert not ok, (f.name, lines)


def test_rounding_helpers():
    x = np.array([1.0 + 2**-12, -3.0 - 2**-9, 1e-3], np.float32)
    assert ref.to_tf32(x)[0] == 1.0
    assert ref.to_tf32(x)[1] == np.float32(-3.0 - 2**-9)
    np.testing.assert_array_equal(
        ref.to_bf16(x), torch.from_numpy(x).to(torch.bfloat16).float().numpy())
