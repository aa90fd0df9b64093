"""The static map's reference (``portbench/reference/static.py``): against
the port's CPU step on a small static map, its control against it, a
static cell added as files, the stages it shares with the dynamic map
against :mod:`portbench.reference.dsp`'s on the same inputs, and what it
loads."""

import json
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from portbench import harness, judge, program, spec as spec_mod
from portbench.reference import dsp, static as ref
from portbench.traffic import generator

import tiny

REPO = pathlib.Path(__file__).resolve().parents[2]
#: a small static map: 20 x 20 x 10 voxels at 0.4 m, the preset's 50 slots
TINY_STATIC = {"preset": "dsp_static",
               "overrides": dict(nx=20, ny=20, nz=10, voxel_resolution=0.4,
                                 max_input_points=256, mover_capacity=2048,
                                 pyramid_slot_capacity=64),
               "wrap": ["example_node_settings"]}
THRESHOLD = 0.5


def _limits() -> dict:
    return spec_mod.Spec().workload("static.street")["limits"]


def _frames(builder, n, seed, control=False):
    """``n`` frames of the port's CPU step on a short street lap, each held
    against the reference (or, with ``control``, the control against the
    reference) from the port's state before it with the same draws."""
    cfg = program.build_config(builder)
    rcfg = ref.config(program.config_values(cfg))
    assert ref.shapes(rcfg) == tiny.shapes_of(cfg)
    mix = generator.load("street")
    mix.update(rays=1500, lap_frames=12)
    lap = generator.render_lap(mix, 77, cfg.max_input_points,
                               cfg.half_fov_h_deg, cfg.half_fov_v_deg)
    pos = lap.frame(0)[2][0]
    state = program.init_state(cfg, 1, 0, pos, "cpu")
    step = program.make_step(cfg, 1, "cpu")
    readings, spilled = [], 0
    for i in range(n):
        rendered = lap.frame(i)
        draws = harness.make_draws(rcfg, 1, seed + i, "cpu")
        before = (program.to_tree(state) if i
                  else ref.init_tree(rcfg, 1, pos))
        state, out = step(state, program.frame(1, *rendered), draws)
        spilled += int(out.metrics["update_spilled"])
        occ, centers, future, cleared = program.readout(state, cfg,
                                                        THRESHOLD)
        mine = (program.to_tree(state),
                {"occupied": occ.numpy(), "centers": centers.numpy(),
                 "future": future.numpy()})
        theirs = ref.run(rcfg, 1, before, rendered, draws, THRESHOLD)
        if control:
            mine = ref.run(rcfg, 1, before, rendered, draws, THRESHOLD,
                           control=True)
        readings.append(judge.compare(mine, theirs, cfg.voxel_resolution,
                                      start=i == 0))
        state = cleared
    return readings, state, spilled


@pytest.mark.parametrize("dense", [None, 4], ids=["preset_tiers", "spilling"])
def test_static_reference_agrees_with_the_port_cpu_step(dense):
    """Eight frames: the voxels' state, the future and the readout equal to
    the judge's tolerances, every number within ``static.street``'s
    limits; with a dense tier of 4 slots most of the update's particles go
    through the spill tier, which the reference sums as the dense one."""
    builder = dict(TINY_STATIC, overrides=dict(
        TINY_STATIC["overrides"], pyramid_dense_slots=dense))
    readings, state, spilled = _frames(builder, 8, 100)
    for i, got in enumerate(readings):
        for k in ("voxel_state_off", "future_off", "readout_off",
                  "estimator_off"):
            assert got[k] == 0, (i, got)
    flags = state.particles.flags
    assert int((flags != 0).sum()) > 1000
    assert torch.equal(state.particles.vx[flags != 0],
                       torch.zeros(int((flags != 0).sum())))
    assert (spilled > 0) == (dense is not None)
    ok, lines = judge.verdict(judge.worst(readings), _limits())
    assert ok, lines


def test_the_static_control_fails_the_limits():
    """The control (the reference in bfloat16) from the port's states and
    the same draws comes out not correct under ``static.street``'s
    limits."""
    readings, _, _ = _frames(TINY_STATIC, 6, 200, control=True)
    ok, lines = judge.verdict(judge.worst(readings[3:]), _limits())
    assert not ok, lines


def test_a_static_cell_added_as_files_runs_correct(tmp_path):
    """A small static configuration naming ``static`` as its reference
    comes in as files and entries; a run of its cell on the CPU reads
    ``correct`` and reports the spill share."""
    spec = tiny.copy_with_tiny_cell(tmp_path, builder=TINY_STATIC,
                                    reference="static", config="tiny_static",
                                    limits_of="static.street")
    assert spec.problems() == []
    assert spec.reference_name("tiny_static") == "static"
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] == "spill_share":
            m["workloads"].append("tiny_static.street")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = spec_mod.Spec(tmp_path, tmp_path / "portbench")
    out = harness.run_cell(spec, "tiny_static.street", 2**31 + 23, 3.0, True,
                           time.time(), device="cpu")
    assert out["correct"], out["_lines"]
    assert 0 <= out["metrics"]["spill_share"]["value"] <= 1


# ------------------------------------------- stages shared with dsp.py

def _pool(c, rng, fill=0.3):
    """A random pool of static particles around the window's centre."""
    S, V = c.S, c.V
    flags = np.where(rng.random((S, V)) < fill,
                     rng.choice([1, 1, 3], (S, V)), 0).astype(np.int32)
    half = np.asarray(c.half_extent, np.float32)
    P_ = {"flags": flags, "t": np.zeros((S, V), np.float32),
          "weight": rng.uniform(1e-4, 0.2, (S, V)).astype(np.float32)}
    for k, a in enumerate("xyz"):
        P_["p" + a] = rng.uniform(-half[k], half[k], (S, V)).astype(
            np.float32)
        P_["v" + a] = np.zeros((S, V), np.float32)
    return P_


def _config():
    cfg = program.build_config(TINY_STATIC)
    values = program.config_values(cfg)
    return ref.config(values), dsp.derive(values)


def test_projection_agrees_with_dsp():
    c, d = _config()
    rng = np.random.default_rng(1)
    points = rng.normal(0, 3, (256, 3)).astype(np.float32)
    points[:, 0] = np.abs(points[:, 0]) + 0.5
    pos = np.asarray([0.3, -0.2, 1.5], np.float32)
    quat = np.asarray([np.cos(0.2), 0, 0, np.sin(0.2)], np.float32)
    want = dsp.project(points, 200, pos, quat, d)
    got = ref.project(points, 200, pos, quat, c)
    for k in ("valid", "pyr", "used", "max_range"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    np.testing.assert_allclose(got.world, want.world, rtol=0, atol=1e-6)
    assert got.n_valid == want.n_valid > 50


def test_registration_agrees_with_dsp():
    """The zero-velocity registration against the dynamic one of
    :mod:`.dsp` on a pool at rest: the same planes and the same update
    particles, with the FOV buffer and the pyramids binding."""
    c, d = _config()
    for x in (c, d):
        x.fov_cap, x.pyr_slots = 6000, 40
    P_ = _pool(c, np.random.default_rng(2))
    pos = np.asarray([0.6, 0.4, 1.0], np.float32)
    quat = np.asarray([np.cos(0.3), 0, 0, np.sin(0.3)], np.float32)
    origin = dsp.window_origin(pos, d)
    want_P = {k: v.copy() for k, v in P_.items()}
    want, _ = dsp._fused_register(want_P, d, np.float32(0.1), origin, pos,
                                  quat)
    got_P = {k: v.copy() for k, v in P_.items()}
    got = ref.register(got_P, c, ref.window_origin(pos, c), pos, quat)
    for k in ("flags", "px", "py", "pz", "weight"):
        np.testing.assert_array_equal(got_P[k], want_P[k], err_msg=k)
    for k in ("slot", "pos", "w", "pyr"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    np.testing.assert_allclose(got.rng, want.rng, rtol=1e-6)
    assert len(want.slot) > 500 and (want_P["flags"] != P_["flags"]).any()


def test_update_pair_sums_agree_with_dsp():
    """The update's weights and ``sum_z 1/C(z)`` from the same registered
    particles and points, to float32 rounding."""
    c, d = _config()
    rng = np.random.default_rng(3)
    M, Z = 3000, 256
    upd = types.SimpleNamespace(
        slot=rng.permutation(c.S * c.V)[:M].astype(np.int64),
        pos=rng.normal(0, 0.5, (M, 3)).astype(np.float32),
        w=rng.uniform(1e-3, 0.1, M).astype(np.float32),
        pyr=rng.integers(0, c.n_pyr, M).astype(np.int64),
        rng=rng.uniform(0, 6, M).astype(np.float32))
    obs = types.SimpleNamespace(
        world=rng.normal(0, 0.5, (Z, 3)).astype(np.float32),
        used=rng.random(Z) < 0.9,
        pyr=rng.integers(0, c.n_pyr, Z).astype(np.int64),
        max_range=np.where(rng.random(c.n_pyr) < 0.7,
                           rng.uniform(1, 5, c.n_pyr), -1).astype(
            np.float32))
    weight = rng.uniform(0, 0.1, c.S * c.V).astype(np.float32)
    expected = np.float32(0.0512)
    want_w, want_norm = dsp.update(weight, upd, obs, expected, d)
    got_w, got_norm = ref.update(weight, upd, obs, expected, c)
    np.testing.assert_allclose(got_w, want_w, rtol=2e-6, atol=0)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    assert (want_w != weight).sum() > 500


def test_resample_walk_agrees_with_dsp():
    """Cull, the slot walk and the resample on the same pool: the same
    planes, ``weight_sum`` and ``vel_avg``, and the still particles'
    weight equal to :mod:`.dsp`'s static weight."""
    c, d = _config()
    P_ = _pool(c, np.random.default_rng(4), fill=0.5)
    P_["weight"][::3] = np.float32(5e-4)  # some culled
    want, want_ws, want_va, want_sw, _ = dsp.occupancy(
        {k: v.copy() for k, v in P_.items()}, d)
    got, ws, va, sw = ref.occupancy({k: v.copy() for k, v in P_.items()}, c)
    for k in dsp.PLANES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(ws, want_ws)
    np.testing.assert_array_equal(va, want_va)
    np.testing.assert_allclose(sw, want_sw, rtol=1e-6)
    assert (want["flags"] != P_["flags"]).any()


def test_the_static_reference_loads_nothing_of_jax_or_the_port():
    code = ("import sys; import portbench.reference.static as s; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"jax", "jaxlib", "flax", "dspmap_tpu",
                         "dspmap_tpu_torch", "torch"}, loaded


def test_a_rejected_frame_keeps_the_state():
    """A pose jump of 12 m: admission rejects the frame, the state comes
    back as it went in and the readout is the state's."""
    c, _ = _config()
    pos = np.asarray([1.0, 2.0, 1.5], np.float32)
    tree = ref.init_tree(c, 1, pos)
    tree.initialized, tree.last_timestamp = True, np.float32(1.0)
    tree.weight_sum[:5] = 1.0
    P = c.max_input_points
    frame = (np.zeros((1, P, 3), np.float32), np.asarray([0]),
             (pos + np.float32([12, 0, 0]))[None],
             np.asarray([[1, 0, 0, 0]], np.float32), np.asarray([1.1]))
    draws = harness.make_draws(c, 1, 5, "cpu")
    after, out = ref.run(c, 1, tree, frame, draws, THRESHOLD)
    assert after is tree
    assert int(out["occupied"].sum()) == 5
