"""``BENCHMARK.json`` against its files, cells and metrics added as files
alone, a run without a card, and the run's comparison with the step broken
underneath."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, spec as spec_mod

import tiny

REPO = pathlib.Path(__file__).resolve().parents[2]


def test_benchmark_json_matches_its_files():
    spec = spec_mod.Spec()
    assert spec.problems() == []
    b = spec.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert [m["name"] for m in b["end_to_end"]] == [
        "frames_per_s", "frame_ms_p95", "peak_mem_gib", "setup_s"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        wl = spec.workload(w["name"])
        assert set(wl["limits"]) <= set(harness.judge.NUMBERS)
        assert spec.end_to_end(w["name"]) and spec.per_layer(w["name"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = spec.config(c["name"])
        assert data["reduced"] == [] and len(c["source"]) <= 200
    for m in b["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in spec.end_to_end(cell)]
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    spec = tiny.copy_with_tiny_cell(tmp_path)
    assert spec.problems() == []
    assert spec.cell("tiny.street")["config"] == "tiny"
    assert "frames_seen" in [m["name"] for m in spec.per_layer("tiny.street")]
    out = harness.run_cell(spec, "tiny.street", 2**31 + 99, 3.0, True,
                           time.time(), device="cpu")
    assert out["correct"], out["_lines"]
    assert out["metrics"]["frames_seen"]["value"] == out["attempted"]
    assert list(out)[-2] == "compared"


def test_a_broken_entry_is_a_problem(tmp_path):
    spec = tiny.copy_with_tiny_cell(tmp_path)
    spec.bench["per_layer"][-1]["moves"] = "setup_s_typo"
    spec.bench["workloads"][-1]["config"] = "nowhere"
    del spec.bench["configs"][-1]["why"]
    problems = spec.problems()
    assert any("moves" in p for p in problems)
    assert any("nowhere" in p for p in problems)
    assert any(p.startswith("configs tiny: keys") for p in problems)


def test_a_configuration_naming_a_missing_reference_is_a_problem(tmp_path):
    spec = tiny.copy_with_tiny_cell(tmp_path, builder=tiny.COMPACT_BUILDER,
                                    reference="nowhere", config="tiny_c")
    assert any("tiny_c: no reference module 'nowhere'" in p
               for p in spec.problems()), spec.problems()


def test_a_configuration_with_its_own_reference_comes_as_files(tmp_path):
    """A compact configuration whose reference is a file added beside the
    others, named by the configuration's file, comes in as files and
    entries alone: the copy's own reference runs, and a run of its cell on
    the CPU is correct."""
    spec = tiny.copy_with_tiny_cell(
        tmp_path, builder=tiny.COMPACT_BUILDER, reference="tiny_ref",
        config="tiny_c")
    (tmp_path / "portbench/reference/tiny_ref.py").write_text(
        '"""The compact reference under a name of its own."""\n\n'
        "from .compact import config, init_tree, run, shapes  # noqa: F401"
        "\n")
    assert spec.problems() == []
    ref = spec.reference("tiny_c")
    assert ref.__name__.endswith(".tiny_ref")
    assert ref.__file__.startswith(str(tmp_path))
    assert spec.reference("flagship").__name__.endswith(".step")
    out = harness.run_cell(spec, "tiny_c.street", 2**31 + 11, 3.0, True,
                           time.time(), device="cpu")
    assert out["correct"], out["_lines"]
    assert out["compared"]["alive_rel"]["value"] is not None


def test_a_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "flagship.street", "--seed", "5", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 3
    assert res.stdout.strip() == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and the benchmark's
    folder has no program to run: the run fails with no result."""
    tiny.copy_with_tiny_cell(tmp_path)
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from portbench import harness, spec;"
            "s = spec.Spec(); harness.run_cell(s, 'tiny.street', 1, 1.0,"
            " False, time.time(), device='cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert "dspmap_tpu_torch" in res.stderr
    assert res.stdout.strip() == ""


def _unchanged(step):
    def broken(state, frame, draws=None):
        before = state
        _, out = step(state, frame, draws)
        return before, out
    return broken


def _half_the_points(step):
    def broken(state, frame, draws=None):
        return step(state, frame._replace(n_points=int(frame.n_points) // 2),
                    draws)
    return broken


def _weights_altered(step):
    def broken(state, frame, draws=None):
        state, out = step(state, frame, draws)
        p = state.particles
        return dataclasses.replace(state, particles=dataclasses.replace(
            p, weight=p.weight * 1.001)), out
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_the_points,
                                   _weights_altered],
                         ids=["state_unchanged", "half_the_points",
                              "answer_altered"])
def test_a_broken_step_is_not_correct(tmp_path, fault):
    """The rest of a run, on the CPU at the tiny cell, with the step
    broken underneath: ``correct`` comes out false."""
    spec = tiny.copy_with_tiny_cell(tmp_path)
    out = harness.run_cell(spec, "tiny.street", 2**31 + 7, 3.0, False,
                           time.time(), device="cpu", wrap_step=fault)
    # a window frame was compared: the verdict is the numbers', not the
    # want of them
    assert out["compared"]["alive_rel"]["value"] is not None
    assert not out["correct"], out["_lines"]


@pytest.mark.parametrize("fault", [_unchanged, _half_the_points,
                                   _weights_altered],
                         ids=["state_unchanged", "half_the_points",
                              "answer_altered"])
def test_a_broken_compact_step_is_not_correct(tmp_path, fault):
    """The same faults under the compact layout's step, judged by the
    compact reference (at the street cell's limits, as the pool's)."""
    spec = tiny.copy_with_tiny_cell(
        tmp_path, builder=tiny.COMPACT_BUILDER, reference="compact",
        config="tiny_c")
    out = harness.run_cell(spec, "tiny_c.street", 2**31 + 7, 3.0, False,
                           time.time(), device="cpu", wrap_step=fault)
    assert out["compared"]["alive_rel"]["value"] is not None
    assert not out["correct"], out["_lines"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "flagship.open_ground", "--seed", str(2**31 + 3),
                          "--seconds", "2", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                   "peak_mem_gib", "setup_s"}
