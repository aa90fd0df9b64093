"""The port stands alone -- it imports and runs without jax and without the
JAX package beside it -- and its own copies of the configuration and the
scene generator have not drifted from the JAX package's."""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu.utils import sim as jsim
from dspmap_tpu_torch.utils import sim as tsim

REPO = pathlib.Path(__file__).resolve().parent.parent

_STEP_SCRIPT = """
import importlib
import pkgutil
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import dspmap_tpu_torch as dm
from dspmap_tpu_torch.utils import sim
for mod in pkgutil.walk_packages(dm.__path__, "dspmap_tpu_torch."):
    importlib.import_module(mod.name)
cfg = dm.example_node_settings(dm.dsp_dynamic(
    nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=1024,
    mover_capacity=1024, pyramid_slot_capacity=16, max_clusters=4,
    layout=sys.argv[1]))
state = dm.init_state(cfg, seed=0, device="cpu")
step = dm.make_step(cfg)
for pts, n, pos, quat, t in sim.generate_sequence(2, cfg, seed=7):
    state, out = step(state, dm.Frame(pts, n, pos, quat, t))
    assert out.accepted
assert int(out.metrics["alive"]) > 0
occ = dm.get_occupancy_map(state, cfg, 0.2)[0]
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("OK", int(out.metrics["alive"]))
"""


@pytest.mark.parametrize("layout", ["pool", "compact"])
def test_port_runs_a_step_without_jax(layout):
    """In a fresh interpreter: import every module of the port, step two
    CPU frames of either layout and read the map -- jax never enters
    ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _STEP_SCRIPT, layout],
                         cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")


_ALONE_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax raises ImportError
import importlib
import pathlib
import pkgutil
import torch
torch.set_num_threads(1)
import dspmap_tpu_torch as dm
from dspmap_tpu_torch.utils import sim
here = pathlib.Path.cwd().resolve()
assert pathlib.Path(dm.__file__).resolve().is_relative_to(here), dm.__file__
assert not (here / "dspmap_tpu").exists()
names = [m.name for m in pkgutil.walk_packages(dm.__path__, "dspmap_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"dspmap_tpu_torch.ops.relayout", "dspmap_tpu_torch.ops.propagate",
        "dspmap_tpu_torch.ops.rebin", "dspmap_tpu_torch.io.replay",
        "dspmap_tpu_torch.io.checkpoint", "dspmap_tpu_torch.io.ros_bridge",
        "dspmap_tpu_torch.io.ros2_bridge", "dspmap_tpu_torch.utils.profiling",
        "dspmap_tpu_torch.utils.markers", "dspmap_tpu_torch.utils.viz"} <= set(names)
assert not [m for m in sys.modules if m == "dspmap_tpu" or m.startswith("dspmap_tpu.")]
cut = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=1024,
           mover_capacity=1024, max_clusters=4)
shapes = []
for preset, kw in (("dsp_dynamic", {}), ("dsp_static", {}),
                   ("dsp_dynamic_multi_neighbors", {}),
                   ("large_urban", dict(particle_capacity=4096))):
    cfg = dm.example_node_settings(getattr(dm, preset)(**cut, **kw))
    state = dm.init_state(cfg, seed=0, device="cpu")
    shapes.append(tuple(state.particles.flags.shape))
    step = dm.make_step(cfg)
    for pts, n, pos, quat, t in sim.generate_sequence(2, cfg, seed=7):
        state, out = step(state, dm.Frame(pts, n, pos, quat, t))
        assert out.accepted, preset
    assert int(out.metrics["alive"]) > 0, preset
assert shapes == [(18, 7168), (50, 7168), (60, 7168), (4096,)], shapes
for layout in ("pool", "compact"):  # noisy prediction, then two cameras
    cfg = dm.example_node_settings(dm.dsp_dynamic(
        **cut, layout=layout, limit_motion_to_xy_plane=False,
        particle_capacity=4096))
    step = dm.make_step(cfg)
    ms_step = dm.make_multisensor_step(cfg, 2)
    state = dm.init_state(cfg, seed=0, device="cpu")
    ms_state = dm.init_multisensor_state(cfg, 2, seed=0, device="cpu")
    for f in sim.generate_sequence(2, cfg, seed=7):
        state, out = step(state, dm.Frame(*f))
        ms_state, ms_out = ms_step(ms_state, dm.stack_frames([dm.Frame(*f)] * 2))
        assert out.accepted and ms_out.accepted, layout
    assert int(out.metrics["alive"]) > 0 and int(ms_out.metrics["alive"]) > 0
import contextlib, io
from dspmap_tpu_torch.io import load_state, replay
with contextlib.redirect_stdout(io.StringIO()) as said:
    replay.main(["--cpu", "--tiny", "--frames", "2", "--csv", "p.csv",
                 "--checkpoint", "c.npz"])
assert "updates_per_sec" in said.getvalue()
cfg = dm.example_node_settings(dm.dsp_dynamic(**replay.TINY))
state = load_state(dm.init_state(cfg, seed=1, device="cpu"), "c.npz")
assert state.update_counter == 2
assert len(open("p.csv").read().splitlines()) == int(state.particles.valid.sum())
print("OK", shapes)
"""


def test_port_copied_alone_runs_every_preset(tmp_path):
    """The package copied into an empty directory -- no ``dspmap_tpu/``
    beside it, ``jax`` blocked -- imports every module, builds a state for
    the flagship, static, multi-neighbor and compact presets and steps two
    frames of each on the CPU, then two frames of the noisy prediction
    path and of the two-camera step on both layouts, then two frames of the
    replay CLI on the CPU with its CSV and its checkpoint, loaded back."""
    shutil.copytree(REPO / "dspmap_tpu_torch", tmp_path / "dspmap_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", _ALONE_SCRIPT], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")


def test_port_sources_name_no_module_of_the_jax_package():
    """No source of the port imports ``jax`` or ``dspmap_tpu``, and the
    by-path loader is gone."""
    pkg = REPO / "dspmap_tpu_torch"
    assert not (pkg / "_jaxfree.py").exists()
    for path in list(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]):
                root = words[1].split(".")[0]
                assert root not in ("jax", "jaxlib", "dspmap_tpu"), (path, line)
            assert "spec_from_file_location" not in line, (path, line)


_DERIVED = sorted(n for n, v in vars(T.MapConfig).items()
                  if isinstance(v, property))


@pytest.mark.parametrize("preset", ["dsp_dynamic", "dsp_dynamic_multi_neighbors",
                                    "dsp_static", "large_urban"])
def test_presets_equal_jax_presets(preset):
    """The port's copy of the configuration against the JAX package's:
    field for field, with and without the node settings and under
    overrides, every derived size, and a round trip through
    ``dataclasses.asdict`` in both directions."""
    assert _DERIVED == sorted(n for n, v in vars(J.MapConfig).items()
                              if isinstance(v, property))
    assert len(_DERIVED) > 20 and "storage_voxels" in _DERIVED
    cut = dict(nx=24, ny=20, nz=12, max_input_points=1024)
    for kw in ({}, cut):
        j, t = getattr(J, preset)(**kw), getattr(T, preset)(**kw)
        for jc, tc in ((j, t), (J.example_node_settings(j),
                                T.example_node_settings(t))):
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
            for name in _DERIVED:
                assert getattr(tc, name) == getattr(jc, name), name
            assert T.MapConfig(**dataclasses.asdict(jc)) == tc
            assert J.MapConfig(**dataclasses.asdict(tc)) == jc
    assert (T.performance_level_parameters(55.0)
            == J.performance_level_parameters(55.0))


@pytest.mark.parametrize("preset", ["dsp_dynamic", "dsp_static"])
def test_sim_copy_generates_the_jax_packages_frames(preset):
    """``generate_sequence(3, cfg, seed=0)`` of the port's copy of
    ``utils/sim.py`` against the JAX package's: every array equal."""
    j = J.example_node_settings(getattr(J, preset)())
    t = T.example_node_settings(getattr(T, preset)())
    got, want = (list(m.generate_sequence(3, c, seed=0))
                 for m, c in ((tsim, t), (jsim, j)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == len(w) == 5
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert sorted(n for n in vars(tsim) if not n.startswith("_")) == sorted(
        n for n in vars(jsim) if not n.startswith("_"))


def test_state_constructors_default_to_the_card():
    """``init_state``, ``init_estimator_state`` and ``state_from_numpy``
    with no device build on CUDA, and raise an error that names CUDA where
    there is no card: nothing carries on on the CPU unasked."""
    cfg = T.dsp_dynamic(nx=16, ny=16, nz=8, max_input_points=128)
    cpu = T.init_state(cfg, device="cpu")
    assert cpu.device.type == "cpu"
    if torch.cuda.is_available():
        assert T.init_state(cfg).device.type == "cuda"
        assert T.state_from_numpy(cpu, cfg).device.type == "cuda"
        return
    from dspmap_tpu_torch.state import init_estimator_state
    for build in (lambda: T.init_state(cfg),
                  lambda: init_estimator_state(cfg),
                  lambda: T.state_from_numpy(cpu, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_flagship_sizes():
    """The main path's sizes: 66x66x40 at 0.15 m, S=18 x V=175104, 448
    pyramids, dense tier 64 x 32, CK = 288."""
    cfg = T.example_node_settings(T.dsp_dynamic())
    assert (cfg.nx, cfg.ny, cfg.nz, cfg.voxel_resolution) == (66, 66, 40, 0.15)
    assert (cfg.slots_per_voxel, cfg.storage_voxels) == (18, 175104)
    assert cfg.n_pyramids == 448 and cfg.dense_slots == 64
    assert cfg.obs_dense * cfg.neighbor_cells == 288


def test_large_urban_sizes():
    """The compact slice's configuration: 300x300x60 at 0.1 m, S = 10 over
    5,439,488 storage voxels, P = 131072 rows, the flagship's update tile
    (448 pyramids, dense tier 64, CK = 288)."""
    cfg = T.large_urban()
    assert cfg.layout == "compact" and cfg.limit_motion_to_xy_plane
    assert (cfg.nx, cfg.ny, cfg.nz, cfg.voxel_resolution) == (300, 300, 60, 0.1)
    assert (cfg.slots_per_voxel, cfg.storage_voxels) == (10, 5439488)
    assert cfg.compact_capacity == 1 << 17
    assert cfg.n_pyramids == 448 and cfg.dense_slots == 64
    assert cfg.obs_dense * cfg.neighbor_cells == 288
