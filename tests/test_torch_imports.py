"""The port imports without jax, and its configuration is the JAX package's."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

import dspmap_tpu as J
import dspmap_tpu_torch as T

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
state = dm.init_state(cfg, seed=0)
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


@pytest.mark.parametrize("preset", ["dsp_dynamic", "dsp_dynamic_multi_neighbors",
                                    "dsp_static", "large_urban"])
def test_presets_equal_jax_presets(preset):
    """Field for field, with and without the node settings, and every
    derived size the port reads."""
    j, t = getattr(J, preset)(), getattr(T, preset)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (dataclasses.asdict(T.example_node_settings(t))
            == dataclasses.asdict(J.example_node_settings(j)))
    for name in ("slots_per_voxel", "storage_voxels", "n_pyramids",
                 "pyramid_slots", "dense_slots", "obs_dense",
                 "fov_buffer_capacity", "neighbor_cells"):
        assert getattr(t, name) == getattr(j, name), name


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
