"""The port's IO and its copies of the JAX package's host modules, on the
CPU: the particle CSV byte for byte, the bag reader, the native
preprocessing (and its numpy fallback), the markers and PLY exports, the
public names of each copy, and the replay -- its loop against the JAX
replay loop with JAX's draws injected, its CLI in a fresh interpreter with
jax blocked.

Maps: ``tests/test_io.py``'s small map for the bag, the replay's ``--tiny``
map elsewhere."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu.io import checkpoint as jckpt
from dspmap_tpu.io import native as jnative
from dspmap_tpu.io import particles_csv as jcsv
from dspmap_tpu.io import rosbag as jrosbag
from dspmap_tpu.utils import markers as jmarkers
from dspmap_tpu.utils import sim
from dspmap_tpu.utils import viz as jviz
from dspmap_tpu_torch.io import native as tnative
from dspmap_tpu_torch.io import particles_csv as tcsv
from dspmap_tpu_torch.io import replay as treplay
from dspmap_tpu_torch.io import rosbag as trosbag
from dspmap_tpu_torch.utils import markers as tmarkers
from dspmap_tpu_torch.utils import viz as tviz
from test_io import _write_test_bag, small_cfg
from torch_parity import jax_draws

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = treplay.TINY


def tiny_configs(**kw):
    return (J.example_node_settings(J.dsp_dynamic(**TINY, **kw)),
            T.example_node_settings(T.dsp_dynamic(**TINY, **kw)))


@pytest.mark.parametrize("layout", ["pool", "compact"])
def test_particle_csv_is_the_jax_packages_byte_for_byte(tmp_path, layout):
    """The same state -- random initial particles around a sensor off the
    origin, every third one marked newborn -- through both exporters: the
    same bytes, and rows for every valid particle."""
    jcfg, tcfg = tiny_configs(layout=layout)
    state = J.init_state(jcfg, jax.random.key(3), sensor_pos=(0.7, -0.4, 1.1),
                         init_particle_num=600, init_weight=0.02)
    flags = np.array(state.particles.flags)
    flags[flags != 0] = np.where(np.arange((flags != 0).sum()) % 3 == 0, 3, 1)
    state = dataclasses.replace(state, particles=dataclasses.replace(
        state.particles, flags=jnp.asarray(flags)))
    n_valid = int((flags != 0).sum())
    assert n_valid > 300
    n_j = jcsv.export_particles_csv(state, jcfg, tmp_path / "jax.csv")
    n_t = tcsv.export_particles_csv(
        T.state_from_numpy(jax.device_get(state), tcfg, device="cpu"), tcfg,
        tmp_path / "port.csv")
    assert n_j == n_t == n_valid
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert b"\n15," in b"\n" + got and b"\n1," in b"\n" + got


def test_bag_copy_gives_the_jax_packages_frames(tmp_path):
    """``bag_to_frames`` of the synthetic bag of ``tests/test_io.py``:
    every frame array equal."""
    bag = tmp_path / "test.bag"
    _write_test_bag(bag)
    jcfg = small_cfg()
    tcfg = T.MapConfig(**{k: getattr(jcfg, k)
                          for k in T.MapConfig.__dataclass_fields__})
    want = list(jrosbag.bag_to_frames(bag, jcfg))
    got = list(trosbag.bag_to_frames(bag, tcfg))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(trosbag.voxel_downsample(pts, 0.25),
                                  jrosbag.voxel_downsample(pts, 0.25))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_native_copy_matches_the_jax_packages(monkeypatch, path):
    """``preprocess_frame`` and ``interp_pose`` of both copies on the same
    inputs, through the native library and through the numpy fallback."""
    if path == "numpy":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_load", lambda: None)
    elif not (jnative.available() and tnative.available()):
        pytest.skip("native toolchain unavailable")
    assert tnative.available() == jnative.available() == (path == "native")
    rng = np.random.default_rng(0)
    cam = rng.uniform([-3, -2, 0.3], [3, 2, 8.0], (4000, 3)).astype(np.float32)
    cam[5] = np.nan
    half = np.asarray([4.95, 4.95, 3.0], np.float32)
    for a, b in zip(tnative.preprocess_frame(cam, 0.1, half, 5000),
                    jnative.preprocess_frame(cam, 0.1, half, 5000)):
        np.testing.assert_array_equal(a, b)
    times = np.asarray([0.0, 1.0, 2.5])
    pos = rng.normal(size=(3, 3)).astype(np.float32)
    quat = rng.normal(size=(3, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    for t in (-1.0, 0.3, 1.7, 9.0):
        for a, b in zip(tnative.interp_pose(times, pos, quat, t),
                        jnative.interp_pose(times, pos, quat, t)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def readout():
    """A port readout after four frames on the tiny map (CPU tensors):
    ``(cfg, occupied, centers, future, weight, estimator cloud, quat)``."""
    _, cfg = tiny_configs()
    state = T.init_state(cfg, seed=0, device="cpu")
    step = T.make_step(cfg)
    for f in sim.generate_sequence(4, cfg, seed=0):
        state, out = step(state, T.Frame(*f))
    occ, centers, future, weight, _ = T.read_occupancy(state, cfg, 0.2)
    assert int(occ.sum()) > 0
    cloud = tuple(out.estimator_cloud)
    return cfg, occ, centers, future, weight, cloud, f[3]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("given", ["tensors", "numpy"])
def test_markers_copy_matches_the_jax_packages(readout, given):
    """Every function of the port's ``utils/markers.py``, fed CPU tensors or
    numpy, returns the JAX package's arrays for the same numpy inputs."""
    cfg, occ, centers, future, weight, cloud, quat = readout
    arg = (lambda x: x) if given == "tensors" else _np
    quat_t = torch.from_numpy(quat)
    np.testing.assert_array_equal(
        tmarkers.fov_marker_points(arg(quat_t), 1.5, 0.9, 5.0),
        jmarkers.fov_marker_points(quat, 1.5, 0.9, 5.0))
    np.testing.assert_array_equal(
        tmarkers.color_assign(arg(weight), 0.0, 0.5, True),
        jmarkers.color_assign(weight.numpy(), 0.0, 0.5, True))
    for a, b in zip(tmarkers.future_layer_cloud(arg(future), arg(centers),
                                                cfg.nz),
                    jmarkers.future_layer_cloud(future.numpy(),
                                                centers.numpy(), cfg.nz)):
        np.testing.assert_array_equal(a, b)
    got = tmarkers.actor_markers(arg(centers[:3]))
    want = jmarkers.actor_markers(centers[:3].numpy())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    vel = torch.where(torch.arange(cloud[1].shape[0])[:, None] % 2 == 0,
                      torch.tensor([0.5, -0.3, 0.0]), cloud[1])
    moving = (cloud[0], vel, torch.ones_like(cloud[2]), cloud[3])
    arrows = tmarkers.cluster_velocity_arrows(tuple(arg(x) for x in moving))
    assert arrows.shape[0] > 0
    np.testing.assert_array_equal(
        arrows, jmarkers.cluster_velocity_arrows([_np(x) for x in moving]))


@pytest.mark.parametrize("given", ["tensors", "numpy"])
def test_viz_copy_writes_the_jax_packages_bytes(readout, tmp_path, given):
    """The three PLY exports of the port's ``utils/viz.py``, fed CPU
    tensors or numpy, write the JAX package's bytes."""
    cfg, occ, centers, future, weight, _, _ = readout
    arg = (lambda x: x) if given == "tensors" else _np
    colors = torch.arange(150, dtype=torch.uint8).reshape(50, 3)
    calls = {
        "write_ply": lambda m, a, f: m.write_ply(f, a(centers[:50]),
                                                 a(colors)),
        "export_occupancy_ply": lambda m, a, f: m.export_occupancy_ply(
            f, a(centers), a(occ), a(weight)),
        "export_future_layer_ply": lambda m, a, f: m.export_future_layer_ply(
            f, cfg, a(centers), a(future)),
    }
    for name, call in calls.items():
        port, ref = tmp_path / f"port_{name}.ply", tmp_path / f"jax_{name}.ply"
        assert call(tviz, arg, port) == call(jviz, _np, ref), name
        assert port.read_bytes() == ref.read_bytes(), name


@pytest.mark.parametrize("jmod,tmod", [(jrosbag, trosbag), (jnative, tnative),
                                       (jmarkers, tmarkers), (jviz, tviz)],
                         ids=["rosbag", "native", "markers", "viz"])
def test_copies_keep_the_jax_modules_public_names(jmod, tmod):
    names = lambda m: sorted(n for n in vars(m) if not n.startswith("_"))  # noqa: E731
    assert names(tmod) == names(jmod)


def test_replay_with_jax_draws_matches_the_jax_replay_loop(capsys):
    """The JAX replay loop (``dspmap_tpu/io/replay.py:100-125``: jitted
    step, ``get_occupancy_map`` at 0.2) over six frames of the tiny map,
    and :func:`replay` on the CPU given JAX's draws for each frame: the
    per-frame occupied-voxel counts agree within 2 voxels or 2% (the
    newborn weight's last bit may flip a resample decision, see
    ``tests/test_torch_step.py``)."""
    jcfg, tcfg = tiny_configs()
    frames = list(sim.generate_sequence(6, jcfg, seed=0))
    state = J.init_state(jcfg, jax.random.key(0))
    step = jax.jit(J.make_step(jcfg))
    draws, want = [], []
    for pts, n, pos, quat, t in frames:
        draws.append(jax_draws(state.rng, jcfg))
        state, _ = step(state, J.Frame(jnp.asarray(pts), jnp.int32(n),
                                       jnp.asarray(pos), jnp.asarray(quat),
                                       jnp.asarray(np.float32(t))))
        occ, _, _, state = J.get_occupancy_map(state, jcfg, 0.2)
        want.append(int(np.asarray(occ).sum()))
    _, walls, outputs = treplay.replay(tcfg, frames, "cpu", draws=draws,
                                       keep_centers=True)
    got = [o["n_occupied"] for o in outputs]
    assert len(walls) == 6 and all(w > 0 for w in walls)
    assert all(len(o["occupied_centers"]) == o["n_occupied"] for o in outputs)
    assert min(want[1:]) > 0, want
    for g, w in zip(got, want):
        assert abs(g - w) <= max(2, 0.02 * w), (got, want)
    assert capsys.readouterr().out.count("occupied=") == 6


#: runs the port's replay CLI as ``python -m`` would, with jax blocked
_CLI = """
import runpy, sys
sys.modules["jax"] = None
sys.argv = ["replay"] + sys.argv[1:]
runpy.run_module("dspmap_tpu_torch.io.replay", run_name="__main__")
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
"""


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", _CLI, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_replay_cli_on_the_cpu(tmp_path):
    """``--cpu --tiny --frames 3`` with ``--out``, ``--csv`` and
    ``--checkpoint`` exits 0 with jax blocked, prints the summary's three
    keys, and leaves files in the JAX formats: JAX's ``load_state`` reads
    the checkpoint."""
    out, csv, ckpt = (tmp_path / n for n in ("out.npz", "p.csv", "c.npz"))
    res = _run_cli("--cpu", "--tiny", "--frames", "3", "--out", str(out),
                   "--csv", str(csv), "--checkpoint", str(ckpt))
    assert res.returncode == 0, res.stderr[-3000:]
    summary = json.loads(next(line for line in res.stdout.splitlines()
                              if line.startswith("{")))
    assert set(summary) == {"mean_ms", "p50_ms", "updates_per_sec"}
    with np.load(out) as data:
        assert len(data["n_occupied"]) == 3
        assert data["centers_2"].shape == (int(data["n_occupied"][2]), 3)
    jcfg, _ = tiny_configs()
    loaded = jckpt.load_state(J.init_state(jcfg, jax.random.key(1)), ckpt)
    assert int(loaded.update_counter) == 3 and bool(loaded.initialized)
    n_valid = int((np.asarray(loaded.particles.flags) != 0).sum())
    rows = csv.read_text().splitlines()
    assert len(rows) == n_valid > 0
    assert f"wrote {n_valid} particles" in res.stdout


def test_replay_cli_without_a_card_says_so():
    """Without ``--cpu`` and without a card the CLI exits nonzero, naming
    the missing card and the flag."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run_cli("--tiny", "--frames", "1")
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "--cpu" in res.stderr
    assert "updates_per_sec" not in res.stdout
