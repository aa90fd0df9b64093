"""A tiny cell added to a copy of the benchmark as files only: a 16 x 16 x
8 map at 0.6 m voxels on a short lap of the street, for the CPU tests; in
the pool layout, or in the compact layout with the compact reference."""

from __future__ import annotations

import json
import pathlib
import shutil

from portbench import program, spec as spec_mod

REPO = pathlib.Path(__file__).resolve().parents[2]
BUILDER = {"preset": "dsp_dynamic",
           "overrides": dict(nx=16, ny=16, nz=8, voxel_resolution=0.6,
                             max_input_points=256, mover_capacity=2048,
                             pyramid_slot_capacity=32, max_clusters=8),
           "wrap": ["example_node_settings"]}
#: the same map in the compact layout, 8,192 rows
COMPACT_BUILDER = {"preset": "dsp_dynamic",
                   "overrides": dict(BUILDER["overrides"], layout="compact",
                                     particle_capacity=1 << 13),
                   "wrap": ["example_node_settings"]}


def shapes_of(cfg) -> dict:
    """A configuration file's ``shapes``, as the program derives them."""
    compact = cfg.layout == "compact"
    return {"storage_voxels": cfg.storage_voxels,
            "slots_per_voxel": cfg.slots_per_voxel,
            "n_pyramids": cfg.n_pyramids, "layout": cfg.layout,
            "compact_capacity": cfg.compact_capacity if compact else None,
            "max_input_points": cfg.max_input_points,
            "n_horizons": cfg.n_horizons}


def copy_with_tiny_cell(tmp: pathlib.Path, traffic: str = "street",
                        limits_of: str = "flagship.street",
                        builder: dict = BUILDER, reference: str = None,
                        config: str = "tiny") -> spec_mod.Spec:
    """A copy of ``BENCHMARK.json`` and the benchmark's folder under
    ``tmp`` with a configuration ``config`` (of ``builder``, naming
    ``reference`` where given), a mix ``tiny_<traffic>`` and a cell
    ``<config>.<traffic>`` added as files and entries, and a per-layer
    metric ``frames_seen`` that reads the window's frame count."""
    tmp = pathlib.Path(tmp)
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = program.build_config(builder)
    data = {"builder": builder, "config": program.config_values(cfg),
            "shapes": shapes_of(cfg), "reduced": [], "assumed": []}
    if reference is not None:
        data["reference"] = reference
    (tmp / f"portbench/configs/{config}.json").write_text(json.dumps(data))
    mix = json.loads((REPO / f"portbench/traffic/{traffic}.json")
                     .read_text())
    mix.update(rays=max(60, mix["rays"] // 20), lap_frames=20)
    (tmp / f"portbench/traffic/tiny_{traffic}.json").write_text(
        json.dumps(mix))
    wl = json.loads((REPO / f"portbench/workloads/{limits_of}.json")
                    .read_text())
    wl.update(warmup_frames=1, compare_frames=2, profiled_frames=2)
    name = f"{config}.{traffic}"
    (tmp / f"portbench/workloads/{name}.json").write_text(json.dumps(wl))
    (tmp / "portbench/metrics/frames_seen.py").write_text(
        '"""Frames in the window."""\n\n\ndef read(run):\n'
        '    return float(len(run.frame_ms))\n')
    b["configs"].append({"name": config, "source": "tests",
                         "file": f"portbench/configs/{config}.json",
                         "reduced": [], "why": "the CPU tests' map"})
    b["workloads"].append({"name": name, "config": config,
                           "traffic": f"tiny_{traffic}", "chips": 1,
                           "why": "the CPU tests' cell"})
    b["per_layer"].append({"name": "frames_seen", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry: the window",
                           "moves": "frames_per_s", "workloads": [name]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return spec_mod.Spec(tmp, tmp / "portbench")
