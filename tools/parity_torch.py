"""The PyTorch port's parity ritual: the port held over many frames against
the JAX package on the CPU, and the port on a CUDA card against the port on
the CPU.  Writes docs/PARITY_TORCH.md (in the form of docs/PARITY.md).

Usage::

    python tools/parity_torch.py jax [--presets ...] [--jobs 4] [--threads 2]
    python tools/parity_torch.py card [--paths ...] [--jobs 2] [--threads 4]
    python tools/parity_torch.py report

``jax`` (a machine with jax; no card needed): each preset of
:data:`PRESETS` runs three times on :func:`make_frames`'s street sequence --
the port on the CPU with seed s, JAX with ``jax.random.key(s)``, and JAX
with another key as the null, JAX's own divergence between two random
streams -- and each frame's occupancy is read as a ROS node reads it
(``read_occupancy`` at 0.2, which clears the future grid).  Readings: the
agreement of the occupied voxels (chamfer fractions at 1.6 voxel) per frame
and by window, the operating curve over :data:`THRESHOLDS`, future-status
calibration per horizon and the occupied-voxel counts.  Gates: the drift
gate (final-third agreement of the port with JAX at least JAX's with
itself less 0.06) and the calibration gate (every hit rate of the port in a
bin of at least 500 predictions within ``|JAX_a - JAX_b| + 0.05`` of
JAX's).

``card`` (a machine with a CUDA card; never imports jax): each path of
:data:`CARD_PATHS` starts from one state made by 10 CPU frames, saved and
loaded into a card template and a CPU template, then runs 30 frames on
draws made on the CPU and copied to the card: (i) teacher-forced, the CPU
stepping each frame from the card's state with the card's result of each
``measurement_update`` (particles and ``norm_coeff``), every frame held to ``utils/parity.py::PINNED_BARS``, the bars of
``chip_smoke.py``'s card against CPU (a compact frame also records, for the
particles that :data:`COMPACT_STAGES` take in and for the step's result,
where the card's rows and the CPU's part: ``rows_parted``); (ii)
free-running, the card and the CPU each on its own, the gate being their
final-third agreement at least that of the CPU with itself on other draws
less 0.06, the per-frame alive ratio recorded as the drift; (iii) the card's
free run taken twice, bit-equal.

Each job writes one JSON file to ``--out`` (default
``tools/parity_torch_out/``); every mode ends by rendering the report from
all the files there, and ``report`` renders it alone.  Importing this file
imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
for _p in (REPO, Path(__file__).resolve().parent):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from parity_roc import chamfer  # noqa: E402  (imports numpy only)

OUT = REPO / "tools" / "parity_torch_out"
DOC = REPO / "docs" / "PARITY_TORCH.md"

#: occupancy thresholds of the operating curve (tools/parity_roc.py's)
THRESHOLDS = [0.1, 0.2, 0.4, 0.7, 1.0, 1.5]
#: the threshold a frame's occupancy is read at, as parity_report.py reads
READ_THRESHOLD = 0.2
#: predicted-weight bins of the calibration (0-0.5 / 0.5-1 / 1-2 / >2)
BINS = np.array([0.0, 0.5, 1.0, 2.0, np.inf])
#: the synthetic frames' spacing, seconds
FRAME_DT = 0.1
#: points a frame (parity_report.py's ``--max-points``)
MAX_POINTS = 3000
#: the drift gate's margin, and the calibration gate's margin and least n
DRIFT_MARGIN, CALIB_MARGIN, CALIB_MIN_N = 0.06, 0.05, 500
#: the JAX null's key is the seed plus this
NULL_KEY_OFFSET = 1000

#: jax mode: preset -> (frames, seeds, steady-state first frame)
PRESETS = {
    "dynamic": (300, (3, 4, 5), 15),
    "static": (100, (3,), 12),
    "multi": (60, (3,), 8),
    "large_urban": (100, (3,), 15),
    "noisy": (60, (3,), 15),
}
#: card mode: the paths, their CPU start frames and card frames, and the
#: free-running null's draw seed offset
CARD_PATHS = ("flagship", "static", "multi", "large_urban", "multisensor_2cam",
              "noisy")
CARD_WARM, CARD_FRAMES, CARD_SEED, CARD_NULL_OFFSET = 10, 30, 3, 1000
#: card mode, compact layout: the stages whose particles are compared row
#: by row, in the step's order
COMPACT_STAGES = ("measurement_update", "particle_birth_compact",
                  "occupancy_compact")


def preset_config(lib, name: str, max_points: int = MAX_POINTS):
    """The jax mode's configuration ``name`` from ``lib`` (the port or the
    JAX package, whose presets take the same arguments)."""
    mp = dict(max_input_points=max_points)
    if name == "dynamic":
        return lib.example_node_settings(lib.dsp_dynamic(**mp))
    if name == "static":
        return lib.example_node_settings(lib.dsp_static(**mp))
    if name == "multi":
        return lib.example_node_settings(lib.dsp_dynamic_multi_neighbors(**mp))
    if name == "large_urban":
        return lib.large_urban(**mp)
    if name == "noisy":
        return lib.example_node_settings(lib.dsp_dynamic(
            limit_motion_to_xy_plane=False, **mp))
    raise ValueError(f"unknown preset {name!r}")


def card_config(name: str):
    """The card mode's configuration of path ``name`` (chip_smoke.py's),
    and its cameras (``None``: the single-sensor step)."""
    import dspmap_tpu_torch as dm

    if name in ("flagship", "multisensor_2cam"):
        cfg = dm.example_node_settings(dm.dsp_dynamic())
    elif name == "static":
        cfg = dm.example_node_settings(dm.dsp_static())
    elif name == "multi":
        cfg = dm.example_node_settings(dm.dsp_dynamic_multi_neighbors())
    elif name == "large_urban":
        cfg = dm.large_urban()
    elif name == "noisy":
        cfg = dm.example_node_settings(
            dm.dsp_dynamic(limit_motion_to_xy_plane=False))
    else:
        raise ValueError(f"unknown path {name!r}")
    return cfg, (2 if name == "multisensor_2cam" else None)


# ---- frames -----------------------------------------------------------------

def make_frames(n_frames: int, max_points: int, seed: int = 0,
                dense: bool = True, cfg=None):
    """``tools/oracle/run_oracle.py::make_frames`` on the port's scene
    generator: the street scene of ``seed``, the sensor moving down it at
    0.5 m/s with a slight sway and yaw, ``(points, n, pos, quat, t)`` a
    frame.  The field of view is ``cfg``'s (default: the flagship's, as
    the original)."""
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.utils import sim

    if cfg is None:
        cfg = dm.example_node_settings(
            dm.dsp_dynamic(max_input_points=max_points))
    scene = sim.street_scene(seed)
    rng = np.random.default_rng(seed + 1)
    frames = []
    for i in range(n_frames):
        t = i * 0.1
        pos = np.array([0.5 * t, 0.3 * np.sin(0.3 * t), 1.0], np.float32)
        yaw = 0.1 * np.sin(0.5 * t)
        quat = np.array(
            [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], np.float32
        )
        pts, n = sim.render_frame(
            scene, pos, quat, t, rng, max_points,
            points_per_box=150 if not dense else 600,
            fov_h_deg=cfg.half_fov_h_deg, fov_v_deg=cfg.half_fov_v_deg,
        )
        frames.append((pts, n, pos, quat, t))
    return frames


# ---- readings ----------------------------------------------------------------

def reduce_record(weight, centers, future) -> dict:
    """A frame's readout (``read_occupancy``'s weight, centres and future
    grid, in ego order) cut to the voxels the readings look at: weight
    above the least threshold or any future weight.  Every reading of the
    whole readout gives the same on the cut one."""
    weight, centers, future = (np.asarray(x) for x in (weight, centers,
                                                       future))
    keep = (weight > min(THRESHOLDS)) | (future > 0).any(1)
    return {"weight": weight[keep], "centers": centers[keep],
            "future": future[keep]}


def occupied(rec, threshold=READ_THRESHOLD):
    return rec["centers"][rec["weight"] > threshold]


def agreement_curve(recs, ref, tol, threshold=READ_THRESHOLD) -> np.ndarray:
    """Per frame ``(recs-matched, ref-matched, n recs, n ref)``
    (parity_report.py's ``per_frame``)."""
    rows = []
    for r, f in zip(recs, ref):
        a, b = occupied(r, threshold), occupied(f, threshold)
        rows.append(chamfer(a, b, tol) + (len(a), len(b)))
    return np.asarray(rows, np.float64)


def windows(pf) -> dict:
    """Mean agreement ``[recs-matched, ref-matched]`` of a per-frame curve
    over frames 10-30, the middle third, the final third and the last 20
    (parity_report.py's table)."""
    third = len(pf) // 3
    sl = {"frames 10-30": slice(10, 30),
          "middle third": slice(third, 2 * third),
          "final third": slice(-third, None), "last 20": slice(-20, None)}
    return {k: [float(pf[s, 0].mean()), float(pf[s, 1].mean())]
            for k, s in sl.items()}


def final_third(pf) -> float:
    """parity_report.py's gate reading: the mean of both fractions over the
    final third."""
    return float(pf[-(len(pf) // 3):, :2].mean())


def operating_curve(recs, ref, tol, steady) -> dict:
    """Threshold -> mean ``[recs-matched, ref-matched]`` over the frames
    from ``steady`` on (parity_roc.py's ROC sweep, both maps thresholded at
    the same value)."""
    return {th: np.mean([chamfer(occupied(r, th), occupied(f, th), tol)
                         for r, f in zip(recs[steady:], ref[steady:])],
                        axis=0).tolist()
            for th in THRESHOLDS}


def calibration(recs, taus, steady, tol, frame_dt=FRAME_DT):
    """parity_roc.py's future-status calibration of one run: for each
    horizon tau, the predictions of frame i (voxels with future weight
    above 0) binned by weight (:data:`BINS`), and a hit where a voxel
    centre lies within ``tol`` of a voxel occupied (weight > 0.2) at frame
    i + tau / frame_dt.  Returns ``(hits, totals)``, each ``[T, 4]``."""
    from scipy.spatial import cKDTree

    hits = np.zeros((len(taus), 4))
    tot = np.zeros((len(taus), 4))
    for k, tau in enumerate(taus):
        lead = int(round(tau / frame_dt))
        for i in range(steady, len(recs) - lead):
            pred = recs[i]["future"][:, k]
            pc = recs[i]["centers"]
            realized = recs[i + lead]["centers"][
                recs[i + lead]["weight"] > 0.2]
            if len(realized) == 0:
                continue
            b = np.digitize(pred, BINS) - 1
            sel_any = pred > 0
            pts = pc[sel_any]
            d, _ = cKDTree(realized).query(pts)
            hit = d <= tol
            bsel = b[sel_any]
            for bi in range(4):
                m = bsel == bi
                tot[k, bi] += m.sum()
                hits[k, bi] += (m & hit).sum()
    return hits, tot


def rates(hits, tot) -> np.ndarray:
    return np.asarray(hits) / np.maximum(np.asarray(tot), 1)


def calibration_gate(port, jax_a, jax_b):
    """The calibration gate over ``(hits, totals)`` of the port and the two
    JAX runs: every bin where the port and JAX_a each hold at least
    :data:`CALIB_MIN_N` predictions.  Returns ``(passed, [(tau index, bin,
    port rate, JAX_a rate, JAX_b rate, allowed), ...] of the bins that
    failed, bins checked)``."""
    rp, ra, rb = rates(*port), rates(*jax_a), rates(*jax_b)
    checked, failed = 0, []
    for k in range(rp.shape[0]):
        for b in range(4):
            if min(port[1][k, b], jax_a[1][k, b]) < CALIB_MIN_N:
                continue
            checked += 1
            allowed = abs(ra[k, b] - rb[k, b]) + CALIB_MARGIN
            if abs(rp[k, b] - ra[k, b]) > allowed:
                failed.append((k, b, float(rp[k, b]), float(ra[k, b]),
                               float(rb[k, b]), float(allowed)))
    return not failed, failed, checked


# ---- jax mode ------------------------------------------------------------------

def run_port(cfg, frames, seed: int):
    """The port on the CPU from ``init_state(cfg, seed)``: a reduced record
    a frame (:func:`reduce_record`), read as parity_report.py reads."""
    import dspmap_tpu_torch as dm

    state = dm.init_state(cfg, seed=seed, device="cpu")
    step = dm.make_step(cfg)
    recs = []
    for pts, n, pos, quat, t in frames:
        state, _ = step(state, dm.Frame(pts, n, pos, quat, np.float32(t)))
        _, centers, future, weight, state = dm.read_occupancy(
            state, cfg, READ_THRESHOLD)
        recs.append(reduce_record(weight.numpy(), centers.numpy(),
                                  future.numpy()))
    return recs


def run_jax(jcfg, frames, keys):
    """The JAX step on the CPU once from each of ``keys``' states, one
    compiled step for all: a reduced record a frame a run."""
    import jax
    import jax.numpy as jnp
    import dspmap_tpu as jdm

    step = jax.jit(jdm.make_step(jcfg))
    read = jax.jit(lambda s: jdm.read_occupancy(s, jcfg, READ_THRESHOLD))
    runs = []
    for key in keys:
        state = jdm.init_state(jcfg, jax.random.key(key))
        recs = []
        for pts, n, pos, quat, t in frames:
            fr = jdm.Frame(jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos),
                           jnp.asarray(quat), jnp.asarray(np.float32(t)))
            state, _ = step(state, fr)
            _, centers, future, weight, state = read(state)
            recs.append(reduce_record(weight, centers, future))
        runs.append(recs)
    return runs


def jax_readings(cfg, port, jax_a, jax_b, steady) -> dict:
    """Every reading of one preset and seed from its three runs' records."""
    tol = cfg.voxel_resolution * 1.6
    taus = list(cfg.prediction_horizons)
    ours = agreement_curve(port, jax_a, tol)
    null = agreement_curve(jax_b, jax_a, tol)
    calib = {k: [x.tolist() for x in calibration(r, taus, steady, tol)]
             for k, r in (("port", port), ("jax_a", jax_a),
                          ("jax_b", jax_b))}
    return {
        "taus": taus, "steady": steady,
        "port_vs_jax": ours.tolist(), "jax_vs_jax": null.tolist(),
        "roc_port_vs_jax": operating_curve(port, jax_a, tol, steady),
        "roc_jax_vs_jax": operating_curve(jax_b, jax_a, tol, steady),
        "calibration": calib,
    }


def jax_job(name: str, seed: int, out: Path, n_frames=None, cfg_overrides=None,
            steady=None) -> dict:
    """One preset and seed of the jax mode (``n_frames``, ``cfg_overrides``
    of both packages' configuration and ``steady`` cut it down); writes
    ``out/jax_<name>_s<seed>.json`` and returns its content.  jax must be
    set to the CPU platform first (:func:`main` does)."""
    import dataclasses

    import dspmap_tpu as jdm
    import dspmap_tpu_torch as dm

    frames_d, _, steady_d = PRESETS[name]
    n_frames = n_frames or frames_d
    steady = steady_d if steady is None else steady
    cfg = preset_config(dm, name)
    jcfg = preset_config(jdm, name)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides).validate()
        jcfg = dataclasses.replace(jcfg, **cfg_overrides).validate()
    frames = make_frames(n_frames, cfg.max_input_points, seed=seed,
                         dense=False, cfg=cfg)
    t0 = time.perf_counter()
    port = run_port(cfg, frames, seed)
    t1 = time.perf_counter()
    jax_a, jax_b = run_jax(jcfg, frames, (seed, seed + NULL_KEY_OFFSET))
    t2 = time.perf_counter()
    rec = {"mode": "jax", "preset": name, "seed": seed, "frames": n_frames,
           "max_points": cfg.max_input_points,
           "null_key": seed + NULL_KEY_OFFSET,
           "port_seconds": t1 - t0, "jax_seconds": t2 - t1,
           **jax_readings(cfg, port, jax_a, jax_b, steady)}
    _write(out / f"jax_{name}_s{seed}.json", rec)
    return rec


# ---- card mode -----------------------------------------------------------------

def _draws(cfg, n_sensors, gen, device):
    """One frame's draws made by ``gen`` on the CPU, and the same on
    ``device``."""
    import dspmap_tpu_torch as dm

    if n_sensors is None:
        cpu = dm.make_draws(cfg, gen, "cpu")
        return cpu, tuple(d.to(device) for d in cpu)
    prop, sensors = dm.make_multisensor_draws(cfg, n_sensors, gen, "cpu")
    return (prop, sensors), (
        None if prop is None else prop.to(device),
        tuple(tuple(d.to(device) for d in s) for s in sensors))


def card_job(name: str, out: Path | None, device="cuda", cfg=None,
             n_sensors=None, warm=CARD_WARM, n_frames=CARD_FRAMES,
             seed=CARD_SEED) -> dict:
    """One path of the card mode: the port on ``device`` against the port
    on the CPU (``device="cpu"`` runs the same code CPU against CPU).
    ``cfg`` and ``n_sensors`` default to the path's (:func:`card_config`).
    Writes ``out/card_<name>.json`` unless ``out`` is None; returns the
    record."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.io import load_state, save_state
    from dspmap_tpu_torch.utils.parity import (
        PINNED_BARS, agreement, differing_leaves, missed_bars,
        particles_recorded, placed_alike, rows_parted, updates_pinned,
        updates_recorded)

    if cfg is None:
        cfg, n_sensors = card_config(name)
    device = torch.device(device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    frames = make_frames(warm + n_frames, cfg.max_input_points, seed=seed,
                         dense=False, cfg=cfg)
    frames = [dm.Frame(pts, n, pos, quat, np.float32(t))
              for pts, n, pos, quat, t in frames]
    if n_sensors is None:
        step = dm.make_step(cfg)

        def fresh(dev, s):
            return dm.init_state(cfg, seed=s, device=dev)
    else:
        step = dm.make_multisensor_step(cfg, n_sensors)
        frames = [dm.stack_frames([f] * n_sensors) for f in frames]

        def fresh(dev, s):
            return dm.init_multisensor_state(cfg, n_sensors, seed=s,
                                             device=dev)
    t0 = time.perf_counter()
    state = fresh("cpu", seed)
    for f in frames[:warm]:
        state, out_ = step(state, f)
        assert out_.accepted, f"{name}: a start frame rejected"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "start.npz")
        save_state(state, path)
        card0 = load_state(fresh(device, seed + 1), path)
        cpu0 = load_state(fresh("cpu", seed + 1), path)
    assert not differing_leaves(card0, cpu0), f"{name}: start states differ"
    frames = frames[warm:]
    gen = torch.Generator().manual_seed(seed)
    draws = [_draws(cfg, n_sensors, gen, device) for _ in frames]
    null_gen = torch.Generator().manual_seed(seed + CARD_NULL_OFFSET)
    null_draws = [_draws(cfg, n_sensors, null_gen, "cpu")[0] for _ in frames]
    tol = cfg.voxel_resolution * 1.6

    # (i) teacher-forced: the CPU from the card's state, given its update
    teacher = []
    card = card0
    stages = COMPACT_STAGES if cfg.layout == "compact" else ()
    for f, (d_cpu, d_card) in zip(frames, draws):
        seen, into_card, into_cpu = [], {}, {}
        with updates_recorded(seen), particles_recorded(stages, into_card):
            new, out_c = step(card, f, d_card)
        with updates_pinned(list(seen)), particles_recorded(stages,
                                                            into_cpu):
            ref = step(card.to("cpu"), f, d_cpu)
        m = agreement((new, out_c), ref)
        m["met"] = not missed_bars(m, PINNED_BARS)
        if cfg.layout == "compact":  # diagnostics beside the bars
            m["placed_alike"] = placed_alike(new.particles,
                                             ref[0].particles, cfg)
            m["rows_parted"] = {
                **{f"into {s}": rows_parted(into_card[s][0], into_cpu[s][0],
                                            cfg) for s in stages},
                "result": rows_parted(new.particles, ref[0].particles, cfg)}
        teacher.append(m)
        card = new
    sync()
    t1 = time.perf_counter()

    # (ii) free-running, the card's run twice (iii)
    def free(start, dev_draws):
        s, recs, alive = start, [], []
        for f, d in zip(frames, dev_draws):
            s, o = step(s, f, d)
            _, centers, future, weight, s = dm.read_occupancy(
                s, cfg, READ_THRESHOLD)
            recs.append(reduce_record(weight.cpu().numpy(),
                                      centers.cpu().numpy(),
                                      future.cpu().numpy()))
            alive.append(int(o.metrics["alive"]))
        return s, recs, alive

    card_a, recs_card, alive_card = free(card0, [d[1] for d in draws])
    card_b, recs_card_b, _ = free(card0, [d[1] for d in draws])
    sync()
    t2 = time.perf_counter()
    _, recs_cpu, alive_cpu = free(cpu0, [d[0] for d in draws])
    _, recs_null, _ = free(cpu0, null_draws)
    t3 = time.perf_counter()
    repeat_differ = differing_leaves(card_a, card_b)
    repeat_frames_equal = all(
        all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(recs_card, recs_card_b))
    ours = agreement_curve(recs_card, recs_cpu, tol)
    null = agreement_curve(recs_null, recs_cpu, tol)
    rec = {
        "mode": "card", "path": name, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "card": _smi() if device.type == "cuda" else None,
        "torch": torch.__version__, "start_frames": warm, "frames": n_frames,
        "seed": seed, "null_seed": seed + CARD_NULL_OFFSET,
        "teacher_forced": teacher,
        "teacher_forced_met": sum(m["met"] for m in teacher),
        "card_vs_cpu": ours.tolist(), "cpu_vs_cpu": null.tolist(),
        "alive_card": alive_card, "alive_cpu": alive_cpu,
        "repeat_leaves_differing": repeat_differ,
        "repeat_readouts_equal": bool(repeat_frames_equal),
        "seconds": {"start_and_teacher_forced": t1 - t0,
                    "card_free_twice": t2 - t1, "cpu_free_twice": t3 - t2},
    }
    if out is not None:
        _write(out / f"card_{name}.json", rec)
    return rec


def _smi() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return None


# ---- report ----------------------------------------------------------------------

def _write(path: Path, rec: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec))


def _load(out: Path, mode: str) -> list:
    return [json.loads(p.read_text())
            for p in sorted(out.glob(f"{mode}_*.json"))]


def _pair(x) -> str:
    return f"{x[0]:.3f} / {x[1]:.3f}"


def drift_gate(runs) -> tuple:
    """``(port final third, JAX null final third, passed)`` over one
    preset's seeds (parity_report.py's gate, on both fractions)."""
    ours = float(np.mean([final_third(np.asarray(r["port_vs_jax"]))
                          for r in runs]))
    null = float(np.mean([final_third(np.asarray(r["jax_vs_jax"]))
                          for r in runs]))
    return ours, null, ours >= null - DRIFT_MARGIN


def _calib_sum(runs, who):
    hits = sum(np.asarray(r["calibration"][who][0]) for r in runs)
    tot = sum(np.asarray(r["calibration"][who][1]) for r in runs)
    return hits, tot


def jax_report(runs) -> tuple:
    """The jax mode's section and whether every gate passed."""
    lines = [
        "## Mode `jax`: the port on the CPU against JAX on the CPU", "",
        "Each preset on `make_frames`' street sequence (150 points a box) "
        "three times: the port with seed s, JAX with "
        "`jax.random.key(s)`, and JAX with key s + 1000 as the null. "
        "'port / JAX' = share of the port's occupied voxels (weight > 0.2) "
        "within 1.6 voxel of one of JAX's, and the share of JAX's within "
        "1.6 voxel of one of the port's; 'JAX b / JAX a' the same for the "
        "null. The drift gate holds the mean of both over the final third "
        f"to at least the null's less {DRIFT_MARGIN}; the calibration gate "
        f"every port hit rate in a bin of n >= {CALIB_MIN_N} (port and JAX a) "
        f"to within |JAX a - JAX b| + {CALIB_MARGIN} of JAX a's.", ""]
    ok = True
    for name in PRESETS:
        mine = [r for r in runs if r["preset"] == name]
        if not mine:
            continue
        frames = mine[0]["frames"]
        taus = mine[0]["taus"]
        lines += [f"### {name}: {frames} frames of {mine[0]['max_points']} "
                  "points, seeds "
                  f"{', '.join(str(r['seed']) for r in mine)}", "",
                  "| seed | run | frames 10-30 | middle third | final third "
                  "| last 20 |", "|---|---|---|---|---|---|"]
        for r in mine:
            for label, key in (("port / JAX", "port_vs_jax"),
                               ("JAX b / JAX a", "jax_vs_jax")):
                w = windows(np.asarray(r[key]))
                lines.append(f"| {r['seed']} | {label} | "
                             + " | ".join(_pair(v) for v in w.values())
                             + " |")
        ours, null, passed = drift_gate(mine)
        ok &= passed
        lines += ["", f"Drift gate: final-third agreement port / JAX "
                  f"**{ours:.3f}**, JAX b / JAX a **{null:.3f}** (margin "
                  f"{null - ours:+.3f}; gate <= {DRIFT_MARGIN} -- "
                  f"{'PASS' if passed else 'FAIL'}).", ""]
        counts = ", ".join(
            f"seed {r['seed']}: "
            + "/".join(f"{np.asarray(r[k])[-20:, i].mean():.0f}"
                       for k, i in (("port_vs_jax", 2), ("port_vs_jax", 3),
                                    ("jax_vs_jax", 2)))
            for r in mine)
        lines += [f"Mean occupied-voxel counts, last 20 frames (port / JAX a "
                  f"/ JAX b): {counts}.", "",
                  f"Operating curve (frames {mine[0]['steady']}+, mean over "
                  "seeds; both maps thresholded alike):", "",
                  "| threshold | port / JAX | JAX b / JAX a |", "|---|---|---|"]
        for th in THRESHOLDS:
            key = str(th)
            p = np.mean([r["roc_port_vs_jax"][key] for r in mine], axis=0)
            n = np.mean([r["roc_jax_vs_jax"][key] for r in mine], axis=0)
            lines.append(f"| {th} | {_pair(p)} | {_pair(n)} |")
        port, ja, jb = (_calib_sum(mine, w) for w in ("port", "jax_a",
                                                       "jax_b"))
        rp, ra, rb = rates(*port), rates(*ja), rates(*jb)
        lines += ["", "Future-status calibration (prediction at t against "
                  "the run's own occupancy at t + tau; hit rate by predicted "
                  "weight 0-0.5 / 0.5-1 / 1-2 / >2):", "",
                  "| tau | port | JAX a | JAX b | n port / JAX a / JAX b |",
                  "|---|---|---|---|---|"]
        fmt = lambda r, k: " / ".join(f"{x:.2f}" for x in r[k])  # noqa: E731
        for k, tau in enumerate(taus):
            lines.append(
                f"| {tau}s | {fmt(rp, k)} | {fmt(ra, k)} | {fmt(rb, k)} | "
                f"{int(port[1][k].sum())} / {int(ja[1][k].sum())} / "
                f"{int(jb[1][k].sum())} |")
        passed, failed, checked = calibration_gate(port, ja, jb)
        ok &= passed
        lines += ["", f"Calibration gate: {checked} bins with n >= "
                  f"{CALIB_MIN_N} -- {'PASS' if passed else 'FAIL'}."]
        for k, b, p_, a_, b_, allowed in failed:
            lines.append(f"- tau {taus[k]}s, bin {b}: port {p_:.3f}, JAX a "
                         f"{a_:.3f}, JAX b {b_:.3f}, allowed +-{allowed:.3f}.")
        secs = sum(r["port_seconds"] for r in mine), sum(r["jax_seconds"]
                                                          for r in mine)
        lines += ["", f"CPU seconds: port {secs[0]:.0f}, JAX (two runs and "
                  f"a compile a seed) {secs[1]:.0f}.", ""]
    return lines, ok


def card_report(runs) -> tuple:
    """The card mode's section and whether every gate passed."""
    from dspmap_tpu_torch.utils.parity import PINNED_BARS as bar

    lines = [
        "## Mode `card`: the port on the card against the port on the CPU",
        "",
        f"Each path starts from one state made by {CARD_WARM} CPU frames "
        "(saved, loaded into a card template and a CPU template, bit-equal), "
        f"then {CARD_FRAMES} frames of `make_frames`' sequence at the "
        "configuration's own points a frame, on draws made on the CPU and "
        "copied to the card. (i) Teacher-forced: each frame the CPU steps "
        "from the card's state with the card's result of each "
        "`measurement_update` (particles and `norm_coeff`: birth and "
        "occupancy alone); bars "
        f"(`utils/parity.py::PINNED_BARS`) flags >= {bar['flags_equal']:.1%}"
        f", alive within {bar['alive_rel']:.1%}, `weight_sum` and future grid "
        f"within rtol 1e-4 on >= {bar['weight_sum_close']:.1%} and >= "
        f"{bar['future_close']:.1%}. In the compact layout 'placed alike' is "
        "the share of the CPU's particles that the card puts in the same "
        "voxels, and the rows of the particles each of "
        + ", ".join(f"`{s}`" for s in COMPACT_STAGES) + " takes in, and of "
        "the result, are compared row by row (`utils/parity.py::"
        "rows_parted`). (ii) Free-running: the card and the CPU each on "
        "its own; gate: the final-third agreement card / CPU at least CPU "
        f"(other draws) / CPU less {DRIFT_MARGIN}; the alive ratio card / "
        "CPU per frame is the drift. (iii) The card's free run twice: every "
        "leaf of the last state and every frame's readout bit-equal.", ""]
    ok = True
    if runs:
        lines += [f"Card: {runs[0].get('card') or runs[0]['device_name']}; "
                  f"PyTorch {runs[0]['torch']}.", ""]
    lines += ["| path | teacher-forced frames meeting the bars | least flags "
              "/ ws / future close | most alive diff | future bit-equal "
              "(least) | placed alike (least; compact) | card / CPU final "
              "third | CPU / CPU final third | free gate | bit repeat |",
              "|---|---|---|---|---|---|---|---|---|---|"]
    curves, failed, parted, parted_keys = [], [], [], []
    for r in runs:
        t = r["teacher_forced"]
        ours, null = (final_third(np.asarray(r[k]))
                      for k in ("card_vs_cpu", "cpu_vs_cpu"))
        free_ok = ours >= null - DRIFT_MARGIN
        rep_ok = not r["repeat_leaves_differing"] and r["repeat_readouts_equal"]
        tf_ok = r["teacher_forced_met"] == len(t)
        ok &= free_ok and rep_ok and tf_ok
        least = "/".join(f"{min(m[k] for m in t):.5f}"
                         for k in ("flags_equal", "weight_sum_close",
                                   "future_close"))
        placed = [m["placed_alike"] for m in t if "placed_alike" in m]
        placed = f"{min(placed):.5f}" if placed else "--"
        lines.append(
            f"| {r['path']} | {r['teacher_forced_met']} of {len(t)} "
            f"{'PASS' if tf_ok else 'FAIL'} | {least} | "
            f"{max(m['alive_rel'] for m in t):.5f} | "
            f"{min(m['future_bit_equal'] for m in t):.6f} | "
            f"{placed} | {ours:.3f} | "
            f"{null:.3f} | {'PASS' if free_ok else 'FAIL'} | "
            + ("PASS" if rep_ok else
               f"FAIL {json.dumps(r['repeat_leaves_differing'])}") + " |")
        for i, m in enumerate(t):
            if not m["met"]:
                failed.append(f"- {r['path']}, frame {i + 1}: " + ", ".join(
                    f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in m.items() if k not in ("met", "rows_parted")))
                failed += [f"  - {where}: {_parted_line(w)}" for where, w
                           in m.get("rows_parted", {}).items()]
        if any("rows_parted" in m for m in t):
            parted.append(f"- {r['path']}: " + ", ".join(
                f"{i + 1}: " + " / ".join(
                    f"{w['rows_differing']}:{w['n_cells_off']}"
                    for w in m["rows_parted"].values())
                for i, m in enumerate(t)))
            parted_keys = list(t[0]["rows_parted"])
        ratio = [a / max(c, 1) for a, c in zip(r["alive_card"],
                                               r["alive_cpu"])]
        curves.append(f"- {r['path']}: " + ", ".join(
            f"{i + 1}: {x:.4f}" for i, x in enumerate(ratio)
            if i % 5 == 4 or i == 0))
    if failed:
        lines += ["", "Teacher-forced frames that missed a bar:", ""] + failed
    if parted:
        lines += ["", "Compact rows, teacher-forced, by frame: rows whose "
                  "flags differ : cells whose counts differ, for the "
                  "particles " + ", ".join(f"`{k}`" for k in parted_keys)
                  + ":", ""] + parted
    lines += ["", "Drift: alive on the card over alive on the CPU, free-"
              "running, by frame:", ""] + curves + [""]
    return lines, ok


def _parted_line(w: dict) -> str:
    """One :func:`rows_parted` reading in words."""
    cells = "; ".join(f"cell {c} card {a} / CPU {b} (first rows {x} / {y})"
                      for c, a, b, x, y in w["cells_off"])
    return (f"flags differ on {w['rows_differing']} rows (rows "
            f"{w['first_differing_row']}-{w['last_differing_row']}; alive on "
            f"the card only {w['card_only']}, on the CPU only "
            f"{w['cpu_only']}); alive on both: another cell on "
            f"{w['cell_differing']} rows, other bits in the same cell on "
            f"{w['payload_differing']}; {w['n_cells_off']} cells with "
            f"other counts{': ' + cells if cells else ''}; culled on one "
            f"side only {w['cull_differing']}"
            + "".join(f"; row {r} cell {c} weight card {a:.9g} / CPU {b:.9g}"
                      for r, c, a, b in w["cull_rows"]))


def render(out: Path, doc: Path = DOC) -> bool:
    """Write ``doc`` from every job file in ``out``; returns whether every
    gate of every mode present passed."""
    jax_runs, card_runs = _load(out, "jax"), _load(out, "card")
    lines = ["# PARITY_TORCH — the PyTorch port over many frames", "",
             "The port held against the JAX package (the reference) on the "
             "CPU, and against itself on the CPU when it runs on a CUDA "
             "card. Generated by `tools/parity_torch.py`; the commands that "
             "made each section are under it.", ""]
    ok = True
    if jax_runs:
        part, good = jax_report(jax_runs)
        lines += part + ["Generated by `python tools/parity_torch.py jax`.",
                         ""]
        ok &= good
    if card_runs:
        part, good = card_report(card_runs)
        lines += part + ["Generated by `python tools/parity_torch.py card` "
                         "on the card named above.", ""]
        ok &= good
    doc.write_text("\n".join(lines))
    return ok


# ---- command line --------------------------------------------------------------

def _jobs(mode, args) -> list:
    if mode == "jax":
        return [[name, str(seed)] for name in args.presets
                for seed in PRESETS[name][1]]
    return [[name] for name in args.paths]


def _run_jobs(mode, args) -> int:
    """Each job of ``mode`` in a process of its own, ``args.jobs`` at a
    time, with ``args.threads`` threads each; then the report."""
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    todo, running, rc = _jobs(mode, args), [], 0
    env = dict(os.environ, OMP_NUM_THREADS=str(args.threads))
    with contextlib.ExitStack() as stack:
        while todo or running:
            while todo and len(running) < args.jobs:
                job = todo.pop(0)
                log = stack.enter_context(open(
                    out / f"{mode}_{'_'.join(job)}.log", "w"))
                cmd = [sys.executable, __file__, "_job", mode, *job,
                       "--out", str(out), "--threads", str(args.threads)]
                running.append((job, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, env=env)))
            time.sleep(1)
            for job, proc in list(running):
                if proc.poll() is not None:
                    running.remove((job, proc))
                    print(f"{mode} {' '.join(job)}: exit {proc.returncode}",
                          flush=True)
                    rc = rc or proc.returncode
    ok = render(out)
    print(f"wrote {DOC} ({'every gate passed' if ok else 'a gate failed'})")
    return rc or (0 if ok else 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["jax", "card", "report", "_job"])
    ap.add_argument("job", nargs="*", help=argparse.SUPPRESS)
    ap.add_argument("--presets", nargs="+", default=list(PRESETS),
                    choices=list(PRESETS))
    ap.add_argument("--paths", nargs="+", default=list(CARD_PATHS),
                    choices=list(CARD_PATHS))
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    if args.mode == "report":
        ok = render(Path(args.out))
        print(f"wrote {DOC} ({'every gate passed' if ok else 'a gate failed'})")
        return 0
    if args.mode == "_job":
        import torch

        torch.set_num_threads(args.threads)
        mode, *job = args.job
        if mode == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_threefry_partitionable", True)
            jax_job(job[0], int(job[1]), Path(args.out))
        else:
            if not torch.cuda.is_available():
                print("parity_torch card: no CUDA device", file=sys.stderr)
                return 2
            card_job(job[0], Path(args.out))
        return 0
    if args.mode == "card":
        import torch
        from dspmap_tpu_torch import kernels

        if not torch.cuda.is_available():
            print("parity_torch card: no CUDA device", file=sys.stderr)
            return 2
        kernels.build()  # once, before the jobs start
    return _run_jobs(args.mode, args)


if __name__ == "__main__":
    sys.exit(main())
