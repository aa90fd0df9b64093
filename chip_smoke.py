#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout on a machine with an H100::

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits nonzero):

1. the card: CUDA present, compute capability 9.x, name and power limit;
2. build the port's CUDA kernels from ``dspmap_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it -- K1-K3 at the flagship step's
   (``example_node_settings(dsp_dynamic())``), K4 at ``large_urban()``'s
   -- with inputs made from a numpy seed, plus the median time of each
   over 20 runs (CUDA events);
4. the flagship path: 5 warm-up and 30 timed frames of the synthetic
   street sequence through ``make_step`` (pool layout), with the kernels'
   launch counts; one warm frame runs under PyTorch's sync debug mode and
   must not synchronize the host with the card;
5. card against CPU: the state after frame 10 is copied to the CPU and the
   next frame is stepped on both with the same random draws (see
   :func:`card_vs_cpu` for the bars);
6. the large_urban path (compact layout, ``make_step(large_urban())``):
   3 warm-up and 10 timed frames, launch counts, the sync watch, and one
   frame on the card against the CPU as in phase 5.

The second-to-last line is a JSON object with every kernel's measurements,
the last ``{"ok": true, "device": {...}}``.  The script imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def _say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _median_ms(fn, n: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _watch_syncs(fn):
    """Run ``fn`` under PyTorch's sync debug mode.  Returns ``(fn's result,
    the synchronizing operations it flagged as "file:line message")``."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    found = [f"{w.filename}:{w.lineno} {str(w.message)[:60]}" for w in caught
             if "synchronizing" in str(w.message)]
    return result, found


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _flagship_pool(cfg, rng, device):
    """A populated [S, V] pool, built like tests/test_pallas.py builds its
    occupancy pool: random voxels holding 1..S slots of valid/newborn
    particles with uniform weights, 30% of them moving in x or y."""
    import torch
    import dspmap_tpu_torch as dm

    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    n_vox = V // 4
    cols = rng.choice(cfg.voxel_num, size=n_vox, replace=False)
    k = rng.integers(1, S + 1, size=n_vox)
    occ = np.arange(S)[:, None] < k[None, :]  # first k slots, then shuffle
    occ = np.take_along_axis(occ, rng.permuted(
        np.tile(np.arange(S)[:, None], (1, n_vox)), axis=0), axis=0)
    flags = np.zeros((S, V), np.int32)
    flags[:, cols] = np.where(occ, rng.choice([1, 1, 1, 3], size=(S, n_vox)), 0)
    valid = flags != 0
    weight = np.where(valid, rng.uniform(0.0005, 1.0, (S, V)), 0).astype(np.float32)
    mv = valid & (rng.random((S, V)) < 0.3)
    vx = np.where(mv, rng.normal(0, 0.8, (S, V)), 0).astype(np.float32)
    vy = np.where(mv, rng.normal(0, 0.8, (S, V)), 0).astype(np.float32)
    # positions uniform over the window of a sensor at the origin
    half = np.asarray(cfg.half_extent, np.float32)
    pos = [rng.uniform(-h, h, (S, V)).astype(np.float32) for h in half]
    pos[2] = pos[2] + half[2]
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    zeros = torch.zeros((S, V), dtype=torch.float32, device=device)
    return dm.Particles(flags=t(flags), px=t(pos[0]), py=t(pos[1]),
                        pz=t(pos[2]), vx=t(vx), vy=t(vy), vz=zeros.clone(),
                        weight=t(weight), t=zeros.clone())


def check_kernels(cfg, device):
    """Phase 3: every kernel against its plain version on the card."""
    import torch
    from dspmap_tpu_torch import geometry, kernels
    from dspmap_tpu_torch.ops import occupancy, sweep, update

    rng = np.random.default_rng(0)
    pool = _flagship_pool(cfg, rng, device)
    rows = []

    # K1: occupancy pool pass --------------------------------------------
    got = occupancy.pool_pass_cuda(pool, cfg, with_moving=False)
    ref = occupancy.pool_pass_plain(pool, cfg, with_moving=False)
    torch.cuda.synchronize()
    _require(torch.equal(got[0]["flags"], ref[0]["flags"]), "K1 flags differ")
    werr = (got[0]["weight"] - ref[0]["weight"]).abs()
    _require(bool((werr <= 1e-9 + 1e-6 * ref[0]["weight"].abs()).all()),
             "K1 weights beyond rtol 1e-6")
    for name in ("px", "py", "pz", "vx", "vy"):
        _require(torch.allclose(got[0][name], ref[0][name], rtol=1e-6, atol=0),
                 f"K1 {name} differs")
    _require(torch.allclose(got[1], ref[1], rtol=1e-6, atol=0), "K1 weight_sum")
    _require(torch.allclose(got[4], ref[4], rtol=1e-6, atol=0), "K1 static")
    for a, b in zip(got[6], ref[6]):
        _require(float(a.sum()) == float(b.sum()), "K1 counter sums differ")
    k1_err = float(torch.maximum(werr.max(), (got[1] - ref[1]).abs().max()))
    k1_ms = _median_ms(lambda: occupancy.pool_pass_cuda(pool, cfg, False))
    k1_plain = _median_ms(lambda: occupancy.pool_pass_plain(pool, cfg, False))
    _say("K1", flags="exact", max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain)
    rows.append(("occupancy_pool_pass", "dspmap_tpu_torch/csrc/occupancy.cu",
                 "dspmap_tpu/ops/pallas/occupancy.py:231", k1_err, k1_ms,
                 k1_plain))

    # K2: fused sweep, moving sensor pose --------------------------------
    dt = np.float32(0.1)
    sensor = np.asarray([0.35, -0.2, 1.0], np.float32)
    yaw = 0.3
    quat = np.asarray([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], np.float32)
    origin = geometry.window_origin_np(sensor, cfg)
    got = sweep.sweep_cuda(pool, cfg, dt, origin, sensor, quat)
    ref = sweep.sweep_reference(pool, cfg, dt, origin, sensor, quat)
    torch.cuda.synchronize()
    k2_err = max(float((got.px - ref.px).abs().max()),
                 float((got.py - ref.py).abs().max()))
    _require(k2_err <= 1e-5, f"K2 positions differ by {k2_err}")
    flips = {n: float((getattr(got, n) != getattr(ref, n)).float().mean())
             for n in ("flags", "new_cell", "tags")}
    _require(all(f < 1e-3 for f in flips.values()), f"K2 flips {flips}")
    _require(float(got.fov.float().mean()) > 0.01, "K2 input has no FOV slots")
    k2_ms = _median_ms(lambda: sweep.sweep_cuda(pool, cfg, dt, origin, sensor,
                                                quat))
    k2_plain = _median_ms(lambda: sweep.sweep_reference(pool, cfg, dt, origin,
                                                        sensor, quat))
    _say("K2", max_abs_err=k2_err, flips=json.dumps(flips), ms=k2_ms,
         plain_ms=k2_plain)
    rows.append(("sweep", "dspmap_tpu_torch/csrc/sweep.cu",
                 "dspmap_tpu/ops/pallas/sweep.py:137", k2_err, k2_ms, k2_plain))

    # K3: pair passes at 448 x 64 x 288 ----------------------------------
    n_pyr, st = cfg.n_pyramids, cfg.dense_slots
    ck = cfg.neighbor_cells * cfg.obs_dense
    sigma = float(np.float32(cfg.sigma_ob))
    centre = np.asarray([4.0, 0.5, 1.0], np.float32)
    pos = (centre + rng.normal(0, 1.0, (n_pyr, st, 3))).astype(np.float32)
    pts = (centre + rng.normal(0, 1.0, (n_pyr, ck, 3))).astype(np.float32)
    pos = pos.reshape(n_pyr, st, 3)
    # pair each point with particles a few sigma away so g is not all 0
    pts[:, :st] = pos + rng.normal(0, 2 * sigma, pos.shape).astype(np.float32)
    w = (rng.random((n_pyr, st)) * (rng.random((n_pyr, st)) > 0.3)).astype(np.float32)
    cinv = (rng.random((n_pyr, ck)) * (rng.random((n_pyr, ck)) > 0.5)).astype(np.float32)
    T = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    pos_t, pts_t, w_t, cinv_t = T(pos), T(pts), T(w), T(cinv)
    for name, kern, plain, vec in (
            ("update_pass1", update.update_pass1, update.update_pass1_plain, w_t),
            ("update_pass2", update.update_pass2, update.update_pass2_plain,
             cinv_t)):
        got = kern(pos_t, vec, pts_t, sigma)
        ref32 = plain(pos_t, vec, pts_t, sigma)
        ref64 = plain(pos_t.double(), vec.double(), pts_t.double(), sigma)
        torch.cuda.synchronize()
        err_k = float((got.double() - ref64).abs().max())
        err_p = float((ref32.double() - ref64).abs().max())
        within = bool(torch.allclose(got.double(), ref64, rtol=2e-5, atol=1e-6))
        _require(within or err_k <= err_p,
                 f"{name}: kernel err {err_k} vs plain f32 err {err_p}")
        _require(float(ref64.abs().max()) > 1e-3, f"{name}: degenerate input")
        ms = _median_ms(lambda: kern(pos_t, vec, pts_t, sigma))
        pms = _median_ms(lambda: plain(pos_t, vec, pts_t, sigma))
        _say(name, max_abs_err_vs_f64=err_k, plain_f32_err_vs_f64=err_p,
             within_rtol_2e5=within, ms=ms, plain_ms=pms)
        rows.append((name, "dspmap_tpu_torch/csrc/update.cu",
                     "dspmap_tpu/ops/pallas/update.py:"
                     + ("117" if name == "update_pass1" else "125"),
                     err_k, ms, pms))
    kernels.reset_launch_counts()
    return rows


#: (columns, n_tot, max_run) of the compact step's seg_scans calls at
#: large_urban (S = 10): occupancy_compact's two calls (reach 32) and
#: segment_table's in birth and rebin (reach 16)
SEGSCAN_CASES = ((7, 2, 20), (2, 2, 20), (4, 0, 10), (1, 0, 10))


def check_segscan(cfg, device):
    """Phase 3, K4: the segmented-scan kernel against its plain version at
    ``cfg.compact_capacity`` rows: sorted runs of 1..max_run rows, six
    rows of one run repeated further on, a dead tail and some -0.0
    values.  ``hi`` must be bit-equal on every row, ``tot`` on every live
    row.  Returns the JSON row (times of the 7-column call)."""
    import torch
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.ops import compact

    P = cfg.compact_capacity
    times = {}
    for C, n_tot, max_run in SEGSCAN_CASES:
        rng = np.random.default_rng(C * 100 + max_run)
        key = np.repeat(np.arange(P), rng.integers(1, max_run + 1, P))[:P]
        key[5000:5006] = key[11]
        key[-P // 5:] = 1 << 30
        live = torch.from_numpy(key < 1 << 30).to(device)
        st = torch.from_numpy(
            np.concatenate([[True], key[1:] != key[:-1]])).to(device)
        en = torch.from_numpy(np.concatenate([key[1:] != key[:-1], [True]])
                              & (key < 1 << 30)).to(device)
        x = rng.uniform(0, 1, (C, P)).astype(np.float32)
        x[:, ::101] = -0.0
        cols = [torch.from_numpy(c).to(device) for c in x]
        got = compact.seg_scans_cuda(cols, st, en, max_run, n_tot)
        ref = compact.seg_scans_plain(cols, st, en, max_run, n_tot)
        torch.cuda.synchronize()
        bits = lambda t: t.view(torch.int32)  # noqa: E731
        _require(all(torch.equal(bits(g), bits(r))
                     for g, r in zip(got[0], ref[0])), f"K4 hi {C} cols")
        _require(all(torch.equal(bits(g[live]), bits(r[live]))
                     for g, r in zip(got[1], ref[1])), f"K4 tot {C} cols")
        ms = _median_ms(lambda: compact.seg_scans_cuda(cols, st, en, max_run,
                                                       n_tot))
        pms = _median_ms(lambda: compact.seg_scans_plain(cols, st, en,
                                                         max_run, n_tot))
        times[C] = (ms, pms)
        _say("K4", columns=C, n_tot=n_tot, reach=compact._reach(max_run),
             rows=P, bit_equal=True, ms=ms, plain_ms=pms)
    kernels.reset_launch_counts()
    return ("seg_scans", "dspmap_tpu_torch/csrc/segscan.cu",
            "dspmap_tpu/ops/pallas/segscan.py:121", 0.0, *times[7])


def _agreement(card, cpu) -> dict:
    """Phase 5's measures of one step's result on the card against the
    CPU's: ``(state, StepOutput)`` pairs."""
    import torch

    (g_state, g_out), (c_state, c_out) = card, cpu
    close = lambda a, b, atol: float(torch.isclose(  # noqa: E731
        a.cpu(), b, rtol=1e-4, atol=atol).float().mean())
    ga, ca = int(g_out.metrics["alive"]), int(c_out.metrics["alive"])
    return dict(
        flags_equal=float((g_state.particles.flags.cpu()
                           == c_state.particles.flags).float().mean()),
        alive_card=ga, alive_cpu=ca, alive_rel=abs(ga - ca) / max(ca, 1),
        weight_sum_close=close(g_state.weight_sum, c_state.weight_sum, 1e-7),
        future_close=close(g_state.future, c_state.future, 1e-6))


def card_vs_cpu(cfg, step, state, frame, device, label="card_vs_cpu") -> None:
    """Phase 5: one frame from the same state with the same draws on the
    card and through the CPU's plain path.

    The two newborn weights ``w_b * sum 1/C(z)`` differ in their last bit:
    the CPU's pair passes use the ``|a|^2 + |b|^2 - 2ab`` form, the
    kernels coordinate differences.  Voxels full of equal-weight newborns
    sit exactly on the resample's ``ceil(x/wa - 1/2)`` grid, so that bit
    flips which copies survive there (46 of 10743 particles in one run).
    The bars (flags >= 99.9%, alive within 0.5%, weight_sum and future
    within rtol 1e-4 on >= 99.9%) therefore hold the card against a CPU
    step given the card's ``norm_coeff``; the free CPU step holds the same
    bars except alive, held within 2%, and, in the compact layout, flags:
    there the flags are compared over the P = 131072 rows of the live
    array rather than over 3.2M mostly empty pool slots, so the same flips
    weigh 24 times more (176 rows differed, 99.87% equal, with alive
    equal), and the free case is held to the free-newborn-weight flag bar
    of tests/test_torch_step.py, 99.5%."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.models import pipeline

    draws = dm.make_draws(cfg, state.gen, device)
    cpu_draws = tuple(d.cpu() for d in draws)
    cpu_state = state.to("cpu")
    name = ("particle_birth_compact" if cfg.layout == "compact"
            else "particle_birth")
    birth = getattr(pipeline, name)
    seen = {}

    def card_birth(*a, **kw):
        seen["norm_coeff"] = kw["norm_coeff"]
        return birth(*a, **kw)

    def pinned_birth(*a, **kw):
        kw["norm_coeff"] = seen["norm_coeff"].cpu()
        return birth(*a, **kw)

    try:
        setattr(pipeline, name, card_birth)
        card = step(state, frame, draws)
        setattr(pipeline, name, pinned_birth)
        pinned = _agreement(card, step(cpu_state, frame, cpu_draws))
    finally:
        setattr(pipeline, name, birth)
    free = _agreement(card, step(cpu_state, frame, cpu_draws))
    torch.cuda.synchronize()
    free_flags = 0.995 if cfg.layout == "compact" else 0.999
    for tag, m, flag_bar in ((label, pinned, 0.999),
                             (label + "_free", free, free_flags)):
        _say(tag, **m)
        _require(m["flags_equal"] >= flag_bar, f"{tag} flags")
        _require(m["weight_sum_close"] >= 0.999, f"{tag} weight_sum")
        _require(m["future_close"] >= 0.999, f"{tag} future grid")
    _require(pinned["alive_rel"] <= 0.005, f"{label} alive")
    _require(free["alive_rel"] <= 0.02, f"{label} free alive")


#: per path: (warm-up frames, timed frames, the watched warm frame, the
#: kernels' launches per frame)
PATHS = {
    "flagship": (5, 30, 4, {"occupancy_pool_pass": 1, "sweep": 1,
                            "update_pass1": 1, "update_pass2": 1,
                            "seg_scans": 0}),
    "large_urban": (3, 10, 2, {"occupancy_pool_pass": 0, "sweep": 0,
                               "update_pass1": 1, "update_pass2": 1,
                               "seg_scans": 4}),
}


def run_path(name, cfg, device):
    """Phases 4-6 for one path: its frames on the card with the launch
    counts set to 0 just before and read just after, then one frame on
    both the card and the CPU from the same state and draws.  Returns
    ``(launches, median frame ms, alive after the last frame)``."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.utils import sim

    warm, timed, watched, per_frame = PATHS[name]
    n = warm + timed
    kept_at = min(10, n - 2)  # the frame whose state phase 5 starts from
    step = dm.make_step(cfg)
    state = dm.init_state(cfg, seed=0, device=device)
    frames = list(sim.generate_sequence(n, cfg, seed=0))
    alive, ms = [], []
    kept = None
    kernels.reset_launch_counts()
    for i, (pts, n_pts, pos, quat, t) in enumerate(frames):
        t0 = time.perf_counter()
        if i == watched:  # a warm frame, watched for host syncs
            (state, out), syncs = _watch_syncs(
                lambda: step(state, dm.Frame(pts, n_pts, pos, quat, t)))
        else:
            state, out = step(state, dm.Frame(pts, n_pts, pos, quat, t))
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        _require(out.accepted, f"{name} frame {i} rejected")
        alive.append(int(out.metrics["alive"]))
        if i >= warm:
            ms.append(dt_ms)
        if i == kept_at:
            kept = state
    launches = dict(kernels.LAUNCHES)
    want = {k: v * n for k, v in per_frame.items()}
    _require(launches == want, f"{name} launch counts {launches} != {want}")
    _require(not syncs, f"{name}: host syncs in the step: {syncs}")
    _require(alive[0] > 0 and alive[-1] > alive[0], f"{name} alive {alive}")
    _require(bool(torch.isfinite(state.weight_sum).all()), "weight_sum")
    _require(bool(torch.isfinite(state.vel_avg).all()), "vel_avg")
    _require(bool(torch.isfinite(state.future).all()), "future")
    occ, centers, future, _ = dm.get_occupancy_map(state, cfg, 0.2)
    n_occ = int(occ.sum())
    _require(n_occ > 0, f"{name}: no occupied voxels")
    _say(name, frames=n, median_frame_ms=statistics.median(ms),
         alive_last=alive[-1], occupied=n_occ, launches=json.dumps(launches),
         host_syncs_in_watched_frame=len(syncs))

    card_vs_cpu(cfg, step, kept, dm.Frame(*frames[kept_at + 1]), device,
                label=f"{name}_card_vs_cpu")
    return launches, statistics.median(ms), alive[-1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels

    major, minor = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _say("card", capability=f"{major}.{minor}", torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=json.dumps(smi))
    _require(major == 9, f"need compute capability 9.x, got {major}.{minor}")

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.lib()
    _say("build", seconds=time.perf_counter() - t0)

    device = torch.device("cuda", 0)
    cfg = dm.example_node_settings(dm.dsp_dynamic())
    urban = dm.large_urban()
    rows = check_kernels(cfg, device) + [check_segscan(urban, device)]
    by_path = {}
    for name, c in (("flagship", cfg), ("large_urban", urban)):
        launches, frame_ms, alive = run_path(name, c, device)
        by_path[name] = launches
        _say(f"{name}_summary", median_frame_ms=frame_ms, alive=alive,
             card=smi)

    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(p[name] for p in by_path.values()),
         "launches_by_path": {k: p[name] for k, p in by_path.items()},
         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
        for name, src, rep, err, k_ms, p_ms in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
