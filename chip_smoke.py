#!/usr/bin/env python3
"""Drive the PyTorch port's nine paths, its IO and its sharded steps on one
CUDA card and check them.

Run from the root of a checkout on a machine with an H100::

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits nonzero):

1. the card: CUDA present, compute capability 9.x, name and power limit;
2. build the port's CUDA kernels from ``dspmap_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its paths give it (K2 reading the frame's values from the frame
   blocks, as the step hands them, and bit-equal to a launch given the
   host values; also on the upper half of the flagship pool, a slab of the
   sharded step, with ``cell_base = V/2``), with
   inputs made from a numpy seed, plus the
   median time of each over 20 runs (``ms``: CUDA events around the
   wrapper; ``device_ms``: the kernel's own duration from the profiler's
   device-side events), the least time the card could take for the same
   work (``bound_ms``: bytes moved once over 3.35 TB/s, or float
   operations over 67 TFLOP/s, whichever is larger) and, where PyTorch
   calls compute the same function, their time: K1 (pool pass) at S = 18,
   50 and 60 slots, K2 (sweep) at the same three pools, K3a/K3b (pair
   passes) at (448, 64, 288), (504, 32, 288) and (4536, 16, 400), called as
   the step calls them (operands scaled once for both passes), twice with
   bit-equal results, at a ragged shape and at rows of 9 points; K4 (segmented scans) at
   P = 131072 rows for the four calls of a compact frame, then at reach 64
   and 512, at reach 1 to 8 and at ragged row counts; K5a/K5b (relayout) at (60, 75776):
   the seven planes of a frame in one launch beside seven ``clone()``
   calls, one plane beside one; the Euclidean clustering on every case of
   ``kernel_times.cluster_case`` and on a street frame's cloud, timed at
   P = 5000 on that cloud, on it with every point valid and on the chain;
   K1's ``with_moving`` arm (the moving
   mask of the noisy and multi-sensor paths) at S = 18 with three
   velocity planes and with two, and with two on the upper half of the
   pool (a rank's slab of the sharded two-camera path);
4. the nine paths at full width on the synthetic street sequence --
   through ``make_step``: ``flagship`` (``example_node_settings(
   dsp_dynamic())``, pool layout), ``large_urban`` (compact layout),
   ``static`` (``example_node_settings(dsp_static())``), ``multi``
   (``example_node_settings(dsp_dynamic_multi_neighbors())``, whose
   planes of 17.3 MiB take the flat working phase through K5: one launch
   in and one out a frame), ``noisy`` (the flagship with
   ``limit_motion_to_xy_plane=False``: propagate, rebin and register_fov
   on [S, V] planes, K1 with its moving mask) and ``noisy_compact``
   (``large_urban(limit_motion_to_xy_plane=False)``); through
   ``make_multisensor_step`` with two cameras that share each frame's
   cloud and pose (the rule of ``bench.py``'s two-camera cell):
   ``multisensor_2cam`` (the flagship's configuration) and
   ``multisensor_compact`` (``large_urban()``); through
   ``make_multisensor_step(cfg, 4)`` on the frames of a surround rig of
   four cameras (``dspmap_tpu_torch/utils/rig.py``: camera k turned k x 90
   degrees about the body's z axis, each rendering its own cloud):
   ``multisensor_4cam`` (the flagship's configuration) -- each with
   the kernels' launch counts set to 0 before and pinned after, one warm
   frame under PyTorch's sync debug mode (it must not synchronize the host
   with the card), finite state and occupied voxels;
5. card against CPU for each path: the state after a kept frame is copied
   to the CPU and the next frame is stepped on both with the same random
   draws (see :func:`card_vs_cpu` for the bars; on the multi-sensor paths
   every sensor's birth is pinned to the card's ``norm_coeff`` in turn;
   the CPU's frames of every path run together in worker processes after
   phase 8, so that none overlaps a timed phase, and their lines and
   checks come then), then ``repeat`` (:func:`check_repeat`): from the
   path's last state, four more frames twice over with the same draws,
   every leaf of the two states and every output bit-equal; then ``graph``
   (:func:`check_graph`): eight more frames through the eager step and
   through its graphed form on the same draws, by
   ``dspmap_tpu_torch/utils/graph_ritual.py`` -- ``make_graphed_step`` on
   the six single-camera paths (one CUDA graph), and
   ``make_graphed_multisensor_step`` on the three multi-camera paths (one
   graph a pattern of admitted cameras: a frame of camera 0 alone and one
   of the last camera alone among the eight, three captures on two
   cameras; on four also a frame of cameras 0 and 2, four captures) --
   with a rejected frame and a live setter among them, every leaf and
   output bit-equal frame by frame, one capture a pattern, no kernel
   launched from the host during a replay, both frame times, each
   capture's time and memory pool;
6. the caller's TF32 matmul setting, True through phases 4 and 5, is
   still True after them;
7. ``io``, in a temporary directory (see :func:`check_io`): the replay
   entry point as a user runs it (``dspmap_tpu_torch.io.replay.main``,
   which runs the graphed step on the card) on the flagship and the
   multi-neighbor preset; checkpoints saved and loaded
   on the card for the flagship and large_urban, resumed (bit-equal to the
   run without a break), and loaded on the CPU; the particle CSV of a card state against the CPU's; a
   ``torch.profiler`` trace of two flagship frames and its summary.  Each
   sub-path pins its kernel launches as phase 4 does;
8. ``sharded`` (see :func:`check_sharded`; its ranks start, and wait off
   the card, while the kernels build): the sharded step of
   ``dspmap_tpu_torch.parallel`` in two ranks that share the card (gloo:
   NCCL takes one rank a card) on the flagship with the ``all_gather``
   mover exchange and on large_urban with the ``ring`` exchange, six
   frames each at full width, large_urban once more with update budgets
   that neither step overflows, the flagship for three frames in a
   one-rank NCCL group, then the two-camera step on the flagship and on
   large_urban with those budgets; each rank's launches pinned, one frame
   of rank 0 watched for host syncs, every replicated leaf and metric of
   the ranks compared (none may differ), the flagship run twice with its
   gathered states bit-equal, the gathered state held to the
   unsharded card step of as many cameras on the same frames and draws by
   phase 5's bars (large_urban at its own budgets, which the whole map
   overflows, by what per-rank budgets imply: see :data:`SHARDED`); every
   gloo path handed to the graphed sharded constructor, which must refuse it;
   then ``sharded_graph`` (:func:`_sharded_graph`) in the one-rank NCCL
   group: ``make_graphed_shardmap_step`` against ``make_shardmap_step`` on
   the flagship and on the two-camera flagship by
   ``dspmap_tpu_torch/utils/shard_probe.py``'s ritual (eight frames in
   turns on the same draws, a rejected frame, a setter and the
   one-camera frames), every leaf and output bit-equal, one capture a
   pattern with its launches pinned, none from the host in a replay.

The second-to-last line is a JSON object with every kernel's measurements,
the last ``{"ok": true, "device": {...}}``.  The script imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np


#: the host clock when the script started (each line ends with its
#: seconds since then, ``at_s``)
_STARTED = time.perf_counter()


def _say(phase: str, **kv) -> None:
    kv["at_s"] = round(time.perf_counter() - _STARTED, 1)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _median_ms(fn) -> float:
    """Median of 20 calls, CUDA events around the call."""
    from dspmap_tpu_torch.utils.kernel_times import median_ms

    return median_ms(fn)


def _device_ms(fn, own: bool = True):
    """Median of 20 calls of the time the card spent in the port's own
    kernels during one call (the profiler's device-side events); with
    ``own`` false, in whatever it ran.  ``None``, said on a line of its own,
    where the profiler lost events in every trace: a measurement it could
    not take, not a fault of the kernel (``ms`` is taken without it)."""
    from dspmap_tpu_torch.utils.kernel_times import (ANY_KERNEL,
                                                     ProfilerLostEvents,
                                                     device_ms)
    from dspmap_tpu_torch.utils.stage_times import OWN_KERNELS

    try:
        return device_ms(fn, names=OWN_KERNELS if own else ANY_KERNEL)
    except ProfilerLostEvents as e:
        _say("device_ms_not_measured", reason=json.dumps(str(e)))
        return None


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


#: the card's published peaks (H100 SXM): device memory and float32
#: outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def _bound(n_bytes: float, n_flops: float):
    """``(bound_ms, bound_by)``: the larger of the bytes the function must
    move once over the memory rate and its float operations over the f32
    peak."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _row(err, kernel, plain, n_bytes, n_flops, library=None, **extra):
    """One kernel's measurements at one shape: ``kernel``, ``plain`` and
    ``library`` are the calls to time."""
    bound_ms, bound_by = _bound(n_bytes, n_flops)
    return dict(max_abs_err=err, ms=_median_ms(kernel),
                device_ms=_device_ms(kernel), plain_ms=_median_ms(plain),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=_median_ms(library) if library else None,
                **({"library_device_ms": _device_ms(library, own=False)}
                   if library else {}), **extra)


#: float operations per slot of the pool pass (cull, three to five
#: slot-order sums, the weight cumsum, two grid thresholds of a divide, a
#: subtract and a ceil each, the new weight), of the sweep (advance, voxel,
#: rotation, two atan2 of about 20 each) and per particle-point pair of the
#: pair passes (three differences, their squares summed, the scale, an exp
#: of about 8, the constant, the weight, the sum)
K1_FLOPS_PER_SLOT = 24
K2_FLOPS_PER_SLOT = 80
K3_FLOPS_PER_PAIR = 20


#: the card's special-function rate: 16 ex2 a clock on each of 132 SMs at
#: the 1.98 GHz boost clock.  A pair term needs one, so this is the least
#: time of a pair pass by the unit that limits it, printed on the
#: ``K3_ex2_bound`` lines beside the ``bound_ms`` of the ``kernels`` line (20
#: float operations a pair over the f32 peak)
PEAK_EX2_PER_S = 132 * 16 * 1.98e9


def check_pairs(label, n_rows, st, ck, sigma, rng, device, timed=True):
    """Phase 3, K3a and K3b at ``(n_rows, st, ck)``: each pass within rtol
    2e-5 (atol 1e-6) of its plain version evaluated in float64, and
    bit-equal over two calls.  Timed as the step calls them, with the
    operands scaled once for both passes.  Returns ``{kernel name:
    measurements}``."""
    import torch
    from dspmap_tpu_torch.ops import update
    from dspmap_tpu_torch.utils.kernel_times import pair_operands

    pos_t, pts_t, w_t, cinv_t = pair_operands(n_rows, st, ck, sigma, rng,
                                              device)
    scaled = update.prescale_pairs(pos_t, pts_t, sigma)
    rows = {}
    for name, kern, plain, vec, n_out in (
            ("update_pass1", update.update_pass1, update.update_pass1_plain,
             w_t, ck),
            ("update_pass2", update.update_pass2, update.update_pass2_plain,
             cinv_t, st)):
        got = kern(pos_t, vec, pts_t, sigma, scaled)
        again = kern(pos_t, vec, pts_t, sigma)
        ref32 = plain(pos_t, vec, pts_t, sigma)
        ref64 = plain(pos_t.double(), vec.double(), pts_t.double(), sigma)
        torch.cuda.synchronize()
        _require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                 f"{name} {label}: two calls differ")
        err_k = float((got.double() - ref64).abs().max())
        err_p = float((ref32.double() - ref64).abs().max())
        within = bool(torch.allclose(got.double(), ref64, rtol=2e-5, atol=1e-6))
        _require(within, f"{name} {label}: kernel err {err_k} against "
                 f"float64 (the plain version in float32: {err_p})")
        _require(float(ref64.abs().max()) > 1e-3,
                 f"{name} {label}: degenerate input")
        shape = f"rows={n_rows} S_t={st} CK={ck}"
        if not timed:
            _say(f"{name}_{label}", shape=shape, max_abs_err=err_k,
                 within_rtol_2e5=within, two_calls="bit-equal")
            continue
        n_bytes = 4 * (n_rows * st * 3 + n_rows * ck * 3 + vec.numel()
                       + n_rows * n_out)
        pairs = n_rows * st * ck
        rows[name] = _row(err_k,
                          lambda: kern(pos_t, vec, pts_t, sigma, scaled),
                          lambda: plain(pos_t, vec, pts_t, sigma), n_bytes,
                          K3_FLOPS_PER_PAIR * pairs, shape=shape,
                          plain_f32_err_vs_f64=err_p, within_rtol_2e5=within)
        _say(f"{name}_{label}", **rows[name])
        if name == "update_pass1":  # K3a beside the bound of its unit
            _say(f"K3_ex2_bound_{label}", shape=shape, pairs=pairs,
                 ex2_bound_ms=pairs / PEAK_EX2_PER_S * 1e3)
    return rows


def check_kernels(label, cfg, device):
    """Phase 3 for one pool-layout configuration: K1, K2, K3a and K3b against
    their plain versions on the card at ``cfg``'s shapes.  Returns
    ``{kernel name: measurements}``."""
    import torch
    from dspmap_tpu_torch import geometry, kernels
    from dspmap_tpu_torch.ops import occupancy, sweep
    from dspmap_tpu_torch.utils.kernel_times import populated_pool

    rng = np.random.default_rng(0)
    pool = populated_pool(cfg, rng, device)
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    n_vel = occupancy._n_vel(cfg)
    shape = f"S={S} V={V} n_vel={n_vel}"
    rows = {}

    # K1: occupancy pool pass --------------------------------------------
    got = occupancy.pool_pass_cuda(pool, cfg, with_moving=False)
    ref = occupancy.pool_pass_plain(pool, cfg, with_moving=False)
    torch.cuda.synchronize()
    _require(torch.equal(got[0]["flags"], ref[0]["flags"]),
             f"K1 {label} flags differ")
    _require(torch.equal(got[0]["weight"], ref[0]["weight"]),
             f"K1 {label} weights differ")
    for name in ("px", "py", "pz", "vx", "vy"):
        _require(torch.equal(got[0][name], ref[0][name]),
                 f"K1 {label} {name} differs")
    _require(torch.equal(got[1], ref[1]), f"K1 {label} weight_sum")
    _require(torch.equal(got[4], ref[4]), f"K1 {label} static contribution")
    for a, b in zip(got[6], ref[6]):
        _require(torch.equal(a, b), f"K1 {label} counters differ")
    _require(float(ref[6][4].sum()) > 0, f"K1 {label}: nothing resampled")
    k1_err = float(torch.maximum(
        (got[0]["weight"] - ref[0]["weight"]).abs().max(),
        (got[1] - ref[1]).abs().max()))
    # read and written once: flags, weight, px, py, pz and the carried
    # velocity planes per slot; 8 + n_vel per-voxel vectors out
    k1_bytes = 2 * 4 * (5 + n_vel) * S * V + 4 * (8 + n_vel) * V
    rows["occupancy_pool_pass"] = _row(
        k1_err, lambda: occupancy.pool_pass_cuda(pool, cfg, False),
        lambda: occupancy.pool_pass_plain(pool, cfg, False), k1_bytes,
        K1_FLOPS_PER_SLOT * S * V, shape=shape)
    _say(f"K1_{label}", flags="exact", weights="exact",
         **rows["occupancy_pool_pass"])

    # K2: fused sweep, moving sensor pose --------------------------------
    dt = np.float32(0.1)
    sensor = np.asarray([0.35, -0.2, 1.0], np.float32)
    yaw = 0.3
    quat = np.asarray([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], np.float32)
    origin = geometry.window_origin_np(sensor, cfg)
    # the frame's values as the step hands them: views of its frame blocks
    args, kw = _frame_block_args(cfg, dt, sensor, quat, device)
    got = sweep.sweep_cuda(pool, cfg, *args, **kw)
    ref = sweep.sweep_reference(pool, cfg, *args, **kw)
    host = sweep.sweep_cuda(pool, cfg, dt, origin, sensor, quat)
    torch.cuda.synchronize()
    k2_err = max(float((got.px - ref.px).abs().max()),
                 float((got.py - ref.py).abs().max()))
    _require(k2_err <= 1e-5, f"K2 {label} positions differ by {k2_err}")
    for n in ("px", "py", "flags", "new_cell", "tags"):
        _require(torch.equal(getattr(got, n), getattr(host, n)),
                 f"K2 {label} {n}: the blocks' launch differs from the host "
                 "values'")
    if cfg.motion_model == "static":  # no advance: positions pass through
        _require(torch.equal(got.px, pool.px) and torch.equal(got.py, pool.py),
                 f"K2 {label} moved a static particle")
    flips = {n: float((getattr(got, n) != getattr(ref, n)).float().mean())
             for n in ("flags", "new_cell", "tags")}
    _require(all(f < 1e-3 for f in flips.values()), f"K2 {label} flips {flips}")
    _require(float(got.fov.float().mean()) > 0.01,
             f"K2 {label} input has no FOV slots")
    # in: flags px py pz vx vy; out: px py flags new_cell tags
    rows["sweep"] = _row(
        k2_err, lambda: sweep.sweep_cuda(pool, cfg, *args, **kw),
        lambda: sweep.sweep_reference(pool, cfg, *args, **kw),
        4 * 11 * S * V, K2_FLOPS_PER_SLOT * S * V, shape=f"S={S} V={V}",
        flips=flips, scalars="frame blocks")
    _say(f"K2_{label}", **rows["sweep"])

    # K3: pair passes at [n_pyr, S_t] x [n_pyr, CK] ----------------------
    rows.update(check_pairs(
        label, cfg.n_pyramids, cfg.dense_slots,
        cfg.neighbor_cells * cfg.obs_dense, float(np.float32(cfg.sigma_ob)),
        rng, device))
    kernels.reset_launch_counts()
    return rows


def _frame_block_args(cfg, dt, sensor, quat, device):
    """K2's per-frame operands as the step hands them -- views of the frame
    blocks on the card (``dspmap_tpu_torch/scalars.py``) -- as ``(args,
    kwargs)`` of ``sweep_cuda`` / ``sweep_reference`` after ``(particles,
    cfg)``."""
    from dspmap_tpu_torch import scalars

    fs = scalars.frame_scalars(cfg, device, dt=dt, sensor_pos=sensor,
                               quat=quat)
    return (fs.dt, fs.origin, fs.sensor_pos), {
        "origin_mod": fs.origin_mod, "R": fs.R}


def check_sweep_slab(cfg, device):
    """Phase 3, K2 on a slab of the sharded step: the upper half of
    ``cfg``'s pool (``[S, V/2]``, ``cell_base = V/2``) against the plain
    version at the same ``cell_base`` by :func:`check_kernels`' bars, and
    every output bit-equal to the whole-pool launch's in the same columns.
    Returns ``{kernel name: measurements}``."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.ops import sweep
    from dspmap_tpu_torch.utils.kernel_times import populated_pool

    pool = populated_pool(cfg, np.random.default_rng(0), device)
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    base = V // 2
    slab = dm.Particles(**{f.name: getattr(pool, f.name)[:, base:].contiguous()
                           for f in dataclasses.fields(dm.Particles)})
    sensor = np.asarray([0.35, -0.2, 1.0], np.float32)
    quat = np.asarray([np.cos(0.15), 0, 0, np.sin(0.15)], np.float32)
    frame, kw = _frame_block_args(cfg, np.float32(0.1), sensor, quat, device)
    args = (cfg, *frame)
    got = sweep.sweep_cuda(slab, *args, cell_base=base, **kw)
    ref = sweep.sweep_reference(slab, *args, cell_base=base, **kw)
    whole = sweep.sweep_cuda(pool, *args, **kw)
    torch.cuda.synchronize()
    err = max(float((got.px - ref.px).abs().max()),
              float((got.py - ref.py).abs().max()))
    _require(err <= 1e-5, f"K2 slab positions differ by {err}")
    flips = {n: float((getattr(got, n) != getattr(ref, n)).float().mean())
             for n in ("flags", "new_cell", "tags")}
    _require(all(f < 1e-3 for f in flips.values()), f"K2 slab flips {flips}")
    for n in ("px", "py", "flags", "new_cell", "tags"):
        _require(torch.equal(getattr(got, n), getattr(whole, n)[:, base:]),
                 f"K2 slab {n} differs from the whole pool's columns")
    _require(float(got.mover.float().mean()) > 0.01, "K2 slab: no movers")
    n = S * (V - base)
    row = _row(err, lambda: sweep.sweep_cuda(slab, *args, cell_base=base,
                                             **kw),
               lambda: sweep.sweep_reference(slab, *args, cell_base=base,
                                             **kw),
               4 * 11 * n, K2_FLOPS_PER_SLOT * n,
               shape=f"S={S} V={V - base} cell_base={base}", flips=flips)
    _say("K2_slab_flagship", whole_pool_columns="bit-equal", **row)
    kernels.reset_launch_counts()
    return {"sweep": row}


def check_moving_mask(label, cfg, device, slab=False):
    """Phase 3, K1's ``with_moving`` arm at ``cfg``'s pool shape (``slab``:
    at the upper half of it, ``[S, V/2]``, a rank's slab of the sharded
    step on two ranks): every output of the kernel, the moving mask
    included, bit-equal to the plain version's.  With three velocity
    planes the pool's moving particles move in z too.  Returns ``{kernel
    name: measurements}``."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.ops import occupancy
    from dspmap_tpu_torch.utils.kernel_times import populated_pool

    rng = np.random.default_rng(3)
    pool = populated_pool(cfg, rng, device)
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    n_vel = occupancy._n_vel(cfg)
    if n_vel == 3:
        vz = np.where(pool.vx.cpu().numpy() != 0, rng.normal(0, 0.5, (S, V)),
                      0).astype(np.float32)
        pool.vz = torch.from_numpy(vz).to(device)
    if slab:
        pool = dm.Particles(**{
            f.name: getattr(pool, f.name)[:, V // 2:].contiguous()
            for f in dataclasses.fields(dm.Particles)})
        V -= V // 2
    got = occupancy.pool_pass_cuda(pool, cfg, with_moving=True)
    ref = occupancy.pool_pass_plain(pool, cfg, with_moving=True)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    for name in ("flags", "weight", "px", "py", "pz", "vx", "vy", "vz"):
        _require(torch.equal(bits(got[0][name]), bits(ref[0][name])),
                 f"K1 {label} {name} differs")
    for i, what in ((1, "weight_sum"), (2, "n_old"), (4, "static")):
        _require(torch.equal(bits(got[i]), bits(ref[i])), f"K1 {label} {what}")
    _require(all(torch.equal(bits(a), bits(b)) for a, b in zip(got[3], ref[3])),
             f"K1 {label} velocity sums")
    _require(torch.equal(got[5], ref[5]), f"K1 {label} moving mask differs")
    _require(all(torch.equal(a, b) for a, b in zip(got[6], ref[6])),
             f"K1 {label} counters differ")
    n_moving = int(ref[5].sum())
    _require(n_moving > 0 and float(ref[6][4].sum()) > 0,
             f"K1 {label}: no moving particle or nothing resampled")
    # as check_kernels' K1, plus the one-byte mask written once
    n_bytes = 2 * 4 * (5 + n_vel) * S * V + 4 * (8 + n_vel) * V + S * V
    row = _row(0.0, lambda: occupancy.pool_pass_cuda(pool, cfg, True),
               lambda: occupancy.pool_pass_plain(pool, cfg, True), n_bytes,
               K1_FLOPS_PER_SLOT * S * V,
               shape=f"S={S} V={V} n_vel={n_vel} with_moving", moving=n_moving)
    _say(f"K1_moving_{label}", bit_equal=True, **row)
    kernels.reset_launch_counts()
    return {"occupancy_pool_pass": row}


def check_cuda_cost(device) -> None:
    """Phase 2's second line: host microseconds of ``kernels.check_cuda`` on
    one tensor with its per-device answer kept, and with the card asked for
    its compute capability on every call."""
    import torch
    from dspmap_tpu_torch import kernels

    x = torch.zeros(4, device=device)

    def asked_each_time():
        kernels._capability.clear()
        kernels.check_cuda(x)

    def per_call_us(fn, n=5000):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    _say("check_cuda", kept_us=per_call_us(lambda: kernels.check_cuda(x)),
         asked_each_time_us=per_call_us(asked_each_time))


#: planes one multi frame copies in (flags i32, then px, py, pz, vx, vy and
#: weight) and out (the zero vz plane)
RELAYOUT_IN, RELAYOUT_OUT = 7, 1


def check_relayout(cfg, device):
    """Phase 3, K5: ``to_flat_many`` and ``from_flat_many`` at ``cfg``'s
    plane shape, bit-equal to their plain versions for the seven planes of
    a frame (one i32, six f32) in one launch and for one plane: the sources
    untouched, the buffers of one call apart, the sentinel word of each
    working buffer outside its flat plane, the restored planes fresh and of
    the exact size.  Timed beside as many ``clone()`` calls on the same
    planes; a one-plane launch takes four distinct planes in turn (145 MB of
    traffic, so no launch finds its plane in the 50 MB L2, as in the step).
    Returns ``{kernel name: measurements}``."""
    import torch
    from dspmap_tpu_torch import kernels, state
    from dspmap_tpu_torch.ops import relayout
    from dspmap_tpu_torch.ops.common import padded_buffer

    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    _require(S * V * 4 >= state._DMA_RELAYOUT_BYTES and V % 1024 == 0,
             "the relayout kernels are not on this configuration's path")
    rng = np.random.default_rng(5)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    same = lambda xs, ys: all(  # noqa: E731
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bits(x), bits(y)) for x, y in zip(xs, ys))
    planes = [torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, (S, V)).astype(np.int32)).to(device).view(dtype)
        for dtype in [torch.int32] + [torch.float32] * (RELAYOUT_IN - 1)]
    keep = [x.clone() for x in planes]
    for n in (RELAYOUT_IN, 1):
        src = planes[:n]
        flats = relayout.to_flat_many_cuda(src)
        want = relayout.to_flat_many_plain(src)
        backs = relayout.from_flat_many_cuda(flats, S, V)
        want_backs = relayout.from_flat_many_plain(want, S, V)
        torch.cuda.synchronize()
        tag = f"n={n}"
        _require(all(f.shape == (S * V,) for f in flats)
                 and same(flats, want), f"K5a {tag}")
        bufs = [padded_buffer(f) for f in flats]
        _require(all(b.shape == (S * V + 1,) and b.data_ptr() % 16 == 0
                     for b in bufs), f"K5a buffers {tag}")
        starts = sorted(b.data_ptr() for b in bufs)
        _require(all(y - x >= 4 * (S * V + 1)
                     for x, y in zip(starts, starts[1:])),
                 f"K5a buffers overlap {tag}")
        _require(same(planes, keep), f"K5a wrote its source {tag}")
        _require(all(x.shape == (S, V) for x in backs)
                 and same(backs, want_backs) and same(backs, keep[:n]),
                 f"K5b {tag}")
        _require(all(x.untyped_storage().nbytes() == S * V * 4
                     for x in backs), "K5b plane is not of the exact size")
        _require(same(flats, want), f"K5b wrote its source {tag}")
    f32 = planes[1:5]  # four distinct planes for the one-plane launches
    flats = relayout.to_flat_many_cuda(planes)
    each = lambda fn, xs: (lambda: [fn(x) for x in xs])  # noqa: E731
    per = lambda row, n: {  # noqa: E731  (a row of n launches, per launch)
        k: (v / n if (k == "ms" or k.endswith("_ms")) and v is not None
            else v) for k, v in row.items()}
    n_bytes = 2 * 4 * S * V
    rows = {}
    # K5a: the frame's seven planes in one launch, beside seven clone() calls
    rows["to_flat"] = _row(
        0.0, lambda: relayout.to_flat_many_cuda(planes),
        lambda: relayout.to_flat_many_plain(planes), RELAYOUT_IN * n_bytes, 0,
        library=each(torch.clone, planes),
        shape=f"n={RELAYOUT_IN} S={S} V={V}",
        library_call=f"{RELAYOUT_IN} x torch.clone",
        one_plane=per(_row(
            0.0, each(relayout.to_flat_cuda, f32),
            each(relayout.to_flat_plain, f32), len(f32) * n_bytes, 0,
            library=each(torch.clone, f32)), len(f32)))
    # K5b: the one plane a frame copies out, beside one clone() call
    one = flats[1:5]
    rows["from_flat"] = per(_row(
        0.0, each(lambda f: relayout.from_flat_cuda(f, S, V), one),
        each(lambda f: relayout.from_flat_plain(f, S, V), one),
        len(one) * n_bytes, 0, library=each(torch.clone, one),
        shape=f"n={RELAYOUT_OUT} S={S} V={V}", library_call="torch.clone"),
        len(one))
    for name in rows:
        _say(f"K5_{name}", bit_equal=True, **rows[name])
    kernels.reset_launch_counts()
    return rows


#: K4 beyond the paths: (row count, n_tot, max_run, column types).  Reach 64
#: and 512 and reach 1 to 8 take the kernel's tile form; the row counts are
#: no multiple of a window (32), a strip or a tile (1024)
SEGSCAN_EXTRA = ((131072, 2, 50, ("f32", "bool", "f32")),
                 (131072, 1, 400, ("f32", "i32")),
                 (131072, 1, 1, ("f32", "bool")),
                 (20011, 2, 2, ("i32", "f32", "bool")),
                 (33 * 1024 + 1, 2, 3, ("f32", "bool")),
                 (6001, 1, 7, ("bool", "f32", "i32")),
                 (131072 - 1000 + 7, 2, 20, ("bool", "f32", "i32")),
                 (33 * 1024 + 1, 1, 10, ("f32", "bool")),
                 (20011, 2, 50, ("f32", "bool")),
                 (6001, 1, 400, ("i32", "f32")))


def check_segscan(cfg, device):
    """Phase 3, K4: the segmented-scan kernel against its plain version at
    ``cfg.compact_capacity`` rows for the four calls of a compact frame,
    with the column types the step passes: sorted runs of 1..max_run rows,
    six rows of one run repeated further on, a dead tail and some -0.0
    values.  ``hi`` must be bit-equal on every row, ``tot`` on every live
    row.  Then the cases of ``SEGSCAN_EXTRA``, bit-equal on every row.
    Returns the JSON row (times of the 7-column call)."""
    import torch
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.ops import compact
    from dspmap_tpu_torch.utils.kernel_times import SEGSCAN_CALLS, segscan_case

    bits = lambda t: t.view(torch.int32)  # noqa: E731

    def compare(P, n_tot, max_run, types, every_row):
        cols, st, en, live = segscan_case(P, types, max_run, device)
        if every_row:
            live = torch.ones_like(live)
        got = compact.seg_scans_cuda(cols, st, en, max_run, n_tot)
        ref = compact.seg_scans_plain(cols, st, en, max_run, n_tot)
        torch.cuda.synchronize()
        tag = f"P={P} C={len(types)} n_tot={n_tot} max_run={max_run}"
        _require(len(got[0]) == len(types) and len(got[1]) == n_tot,
                 f"K4 outputs {tag}")
        _require(all(torch.equal(bits(g), bits(r))
                     for g, r in zip(got[0], ref[0])), f"K4 hi {tag}")
        _require(all(torch.equal(bits(g[live]), bits(r[live]))
                     for g, r in zip(got[1], ref[1])), f"K4 tot {tag}")
        return cols, st, en

    P = cfg.compact_capacity
    times = {}
    for n_tot, max_run, types in SEGSCAN_CALLS:
        cols, st, en = compare(P, n_tot, max_run, types, every_row=False)
        C = len(types)
        # in: C columns (4 bytes or 1) and two flag bytes a row; out: C hi
        # and n_tot tot columns; log2(reach) adds a column forward
        steps = int(np.log2(compact._reach(max_run)))
        in_bytes = sum(c.element_size() for c in cols) + 2
        times[C] = _row(
            0.0, lambda: compact.seg_scans_cuda(cols, st, en, max_run, n_tot),
            lambda: compact.seg_scans_plain(cols, st, en, max_run, n_tot),
            P * (in_bytes + 4 * (C + n_tot)), P * C * steps,
            shape=f"P={P} C={C} n_tot={n_tot} types={','.join(types)}")
        _say("K4", columns=C, n_tot=n_tot, reach=compact._reach(max_run),
             rows=P, bit_equal=True, ms=times[C]["ms"],
             device_ms=times[C]["device_ms"], plain_ms=times[C]["plain_ms"],
             bound_ms=times[C]["bound_ms"])
    for P_x, n_tot, max_run, types in SEGSCAN_EXTRA:
        compare(P_x, n_tot, max_run, types, every_row=True)
        _say("K4_extra", rows=P_x, columns=len(types), n_tot=n_tot,
             reach=compact._reach(max_run), bit_equal="every row")
    kernels.reset_launch_counts()
    return {"seg_scans": {**times[7], "by_call": {
        f"C={C}": {k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
        for C, t in times.items()}}}


#: the JV solve's phase-3 instances: every JV_ON_CARD-th is also solved by
#: the plain version on the card (the plain version on the CPU runs in the
#: WORKERS processes while the kernels build); besides the flagship's
#: (``_jv_sets``), the block arm's: tie-heavy costs at N = JV_BLOCK_N, past
#: the warp arm's WARP_MAX_N = 31, from a generator of seed JV_BLOCK_N
JV_ON_CARD = 25
JV_BLOCK_N, JV_BLOCK_INSTANCES = 40, 36
#: the worker processes of the CPU's side, one a core of the card's host
#: (8): the JV check's plain solves while the kernels build, then phase 5's
#: CPU frames once the card's phases are done
WORKERS = 8
#: float operations a JV path step takes per column (two subtracts, an
#: add, the compare and the argmin's compare) and a row per used column
#: (the two potential updates)
JV_FLOPS_PER_COLUMN_STEP, JV_FLOPS_PER_USED = 5, 2


def _jv_sets(n):
    """:func:`check_jv`'s instance sets at the flagship's ``N = n``:
    ``{N: (seed, instances)}``, the warp arm's (tie-heavy costs from
    ``kernel_times``' seed, the ones it checks before the one it times, n_rows
    cycling through 0..N) and the block arm's."""
    from dspmap_tpu_torch.utils.kernel_times import JV_INSTANCES, JV_SEED

    return {n: (JV_SEED, JV_INSTANCES),
            JV_BLOCK_N: (JV_BLOCK_N, JV_BLOCK_INSTANCES)}


def _jv_plain_share(n, part):
    """``_jv_plain`` on the CPU of :func:`check_jv`'s instances ``part``,
    ``part + WORKERS``, ... of each set: ``{(N, k): p as numpy}`` (run in a
    worker process of its own)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dspmap_tpu_torch.ops import assignment
    from dspmap_tpu_torch.utils.kernel_times import jv_case

    torch.set_num_threads(1)
    out = {}
    for N, (seed, count) in _jv_sets(n).items():
        rng = np.random.default_rng(seed)
        for k in range(count):
            a = jv_case(N, rng)
            if k % WORKERS == part:
                out[N, k] = assignment._jv_plain(
                    torch.from_numpy(a), torch.tensor(k % (N + 1)), N).numpy()
    return out


def start_jv_plain(cfg):
    """Start :func:`_jv_plain_share` in :data:`WORKERS` processes for
    :func:`check_jv` at ``cfg``'s ``N = max_clusters``.  Returns the pool
    (the caller shuts it down) and the futures."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return pool, [pool.submit(_jv_plain_share, cfg.max_clusters, part)
                  for part in range(WORKERS)]


def check_jv(cfg, device, on_cpu):
    """Phase 3, the JV solve (``jv_solve``): the kernel's ``p`` bit-equal
    to ``_jv_plain``'s on ``kernel_times.JV_INSTANCES`` tie-heavy costs at
    the flagship's ``N = max_clusters`` (the warp arm) and on
    :data:`JV_BLOCK_INSTANCES` at :data:`JV_BLOCK_N` (the block arm) --
    the plain version on the CPU, whose adds, subtracts, compares and
    argmin give the card's bits (``on_cpu``, by ``(N, instance)``, from
    :func:`start_jv_plain`), and on the card for every
    :data:`JV_ON_CARD`-th.  Timed with every row augmented on
    ``kernel_times.jv_timed_cases``' two costs at the flagship's N, the
    tie-heavy one and the worst chain; each bound counts the path steps
    that cost takes (``kernel_times.jv_numpy``), and ``ns_per_path_step``
    is the device time over them.  Returns ``{shape label: {kernel name:
    measurements}}``."""
    import torch
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.ops import assignment
    from dspmap_tpu_torch.utils.kernel_times import (jv_case, jv_numpy,
                                                     jv_timed_cases)

    N = R = cfg.max_clusters
    _require(N <= assignment.WARP_MAX_N < JV_BLOCK_N,
             f"jv_solve: N = {N} and {JV_BLOCK_N} check one arm")
    for n, (seed, count) in _jv_sets(N).items():
        rng = np.random.default_rng(seed)
        equal = on_card = 0
        for k in range(count):
            a_np = jv_case(n, rng)
            a = torch.from_numpy(a_np).to(device)
            n_rows = torch.tensor(k % (n + 1), dtype=torch.int64,
                                  device=device)
            got = assignment.jv_solve_cuda(a, n_rows, n).cpu()
            equal += torch.equal(got, torch.from_numpy(on_cpu[n, k]))
            if k % JV_ON_CARD == 0:
                on_card += torch.equal(got, assignment._jv_plain(
                    a, n_rows, n).cpu())
        arm = "warp" if n <= assignment.WARP_MAX_N else "block"
        _require(equal == count and on_card == len(range(0, count,
                                                         JV_ON_CARD)),
                 f"jv_solve, {arm} arm at N = {n}: {equal} of {count} "
                 f"bit-equal to the plain version, {on_card} on the card")
        full = torch.tensor(n, dtype=torch.int64, device=device)
        steps = jv_numpy(a_np, n, n)[1]
        d_ms = _device_ms(lambda: assignment.jv_solve_cuda(a, full, n))
        _say("jv_solve_check", arm=arm, N=n, instances=count,
             bit_equal=equal, plain_on_card_bit_equal=on_card,
             last_cost_all_rows_path_steps=steps, device_ms=d_ms,
             ns_per_path_step=d_ms and d_ms * 1e6 / steps)
    n_rows = torch.tensor(R, dtype=torch.int64, device=device)
    rows = {}
    for case, a_np in jv_timed_cases(N).items():
        a = torch.from_numpy(a_np).to(device)
        _, n_path, _ = jv_numpy(a_np, R, R)
        _require(torch.equal(
            assignment.jv_solve_cuda(a, n_rows, R).cpu(),
            assignment._jv_plain(a.cpu(), n_rows.cpu(), R)),
            f"jv_solve {case}: not bit-equal to the plain version")
        # cost read once, n_rows read, p written once
        n_bytes = 4 * N * N + 8 + 8 * (N + 1)
        n_flops = (JV_FLOPS_PER_COLUMN_STEP * N * n_path
                   + JV_FLOPS_PER_USED * (n_path + R))
        row = _row(0.0, lambda: assignment.jv_solve_cuda(a, n_rows, R),
                   lambda: assignment._jv_plain(a, n_rows, R), n_bytes,
                   n_flops, shape=f"N={N} R={R} n_rows={R} {case}",
                   path_steps=n_path)
        row["ns_per_path_step"] = (row["device_ms"] and
                                   row["device_ms"] * 1e6 / n_path)
        _say(f"jv_solve_{case}", **row)
        rows[case] = row
    kernels.reset_launch_counts()
    return {"flagship": {"jv_solve": rows["tie_heavy"]},
            "flagship_worst_chain": {"jv_solve": rows["worst_chain"]}}


#: the clustering check's frame of the street sequence, whose non-ground
#: cloud it times
CLUSTER_FRAME = 10


def _street_cloud(cfg, device, all_valid=False):
    """The points and the non-ground mask the estimator clusters at frame
    :data:`CLUSTER_FRAME` of the street sequence (with ``all_valid``, every
    one of the frame's points valid, ground included)."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.models import pipeline
    from dspmap_tpu_torch.utils import sim

    state = dm.init_state(cfg, seed=0, device=device)
    *_, (pts, n, pos, quat, _) = sim.generate_sequence(CLUSTER_FRAME + 1, cfg,
                                                       seed=0)
    obs, _ = pipeline._observe(pts, n, pos, quat, cfg, state.params, device)
    if all_valid:
        return obs.cloud_world, torch.ones_like(obs.cloud_valid)
    ground = obs.cloud_world[:, 2] <= cfg.voxel_filter_resolution
    return obs.cloud_world, obs.cloud_valid & ~ground


def check_cluster(cfg, device):
    """Phase 3, the Euclidean clustering (``euclidean_cluster``): the
    kernel's labels bit-equal to the plain version's on the card for every
    ``kernel_times.cluster_case`` kind at the flagship's P and for the
    street's cloud; timed on the street's non-ground cloud (as the
    estimator hands it), on the same frame with every point valid and on
    the chain (every sweep run), at the flagship's tolerance and sweeps.
    ``ms`` times the wrapper (the Gram product included), ``device_ms`` the
    kernel's own launches; the bound counts the Gram product read once,
    ``sq``, the valid flags and the labels.  ``sweeps`` is what the
    kernel's counter on the card read for the call.  Returns ``{shape
    label: {kernel name: measurements}}``."""
    import torch
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.ops import cluster
    from dspmap_tpu_torch.utils.kernel_times import (CLUSTER_KINDS,
                                                     CLUSTER_TOLERANCE,
                                                     cluster_case)

    P, iters = cfg.max_input_points, cfg.cluster_propagation_iters
    tol = cfg.cluster_tolerance
    clouds = {"street": _street_cloud(cfg, device) + (tol,),
              "street_all_valid": _street_cloud(cfg, device, True) + (tol,)}
    for kind in CLUSTER_KINDS:
        pts, ok = cluster_case(kind, P, np.random.default_rng(P))
        clouds[kind] = (torch.from_numpy(pts).to(device),
                        torch.from_numpy(ok).to(device), CLUSTER_TOLERANCE)
    sweeps = {}
    for kind, (pts, ok, t) in clouds.items():
        s0, _ = cluster.sweeps_run(device)
        got = cluster.euclidean_cluster_cuda(pts, ok, t, iters)
        sweeps[kind] = cluster.sweeps_run(device)[0] - s0
        _require(torch.equal(got, cluster.euclidean_cluster_plain(
            pts, ok, t, iters)),
            f"euclidean_cluster {kind}: not bit-equal to the plain version")
    _say("euclidean_cluster_check", P=P, iters=iters,
         cases=json.dumps(sorted(clouds)), bit_equal=len(clouds),
         sweeps=json.dumps(sweeps))
    rows = {}
    for case in ("street", "street_all_valid", "chain"):
        pts, ok, t = clouds[case]
        n_bytes = 4 * P * P + 4 * P + P + 4 * P
        row = _row(0.0, lambda: cluster.euclidean_cluster_cuda(pts, ok, t,
                                                               iters),
                   lambda: cluster.euclidean_cluster_plain(pts, ok, t, iters),
                   n_bytes, 0, shape=f"P={P} iters={iters} {case}",
                   valid_points=int(ok.sum()), sweeps=sweeps[case])
        _say(f"euclidean_cluster_{case}", **row)
        rows[case] = row
    kernels.reset_launch_counts()
    return {"flagship": {"euclidean_cluster": rows["street"]},
            "flagship_all_valid": {"euclidean_cluster":
                                   rows["street_all_valid"]},
            "flagship_chain": {"euclidean_cluster": rows["chain"]}}


#: torch's threads in a worker process that steps phase 5's CPU frames
CPU_THREADS = 1


def _cpu_frame(cfg, n_sensors, state, frame, draws, updates):
    """Phase 5's CPU step, in a worker process of :func:`start_jv_plain`'s
    pool: ``state`` (on the CPU) through the plain path on ``frame`` with
    ``draws``, each ``measurement_update`` pinned to the next of
    ``updates`` (``None``: the free step).  Returns the new state's flags,
    ``weight_sum`` and future, its ``alive`` and the step's seconds."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.utils.parity import updates_pinned

    torch.set_num_threads(CPU_THREADS)
    step = (dm.make_step(cfg) if n_sensors is None
            else dm.make_multisensor_step(cfg, n_sensors))
    pending = list(updates or ())
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if updates is None
          else updates_pinned(pending)):
        new, out = step(state, frame, draws)
    if pending:
        raise RuntimeError(f"{len(pending)} updates left unpinned")
    return (new.particles.flags, new.weight_sum, new.future,
            out.metrics["alive"], time.perf_counter() - t0)


def _measures(flags, weight_sum, future, alive):
    """What :func:`~dspmap_tpu_torch.utils.parity.agreement` reads of a
    step's ``(state, output)``."""
    from types import SimpleNamespace as NS

    return (NS(particles=NS(flags=flags), weight_sum=weight_sum,
               future=future), NS(metrics={"alive": alive}))


def card_vs_cpu(cfg, step, state, frame, device, label="card_vs_cpu",
                n_sensors=None):
    """Phase 5: one frame from the same state with the same draws on the
    card and through the CPU's plain path (``n_sensors``: the step is
    :func:`make_multisensor_step`'s, whose updates are pinned one by one).
    The card's frame runs here.  Returns ``(jobs, check)``: the arguments
    of the two CPU frames (the teacher-forced and the free one) for
    :func:`_cpu_frame`, which the caller runs in worker processes once no
    timed phase is left, and the check, which takes their results, prints
    the lines and holds the bars.

    The updated weights and the newborn weight ``w_b * sum 1/C(z)`` differ
    in their last bits: the CPU's pair passes use the ``|a|^2 + |b|^2 -
    2ab`` form, the kernels coordinate differences.  Voxels full of
    equal-weight newborns sit exactly on the resample's ``ceil(x/wa -
    1/2)`` grid, so that bit flips which copies survive there (46 of 10743
    particles in one run), and an updated weight on the other side of the
    cull threshold reorders the compact layout's sorted rows (thousands of
    rows' flags for one particle).  The bars (flags >= 99.9%, alive within
    0.5%, weight_sum and future within rtol 1e-4 on >= 99.9%) therefore
    hold the card against a CPU step given the card's result of each
    ``measurement_update`` (its particles and ``norm_coeff``: birth and
    occupancy alone); the free CPU step holds the same bars except alive,
    held within 2%, and, in the compact layout, flags: there the flags are
    compared over the P = 131072 rows of the live array rather than over
    3.2M mostly empty pool slots, so the same flips weigh 24 times more
    (176 rows differed, 99.87% equal, with alive equal), and the free case
    is held to the free-newborn-weight flag bar of
    tests/test_torch_step.py, 99.5%.  Both sets of bars are
    ``utils/parity.py``'s (``PINNED_BARS``, ``free_bars``), which
    ``tools/parity_torch.py card`` holds every frame of 30 to."""
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.utils.parity import (PINNED_BARS, agreement,
                                               free_bars, missed_bars,
                                               updates_recorded)

    if n_sensors is None:
        draws = dm.make_draws(cfg, state.gen, device)
        cpu_draws = tuple(d.cpu() for d in draws)
    else:
        draws = dm.make_multisensor_draws(cfg, n_sensors, state.gen, device)
        prop, sensors = draws
        cpu_draws = (None if prop is None else prop.cpu(),
                     tuple(tuple(d.cpu() for d in s) for s in sensors))
    cpu_state = state.to("cpu")
    t0 = time.perf_counter()
    seen = []
    with updates_recorded(seen):
        new, out = step(state, frame, draws)
    card = _measures(new.particles.flags.cpu(), new.weight_sum.cpu(),
                     new.future.cpu(), out.metrics["alive"].cpu())
    card_s = time.perf_counter() - t0
    _require(len(seen) == (n_sensors or 1),
             f"{label}: {len(seen)} updates recorded")
    updates = [(p.to("cpu"), nc.cpu()) for p, nc in seen]
    jobs = [(cfg, n_sensors, cpu_state, frame, cpu_draws, u)
            for u in (updates, None)]

    def check(results):
        (*pinned, pinned_s), (*free, free_s) = results
        _say(label + "_cost", card_frame_s=card_s, cpu_frame_s=json.dumps(
            [pinned_s, free_s]), cpu_threads=CPU_THREADS)
        for tag, m, bars in (
                (label, agreement(card, _measures(*pinned)), PINNED_BARS),
                (label + "_free", agreement(card, _measures(*free)),
                 free_bars(cfg))):
            _say(tag, **m)
            missed = missed_bars(m, bars)
            _require(not missed, f"{tag} missed the bars of {missed}")

    return jobs, check


_POOL_FRAME = {"occupancy_pool_pass": 1, "sweep": 1, "update_pass1": 1,
               "update_pass2": 1, "seg_scans": 0, "to_flat": 0, "from_flat": 0,
               "jv_solve": 1, "euclidean_cluster": 1}
_COMPACT_FRAME = {**_POOL_FRAME, "occupancy_pool_pass": 0, "sweep": 0,
                  "seg_scans": 4}
def _cameras(n) -> dict:
    """``n`` cameras: the pair passes and the estimator's JV solve and
    clustering run once a sensor."""
    return {"update_pass1": n, "update_pass2": n, "jv_solve": n,
            "euclidean_cluster": n}


#: per path: (warm-up frames, timed frames, the watched warm frame, the
#: kernels' launches per frame, sensors: None for ``make_step``, whether
#: its cameras are ``utils/rig.py``'s surround rig -- each its own cloud --
#: rather than each given the frame's one cloud and pose; the frames are
#: ``graph_ritual.sequence``'s).  The
#: multi-neighbor planes (17.3 MiB) take the flat working phase: flags, px,
#: py, pz, vx, vy and weight are copied in by one K5a launch (vz is made
#: anew as zeros, t is not touched); K1 reads the seven working planes
#: where they lie, and one K5b launch copies out vz, which K1 hands
#: through.  The noisy arm and the multi-sensor steps never call the sweep
#: (K2) and keep [S, V] planes (no K5).  A compact frame launches K4 four
#: times (rebin_compact's segment table, birth's table, occupancy's two
#: scan sets); the two-camera compact frame five, birth's table once a
#: sensor.  The velocity estimator clusters once and solves one assignment a
#: frame (a camera) wherever it runs: every path but static, whose preset
#: turns it off.  The
#: four-camera path runs the flagship's pool through the same stages as the
#: two-camera one.
PATHS = {
    "flagship": (5, 10, 4, _POOL_FRAME, None, False),
    "large_urban": (3, 6, 2, _COMPACT_FRAME, None, False),
    "static": (3, 8, 2, {**_POOL_FRAME, "jv_solve": 0,
                         "euclidean_cluster": 0}, None, False),
    "multi": (3, 8, 2, {**_POOL_FRAME, "to_flat": 1, "from_flat": 1}, None,
              False),
    "noisy": (5, 10, 4, {**_POOL_FRAME, "sweep": 0}, None, False),
    "noisy_compact": (3, 6, 2, _COMPACT_FRAME, None, False),
    "multisensor_2cam": (3, 8, 2, {**_POOL_FRAME, "sweep": 0,
                                   **_cameras(2)}, 2, False),
    "multisensor_compact": (3, 4, 2, {**_COMPACT_FRAME, "seg_scans": 5,
                                      **_cameras(2)}, 2, False),
    "multisensor_4cam": (3, 4, 2, {**_POOL_FRAME, "sweep": 0,
                                   **_cameras(4)}, 4, True),
}


def run_path(name, cfg, device):
    """Phases 4 and 5 for one path: its frames on the card with the launch
    counts set to 0 just before and read just after, then one frame on
    the card from a kept state, to be held against the CPU's from the same
    state and draws (:func:`card_vs_cpu`).  Returns ``(launches, median
    frame ms, alive after the last frame, the state after it, phase 5's
    CPU jobs and check)``."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.utils.graph_ritual import sequence

    warm, timed, watched, per_frame, n_sensors, rig = PATHS[name]
    n = warm + timed
    kept_at = min(10, n - 2)  # the frame whose state phase 5 starts from
    frames = sequence(n, cfg, n_sensors, rig)
    if n_sensors is None:
        step = dm.make_step(cfg)
        state = dm.init_state(cfg, seed=0, device=device)
    else:
        step = dm.make_multisensor_step(cfg, n_sensors)
        state = dm.init_multisensor_state(cfg, n_sensors, seed=0,
                                          device=device)
    alive, ms = [], []
    kept = None
    kernels.reset_launch_counts()
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        if i == watched:  # a warm frame, watched for host syncs
            (state, out), syncs = _watch_syncs(lambda: step(state, frame))
        else:
            state, out = step(state, frame)
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        _require(out.accepted, f"{name} frame {i} rejected")
        alive.append(int(out.metrics["alive"]))
        if i >= warm:
            ms.append(dt_ms)
        if i == kept_at:
            kept = state
    launches = dict(kernels.LAUNCHES)
    _pinned(name, launches, {k: v * n for k, v in per_frame.items()})
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

    phase5 = card_vs_cpu(cfg, step, kept, frames[kept_at + 1], device,
                         label=f"{name}_card_vs_cpu", n_sensors=n_sensors)
    return launches, statistics.median(ms), alive[-1], state, phase5


#: the ``repeat`` phase: frames run twice a path, and the seed of their draws
REPEAT_FRAMES, REPEAT_SEED = 4, 1


def check_repeat(name, cfg, state, device) -> None:
    """The ``repeat`` phase for one path: from ``state`` (the path's state
    after phase 4), the next :data:`REPEAT_FRAMES` frames of its sequence
    twice over with the same draws (made once, up front, from a generator
    of their own): every leaf of the two states and every output must be
    bit-equal.  Float sums that meet duplicate indices add in an order
    fixed by the indices (``ops/common.py::add_at``), so the card repeats
    its bits."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.utils.graph_ritual import sequence
    from dspmap_tpu_torch.utils.parity import (differing_leaves,
                                               differing_outputs, leaves)

    warm, timed, _, _, n_sensors, rig = PATHS[name]
    n = warm + timed
    frames = sequence(n + REPEAT_FRAMES, cfg, n_sensors, rig)[n:]
    gen = torch.Generator(device=device)
    gen.manual_seed(REPEAT_SEED)
    if n_sensors is None:
        step = dm.make_step(cfg)
        draws = [dm.make_draws(cfg, gen, device) for _ in frames]
    else:
        step = dm.make_multisensor_step(cfg, n_sensors)
        draws = [dm.make_multisensor_draws(cfg, n_sensors, gen, device)
                 for _ in frames]
    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        s, outs = state, []
        for frame, d in zip(frames, draws):
            s, out = step(s, frame, d)
            _require(out.accepted, f"repeat_{name}: frame rejected")
            outs.append(out)
        runs.append((s, outs))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    (a, outs_a), (b, outs_b) = runs
    differ = differing_leaves(a, b)
    out_differ = sorted({k for x, y in zip(outs_a, outs_b)
                         for k in differing_outputs(x, y)})
    _say(f"repeat_{name}", frames=REPEAT_FRAMES, runs=2,
         leaves=len(leaves(a)), leaves_differing=json.dumps(differ),
         outputs_differing=json.dumps(out_differ),
         alive=int(outs_a[-1].metrics["alive"]), seconds=seconds)
    _require(not differ, f"repeat_{name}: leaves differ: {differ}")
    _require(not out_differ, f"repeat_{name}: outputs differ: {out_differ}")


#: the per-camera kernels: launches a frame for each camera admitted (the
#: compact layout's birth table is a K4 launch a camera, too)
_A_CAMERA = {"update_pass1": 1, "update_pass2": 1, "jv_solve": 1,
             "euclidean_cluster": 1}


def _pattern_frame(per_frame, admitted) -> dict:
    """A path's launches a frame when only the cameras ``admitted`` run
    (``per_frame`` is the frame of every camera)."""
    skipped = len(admitted) - sum(admitted)
    less = {**_A_CAMERA, "seg_scans": 1 if per_frame["seg_scans"] else 0}
    return {k: v - skipped * less.get(k, 0) for k, v in per_frame.items()}


def check_graph(name, cfg, state, device, smi) -> None:
    """The ``graph`` phase for one path: from ``state`` (the path's state
    after phase 4; neither step modifies it) the next ``graph_ritual.FRAMES``
    frames of its sequence through the eager step (``make_step`` or
    ``make_multisensor_step``) and its graphed form (``make_graphed_step``
    or ``make_graphed_multisensor_step``) in turns by
    ``dspmap_tpu_torch/utils/graph_ritual.py``'s ``in_turns``, each step
    drawing from its own of two equal generators as replay and the ROS
    bridges run it (so on the same draws, and the graphed step's own draw
    path held): a pose jump that admission control rejects, a live setter,
    on the multi-camera paths a frame of camera 0 alone and one of the
    last camera alone (and one of cameras 0 and 2 on four cameras).  Every
    state leaf and every output must be bit-equal after each frame, the
    graphed step must capture once a pattern of admitted cameras (one graph
    on a single-camera path, three on a two-camera path, four on the
    four-camera path; each capture's warm-up run and capture call each
    wrapper once the pattern's frame's worth) and launch no kernel from the
    host during a replay.
    Prints the frame medians of both steps over the frames of every camera
    after the first capture, each capture's own ms and memory pool, the
    host launches a graphed frame and the card's busy ms in one profiled
    graphed frame; then frees the graphs."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.utils import graph_ritual as gr

    warm, timed, _, per_frame, n_sensors, rig = PATHS[name]
    n = warm + timed + REPEAT_FRAMES
    frames, patterns = gr.ritual_frames(
        gr.sequence(n + gr.FRAMES, cfg, n_sensors, rig)[n:], n_sensors)
    if n_sensors is None:
        eager, graphed = dm.make_step(cfg), dm.make_graphed_step(cfg)
    else:
        eager = dm.make_multisensor_step(cfg, n_sensors)
        graphed = dm.make_graphed_multisensor_step(cfg, n_sensors)

    def seeded():
        gen = torch.Generator(device=device)
        gen.manual_seed(gr.SEED)
        return gen

    turns = gr.in_turns(eager, graphed,
                        dataclasses.replace(state, gen=seeded()),
                        dataclasses.replace(state, gen=seeded()),
                        frames, patterns)
    _require(not turns.failed, f"graph_{name}: {turns.failed}")
    for label, launched in turns.capture_launches.items():
        _pinned(f"graph_{name} capture {label}", launched,
                {key: 2 * v for key, v in _pattern_frame(
                    per_frame, tuple(c == "1" for c in label)).items()})
    # one more frame, profiled: the last frame again (dt = 0 is admitted)
    busy = gr.busy(lambda: graphed(turns.b, frames[-1]))
    by_label = lambda d: json.dumps({gr.pattern_label(p): v  # noqa: E731
                                     for p, v in d.items()})
    capture_ms, pool_bytes, kept_bytes = (by_label(graphed.capture_ms),
                                          by_label(graphed.pool_bytes),
                                          by_label(graphed.kept_bytes))
    captures = graphed.captures
    graphed.release()
    turns.a = turns.b = turns.out_a = turns.out_b = graphed = None
    torch.cuda.empty_cache()
    _say(f"graph_{name}", frames=gr.FRAMES, rejected=1, setter=1,
         partial_frames=0 if n_sensors is None else len(
             gr.some_cameras(n_sensors)),
         eager_frame_ms=statistics.median(turns.eager_ms),
         graphed_frame_ms=statistics.median(turns.graphed_ms),
         graphed_frame_ms_all=json.dumps([round(x, 3)
                                          for x in turns.graphed_ms]),
         capture_ms=capture_ms,
         capture_call_ms=json.dumps(turns.capture_call_ms),
         pool_bytes=pool_bytes, kept_bytes=kept_bytes,
         host_launches_per_graphed_frame=max(turns.replay_launches),
         device_busy_ms=(busy["device_busy_ms"] if busy["device_events"]
                         else "not measured"),
         own_kernels=json.dumps(busy["own_kernels"]),
         device_events=busy["device_events"], captures=captures,
         leaves_differing=0, outputs_differing=0, card=json.dumps(smi))


def _pinned(name, launches, want) -> None:
    _require(launches == want, f"{name} launch counts {launches} != {want}")


def _replay(name, args, frames, per_frame):
    """Phase 7: ``replay.main(args)`` as a user calls it, its standard output
    captured, the launch counts set to 0 before and pinned after: on the
    card the replay runs the graphed step, whose warm-up run and capture
    call each wrapper a frame's worth and whose replays none.  Returns
    ``(the JSON summary, the launches)``."""
    import contextlib
    import io

    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.io import replay

    said = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(said):
        replay.main(args)
    launches = dict(kernels.LAUNCHES)
    _pinned(name, launches, {k: 2 * v for k, v in per_frame.items()})
    lines = said.getvalue().splitlines()
    _require(sum(line.startswith("frame ") for line in lines) == frames,
             f"{name}: {len(lines)} lines")
    summary = json.loads(next(line for line in lines if line.startswith("{")))
    _require(set(summary) == {"mean_ms", "p50_ms", "updates_per_sec"},
             f"{name} summary {summary}")
    return summary, launches


def check_checkpoint(label, cfg, device, tmp):
    """Phase 7 for one configuration: four frames on the card, a save, a
    load into a card template of another seed (every leaf and the
    generator's state bit-equal), two more frames of both the restored and
    the uninterrupted state with their generators' own draws (held to the
    bars of phase 5's comparison with the births pinned, and bit-equal to
    it, as is the same two frames stepped once more from the saved state
    without the checkpoint), the same file loaded into a CPU template
    (bit-equal), and the particle CSV of the card state against the same
    state's on the CPU (the same bytes).  Returns the launches of
    its ten card frames."""
    import dataclasses

    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.io import export_particles_csv, load_state, save_state
    from dspmap_tpu_torch.utils import sim
    from dspmap_tpu_torch.utils.parity import agreement, differing_leaves

    name = f"io_checkpoint_{label}"
    step = dm.make_step(cfg)
    frames = [dm.Frame(*f) for f in sim.generate_sequence(6, cfg, seed=0)]
    kernels.reset_launch_counts()
    state = dm.init_state(cfg, seed=0, device=device)
    for f in frames[:4]:
        state, out = step(state, f)
        _require(out.accepted, f"{name}: frame rejected")
    path = os.path.join(tmp, f"{label}.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_state(state, path)
    save_ms = (time.perf_counter() - t0) * 1e3
    template = dm.init_state(cfg, seed=1, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = load_state(template, path)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    _require(restored.device == state.device, f"{name}: restored off the card")
    differ = differing_leaves(restored, state)
    _require(not differ, f"{name}: restored leaves differ: {differ}")
    _require(torch.equal(restored.gen.get_state(), state.gen.get_state()),
             f"{name}: generator differs")
    t0 = time.perf_counter()
    on_cpu = load_state(dm.init_state(cfg, seed=1, device="cpu"), path)
    cpu_load_ms = (time.perf_counter() - t0) * 1e3
    _require(on_cpu.device.type == "cpu"
             and not differing_leaves(on_cpu, state),
             f"{name}: loaded on the CPU, leaves differ")
    gen = torch.Generator(device=device)
    gen.set_state(state.gen.get_state())
    straight, repeat = state, dataclasses.replace(state, gen=gen)
    for f in frames[4:]:
        straight, out_s = step(straight, f)
        restored, out_r = step(restored, f)
        repeat, _ = step(repeat, f)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    _pinned(name, launches, {k: v * 10 for k, v in PATHS[label][3].items()})
    resumed_differ = differing_leaves(restored, straight)
    repeat_differ = differing_leaves(repeat, straight)
    straight_cpu = straight.to("cpu")
    m = agreement((restored, out_r), (straight_cpu, out_s))
    csv = [os.path.join(tmp, f"{label}_{d}.csv") for d in ("card", "cpu")]
    n_csv = export_particles_csv(straight, cfg, csv[0])
    _require(export_particles_csv(straight_cpu, cfg, csv[1]) == n_csv > 0,
             f"{name}: CSV rows")
    with open(csv[0], "rb") as a, open(csv[1], "rb") as b:
        _require(a.read() == b.read(), f"{name}: card and CPU CSV differ")
    _say(name, save_ms=save_ms, load_ms=load_ms, cpu_load_ms=cpu_load_ms,
         file_mb=os.path.getsize(path) / 2**20, restored="bit-equal",
         cpu_load="bit-equal", resumed_bit_equal=not resumed_differ,
         resumed_leaves_differing=json.dumps(resumed_differ),
         repeat_bit_equal=not repeat_differ,
         repeat_leaves_differing=json.dumps(repeat_differ),
         csv_rows=n_csv, csv_card_vs_cpu="same bytes", **m)
    _require(m["flags_equal"] >= 0.999, f"{name} resumed flags")
    _require(m["weight_sum_close"] >= 0.999, f"{name} resumed weight_sum")
    _require(m["future_close"] >= 0.999, f"{name} resumed future grid")
    _require(m["alive_rel"] <= 0.005, f"{name} resumed alive")
    _require(not resumed_differ, f"{name}: resumed leaves differ: "
             f"{resumed_differ}")
    _require(not repeat_differ, f"{name}: repeated leaves differ: "
             f"{repeat_differ}")
    return launches


#: the ``__global__`` names of K1, K2, K3a and K3b, which a flagship
#: frame's trace must show (a bare "sweep" would also match the radix
#: sort's upsweep kernel)
TRACED = ("occupancy_tile_kernel", "sweep_kernel", "pass1_kernel",
          "pass2_kernel")


def check_trace(cfg, device, tmp):
    """Phase 7: ``profiling.trace`` around two flagship frames after three
    warm ones, then ``summarize_device_trace``: its rows must name K1, K2,
    K3a and K3b.  The profiler now and then loses device events, so a trace
    that misses one is taken once more.  Returns the launches."""
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.utils import profiling, sim

    step = dm.make_step(cfg)
    frames = [dm.Frame(*f) for f in sim.generate_sequence(7, cfg, seed=0)]
    kernels.reset_launch_counts()
    state = dm.init_state(cfg, seed=0, device=device)
    for f in frames[:3]:
        state, out = step(state, f)
    profiling.force_sync(out.weight_sum)
    n = 3
    for attempt in range(2):
        log_dir = os.path.join(tmp, f"trace_{attempt}")
        with profiling.trace(log_dir):
            for f in frames[n:n + 2]:
                state, out = step(state, f)
                profiling.force_sync(out.weight_sum)
        n += 2
        rows = profiling.summarize_device_trace(log_dir, top=None)
        missing = [k for k in TRACED if not any(k in r[2] for r in rows)]
        if not missing:
            break
        _say("io_trace_retaken", missing=json.dumps(missing), rows=len(rows))
    _require(not missing, f"io_trace: no {missing} kernel in two traces")
    launches = dict(kernels.LAUNCHES)
    _pinned("io_trace", launches,
            {k: v * n for k, v in PATHS["flagship"][3].items()})
    own = {k: [(op, ms) for ms, op, kernel in rows if k in kernel]
           for k in TRACED}
    _say("io_trace", frames=2, device_ms=sum(r[0] for r in rows),
         rows=len(rows), own_kernels=json.dumps(own))
    for rank, (ms, op, kernel) in enumerate(rows[:5]):
        _say("io_trace_top", rank=rank, ms=ms, op=json.dumps(op),
             kernel=json.dumps(kernel[:80]))
    return launches


def check_io(configs, device, smi) -> dict:
    """Phase 7 in a temporary directory: the replay entry point on the
    flagship (8 frames, with ``--out``, ``--csv`` and ``--checkpoint``) and
    on the multi-neighbor preset (4 frames: K5 takes its launches there),
    then :func:`check_checkpoint` for the flagship and large_urban (the
    compact layout: K4), then :func:`check_trace`.  Returns the launches of
    each sub-path."""
    import tempfile

    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        out, csv, ckpt = (os.path.join(tmp, n)
                          for n in ("out.npz", "p.csv", "c.npz"))
        summary, by_path["io_replay_dynamic"] = _replay(
            "io_replay_dynamic", ["--variant", "dynamic", "--frames", "8",
                                  "--out", out, "--csv", csv,
                                  "--checkpoint", ckpt],
            8, PATHS["flagship"][3])
        with np.load(out) as data:
            n_occupied = data["n_occupied"].tolist()
        _require(len(n_occupied) == 8 and min(n_occupied[3:]) > 0,
                 f"io_replay_dynamic occupied {n_occupied}")
        with np.load(ckpt) as data:
            n_valid = int((data["leaf_0"] != 0).sum())
        with open(csv) as f:
            rows = sum(1 for _ in f)
        _require(rows == n_valid > 0, f"io_replay_dynamic CSV {rows} rows, "
                 f"{n_valid} valid slots")
        _say("io_replay_dynamic", frames=8, **summary,
             n_occupied=json.dumps(n_occupied), csv_rows=rows, card=smi)
        summary, by_path["io_replay_multi"] = _replay(
            "io_replay_multi", ["--variant", "multi", "--frames", "4"], 4,
            PATHS["multi"][3])
        _say("io_replay_multi", frames=4, **summary, card=smi)
        for label in ("flagship", "large_urban"):
            by_path[f"io_checkpoint_{label}"] = check_checkpoint(
                label, configs[label], device, tmp)
        by_path["io_trace"] = check_trace(configs["flagship"], device, tmp)
    return by_path


#: the sharded phase's paths: (label, path whose configuration, launches a
#: frame and sensors it takes, the configuration's overrides, mover
#: exchange, ranks, backend, frames, bars).  Two ranks share the card over
#: gloo; the one-rank group runs NCCL.  A slab's planes (the flagship's 18 x
#: 87552 x 4 B = 6.3 MB) stay under the relayout's 16 MiB line, so no K5
#: launch.  The two-camera paths build their frames as ``multisensor_2cam``
#: does (each camera the frame's cloud and pose) and launch what a frame of
#: their unsharded path launches on each rank.  Bars "phase5" are
#: :func:`card_vs_cpu`'s pinned ones.  The
#: update's budgets (spill tier, pyramid cell) are each rank's, the JAX
#: package's documented deviation, and large_urban's overflow them: the
#: unsharded step leaves some 12,000 particles a frame out of the update and
#: kills 215 in full pyramid cells, two ranks 9,600 and 35, and the
#: particles they update besides lose weight (2.4% fewer alive, 8.7% less
#: weight after 6 frames).  So "capacity" holds that path to what the
#: deviation implies -- the ranks overflow no more than the one step, and
#: alive within the JAX package's band for this comparison
#: (tests/test_compact_shard.py: max(10, 5%)) -- and the "uncontested" path
#: raises the update's budgets on both sides until neither overflows, where
#: the phase-5 bars hold the sharded code itself; the two-camera compact
#: path takes the uncontested budgets for the same reason.
UNCONTESTED = dict(particle_spill_capacity=1 << 15, pyramid_slot_capacity=2048)
SHARDED = (
    ("sharded_flagship", "flagship", {}, "all_gather", 2, "gloo", 6,
     "phase5"),
    ("sharded_large_urban", "large_urban", {}, "ring", 2, "gloo", 6,
     "capacity"),
    ("sharded_large_urban_uncontested", "large_urban", UNCONTESTED, "ring", 2,
     "gloo", 6, "phase5"),
    ("sharded_flagship_nccl", "flagship", {}, "all_gather", 1, "nccl", 3,
     "phase5"),
    ("sharded_multisensor_2cam", "multisensor_2cam", {}, "all_gather", 2,
     "gloo", 6, "phase5"),
    ("sharded_multisensor_compact", "multisensor_compact", UNCONTESTED,
     "ring", 2, "gloo", 5, "phase5"),
)
#: the frame of rank 0 watched for host syncs; the frames from it on are
#: timed
SHARDED_WATCHED = 1
#: the sharded paths run a second time from a fresh state, their gathered
#: states bit-equal to the first run's
SHARDED_REPEATED = ("sharded_flagship",)
#: seconds a rank waits for phase 8 to start before it gives up
SHARDED_WAIT_S = 900
#: the ``sharded_graph`` phase: (label, path whose configuration and launches
#: a frame) of the graphed sharded step at one NCCL rank, held to the eager
#: one by ``utils/shard_probe.py``'s ritual
SHARDED_GRAPH = (("sharded_graph_flagship_nccl", "flagship"),
                 ("sharded_graph_multisensor_2cam_nccl", "multisensor_2cam"))


def path_configs():
    """The paths' configurations, by label (phases 4, 5, 7 and 8)."""
    import dspmap_tpu_torch as dm

    return {
        "flagship": dm.example_node_settings(dm.dsp_dynamic()),
        "large_urban": dm.large_urban(),
        "static": dm.example_node_settings(dm.dsp_static()),
        "multi": dm.example_node_settings(dm.dsp_dynamic_multi_neighbors()),
        "noisy": dm.example_node_settings(
            dm.dsp_dynamic(limit_motion_to_xy_plane=False)),
        "noisy_compact": dm.large_urban(limit_motion_to_xy_plane=False),
        "multisensor_2cam": dm.example_node_settings(dm.dsp_dynamic()),
        "multisensor_compact": dm.large_urban(),
        "multisensor_4cam": dm.example_node_settings(dm.dsp_dynamic()),
    }


def _sharded_path(label, cfg, mesh, n_frames, per_frame, n_sensors, bars,
                  device):
    """One path of phase 8 in this rank: the sharded step (of ``n_sensors``
    cameras, or the single-sensor one) from a fresh state over ``n_frames``
    frames with the launch counts set to 0 before and pinned after, rank
    0's watched frame, the replicated leaves and metrics of every rank
    compared (one ``all_gather`` of their digests), and on rank 0 the
    gathered state against the unsharded step's by ``bars`` (see
    :data:`SHARDED`).  Returns this rank's record."""
    import torch
    import torch.distributed as dist
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.utils import sim
    from dspmap_tpu_torch.utils.parity import differing_leaves, missed_bars
    from dspmap_tpu_torch.utils.shard_probe import (replicated_digests,
                                                    sharded_agreement,
                                                    sharded_bars)

    step = dm.make_shardmap_step(cfg, mesh, device=device,
                                 n_sensors=n_sensors)
    frames = [dm.Frame(*f) for f in sim.generate_sequence(n_frames, cfg,
                                                           seed=0)]
    if n_sensors is None:
        fresh = lambda: dm.init_state(cfg, seed=0, device=device)  # noqa: E731
        ustep = dm.make_step(cfg)
    else:  # every camera sees the frame's cloud from its pose
        fresh = lambda: dm.init_multisensor_state(  # noqa: E731
            cfg, n_sensors, seed=0, device=device)
        ustep = dm.make_multisensor_step(cfg, n_sensors)
        frames = [dm.stack_frames([f] * n_sensors) for f in frames]
    state = dm.shard_state(fresh(), mesh)
    _require(state.device.type == "cuda" and all(
        getattr(state.particles, f.name).is_cuda
        for f in dataclasses.fields(dm.Particles)),
        f"{label}: a slab off the card")
    syncs, ms = [], []
    kernels.reset_launch_counts()
    for i, frame in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == SHARDED_WATCHED and mesh.rank == 0:
            (state, out), syncs = _watch_syncs(lambda: step(state, frame))
        else:
            state, out = step(state, frame)
        torch.cuda.synchronize()
        if i >= SHARDED_WATCHED:
            ms.append((time.perf_counter() - t0) * 1e3)
        _require(out.accepted, f"{label} frame {i} rejected")
    launches = dict(kernels.LAUNCHES)
    _pinned(f"{label} rank {mesh.rank}", launches,
            {k: v * n_frames for k, v in per_frame.items()})
    # gloo stages a CUDA collective through the host on threads of its own,
    # which print their syncs and are not flagged here
    _require(not syncs, f"{label}: host syncs in rank 0's step: {syncs}")
    mine = replicated_digests(state, out)
    every = [mine]
    if mesh.size > 1:
        every = [None] * mesh.size
        dist.all_gather_object(every, mine, group=mesh.group)
    whole = dm.gather_state(state, mesh)
    rec = dict(launches=launches, median_frame_ms=statistics.median(ms),
               alive=int(out.metrics["alive"]))
    if label in SHARDED_REPEATED:
        again = dm.shard_state(fresh(), mesh)
        for frame in frames:
            again, _ = step(again, frame)
        again = dm.gather_state(again, mesh)
        if mesh.rank == 0:
            rec["repeat_leaves_differing"] = differing_leaves(whole, again)
    if mesh.rank == 0:
        differ = sorted(k for k in mine if any(d.get(k) != mine[k]
                                               for d in every))
        _require(bool(torch.isfinite(whole.weight_sum).all()
                      and torch.isfinite(whole.future).all()),
                 f"{label}: not finite")
        ref = fresh()
        for frame in frames:
            ref, ref_out = ustep(ref, frame)
        m = sharded_agreement(cfg, whole, out, ref, ref_out)
        w0, w1 = float(ref.weight_sum.sum()), float(whole.weight_sum.sum())
        m.update(weight_total_unsharded=w0, weight_total_sharded=w1,
                 **{f"{k}_sharded_unsharded": [int(out.metrics[k]),
                                               int(ref_out.metrics[k])]
                    for k in ("update_spill_overflow", "pyramid_full_killed",
                              "mover_overflow_killed") if k in out.metrics})
        if bars == "capacity":
            a0, a1 = m["alive_unsharded"], m["alive_sharded"]
            _require(abs(a0 - a1) <= max(10, 0.05 * a0), f"{label} alive {m}")
            for k in ("update_spill_overflow", "pyramid_full_killed"):
                got, want = m[f"{k}_sharded_unsharded"]
                _require(got <= want, f"{label} {k} {m}")
        else:
            missed = missed_bars(m, sharded_bars(cfg))
            _require(not missed, f"{label} missed the bars of {missed}: {m}")
        rec.update(agreement=m, host_syncs_in_watched_frame=len(syncs),
                   replicated_compared=len(mine), replicated_differing=differ)
    return rec


def _graphed_refusal(cfg, mesh, device, n_sensors):
    """The message with which the graphed sharded constructor refuses ``mesh``
    (a gloo group), or ``None`` if it builds."""
    from dspmap_tpu_torch.parallel import make_graphed_shardmap_step

    try:
        make_graphed_shardmap_step(cfg, mesh, device=device,
                                   n_sensors=n_sensors)
    except ValueError as e:
        return str(e)
    return None


def _sharded_graph(mesh, device, configs) -> dict:
    """The ``sharded_graph`` phase in rank 0 of the one-rank NCCL group:
    each path of :data:`SHARDED_GRAPH` through
    ``shard_probe.ritual``'s light form (the eager and the graphed sharded
    step in turns on the same draws, a rejected frame, a setter, on the
    two-camera path a frame of each camera alone; bit for bit, no host
    launch in a replay, one capture a pattern),
    each capture's launches pinned at two of its pattern's frames' worth
    (the warm-up run and the capture).  Returns the records by label."""
    from dspmap_tpu_torch.utils.shard_probe import ritual

    records = {}
    for label, base in SHARDED_GRAPH:
        cfg = dataclasses.replace(configs[base], mover_exchange="all_gather")
        per_frame, n_sensors = PATHS[base][3], PATHS[base][4]
        rec = ritual(cfg, n_sensors, mesh, device, light=True)
        for pattern, launched in rec["capture_launches"].items():
            want = {k: 2 * v for k, v in _pattern_frame(
                per_frame, tuple(c == "1" for c in pattern)).items()}
            if launched != want:
                rec["failed"].append(f"capture {pattern} launch counts "
                                     f"{launched} != {want}")
        records[label] = rec
    return records


def _sharded_rank(rank, n, port, out_dir):
    """Phase 8 in rank ``rank`` of ``n`` (started by
    ``torch.multiprocessing.spawn``): a gloo group of the ``n`` ranks on
    ``cuda:0``, a one-rank NCCL group of rank 0 inside it, every path of
    :data:`SHARDED` this rank takes part in (a gloo path also handed to the
    graphed sharded constructor, which must refuse it), then rank 0 the
    ``sharded_graph`` phase (:func:`_sharded_graph`) in the NCCL group; its
    records go to ``out_dir/rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist
    from dspmap_tpu_torch.parallel import make_mesh

    deadline = time.monotonic() + SHARDED_WAIT_S
    while not os.path.exists(os.path.join(out_dir, "go")):
        if time.monotonic() > deadline:
            raise TimeoutError("phase 8 was never started")
        time.sleep(0.05)
    torch.cuda.set_device(0)  # the card, once phase 8 has started
    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        nccl = dist.new_group([0], backend="nccl")  # every rank makes it
        configs, records = path_configs(), {}
        for (label, base, overrides, exchange, ranks, backend, frames,
             bars) in SHARDED:
            if rank >= ranks:
                continue
            cfg = dataclasses.replace(configs[base], mover_exchange=exchange,
                                      **overrides)
            mesh = make_mesh(ranks, group=nccl if backend == "nccl" else None)
            per_frame, n_sensors = PATHS[base][3], PATHS[base][4]
            records[label] = _sharded_path(label, cfg, mesh, frames,
                                           per_frame, n_sensors, bars, device)
            records[label]["graphed_refused"] = (
                _graphed_refusal(cfg, mesh, device, n_sensors)
                if backend == "gloo" else None)
        if rank == 0:
            records["sharded_graph"] = _sharded_graph(
                make_mesh(1, group=nccl), device, configs)
        dist.barrier()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(records, f)
    except BaseException:
        # the other rank then fails in its next collective, and spawn may
        # report that one: keep this rank's own account for check_sharded
        import traceback

        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def start_sharded(tmp):
    """Start phase 8's ranks (:func:`_sharded_rank`) with ``tmp`` as their
    directory: each starts its interpreter and imports torch and the port
    while the kernels build, then waits, off the card, for
    :func:`check_sharded`'s mark.  Returns the processes' context."""
    import torch.multiprocessing as mp

    n = max(path[4] for path in SHARDED)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    return mp.spawn(_sharded_rank, args=(n, port, tmp), nprocs=n,
                    join=False)


def check_sharded(smi, procs, tmp) -> dict:
    """Phase 8: the ranks of :func:`start_sharded` (``procs``) run
    :data:`SHARDED` once this marks ``tmp``; a rank that fails fails the
    phase.  Prints a line a path with each rank's launches, rank 0's frame
    median and its agreement with the unsharded step.  Returns the
    launches by path and rank."""
    n = len(procs.processes)
    by_path = {}
    t0 = time.perf_counter()
    open(os.path.join(tmp, "go"), "w").close()
    try:
        while not procs.join():
            pass
    except Exception:
        for r in range(n):
            path = os.path.join(tmp, f"error{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    print(f"[sharded_rank{r}_error]\n{f.read()}",
                          file=sys.stderr, flush=True)
        raise
    seconds = time.perf_counter() - t0
    records = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            records.append(json.load(f))
    for (label, base, overrides, exchange, ranks, backend, frames,
         bars) in SHARDED:
        recs = [records[r][label] for r in range(ranks)]
        for r, rec in enumerate(recs):
            by_path[f"{label}_rank{r}"] = rec["launches"]
        differ = recs[0]["replicated_differing"]
        _say(label, config=base, overrides=json.dumps(overrides),
             exchange=exchange, ranks=ranks, backend=backend, frames=frames,
             bars=bars,
             median_frame_ms=recs[0]["median_frame_ms"],
             launches=json.dumps([rec["launches"] for rec in recs]),
             host_syncs_in_watched_frame=recs[0]["host_syncs_in_watched_frame"],
             alive=json.dumps([rec["alive"] for rec in recs]),
             replicated_compared=recs[0]["replicated_compared"],
             replicated_differing=len(differ),
             replicated_differing_names=json.dumps(differ),
             graphed_refused=json.dumps([rec["graphed_refused"] is not None
                                         for rec in recs]),
             **recs[0]["agreement"], card=json.dumps(smi))
    for label, rec in records[0]["sharded_graph"].items():
        _say(label, ranks=1, backend="nccl", frames=rec["frames"],
             warm=rec["warm"], rejected=1, setter=1,
             bit_equal=all(rec["bit_equal_frames"]),
             captures=rec["captures"],
             host_launches_per_replay=rec["host_launches_per_replay"],
             eager_frame_ms=rec["eager_frame_ms"],
             graphed_frame_ms=rec["graphed_frame_ms"],
             capture_ms=json.dumps(rec["capture_ms"]),
             pool_bytes=json.dumps(rec["pool_bytes"]),
             kept_bytes=json.dumps(rec["kept_bytes"]),
             replicated_differing=len(rec["replicated_differing"]),
             seconds=rec["seconds"],
             failed=json.dumps(rec["failed"]), card=json.dumps(smi))
    _say("sharded", seconds_after_start=seconds)
    for label, _, _, _, ranks, backend, *_ in SHARDED:  # after every line
        differ = records[0][label]["replicated_differing"]
        _require(not differ, f"{label}: replicated leaves differ across the "
                 f"ranks: {differ}")
        refused = [records[r][label]["graphed_refused"] for r in range(ranks)]
        _require(backend != "gloo" or all(
            msg is not None and "NCCL" in msg for msg in refused),
            f"{label}: the graphed sharded constructor took a gloo group: "
            f"{refused}")
    for label, rec in records[0]["sharded_graph"].items():
        _require(not rec["failed"], f"{label}: {rec['failed']}")
    for label in SHARDED_REPEATED:
        differ = records[0][label]["repeat_leaves_differing"]
        _say(f"{label}_repeat", runs=2, bit_equal=not differ,
             leaves_differing=json.dumps(differ))
        _require(not differ, f"{label}: a second run's gathered state "
                 f"differs: {differ}")
    return by_path


#: kernel -> (source, the TPU kernel it replaces, the configuration whose
#: shape the row's own numbers are taken at)
KERNELS = {
    "occupancy_pool_pass": ("dspmap_tpu_torch/csrc/occupancy.cu",
                            "dspmap_tpu/ops/pallas/occupancy.py:231",
                            "flagship"),
    "sweep": ("dspmap_tpu_torch/csrc/sweep.cu",
              "dspmap_tpu/ops/pallas/sweep.py:137", "flagship"),
    "update_pass1": ("dspmap_tpu_torch/csrc/update.cu",
                     "dspmap_tpu/ops/pallas/update.py:117", "flagship"),
    "update_pass2": ("dspmap_tpu_torch/csrc/update.cu",
                     "dspmap_tpu/ops/pallas/update.py:125", "flagship"),
    "seg_scans": ("dspmap_tpu_torch/csrc/segscan.cu",
                  "dspmap_tpu/ops/pallas/segscan.py:121", "large_urban"),
    "to_flat": ("dspmap_tpu_torch/csrc/relayout.cu",
                "dspmap_tpu/ops/pallas/relayout.py:182", "multi"),
    "from_flat": ("dspmap_tpu_torch/csrc/relayout.cu",
                  "dspmap_tpu/ops/pallas/relayout.py:200", "multi"),
    "jv_solve": ("dspmap_tpu_torch/csrc/assignment.cu",
                 "dspmap_tpu/ops/assignment.py:201 (a lax.while_loop, "
                 "with those at :146 and :175; not a pallas_call)",
                 "flagship"),
    "euclidean_cluster": ("dspmap_tpu_torch/csrc/cluster.cu",
                          "dspmap_tpu/ops/cluster.py::_propagate (a "
                          "lax.while_loop; not a pallas_call)", "flagship"),
}


def kernel_row(name, by_shape, by_path) -> dict:
    """One kernel's entry of the ``kernels`` line: its launches over the
    nine paths and the ``io`` phase's, its measurements at the shape of its first path, and under
    ``by_shape`` the same measurements at every shape it was checked at."""
    source, replaces, own = KERNELS[name]
    shapes = {label: rows[name] for label, rows in by_shape.items()
              if name in rows}
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {k: p[name] for k, p in by_path.items()},
            **{k: shapes[own][k] for k in keys}, "by_shape": shapes}


def _stop(procs) -> None:
    """End phase 8's ranks: a phase that raised leaves them waiting."""
    for proc in procs.processes:
        if proc.is_alive():
            proc.terminate()
        proc.join()


def _phases(configs, device, smi, jv_cpu, pool, procs, tmp):
    """Phases 2-8 after the build (phase 8's ranks ``procs`` started in
    ``tmp``, the JV check's plain solves ``jv_cpu`` done in ``pool``, whose
    workers step phase 5's CPU frames of every path together after phase
    8, when no timed phase is left).  Returns the kernels' measurements by
    shape and their launches by path."""
    import torch
    from dspmap_tpu_torch import kernels

    check_cuda_cost(device)
    by_shape = {label: check_kernels(label, configs[label], device)
                for label in ("flagship", "static", "multi")}
    by_shape["flagship_slab"] = check_sweep_slab(configs["flagship"], device)
    for label, rows in check_jv(configs["flagship"], device, jv_cpu).items():
        by_shape.setdefault(label, {}).update(rows)
    for label, rows in check_cluster(configs["flagship"], device).items():
        by_shape.setdefault(label, {}).update(rows)
    # K1's moving mask, as the noisy and the two-camera pool paths take it,
    # and as a rank of the sharded two-camera path takes it on its slab
    for label in ("noisy", "multisensor_2cam"):
        by_shape[label] = check_moving_mask(label, configs[label], device)
    by_shape["multisensor_2cam_slab"] = check_moving_mask(
        "multisensor_2cam_slab", configs["multisensor_2cam"], device,
        slab=True)
    # K3 at a shape that is no multiple of pass 2's lane groups, its
    # particles a lane or its rows a block
    check_pairs("ragged", 37, 13, 101, 0.1, np.random.default_rng(1), device,
                timed=False)
    # and at rows of few points (obs_dense_points = 1), where a block of
    # pass 1 takes whole rows, as many as shared memory stages
    check_pairs("few_points", 300, 64, 9, 0.1, np.random.default_rng(1),
                device, timed=False)
    kernels.reset_launch_counts()
    by_shape["large_urban"] = check_segscan(configs["large_urban"], device)
    by_shape["multi"].update(check_relayout(configs["multi"], device))
    # a caller's TF32 setting: the port's float32 matmuls run in full
    # float32 (the card-against-CPU bars) and leave the setting as it was
    flag = torch.backends.cuda.matmul
    saved, flag.allow_tf32 = flag.allow_tf32, True
    by_path, phase5 = {}, []
    try:
        for name, c in configs.items():
            launches, frame_ms, alive, state, cpu = run_path(name, c, device)
            phase5.append(cpu)
            by_path[name] = launches
            _say(f"{name}_summary", median_frame_ms=frame_ms, alive=alive,
                 card=smi)
            check_repeat(name, c, state, device)
            check_graph(name, c, state, device, smi)
            del state
        _say("tf32_flag", set_before_the_paths=True,
             after_the_paths=flag.allow_tf32)
        _require(flag.allow_tf32 is True, "the paths changed the TF32 flag")
    finally:
        flag.allow_tf32 = saved
    by_path.update(check_io(configs, device, smi))
    by_path.update(check_sharded(smi, procs, tmp))
    t0 = time.perf_counter()
    # the multi-camera paths' frames, the longest, first
    futures = [[pool.submit(_cpu_frame, *job) for job in jobs]
               for jobs, _ in reversed(phase5)][::-1]
    for (_, check), fs in zip(phase5, futures):
        check([f.result() for f in fs])
    _say("card_vs_cpu_frames", seconds=time.perf_counter() - t0,
         frames=sum(map(len, futures)), workers=WORKERS,
         cpu_threads=CPU_THREADS)
    return by_shape, by_path


def main() -> int:
    import torch

    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dspmap_tpu_torch import kernels

    configs = path_configs()
    _require(list(configs) == list(PATHS), "a path without a configuration")
    with contextlib.ExitStack() as stack:
        # what needs neither the card nor a quiet host runs until the
        # kernels are built: phase 8's ranks start up, and the JV check's
        # plain solves run on the CPU; the timed checks start once both
        # are done
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        procs = start_sharded(tmp)
        stack.callback(_stop, procs)
        pool, jv_plain = start_jv_plain(configs["flagship"])
        stack.callback(pool.shutdown, cancel_futures=True)
        major, minor = torch.cuda.get_device_capability(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        _say("card", capability=f"{major}.{minor}", torch=torch.__version__,
             cuda=torch.version.cuda, nvidia_smi=json.dumps(smi))
        _require(major == 9,
                 f"need compute capability 9.x, got {major}.{minor}")
        t0 = time.perf_counter()
        kernels.build(verbose=True)
        kernels.lib()
        t1 = time.perf_counter()
        jv_cpu = {k: v for f in jv_plain for k, v in f.result().items()}
        _say("build", seconds=t1 - t0,
             then_waited_for_the_plain_jv_s=time.perf_counter() - t1)
        by_shape, by_path = _phases(configs, device=torch.device("cuda", 0),
                                    smi=smi, jv_cpu=jv_cpu, pool=pool,
                                    procs=procs, tmp=tmp)

    _say("total", seconds=time.perf_counter() - started)
    print(smi)
    print(json.dumps({"kernels": [kernel_row(name, by_shape, by_path)
                                  for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
