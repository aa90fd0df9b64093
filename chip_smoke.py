#!/usr/bin/env python3
"""Drive the PyTorch port's eight paths and its IO on one CUDA card and
check them.

Run from the root of a checkout on a machine with an H100::

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits nonzero):

1. the card: CUDA present, compute capability 9.x, name and power limit;
2. build the port's CUDA kernels from ``dspmap_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its paths give it, with inputs made from a numpy seed, plus the
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
   calls, one plane beside one; K1's ``with_moving`` arm (the moving
   mask of the noisy and multi-sensor paths) at S = 18 with three
   velocity planes and with two;
4. the eight paths at full width on the synthetic street sequence --
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
   ``multisensor_compact`` (``large_urban()``) -- each with
   the kernels' launch counts set to 0 before and pinned after, one warm
   frame under PyTorch's sync debug mode (it must not synchronize the host
   with the card), finite state and occupied voxels;
5. card against CPU for each path: the state after a kept frame is copied
   to the CPU and the next frame is stepped on both with the same random
   draws (see :func:`card_vs_cpu` for the bars; on the multi-sensor paths
   every sensor's birth is pinned to the card's ``norm_coeff`` in turn);
6. the caller's TF32 matmul setting, True through phases 4 and 5, is
   still True after them;
7. ``io``, in a temporary directory (see :func:`check_io`): the replay
   entry point as a user runs it (``dspmap_tpu_torch.io.replay.main``) on
   the flagship and the multi-neighbor preset; checkpoints saved and loaded
   on the card for the flagship and large_urban, resumed, and loaded on the
   CPU; the particle CSV of a card state against the CPU's; a
   ``torch.profiler`` trace of two flagship frames and its summary.  Each
   sub-path pins its kernel launches as phase 4 does.

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


def _median_ms(fn) -> float:
    """Median of 20 calls, CUDA events around the call."""
    from dspmap_tpu_torch.utils.kernel_times import median_ms

    return median_ms(fn)


def _device_ms(fn, own: bool = True) -> float:
    """Median of 20 calls of the time the card spent in the port's own
    kernels during one call (the profiler's device-side events); with
    ``own`` false, in whatever it ran."""
    from dspmap_tpu_torch.utils.kernel_times import ANY_KERNEL, device_ms
    from dspmap_tpu_torch.utils.stage_times import OWN_KERNELS

    return device_ms(fn, names=OWN_KERNELS if own else ANY_KERNEL)


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
    got = sweep.sweep_cuda(pool, cfg, dt, origin, sensor, quat)
    ref = sweep.sweep_reference(pool, cfg, dt, origin, sensor, quat)
    torch.cuda.synchronize()
    k2_err = max(float((got.px - ref.px).abs().max()),
                 float((got.py - ref.py).abs().max()))
    _require(k2_err <= 1e-5, f"K2 {label} positions differ by {k2_err}")
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
        k2_err, lambda: sweep.sweep_cuda(pool, cfg, dt, origin, sensor, quat),
        lambda: sweep.sweep_reference(pool, cfg, dt, origin, sensor, quat),
        4 * 11 * S * V, K2_FLOPS_PER_SLOT * S * V, shape=f"S={S} V={V}",
        flips=flips)
    _say(f"K2_{label}", **rows["sweep"])

    # K3: pair passes at [n_pyr, S_t] x [n_pyr, CK] ----------------------
    rows.update(check_pairs(
        label, cfg.n_pyramids, cfg.dense_slots,
        cfg.neighbor_cells * cfg.obs_dense, float(np.float32(cfg.sigma_ob)),
        rng, device))
    kernels.reset_launch_counts()
    return rows


def check_moving_mask(label, cfg, device):
    """Phase 3, K1's ``with_moving`` arm at ``cfg``'s pool shape: every
    output of the kernel, the ``[S, V]`` moving mask included, bit-equal
    to the plain version's.  With three velocity planes the pool's moving
    particles move in z too.  Returns ``{kernel name: measurements}``."""
    import torch
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
        k: (v / n if k == "ms" or k.endswith("_ms") else v)
        for k, v in row.items()}
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


def card_vs_cpu(cfg, step, state, frame, device, label="card_vs_cpu",
                n_sensors=None) -> None:
    """Phase 5: one frame from the same state with the same draws on the
    card and through the CPU's plain path (``n_sensors``: the step is
    :func:`make_multisensor_step`'s, whose births are pinned one by one).

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
    name = ("particle_birth_compact" if cfg.layout == "compact"
            else "particle_birth")
    birth = getattr(pipeline, name)
    seen = []

    def card_birth(*a, **kw):
        seen.append(kw["norm_coeff"])
        return birth(*a, **kw)

    def pinned_birth(*a, **kw):
        kw["norm_coeff"] = pending.pop(0).cpu()
        return birth(*a, **kw)

    try:
        setattr(pipeline, name, card_birth)
        card = step(state, frame, draws)
        setattr(pipeline, name, pinned_birth)
        pending = list(seen)
        pinned = _agreement(card, step(cpu_state, frame, cpu_draws))
        _require(not pending and len(seen) == (n_sensors or 1),
                 f"{label}: {len(seen)} births pinned")
    finally:
        setattr(pipeline, name, birth)
    free = _agreement(card, step(cpu_state, frame, cpu_draws))
    torch.cuda.synchronize()
    _say(label + "_cost", seconds_for_one_card_and_two_cpu_frames=(
        time.perf_counter() - t0))
    free_flags = 0.995 if cfg.layout == "compact" else 0.999
    for tag, m, flag_bar in ((label, pinned, 0.999),
                             (label + "_free", free, free_flags)):
        _say(tag, **m)
        _require(m["flags_equal"] >= flag_bar, f"{tag} flags")
        _require(m["weight_sum_close"] >= 0.999, f"{tag} weight_sum")
        _require(m["future_close"] >= 0.999, f"{tag} future grid")
    _require(pinned["alive_rel"] <= 0.005, f"{label} alive")
    _require(free["alive_rel"] <= 0.02, f"{label} free alive")


_POOL_FRAME = {"occupancy_pool_pass": 1, "sweep": 1, "update_pass1": 1,
               "update_pass2": 1, "seg_scans": 0, "to_flat": 0, "from_flat": 0}
_COMPACT_FRAME = {**_POOL_FRAME, "occupancy_pool_pass": 0, "sweep": 0,
                  "seg_scans": 4}
#: two cameras: the pair passes run once a sensor
_TWO_CAMERAS = {"update_pass1": 2, "update_pass2": 2}
#: per path: (warm-up frames, timed frames, the watched warm frame, the
#: kernels' launches per frame, sensors: None for ``make_step``).  The
#: multi-neighbor planes (17.3 MiB) take the flat working phase: flags, px,
#: py, pz, vx, vy and weight are copied in by one K5a launch (vz is made
#: anew as zeros, t is not touched); K1 reads the seven working planes
#: where they lie, and one K5b launch copies out vz, which K1 hands
#: through.  The noisy arm and the multi-sensor steps never call the sweep
#: (K2) and keep [S, V] planes (no K5).  A compact frame launches K4 four
#: times (rebin_compact's segment table, birth's table, occupancy's two
#: scan sets); the two-camera compact frame five, birth's table once a
#: sensor.
PATHS = {
    "flagship": (5, 10, 4, _POOL_FRAME, None),
    "large_urban": (3, 6, 2, _COMPACT_FRAME, None),
    "static": (3, 8, 2, _POOL_FRAME, None),
    "multi": (3, 8, 2, {**_POOL_FRAME, "to_flat": 1, "from_flat": 1}, None),
    "noisy": (5, 10, 4, {**_POOL_FRAME, "sweep": 0}, None),
    "noisy_compact": (3, 6, 2, _COMPACT_FRAME, None),
    "multisensor_2cam": (3, 8, 2, {**_POOL_FRAME, "sweep": 0,
                                   **_TWO_CAMERAS}, 2),
    "multisensor_compact": (3, 4, 2, {**_COMPACT_FRAME, "seg_scans": 5,
                                      **_TWO_CAMERAS}, 2),
}


def run_path(name, cfg, device):
    """Phases 4 and 5 for one path: its frames on the card with the launch
    counts set to 0 just before and read just after, then one frame on
    both the card and the CPU from the same state and draws.  Returns
    ``(launches, median frame ms, alive after the last frame)``."""
    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.utils import sim

    warm, timed, watched, per_frame, n_sensors = PATHS[name]
    n = warm + timed
    kept_at = min(10, n - 2)  # the frame whose state phase 5 starts from
    frames = [dm.Frame(*f) for f in sim.generate_sequence(n, cfg, seed=0)]
    if n_sensors is None:
        step = dm.make_step(cfg)
        state = dm.init_state(cfg, seed=0, device=device)
    else:  # every camera sees the frame's cloud from its pose
        step = dm.make_multisensor_step(cfg, n_sensors)
        state = dm.init_multisensor_state(cfg, n_sensors, seed=0,
                                          device=device)
        frames = [dm.stack_frames([f] * n_sensors) for f in frames]
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

    card_vs_cpu(cfg, step, kept, frames[kept_at + 1], device,
                label=f"{name}_card_vs_cpu", n_sensors=n_sensors)
    return launches, statistics.median(ms), alive[-1]


def _leaves(state) -> dict:
    """Every leaf of a state as numpy, by its path in the JAX state."""
    from dspmap_tpu_torch import state_to_numpy

    out = {}
    for key, value in state_to_numpy(state).items():
        if isinstance(value, dict):
            out.update({f"{key}.{k}": np.asarray(v) for k, v in value.items()})
        else:
            out[key] = np.asarray(value)
    return out


def _differing(a, b) -> list:
    """The leaves in which two states differ, by bits, shape or dtype."""
    x, y = _leaves(a), _leaves(b)
    _require(x.keys() == y.keys(), "states of different structure")
    return [k for k in x if x[k].dtype != y[k].dtype
            or x[k].shape != y[k].shape or x[k].tobytes() != y[k].tobytes()]


def _pinned(name, launches, want) -> None:
    _require(launches == want, f"{name} launch counts {launches} != {want}")


def _replay(name, args, frames, per_frame):
    """Phase 7: ``replay.main(args)`` as a user calls it, its standard output
    captured, the launch counts set to 0 before and pinned after.  Returns
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
    _pinned(name, launches, {k: v * frames for k, v in per_frame.items()})
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
    bars of phase 5's comparison with the births pinned; whether they are
    bit-equal is printed: scatters of plain torch ops need not be
    deterministic on the card, so the same two frames are also stepped once
    more from the saved state without the checkpoint, and whether that
    repeat is bit-equal is printed beside), the same file loaded into a CPU
    template (bit-equal), and the particle CSV of the card state against
    the same state's on the CPU (the same bytes).  Returns the launches of
    its ten card frames."""
    import dataclasses

    import torch
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import kernels
    from dspmap_tpu_torch.io import export_particles_csv, load_state, save_state
    from dspmap_tpu_torch.utils import sim

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
    differ = _differing(restored, state)
    _require(not differ, f"{name}: restored leaves differ: {differ}")
    _require(torch.equal(restored.gen.get_state(), state.gen.get_state()),
             f"{name}: generator differs")
    t0 = time.perf_counter()
    on_cpu = load_state(dm.init_state(cfg, seed=1, device="cpu"), path)
    cpu_load_ms = (time.perf_counter() - t0) * 1e3
    _require(on_cpu.device.type == "cpu" and not _differing(on_cpu, state),
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
    resumed_differ = _differing(restored, straight)
    repeat_differ = _differing(repeat, straight)
    straight_cpu = straight.to("cpu")
    m = _agreement((restored, out_r), (straight_cpu, out_s))
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
}


def kernel_row(name, by_shape, by_path) -> dict:
    """One kernel's entry of the ``kernels`` line: its launches over the
    eight paths and the ``io`` phase's, its measurements at the shape of its first path, and under
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


def main() -> int:
    import torch

    started = time.perf_counter()
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
    check_cuda_cost(device)
    configs = {
        "flagship": dm.example_node_settings(dm.dsp_dynamic()),
        "large_urban": dm.large_urban(),
        "static": dm.example_node_settings(dm.dsp_static()),
        "multi": dm.example_node_settings(dm.dsp_dynamic_multi_neighbors()),
        "noisy": dm.example_node_settings(
            dm.dsp_dynamic(limit_motion_to_xy_plane=False)),
        "noisy_compact": dm.large_urban(limit_motion_to_xy_plane=False),
        "multisensor_2cam": dm.example_node_settings(dm.dsp_dynamic()),
        "multisensor_compact": dm.large_urban(),
    }
    _require(list(configs) == list(PATHS), "a path without a configuration")
    by_shape = {label: check_kernels(label, configs[label], device)
                for label in ("flagship", "static", "multi")}
    # K1's moving mask, as the noisy and the two-camera pool paths take it
    for label in ("noisy", "multisensor_2cam"):
        by_shape[label] = check_moving_mask(label, configs[label], device)
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
    by_path = {}
    try:
        for name, c in configs.items():
            launches, frame_ms, alive = run_path(name, c, device)
            by_path[name] = launches
            _say(f"{name}_summary", median_frame_ms=frame_ms, alive=alive,
                 card=smi)
        _say("tf32_flag", set_before_the_paths=True,
             after_the_paths=flag.allow_tf32)
        _require(flag.allow_tf32 is True, "the paths changed the TF32 flag")
    finally:
        flag.allow_tf32 = saved
    by_path.update(check_io(configs, device, smi))

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
