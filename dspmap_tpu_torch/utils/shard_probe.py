"""The graphed sharded step on several cards, one NCCL rank a card, held
against the eager sharded step and the unsharded step.

Run on a machine with four CUDA cards, from the root of a checkout::

    python3 -m dspmap_tpu_torch.utils.shard_probe [n_ranks [path ...] [budget=value ...]]
    python3 -m dspmap_tpu_torch.utils.shard_probe weak [n_ranks ...] [preset ...]

It builds the kernels, then starts ``n_ranks`` processes (default 4; one
card each, at most as many as the machine has) joined in one NCCL group
over ``tcp://localhost`` and runs each path of :func:`path_configs` (or
those named; a ``budget=value`` argument sets that field of every path's
configuration) in all of them through :func:`ritual`:

* :data:`WARM` frames of the eager sharded step from a fresh state, then
  ``graph_ritual.in_turns``'s frames through the eager sharded step
  (``make_shardmap_step``) and its graphed form
  (``make_graphed_shardmap_step``) in turns on the same draws -- a pose
  jump that admission rejects, a ``p_detection`` setter, on the
  multi-camera paths a frame of the first and one of the last camera
  alone (and on ``sharded_multisensor_4cam``, whose four cameras are
  ``utils/rig.py``'s surround rig, one of cameras 0 and 2): every rank's
  slab, generator and outputs compared bit for bit after each frame, the
  graphed step's captures and the kernels the host launches in a replay
  (none) counted;
* the replicated leaves (estimator, host scalars, runtime parameters,
  generator, metrics) of every rank compared across the ranks;
* on rank 0, after every accepted frame, the gathered sharded state
  against the unsharded step on the same frame and the same numbers (the
  sharded draws, a rank's pool-shaped noise joined in rank order): from
  the gathered state before the frame, held to :func:`sharded_bars`
  (phase 5's form), and running free from the start, recorded.  Both
  sides' counters of dropped particles (``parity.counters_recorded``, the
  sharded one's summed over the ranks) must show that no budget told them
  apart (:func:`contested`); the eager sharded frames are timed with
  that recording on;
* the host clock around a frame that ends in ``torch.cuda.synchronize()``
  (the ranks start each call together): the eager and the graphed frame
  medians of each rank over the accepted frames of every camera after
  their pattern's capture, and the unsharded graphed frame's on rank 0;
* one more graphed frame profiled on rank 0: the card's busy ms and the
  NCCL kernels' device ms and count;
* on the rig's path, every other pattern of admitted cameras captured
  once (:func:`every_pattern`): each pattern's memory pool and their sum
  beside the card's memory.

The ``weak`` mode is the port's counterpart of ``bench_scaling.py``: for
each rank count (default 1, 2 and 4, one card a rank, each count a group
of its own) and preset (flagship and large_urban), the preset's map grown
in z with the ranks (:func:`weak_config`: a rank's slab is the one-rank
map) through the graphed sharded step on one camera (:func:`weak_run`:
3 warm-up frames, 30 timed, 10 for large_urban), and above one rank the
grown map held to the same map on one card (:func:`weak_check`), at
budgets that no run overflows (large_urban's update budgets raised,
:data:`WEAK_URBAN_BUDGETS`; a run that drops particles fails).  Rank 0
prints a line a preset and rank count -- each rank's frame p50 and p90,
busy ms, live particles and counters of dropped particles; particles/s
and voxel-slots/s -- and the last line gives both rates' efficiency
rate_N / (N * rate_1) (:func:`weak_summary`).

Rank 0 prints one JSON line a path with every rank's numbers.  A check
that fails is reported by every rank and fails the run (exit code 1)
after the path has ended; ranks that do not agree on what comes next are
stopped by the group's timeout.  ``chip_smoke.py`` runs
:func:`ritual` at one NCCL rank on one card.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import itertools
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import (Frame, dsp_dynamic, example_node_settings, gather_state,
                init_multisensor_state, init_state, kernels, large_urban,
                make_draws, make_graphed_multisensor_step, make_graphed_step,
                make_graphed_shardmap_step, make_mesh, make_multisensor_draws,
                make_multisensor_step, make_shardmap_step, make_step,
                set_detection_probability, shard_state, state_shardings)
from ..models.graphed import _flat
from ..models.pipeline import _map_draws, _particle_shape
from ..parallel.shard_step import shard_ctx
from . import sim
from .graph_ritual import (FRAMES, P_SETTER, SEED, busy, cameras,
                           differing_on_card, in_turns, pattern_label,
                           ritual_frames, sequence)
from .parity import (PINNED_BARS, agreement, counters_recorded, leaves,
                     missed_bars, placed_alike)

#: eager sharded frames before the ritual's (``graph_ritual.FRAMES``)
WARM = 3
#: the one counter of dropped particles that no rank's budget sets: a
#: voxel's slots are the same on one card and on the rank that owns the
#: voxel, so the sharded and the unsharded step must count alike
VOXEL_SLOTS = "voxel_full_killed"
#: large_urban's budgets raised until neither four ranks nor the unsharded
#: step overflow them, so that the phase-5 bars hold the sharded code
#: itself (the budgets are each rank's, the JAX package's deviation): the
#: update's (``chip_smoke.py``'s ``UNCONTESTED``, its spill tier doubled
#: again for the second camera, whose FOV holds some 47,000 particles by
#: the eleventh frame) and the rows of a slab, ``P/4`` at four ranks, which
#: the densest z-slab outgrows after some nine frames
UNCONTESTED = dict(particle_spill_capacity=1 << 16, pyramid_slot_capacity=2048,
                   particle_capacity=1 << 18)


#: the flagship's spill tier raised for two cameras: the unsharded step
#: leaves particles of the second camera's update out of its 4,096 slots
#: from the eighth frame on, four ranks with a tier each do not
TWO_CAMERAS_UNCONTESTED = dict(particle_spill_capacity=1 << 15)


def path_configs() -> dict:
    """``label -> (cfg, n_sensors or None, rig)``: ``chip_smoke.py``'s
    sharded paths, the flagship's noisy arm and the four-camera rig
    besides, with the budgets neither side overflows.  ``rig``: the
    cameras are ``utils/rig.py``'s surround rig, each its own cloud (whose
    four cameras leave the flagship's budgets as they are: no camera's
    update overflows the spill tier on one card); else every camera is
    given the frame's one cloud and pose, as on ``chip_smoke.py``'s
    two-camera paths (``graph_ritual.sequence``)."""
    flagship = example_node_settings(dsp_dynamic())
    urban = dataclasses.replace(large_urban(), mover_exchange="ring",
                                **UNCONTESTED)
    return {
        "sharded_flagship": (flagship, None, False),
        "sharded_large_urban_uncontested": (urban, None, False),
        "sharded_noisy": (example_node_settings(
            dsp_dynamic(limit_motion_to_xy_plane=False)), None, False),
        "sharded_multisensor_2cam": (dataclasses.replace(
            flagship, **TWO_CAMERAS_UNCONTESTED), 2, False),
        "sharded_multisensor_compact": (urban, 2, False),
        "sharded_multisensor_4cam": (flagship, 4, True),
    }


def sharded_bars(cfg) -> dict:
    """The phase-5 bars as a gathered sharded state is held to them: the
    compact layout's flags compared as :func:`sharded_agreement` places
    them, on 99.5%."""
    return dict(PINNED_BARS,
                flags_equal=0.995 if cfg.layout == "compact" else 0.999)


def sharded_agreement(cfg, whole, out, ref, ref_out) -> dict:
    """:func:`~.parity.agreement`'s measures of a gathered sharded state
    against the unsharded step's -- except the compact layout's
    ``flags_equal``: its rows are arranged by slab in the one and by cell
    in the other, so it is the share of the unsharded population that the
    sharded one places in the same voxels (:func:`~.parity.placed_alike`)."""
    ref = ref.to("cpu")  # agreement's second state lies on the CPU
    m = agreement((whole, out), (ref, ref_out))
    if cfg.layout == "compact":
        m["flags_equal"] = placed_alike(whole.particles, ref.particles, cfg)
    m["alive_unsharded"] = m.pop("alive_cpu")
    m["alive_sharded"] = m.pop("alive_card")
    return m


def replicated_digests(state, out) -> dict:
    """A digest of each replicated leaf of a rank's state (the estimator
    tracks, the host scalars and runtime parameters), of its generator's
    state and of each metric, by name."""
    axes = state_shardings(state)
    mine = {k: v for k, v in leaves(state).items() if axes.get(k) is None}
    mine["gen"] = state.gen.get_state().numpy()
    mine.update({f"metrics.{k}": v.cpu().numpy()
                 for k, v in out.metrics.items()})
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()
                              + str(v.dtype).encode()).hexdigest()
            for k, v in mine.items()}


def _copy(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _together(mesh, device) -> None:
    """Every rank here, the card idle: a tiny ``all_reduce`` and a sync."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=device), group=mesh.group)
    torch.cuda.synchronize(device)


def _joined(draws, cfg, mesh):
    """The unsharded step's draws from a rank's sharded draws: the
    replicated ones as they are, each pool-shaped one gathered from every
    rank and joined in rank order on its voxel axis (the slabs' order)."""
    slab = _particle_shape(cfg, mesh.size)
    if cfg.layout == "compact" and any(
            tuple(d.shape[1:]) == slab for d in _flat(draws)):
        raise ValueError("a compact slab's rows do not join into the "
                         "unsharded rows")

    def join(d):
        if tuple(d.shape[1:]) != slab or mesh.size == 1:
            return d
        parts = [torch.empty_like(d) for _ in range(mesh.size)]
        dist.all_gather(parts, d.contiguous(), group=mesh.group)
        return torch.cat(parts, dim=-1)

    return _map_draws(join, draws)


def _median(xs):
    return statistics.median(xs) if xs else None


def _summed(counts, mesh, device) -> dict:
    """:func:`~.parity.counters_recorded`'s counters of a frame, summed over
    the ranks, as ints by name."""
    names = sorted(counts)
    if not names:
        return {}
    v = torch.stack([torch.as_tensor(counts[k], device=device).to(torch.int64)
                     for k in names])
    if dist.is_initialized():
        dist.all_reduce(v, group=mesh.group)
    return dict(zip(names, v.tolist()))


def contested(sharded: dict, unsharded: dict) -> list:
    """What says that a budget told the two sides apart on a frame: a
    counter of dropped particles above 0 on either side (every budget but
    a voxel's slots is a rank's own, so the ranks drop where one card
    does not), or :data:`VOXEL_SLOTS` unequal; or no update counted."""
    names = sorted(sharded.keys() | unsharded.keys())
    out = [f"{k}: {sharded.get(k)} sharded, {unsharded.get(k)} unsharded"
           for k in names
           if (sharded.get(k) != unsharded.get(k) if k == VOXEL_SLOTS
               else sharded.get(k) or unsharded.get(k))]
    if "update_spill_overflow" not in names:
        out.append(f"no update counted: {names}")
    return out


def _least(x: int, mesh, device) -> int:
    """The least of every rank's ``x``."""
    v = torch.tensor([x], dtype=torch.int64, device=device)
    if dist.is_initialized():
        dist.all_reduce(v, op=dist.ReduceOp.MIN, group=mesh.group)
    return int(v)


def every_pattern(graphed, state, frame, mesh, device) -> dict:
    """Captures every pattern of admitted cameras that the graphed
    multi-camera step ``graphed`` has not captured yet, each on ``frame``
    (a frame of every camera; the others' quaternions made NaN), while
    every rank's card has room for two more pools as large as its largest
    so far (the ranks agree, so each makes the same captures).  Returns
    each pattern's pool bytes by label, their sum, the patterns left out
    for want of room (the caller fails the run on any: the sum must be
    every pattern's), and the card's free and total bytes after."""
    n = len(frame.quat)
    left_out = []
    for pattern in itertools.product((True, False), repeat=n):
        if not any(pattern) or pattern in graphed.pool_bytes:
            continue
        room = torch.cuda.mem_get_info(device)[0] - 2 * max(
            graphed.pool_bytes.values())
        if _least(room, mesh, device) < 0:
            left_out.append(pattern_label(pattern))
            continue
        state, out = graphed(state, cameras(frame, pattern))
        if not out.accepted:
            raise RuntimeError(f"pattern {pattern_label(pattern)} rejected")
    torch.cuda.synchronize(device)
    free, total = torch.cuda.mem_get_info(device)
    pools = {pattern_label(p): v for p, v in graphed.pool_bytes.items()}
    return dict(every_pattern_pool_bytes=pools,
                every_pattern_pool_sum=sum(pools.values()),
                every_pattern_left_out=left_out,
                card_free_bytes=free, card_total_bytes=total)


def ritual(cfg, n_sensors, mesh, device, light=False, rig=False) -> dict:
    """One path in this rank (module docstring); every rank of ``mesh``
    calls it with the same arguments.  ``light`` leaves out the unsharded
    steps and the profiled frame (the bits, the captures and the launches
    alone); ``rig`` takes the frames of ``utils/rig.py``'s surround rig of
    ``n_sensors`` cameras, whose every pattern of admitted cameras is then
    captured once after the ritual (:func:`every_pattern`).  Returns this
    rank's record, whose ``failed`` lists the checks it failed (rank 0's
    also those of the comparisons it alone makes)."""
    started = time.perf_counter()
    parts = {}  # host seconds of the ritual's parts

    def part(name):
        now = time.perf_counter()
        parts[name] = now - started - sum(parts.values())

    failed = []

    def require(cond, what):
        if not cond:
            failed.append(what)

    eager = make_shardmap_step(cfg, mesh, device=device, n_sensors=n_sensors)
    graphed = make_graphed_shardmap_step(cfg, mesh, device=device,
                                         n_sensors=n_sensors)
    shard = graphed.shard
    seq = sequence(WARM + FRAMES, cfg, n_sensors, rig)
    warm = seq[:WARM]
    frames, patterns = ritual_frames(seq[WARM:], n_sensors)
    if n_sensors is None:
        def fresh():
            return init_state(cfg, seed=0, device=device)

        def draws_of(gen):
            return make_draws(cfg, gen, device, shard)
    else:
        def fresh():
            return init_multisensor_state(cfg, n_sensors, seed=0,
                                          device=device)

        def draws_of(gen):
            return make_multisensor_draws(cfg, n_sensors, gen, device, shard)

    # rank 0's unsharded steps on the same frames and numbers
    against = (_Unsharded(cfg, n_sensors, fresh())
               if mesh.rank == 0 and not light else None)

    a = shard_state(fresh(), mesh)
    ref_gen = _copy(a.gen)  # a third generator, in step with the steps'
    before = None if light else gather_state(a, mesh)
    counts = {}

    def counted(state, frame):
        """The eager step, its budgets' counters kept in ``counts``."""
        counts.clear()
        with counters_recorded(counts):
            return eager(state, frame)

    def compare(k, frame, a, out_a, pattern):
        """After an accepted frame's eager step: its draws made again
        from ``ref_gen`` (so ``ref_gen`` follows the steps'), and rank
        0's comparison with the unsharded steps (all ranks gather)."""
        nonlocal before
        draws = draws_of(ref_gen)
        require(torch.equal(a.gen.get_state(), ref_gen.get_state()),
                f"frame {k}: the eager step's generator is not the draws'")
        if light:
            return
        draws = _joined(draws, cfg, mesh)
        after = gather_state(a, mesh)
        summed = _summed(counts, mesh, device)
        if against is not None:
            against.frame(k, frame, draws, before, after, out_a, pattern,
                          summed)
        before = after

    step_a = eager if light else counted
    for k, f in enumerate(warm):
        a, out_a = step_a(a, f)
        require(out_a.accepted, "a warm frame rejected")
        compare(k, f, a, out_a, (True,) * (n_sensors or 1))
    part("build_and_warm")
    ref_gen.manual_seed(SEED)
    a = dataclasses.replace(a, gen=_copy(ref_gen))
    b = dataclasses.replace(a, gen=_copy(ref_gen))

    def at_setter():
        nonlocal before
        if against is not None:
            against.setter()
            before = set_detection_probability(before, P_SETTER)

    turns = in_turns(
        step_a, graphed, a, b, frames, patterns,
        together=lambda: _together(mesh, device),
        after_eager=lambda k, frame, a, out: compare(WARM + k, frame, a, out,
                                                     patterns[k]),
        at_setter=at_setter)
    failed += turns.failed
    part("frames")

    # the replicated leaves of every rank, eager and graphed
    mine = {"eager": replicated_digests(turns.a, turns.out_a),
            "graphed": replicated_digests(turns.b, turns.out_b)}
    every = [mine]
    if dist.is_initialized():
        every = [None] * mesh.size
        dist.all_gather_object(every, mine, group=mesh.group)
    differ_ranks = sorted(f"{arm}.{k}" for arm in mine for k in mine[arm]
                          if any(d[arm].get(k) != mine[arm][k]
                                 for d in every))
    require(not differ_ranks, f"replicated leaves differ across the ranks: "
            f"{differ_ranks}")
    rec = dict(
        rank=mesh.rank, frames=FRAMES, warm=WARM,
        bit_equal_frames=[not d for d in turns.bits],
        captures=graphed.captures,
        capture_ms={pattern_label(p): v
                    for p, v in graphed.capture_ms.items()},
        capture_call_ms=turns.capture_call_ms,
        pool_bytes={pattern_label(p): v
                    for p, v in graphed.pool_bytes.items()},
        kept_bytes={pattern_label(p): v
                    for p, v in graphed.kept_bytes.items()},
        capture_launches=turns.capture_launches,
        host_launches_per_replay=max(turns.replay_launches, default=None),
        eager_frame_ms=_median(turns.eager_ms),
        graphed_frame_ms=_median(turns.graphed_ms),
        graphed_frame_ms_all=[round(x, 3) for x in turns.graphed_ms],
        replicated_compared=len(mine["eager"]),
        replicated_differing=differ_ranks,
        alive=int(turns.out_b.metrics["alive"]))
    if against is not None:
        rec.update(against.summary(require))
    part("replicated_and_unsharded")
    if not light:
        # one more graphed frame, profiled on rank 0: the last frame again
        # (dt = 0 is admitted)
        _together(mesh, device)
        if mesh.rank == 0:
            rec.update(busy(lambda: graphed(turns.b, frames[-1])))
        else:
            graphed(turns.b, frames[-1])
        torch.cuda.synchronize(device)
        if rig:
            rec.update(every_pattern(graphed, turns.b, frames[-1], mesh,
                                     device))
            require(not rec["every_pattern_left_out"],
                    f"no room on the card for the patterns "
                    f"{rec['every_pattern_left_out']}")
    graphed.release()
    part("profiled")
    rec.update(failed=failed, seconds=time.perf_counter() - started,
               seconds_by_part=parts)
    return rec


class _Unsharded:
    """Rank 0's unsharded steps beside the sharded one, on the same frames
    and the same numbers (the joined draws): the eager step from the
    gathered sharded state before each frame -- phase 5's form, one frame
    from the same state, held to :func:`sharded_bars` -- and the graphed
    step running free from the same fresh state (its frame time, and the
    drift of a whole run, which is recorded and not held: the sharded
    step's budgets are each rank's, and arrivals from other slabs take
    other slots than on one card, so a run parts where one side overflows
    a budget the other does not, and, with pool-shaped noise, once a
    particle's slot differs).  Without ``free`` it makes the teacher-forced
    comparison alone."""

    def __init__(self, cfg, n_sensors, state, free=True):
        self.cfg, self.n_sensors, self.state = cfg, n_sensors, state
        if n_sensors is None:
            self.eager = make_step(cfg)
            self.graphed = make_graphed_step(cfg) if free else None
        else:
            self.eager = make_multisensor_step(cfg, n_sensors)
            self.graphed = (make_graphed_multisensor_step(cfg, n_sensors)
                            if free else None)
        self.frames, self.ms, self.seen = [], [], set()

    def setter(self) -> None:
        self.state = set_detection_probability(self.state, P_SETTER)

    def frame(self, k, frame, draws, before, after, out, pattern,
              counts) -> None:
        """Frame ``k``: ``after`` and ``out`` the gathered sharded state and
        rank 0's output, ``counts`` the sharded step's counters of dropped
        particles summed over the ranks (:func:`_summed`)."""
        cfg, dev = self.cfg, after.device
        mine = {}
        with counters_recorded(mine):
            ref, ref_out = self.eager(
                dataclasses.replace(before, gen=_copy(before.gen)), frame,
                draws)
        mine = {m: int(v) for m, v in mine.items()}
        forced = sharded_agreement(cfg, after, out, ref, ref_out)
        free = None
        if self.graphed is not None:
            captured = pattern in self.seen
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            self.state, free_out = self.graphed(self.state, frame, draws)
            torch.cuda.synchronize(dev)
            if captured and all(pattern):
                self.ms.append((time.perf_counter() - t0) * 1e3)
            self.seen.add(pattern)
            free = sharded_agreement(cfg, after, out, self.state, free_out)
        self.frames.append(dict(
            frame=k, teacher_forced=forced, free=free,
            missed=missed_bars(forced, sharded_bars(cfg)),
            dropped={m: [counts.get(m), mine.get(m)]
                     for m in sorted(counts.keys() | mine.keys())},
            contested=contested(counts, mine)))

    def summary(self, require) -> dict:
        """The frames' records; the worst teacher-forced measure of each
        kind; the free run's last; the free graphed frame's median."""
        forced = [f["teacher_forced"] for f in self.frames]
        worst = {m: (max if m == "alive_rel" else min)(f[m] for f in forced)
                 for m in sharded_bars(self.cfg)}
        for f in self.frames:
            require(not f["missed"], f"frame {f['frame']} against the "
                    f"unsharded step from the same state missed "
                    f"{f['missed']}: {f['teacher_forced']}")
            require(not f["contested"], f"frame {f['frame']}: a budget "
                    f"told the sides apart: {f['contested']}")
        if self.graphed is not None:
            self.graphed.release()
        return dict(teacher_forced_worst=worst,
                    free_last=self.frames[-1]["free"],
                    against_unsharded=self.frames,
                    unsharded_graphed_frame_ms=_median(self.ms),
                    unsharded_captures=getattr(self.graphed, "captures",
                                               None))


def _rank(rank, n, port, names, budgets):
    """One rank of :func:`main`: its card, the NCCL group, every path of
    ``names`` with ``budgets`` (fields of its configuration) set."""
    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=180))
    failed = False
    try:
        mesh = make_mesh(n)
        table = path_configs()
        for name in names:
            cfg, n_sensors, rig = table[name]
            cfg = dataclasses.replace(cfg, **budgets)
            rec = ritual(cfg, n_sensors, mesh, device, rig=rig)
            every = [None] * n
            dist.all_gather_object(every, rec)
            failed |= any(r["failed"] for r in every)
            if rank == 0:
                _report(name, cfg, n_sensors, every)
        dist.barrier(device_ids=[rank])
    finally:
        dist.destroy_process_group()
    if failed:
        raise SystemExit(1)


def _report(name, cfg, n_sensors, every) -> None:
    r0 = every[0]
    line = dict(
        path=name, ranks=len(every), layout=cfg.layout,
        exchange=cfg.mover_exchange, sensors=n_sensors or 1,
        budgets=dict(particle_spill_capacity=cfg.particle_spill_capacity,
                     pyramid_slot_capacity=cfg.pyramid_slot_capacity,
                     compact_capacity=cfg.compact_capacity),
        bit_equal=all(all(r["bit_equal_frames"]) for r in every),
        bit_equal_by_rank=[all(r["bit_equal_frames"]) for r in every],
        captures_by_rank=[r["captures"] for r in every],
        host_launches_per_replay=max(r["host_launches_per_replay"] or 0
                                     for r in every),
        replicated_compared=r0["replicated_compared"],
        replicated_differing=len(r0["replicated_differing"]),
        eager_frame_ms_by_rank=[r["eager_frame_ms"] for r in every],
        graphed_frame_ms_by_rank=[r["graphed_frame_ms"] for r in every],
        unsharded_graphed_frame_ms=r0.get("unsharded_graphed_frame_ms"),
        capture_ms_by_rank=[r["capture_ms"] for r in every],
        pool_bytes_by_rank=[r["pool_bytes"] for r in every],
        **({} if "every_pattern_pool_bytes" not in r0 else dict(
            every_pattern_pool_bytes_by_rank=[
                r["every_pattern_pool_bytes"] for r in every],
            every_pattern_pool_sum_by_rank=[r["every_pattern_pool_sum"]
                                            for r in every],
            every_pattern_left_out=r0["every_pattern_left_out"],
            card_free_bytes_by_rank=[r["card_free_bytes"] for r in every],
            card_total_bytes=r0["card_total_bytes"])),
        device_busy_ms=r0.get("device_busy_ms"),
        device_events=r0.get("device_events"),
        nccl_ms=r0.get("nccl_ms"), nccl_kernels=r0.get("nccl_kernels"),
        teacher_forced_worst=r0.get("teacher_forced_worst"),
        free_last=r0.get("free_last"),
        against_unsharded=r0.get("against_unsharded"),
        seconds=r0["seconds"], seconds_by_part=r0["seconds_by_part"],
        failed=[f"rank {r['rank']}: {f}" for r in every for f in r["failed"]])
    print(json.dumps(line), flush=True)


# -- the weak-scaling mode ---------------------------------------------------

#: the weak-scaling mode: its rank counts, warm-up frames and timed frames
#: by preset (``bench.py``'s protocol), and the frames of its check against
#: the grown map on one card (warm, then each compared)
WEAK_RANKS = (1, 2, 4)
WEAK_WARM = 3
WEAK_TIMED = {"flagship": 30, "large_urban": 10}
CHECK_WARM, CHECK_FRAMES = 8, 3
#: large_urban's update budgets in the weak mode, raised to
#: :data:`UNCONTESTED`'s: at the preset's own the one-rank map drops
#: particles of the update's spill tier and pyramid cells (143,496 and
#: 5,751 over 13 frames) and rank 0 at two and four ranks fewer, so the
#: rates would compare runs that throw away different work, and the grown
#: map on one card could not be held to the sharded one.  At these no run
#: drops any (:func:`_weak_line` fails one that does), and the
#: configuration timed is the one checked
WEAK_URBAN_BUDGETS = {k: UNCONTESTED[k] for k in ("particle_spill_capacity",
                                                  "pyramid_slot_capacity")}


def grown(cfg, n: int):
    """``cfg`` grown for ``n`` ranks: its z extent ``n`` times, and in the
    compact layout ``n`` times its rows, so that a rank's slab holds what
    the map of ``cfg`` holds (the storage grid's padding aside)."""
    rows = ({} if cfg.layout != "compact"
            else dict(particle_capacity=cfg.compact_capacity * n))
    return dataclasses.replace(cfg, nz=cfg.nz * n, **rows)


def weak_config(preset: str, n: int):
    """``preset``'s configuration grown for ``n`` ranks (:func:`grown`):
    flagship 175,104 / 349,184 / 720,896 storage voxels at 1 / 2 / 4
    ranks; large_urban with the ``ring`` exchange of :func:`path_configs`
    and the update budgets of :data:`WEAK_URBAN_BUDGETS`, 5,439,488 /
    10,813,440 / 21,626,880 voxels and 131,072 compact rows a rank."""
    if preset == "flagship":
        return grown(example_node_settings(dsp_dynamic()), n)
    if preset == "large_urban":
        return grown(dataclasses.replace(large_urban(), mover_exchange="ring",
                                         **WEAK_URBAN_BUDGETS), n)
    raise ValueError(f"no weak-scaling preset {preset!r}: "
                     f"{sorted(WEAK_TIMED)}")


def weak_run(cfg, timed, mesh, device) -> dict:
    """One weak-scaling run in this rank: :data:`WEAK_WARM` + ``timed``
    frames of ``sim.generate_sequence`` (seed 0, one camera), first through
    the eager sharded step with this rank's counters of dropped particles
    recorded (``parity.counters_recorded``), then from the same fresh state
    through the graphed sharded step, timed (host clock around a call that
    ends in ``torch.cuda.synchronize()``, the ranks starting each call
    together), its last state required bit-equal to the eager step's, and
    one more graphed frame profiled.  Returns this rank's record."""
    failed = []
    seq = [Frame(*f) for f in sim.generate_sequence(WEAK_WARM + timed, cfg,
                                                     seed=0)]
    eager = make_shardmap_step(cfg, mesh, device=device)
    a = shard_state(init_state(cfg, seed=0, device=device), mesh)
    dropped = {}
    for f in seq:
        counts = {}
        with counters_recorded(counts):
            a, out = eager(a, f)
        if not out.accepted:
            failed.append("an eager frame rejected")
        for k, v in counts.items():
            dropped[k] = dropped.get(k, 0) + int(v)
    graphed = make_graphed_shardmap_step(cfg, mesh, device=device)
    b = shard_state(init_state(cfg, seed=0, device=device), mesh)
    ms, alive, alive_total = [], [], []
    for k, f in enumerate(seq):
        _together(mesh, device)
        t0 = time.perf_counter()
        b, out = graphed(b, f)
        torch.cuda.synchronize(device)
        if k >= WEAK_WARM:
            ms.append((time.perf_counter() - t0) * 1e3)
            alive.append(int((b.particles.flags != 0).sum()))
            alive_total.append(int(out.metrics["alive"]))
        if not out.accepted:
            failed.append(f"graphed frame {k} rejected")
    differ = differing_on_card(a, b)
    if not torch.equal(a.gen.get_state(), b.gen.get_state()):
        differ.append("gen")
    if differ:
        failed.append(f"graphed against eager differ in {differ}")
    del a
    _together(mesh, device)
    profiled = busy(lambda: graphed(b, seq[-1]))
    p50, p90 = np.percentile(ms, [50, 90])
    rec = dict(rank=mesh.rank, frame_ms_p50=float(p50),
               frame_ms_p90=float(p90),
               frame_ms_all=[round(x, 3) for x in ms],
               alive_mean=float(np.mean(alive)), alive_last=alive[-1],
               alive_total_mean=float(np.mean(alive_total)),
               dropped=dropped, bit_equal_to_eager=not differ,
               captures=graphed.captures,
               capture_ms=graphed.capture_ms[(True,)],
               pool_bytes=graphed.pool_bytes[(True,)], **profiled,
               failed=failed)
    graphed.release()
    return rec


def weak_check(cfg, mesh, device) -> dict:
    """The grown map's sharded step held to the same map on one card:
    :data:`CHECK_WARM` frames of the eager sharded step, then
    :data:`CHECK_FRAMES` more, each compared on rank 0 from the gathered
    state before it with the unsharded step on the same frame and numbers
    (:class:`_Unsharded`'s teacher-forced comparison: :func:`sharded_bars`,
    and no budget may tell the sides apart).  Returns this rank's record
    (rank 0's holds the comparison)."""
    failed = []

    def require(cond, what):
        if not cond:
            failed.append(what)

    eager = make_shardmap_step(cfg, mesh, device=device)
    shard = shard_ctx(cfg, mesh, device)
    against = (_Unsharded(cfg, None, None, free=False) if mesh.rank == 0
               else None)
    a = shard_state(init_state(cfg, seed=0, device=device), mesh)
    ref_gen = _copy(a.gen)  # a third generator, in step with the step's
    seq = [Frame(*f) for f in sim.generate_sequence(
        CHECK_WARM + CHECK_FRAMES, cfg, seed=0)]
    counts = {}
    for k, f in enumerate(seq):
        compare = k >= CHECK_WARM
        before = gather_state(a, mesh) if compare else None
        counts.clear()
        with counters_recorded(counts):
            a, out = eager(a, f)
        require(out.accepted, f"check frame {k} rejected")
        draws = make_draws(cfg, ref_gen, device, shard)
        require(torch.equal(a.gen.get_state(), ref_gen.get_state()),
                f"check frame {k}: the step's generator is not the draws'")
        if compare:
            summed = _summed(counts, mesh, device)
            draws = _joined(draws, cfg, mesh)
            after = gather_state(a, mesh)
            if against is not None:
                against.frame(k, f, draws, before, after, out, (True,),
                              summed)
    rec = dict(failed=failed)
    if against is not None:
        rec.update(against.summary(require))
        for r in ("free_last", "unsharded_graphed_frame_ms",
                  "unsharded_captures"):
            rec.pop(r)
    return rec


def _weak_rank(rank, n, port, presets, out_path):
    """One rank of :func:`weak_main` at ``n`` ranks: its card, the NCCL
    group, each preset's run (:func:`weak_run`) and above one rank its
    check (:func:`weak_check`); rank 0 prints each preset's line and adds
    it to ``out_path``."""
    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    failed = False
    try:
        mesh = make_mesh(n)
        for preset in presets:
            started = time.perf_counter()
            cfg = weak_config(preset, n)
            rec = weak_run(cfg, WEAK_TIMED[preset], mesh, device)
            if n > 1:
                rec["check"] = weak_check(cfg, mesh, device)
                rec["failed"] += rec["check"].pop("failed")
            rec["seconds"] = time.perf_counter() - started
            every = [None] * n
            dist.all_gather_object(every, rec)
            failed |= any(r["failed"] for r in every)
            if rank == 0:
                line = _weak_line(preset, cfg, n, every)
                failed |= bool(line["failed"])
                print(json.dumps(line), flush=True)
                with open(out_path, "a") as f:
                    f.write(json.dumps(line) + "\n")
        dist.barrier(device_ids=[rank])
    finally:
        dist.destroy_process_group()
    if failed:
        raise SystemExit(1)


def _weak_line(preset, cfg, n, every) -> dict:
    """One preset's line at ``n`` ranks: every rank's numbers, and the
    rates at the slowest rank's median frame: particles/s (the live
    particles of every rank, their mean over the timed frames) and
    voxel-slots/s (S x V of the whole map, what the pool passes sweep)."""
    r0 = every[0]
    fps = 1e3 / max(r["frame_ms_p50"] for r in every)
    by_rank = lambda k: [r[k] for r in every]  # noqa: E731
    names = sorted({k for r in every for k in r["dropped"]})
    alive = sum(by_rank("alive_mean"))
    failed = [f"rank {r['rank']}: {f}" for r in every for f in r["failed"]]
    if alive != r0["alive_total_mean"]:  # the slabs split the population
        failed.append(f"the ranks' live particles {alive} are not the "
                      f"step's alive {r0['alive_total_mean']}")
    # every budget but a voxel's slots is a rank's own: at one that drops
    # particles the runs would not do the same work
    failed += [f"rank {r['rank']}: {k} dropped {v}" for r in every
               for k, v in sorted(r["dropped"].items())
               if v and k != VOXEL_SLOTS]
    return dict(
        mode="weak", preset=preset, ranks=n, layout=cfg.layout,
        exchange=cfg.mover_exchange, nz=cfg.nz,
        storage_voxels=cfg.storage_voxels,
        slab_voxels=cfg.storage_voxels // n, slots=cfg.slots_per_voxel,
        compact_rows=(cfg.compact_capacity if cfg.layout == "compact"
                      else None),
        budgets=dict(particle_spill_capacity=cfg.particle_spill_capacity,
                     pyramid_slot_capacity=cfg.pyramid_slot_capacity,
                     mover_capacity=cfg.mover_capacity),
        warm=WEAK_WARM, timed=len(r0["frame_ms_all"]),
        frame_ms_p50_by_rank=by_rank("frame_ms_p50"),
        frame_ms_p90_by_rank=by_rank("frame_ms_p90"),
        device_busy_ms_by_rank=by_rank("device_busy_ms"),
        device_events_by_rank=by_rank("device_events"),
        nccl_ms_by_rank=by_rank("nccl_ms"),
        nccl_kernels_by_rank=by_rank("nccl_kernels"),
        alive_mean_by_rank=by_rank("alive_mean"),
        alive_last_by_rank=by_rank("alive_last"),
        alive_metric_mean=r0["alive_total_mean"],
        dropped_by_rank={k: [r["dropped"].get(k) for r in every]
                         for k in names},
        bit_equal_to_eager_by_rank=by_rank("bit_equal_to_eager"),
        captures_by_rank=by_rank("captures"),
        capture_ms_by_rank=by_rank("capture_ms"),
        pool_bytes_by_rank=by_rank("pool_bytes"),
        frames_per_s=fps, particles_per_s=alive * fps,
        voxel_slots_per_s=cfg.slots_per_voxel * cfg.storage_voxels * fps,
        check=r0.get("check"),
        frame_ms_all_rank0=r0["frame_ms_all"],
        seconds=r0["seconds"], failed=failed)


def weak_summary(lines) -> dict:
    """Each preset's rates by rank count and their efficiency against one
    rank, rate_N / (N * rate_1) (``bench_scaling.py``'s), on particles/s
    and on voxel-slots/s."""
    out = {}
    for line in lines:
        out.setdefault(line["preset"], {})[line["ranks"]] = line
    summary = {}
    for preset, by_n in out.items():
        one = by_n.get(1)
        summary[preset] = {n: dict(
            particles_per_s=line["particles_per_s"],
            voxel_slots_per_s=line["voxel_slots_per_s"],
            particles_efficiency=(None if one is None else line[
                "particles_per_s"] / (n * one["particles_per_s"])),
            voxel_slots_efficiency=(None if one is None else line[
                "voxel_slots_per_s"] / (n * one["voxel_slots_per_s"])))
            for n, line in sorted(by_n.items())}
    return dict(mode="weak_summary", by_preset=summary)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _card_line() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


def weak_main(args) -> int:
    """``weak [n ...] [preset ...]``: each rank count of ``n`` (default
    :data:`WEAK_RANKS`) in a group of its own, one card a rank, every
    preset (default flagship and large_urban) in it; then the summary
    line (:func:`weak_summary`)."""
    import tempfile

    import torch.multiprocessing as mp

    ranks = [int(a) for a in args if a.isdigit()] or list(WEAK_RANKS)
    presets = [a for a in args if not a.isdigit()] or list(WEAK_TIMED)
    for p in presets:
        weak_config(p, 1)  # an unknown preset raises here
    if not torch.cuda.is_available():
        print("shard_probe: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < max(ranks):
        print(f"shard_probe: {max(ranks)} ranks need {max(ranks)} cards, "
              f"the machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    _card_line()
    t0 = time.perf_counter()
    kernels.build()  # once, before the ranks load it
    print(f"[build] seconds={time.perf_counter() - t0:.1f}", flush=True)
    status = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "weak.jsonl")
        open(out, "w").close()
        for n in ranks:
            t0 = time.perf_counter()
            try:
                mp.spawn(_weak_rank, args=(n, _free_port(), presets, out),
                         nprocs=n, join=True)
            except (mp.ProcessRaisedException,
                    mp.ProcessExitedException) as e:
                print(f"shard_probe: a rank of {n} failed: {e}",
                      file=sys.stderr)
                status = 1
            print(f"[weak {n}] seconds={time.perf_counter() - t0:.1f}",
                  flush=True)
        with open(out) as f:
            lines = [json.loads(x) for x in f]
    print(json.dumps(weak_summary(lines)), flush=True)
    return status


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "weak":
        return weak_main(args[1:])
    n = int(args[0]) if args else 4
    budgets = {k: int(v) for k, v in (a.split("=") for a in args[1:]
                                      if "=" in a)}
    names = [a for a in args[1:] if "=" not in a] or list(path_configs())
    if not torch.cuda.is_available():
        print("shard_probe: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < n:
        print(f"shard_probe: {n} ranks need {n} cards, the machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    _card_line()
    t0 = time.perf_counter()
    kernels.build()  # once, before the ranks load it
    print(f"[build] seconds={time.perf_counter() - t0:.1f}", flush=True)
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    try:
        mp.spawn(_rank, args=(n, _free_port(), names, budgets), nprocs=n,
                 join=True)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        print(f"shard_probe: a rank failed: {e}", file=sys.stderr)
        return 1
    print(f"[total] seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
