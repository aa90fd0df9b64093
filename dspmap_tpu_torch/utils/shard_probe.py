"""The graphed sharded step on several cards, one NCCL rank a card, held
against the eager sharded step and the unsharded step.

Run on a machine with four CUDA cards, from the root of a checkout::

    python3 -m dspmap_tpu_torch.utils.shard_probe [n_ranks [path ...] [budget=value ...]]

It builds the kernels, then starts ``n_ranks`` processes (default 4; one
card each, at most as many as the machine has) joined in one NCCL group
over ``tcp://localhost`` and runs each path of :func:`path_configs` (or
those named; a ``budget=value`` argument sets that field of every path's
configuration) in all of them through :func:`ritual`:

* :data:`WARM` frames of the eager sharded step from a fresh state, then
  ``graph_ritual.in_turns``'s frames through the eager sharded step
  (``make_shardmap_step``) and its graphed form
  (``make_graphed_shardmap_step``) in turns on the same draws -- a pose
  jump that admission rejects, a ``p_detection`` setter, on the two-camera
  paths a frame of each camera alone: every rank's slab, generator and
  outputs compared bit for bit after each frame, the graphed step's
  captures and the kernels the host launches in a replay (none) counted;
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
  NCCL kernels' device ms and count.

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
import json
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
from . import sim
from .graph_ritual import (FRAMES, P_SETTER, SEED, busy, cameras, in_turns,
                           pattern_label, ritual_frames)
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
    """``label -> (cfg, n_sensors or None)``: ``chip_smoke.py``'s sharded
    paths, the flagship's noisy arm besides, with the budgets neither
    side overflows."""
    flagship = example_node_settings(dsp_dynamic())
    urban = dataclasses.replace(large_urban(), mover_exchange="ring",
                                **UNCONTESTED)
    return {
        "sharded_flagship": (flagship, None),
        "sharded_large_urban_uncontested": (urban, None),
        "sharded_noisy": (example_node_settings(
            dsp_dynamic(limit_motion_to_xy_plane=False)), None),
        "sharded_multisensor_2cam": (dataclasses.replace(
            flagship, **TWO_CAMERAS_UNCONTESTED), 2),
        "sharded_multisensor_compact": (urban, 2),
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


def ritual(cfg, n_sensors, mesh, device, light=False) -> dict:
    """One path in this rank (module docstring); every rank of ``mesh``
    calls it with the same arguments.  ``light`` leaves out the unsharded
    steps and the profiled frame (the bits, the captures and the launches
    alone).  Returns this rank's record, whose ``failed`` lists the checks
    it failed (rank 0's also those of the comparisons it alone makes)."""
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
    seq = [Frame(*f) for f in sim.generate_sequence(WARM + FRAMES, cfg,
                                                     seed=0)]
    frames, patterns = ritual_frames(seq[WARM:], n_sensors)
    if n_sensors is None:
        warm = seq[:WARM]

        def fresh():
            return init_state(cfg, seed=0, device=device)

        def draws_of(gen):
            return make_draws(cfg, gen, device, shard)
    else:
        warm = [cameras(f, (True,) * n_sensors) for f in seq[:WARM]]

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
    particle's slot differs)."""

    def __init__(self, cfg, n_sensors, state):
        self.cfg, self.n_sensors, self.state = cfg, n_sensors, state
        if n_sensors is None:
            self.eager = make_step(cfg)
            self.graphed = make_graphed_step(cfg)
        else:
            self.eager = make_multisensor_step(cfg, n_sensors)
            self.graphed = make_graphed_multisensor_step(cfg, n_sensors)
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
        self.graphed.release()
        return dict(teacher_forced_worst=worst,
                    free_last=self.frames[-1]["free"],
                    against_unsharded=self.frames,
                    unsharded_graphed_frame_ms=_median(self.ms),
                    unsharded_captures=self.graphed.captures)


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
            cfg, n_sensors = table[name]
            cfg = dataclasses.replace(cfg, **budgets)
            rec = ritual(cfg, n_sensors, mesh, device)
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
        device_busy_ms=r0.get("device_busy_ms"),
        device_events=r0.get("device_events"),
        nccl_ms=r0.get("nccl_ms"), nccl_kernels=r0.get("nccl_kernels"),
        teacher_forced_worst=r0.get("teacher_forced_worst"),
        free_last=r0.get("free_last"),
        against_unsharded=r0.get("against_unsharded"),
        seconds=r0["seconds"], seconds_by_part=r0["seconds_by_part"],
        failed=[f"rank {r['rank']}: {f}" for r in every for f in r["failed"]])
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    kernels.build()  # once, before the ranks load it
    print(f"[build] seconds={time.perf_counter() - t0:.1f}", flush=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    try:
        mp.spawn(_rank, args=(n, port, names, budgets), nprocs=n, join=True)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        print(f"shard_probe: a rank failed: {e}", file=sys.stderr)
        return 1
    print(f"[total] seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
