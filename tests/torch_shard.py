"""Runs the port's sharded step on gloo ranks for the sharded tests
(``tests/test_torch_shard_*.py``).

The test process (which has jax) prepares lists of cases and
:func:`run_ranks` (or :func:`start_ranks`, :func:`post_jobs` and
:func:`wait_ranks`, which let the test process record the next cases while
the ranks run the first) starts this file once per rank: each rank joins
a gloo group on the CPU through a ``file://`` rendezvous, runs every case
-- the function of this module named by the case's ``"kind"`` -- and
pickles its results.  The ranks import torch and the port, never jax
(``sys.modules["jax"] = None``).  One start of the ranks serves a whole
test file, since each start imports torch in every rank.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
N_RANKS = 4
#: one thread a rank (four ranks run beside the test process), and glibc's
#: malloc kept from giving every large block back to the system at its
#: free: the step's temporaries would be mapped and faulted in anew each
#: time, which doubled the ranks' CPU time on the larger maps
RANK_ENV = {"OMP_NUM_THREADS": "1", "MALLOC_MMAP_THRESHOLD_": "4000000000",
            "MALLOC_TRIM_THRESHOLD_": "4000000000"}

_PLANES = ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")
_EST = ("prev_centers", "prev_point_num", "prev_intensity", "prev_valid")
_PARAMS = ("sigma_ob", "position_noise_std", "velocity_noise_std",
           "p_detection", "kappa", "newborn_particle_weight")
_TOP = ("weight_sum", "vel_avg", "future", "sensor_pos", "last_sensor_pos",
        "origin", "update_time", "last_timestamp", "update_counter",
        "initialized")


def tree(state) -> SimpleNamespace:
    """A state as nested namespaces of numpy arrays (what
    ``state_from_numpy`` reads): from a JAX ``MapState`` after
    ``device_get``, or from the port's ``state_to_numpy`` dict."""
    get = ((lambda o, k: o[k]) if isinstance(state, dict)
           else (lambda o, k: getattr(o, k)))

    def ns(obj, names):
        return SimpleNamespace(**{k: np.asarray(get(obj, k)) for k in names})

    return SimpleNamespace(
        particles=ns(get(state, "particles"), _PLANES),
        estimator=ns(get(state, "estimator"), _EST),
        params=ns(get(state, "params"), _PARAMS),
        **{k: np.asarray(get(state, k)) for k in _TOP})


def newborn_coeff(w_b, target):
    """The float32 ``c`` with ``w_b * c == target`` bit for bit: the
    ``norm_coeff`` that makes the port's newborn weight the given one."""
    w_b, target = np.float32(w_b), np.float32(target)
    c = np.float32(target / w_b)
    for _ in range(8):
        if np.float32(w_b * c) == target:
            break
        c = np.nextafter(c, np.float32(np.inf) if np.float32(w_b * c) < target
                         else np.float32(-np.inf))
    assert np.float32(w_b * c) == target
    return c


def start_ranks(tmp_path, n: int = N_RANKS) -> dict:
    """Start ``n`` ranks that wait for jobs: each list of cases that
    :func:`post_jobs` hands them, in turn, until :func:`wait_ranks` says
    that no job follows and collects the results.  The caller works
    meanwhile (records the next cases, say)."""
    tmp = pathlib.Path(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO), **RANK_ENV)
    procs, logs = [], []
    for r in range(n):
        log = open(tmp / f"rank{r}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp), str(r), str(n)], cwd=REPO,
            env=env, stdout=log, stderr=subprocess.STDOUT))
    return dict(tmp=tmp, procs=procs, logs=logs, posted=0)


def post_jobs(ranks: dict, cases: list) -> None:
    """Hand the ranks of :func:`start_ranks` a list of cases (written
    whole before the ranks can see it)."""
    path = ranks["tmp"] / f"job{ranks['posted']}.pkl"
    with open(path.with_suffix(".part"), "wb") as f:
        pickle.dump(cases, f)
    os.replace(path.with_suffix(".part"), path)
    ranks["posted"] += 1


def stop_ranks(ranks: dict) -> list:
    """End the ranks that still run; returns each rank's output."""
    for p in ranks["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    said = []
    for log in ranks["logs"]:
        if not log.closed:
            log.seek(0)
            said.append(log.read())
            log.close()
    return said


def wait_ranks(ranks: dict, timeout: float = 240.0) -> list:
    """Each rank's list of results, one a posted case in order.  A rank
    that fails or runs out of time fails the call with the end of its
    standard error; the ranks are ended in any case."""
    (ranks["tmp"] / "jobs.end").touch()  # no job follows
    procs = ranks["procs"]
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        said = stop_ranks(ranks)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join(f"rank {r} ({procs[r].returncode}):\n"
                                 f"{said[r][-3000:]}" for r in failed)
    out = []
    for r in range(len(procs)):
        with open(ranks["tmp"] / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def run_ranks(cases: list, tmp_path, n: int = N_RANKS,
              timeout: float = 240.0) -> list:
    """Start ``n`` ranks on ``cases`` and return each rank's list of
    results."""
    ranks = start_ranks(tmp_path, n)
    post_jobs(ranks, cases)
    return wait_ranks(ranks, timeout)


# --- run in the ranks -------------------------------------------------------

def _pin_birth(weights: list):
    """Make the port's birth stages use the given newborn weights, one a
    call, consumed in order."""
    import torch
    from dspmap_tpu_torch.models import pipeline

    for name in ("particle_birth", "particle_birth_compact"):
        orig = getattr(pipeline, "_unpinned_" + name, None) or getattr(
            pipeline, name)
        setattr(pipeline, "_unpinned_" + name, orig)

        def birth(p, cfg, draws, _orig=orig, **kw):
            c = newborn_coeff(kw["rt"].newborn_particle_weight, weights.pop(0))
            kw["norm_coeff"] = torch.tensor(float(c), dtype=torch.float32)
            return _orig(p, cfg, draws, **kw)

        setattr(pipeline, name, birth)


def _unpin_birth():
    from dspmap_tpu_torch.models import pipeline

    for name in ("particle_birth", "particle_birth_compact"):
        orig = getattr(pipeline, "_unpinned_" + name, None)
        if orig is not None:
            setattr(pipeline, name, orig)


def _draws(d, rank):
    """A frame's draws for ``rank``: ``None``, or ``(replicated, per_rank)``
    with ``per_rank`` ``None`` or one tuple of pool-shaped draws a rank."""
    if d is None:
        return None
    replicated, per_rank = d
    return tuple(replicated) + (() if per_rank is None else
                                tuple(per_rank[rank]))


def _metrics(out) -> dict:
    return {k: np.asarray(v.cpu()) for k, v in out.metrics.items()}


def steps(case, mesh):
    """The sharded step over ``case["frames"]``: from ``case["init"]`` with
    the state carried, or from ``case["teacher"][i]`` before every frame;
    ``case["draws"][i]`` as :func:`_draws` reads it; ``case["pin"][i]``
    the newborn weight to pin, if any.  Returns per frame ``(accepted,
    metrics, gathered state as numpy)`` -- the state on rank 0 only, on
    the frames of ``case["keep"]`` (default: all)."""
    import dspmap_tpu_torch as T
    from dspmap_tpu_torch.parallel import (gather_state, make_shardmap_step,
                                           shard_state)

    cfg = case["cfg"]
    step = make_shardmap_step(cfg, mesh, device="cpu")
    teacher = case.get("teacher")
    keep = case.get("keep", range(len(case["frames"])))
    state = None if teacher else shard_state(
        T.state_from_numpy(case["init"], cfg, device="cpu"), mesh)
    out = []
    try:
        for i, frame in enumerate(case["frames"]):
            if teacher:
                state = shard_state(T.state_from_numpy(teacher[i], cfg,
                                                       device="cpu"), mesh)
            if case.get("pin"):
                _pin_birth([case["pin"][i]])
            draws = case["draws"][i] if case.get("draws") else None
            state, res = step(state, T.Frame(*frame), _draws(draws,
                                                            mesh.rank))
            whole = None
            if i in keep:
                whole = gather_state(state, mesh)
                whole = T.state_to_numpy(whole) if mesh.rank == 0 else None
            out.append((res.accepted, _metrics(res), whole))
    finally:
        _unpin_birth()
    return out


def _replicated(state) -> dict:
    """The rank's replicated leaves (``state_shardings`` axis ``None``, and
    the runtime parameters) as numpy, by path, and the generator's state
    under ``"gen"``."""
    import dspmap_tpu_torch as T
    from dspmap_tpu_torch.parallel import state_shardings

    flat = {}
    for k, v in T.state_to_numpy(state).items():
        if isinstance(v, dict):
            flat.update({f"{k}.{n}": x for n, x in v.items()})
        else:
            flat[k] = v
    axes = state_shardings(state)
    out = {k: np.asarray(v) for k, v in flat.items() if axes.get(k) is None}
    out["gen"] = state.gen.get_state().numpy()
    return out


def _count_movers(sink: list):
    """Wrap the multi-sensor step's mover exchange (``pipeline.rebin``,
    ``pipeline.rebin_exchange_compact``) so that each call appends to
    ``sink`` this rank's ``(movers, movers bound for another rank's
    slab)``.  Returns the function that puts the stages back."""
    from dspmap_tpu_torch import geometry
    from dspmap_tpu_torch.models import pipeline

    rebin, exchange = pipeline.rebin, pipeline.rebin_exchange_compact

    def pool(p, cfg, origin, t, shard=None):
        w = geometry.world_voxel_planar(p.px, p.py, p.pz, cfg)
        inside = geometry.in_window_planar(*w, origin, cfg) & p.valid
        away = ~shard.owns(geometry.storage_index_planar(*w, cfg),
                           p.flags.shape[1])
        new, stats = rebin(p, cfg, origin, t, shard)
        sink.append((int(stats["movers"]), int((inside & away).sum())))
        return new, stats

    def compact(p, sw, cfg, shard):
        away = ~shard.owns(sw.cell, cfg.storage_voxels // shard.n_shards)
        new, stats = exchange(p, sw, cfg, shard)
        sink.append((int(stats["movers"]), int((sw.mover & away).sum())))
        return new, stats

    def restore():
        pipeline.rebin, pipeline.rebin_exchange_compact = rebin, exchange

    pipeline.rebin, pipeline.rebin_exchange_compact = pool, compact
    return restore


def multisensor_steps(case, mesh):
    """The sharded multi-sensor step (``make_shardmap_step(...,
    n_sensors=)``) over ``case["frames"]`` (multi-sensor frame tuples),
    as :func:`steps` runs the single-sensor one: from ``case["init"]`` or
    from ``case["teacher"][i]`` before every frame;
    ``case["draws"][i][rank]`` this rank's draws ``(prop_noise, per-sensor
    tuples)``; ``case["pin"][i]`` the newborn weights to pin, one an
    admitted sensor.  Returns per frame ``(accepted, metrics, gathered
    state as numpy on rank 0 or None, this rank's replicated leaves, its
    ``(movers, movers bound for another rank's slab)``)``; a rejected
    frame exchanges nothing and reads ``(0, 0)``."""
    import dspmap_tpu_torch as T
    from dspmap_tpu_torch.parallel import (gather_state, make_shardmap_step,
                                           shard_state)

    cfg, n_sensors = case["cfg"], case["n_sensors"]
    step = make_shardmap_step(cfg, mesh, device="cpu", n_sensors=n_sensors)
    teacher = case.get("teacher")
    keep = case.get("keep", range(len(case["frames"])))
    state = None if teacher else shard_state(
        T.state_from_numpy(case["init"], cfg, device="cpu"), mesh)
    movers = []
    restore = _count_movers(movers)
    out = []
    try:
        for i, frame in enumerate(case["frames"]):
            if teacher:
                state = shard_state(T.state_from_numpy(teacher[i], cfg,
                                                       device="cpu"), mesh)
            weights = list(case["pin"][i]) if case.get("pin") else []
            if weights:
                _pin_birth(weights)
            del movers[:]
            state, res = step(state, T.Frame(*frame),
                              case["draws"][i][mesh.rank])
            assert not weights, (i, weights)  # one pinned birth a sensor
            whole = None
            if i in keep:
                whole = gather_state(state, mesh)
                whole = T.state_to_numpy(whole) if mesh.rank == 0 else None
            out.append((res.accepted, _metrics(res), whole,
                        _replicated(state), movers[0] if movers else (0, 0)))
    finally:
        _unpin_birth()
        restore()
    return out


def rebin_exchange(case, mesh):
    """``sweep_compact`` then ``rebin_exchange_compact`` on this rank's rows
    of ``case["particles"]`` (numpy planes ``[P]``), as the step calls them;
    returns the rank's rows of the result and its stats."""
    import torch
    import dspmap_tpu_torch as T
    from dspmap_tpu_torch.ops.compact import (rebin_exchange_compact,
                                              sweep_compact)
    from dspmap_tpu_torch.parallel.shard_step import shard_ctx

    cfg = case["cfg"]
    shard = shard_ctx(cfg, mesh, "cpu")
    rows = slice(mesh.rank * cfg.compact_capacity // mesh.size,
                 (mesh.rank + 1) * cfg.compact_capacity // mesh.size)
    p = T.Particles(**{k: torch.from_numpy(np.array(v[rows]))
                       for k, v in case["particles"].items()})
    noise = case["noise"]
    noise = None if noise is None else torch.from_numpy(noise[mesh.rank])
    p, sw = sweep_compact(p, cfg, case["dt"], case["origin"],
                          case["sensor_pos"], case["quat"], noise,
                          T.state.RuntimeParams.from_config(cfg))
    new, stats = rebin_exchange_compact(p, sw, cfg, shard)
    return ({k: getattr(new, k).numpy() for k in _PLANES},
            {k: int(v) for k, v in stats.items()})


def birth(case, mesh):
    """``particle_birth`` (pool) or ``particle_birth_compact`` on this
    rank's slab of ``case["particles"]`` with the rank's ``ShardCtx``, the
    estimator output, draws and ``norm_coeff`` the same on every rank;
    returns the rank's planes and the stats."""
    import torch
    import dspmap_tpu_torch as T
    from dspmap_tpu_torch.ops.birth import (particle_birth,
                                            particle_birth_compact)
    from dspmap_tpu_torch.parallel.shard_step import shard_ctx

    cfg = case["cfg"]
    shard = shard_ctx(cfg, mesh, "cpu")
    n, r = mesh.size, mesh.rank

    def cut(v):
        m = v.shape[-1] // n
        return torch.from_numpy(
            np.ascontiguousarray(v[..., r * m:(r + 1) * m]))

    p = T.Particles(**{k: cut(v) for k, v in case["particles"].items()})
    fn = (particle_birth_compact if cfg.layout == "compact"
          else particle_birth)
    t = {k: torch.from_numpy(v) for k, v in case["est"].items()}
    new, stats = fn(
        p, cfg, tuple(torch.from_numpy(d) for d in case["draws"]),
        est_points=t["points"], est_vel=t["vel"], est_dynamic=t["dynamic"],
        est_valid=t["valid"], norm_coeff=torch.tensor(case["norm_coeff"]),
        origin=case["origin"], update_time=case["update_time"],
        rt=T.state.RuntimeParams.from_config(cfg), shard=shard)
    return ({k: getattr(new, k).numpy() for k in _PLANES},
            {k: float(v) for k, v in stats.items()})


def ctx(case, mesh):
    """``ShardCtx`` on rank-marked tensors: ``gather_flat``, ``gather_ring``
    by both transports for each hop count, ``exchange`` of mixed columns,
    ``psum``, and ``ring_reachable`` over ``case["cells"]``."""
    import torch
    from dspmap_tpu_torch.ops.common import ShardCtx

    r, n = mesh.rank, mesh.size
    v_local = case["v_local"]
    x = torch.arange(6, dtype=torch.int32) + 100 * r
    ctxs = {t: ShardCtx(n_shards=n, rank=r, lo=r * v_local, group=mesh.group,
                        transport=t) for t in ("p2p", "all_gather")}
    c = ctxs["p2p"]
    f = torch.linspace(0, 1, 6) + r
    b = (torch.arange(6) % (r + 2)) == 0
    return dict(
        flat=c.gather_flat(x).numpy(),
        ring={(t, h): ctxs[t].gather_ring(x, h).numpy()
              for t in ctxs for h in (1, 2)},
        exchange=[y.numpy() for y in c.exchange([f, x, b])],
        exchange_ring=[y.numpy() for y in ctxs["all_gather"].exchange(
            [f, x, b], ring_hops=1)],
        psum=c.psum(torch.tensor([r, 1], dtype=torch.int64)).numpy(),
        reach={h: c.ring_reachable(torch.from_numpy(case["cells"]), v_local,
                                   h).numpy() for h in (1, 2)},
        owns=c.owns(torch.from_numpy(case["cells"]), v_local).numpy())


def layout(case, mesh):
    """``shard_state`` / ``gather_state`` round trip of ``case["init"]``,
    then ``make_sharded_step`` and ``make_shardmap_step`` over
    ``case["frames"]`` side by side, and ``make_sharded_step`` given a
    whole state; also ``make_draws`` with the rank's ``ShardCtx``."""
    import torch
    import dspmap_tpu_torch as T
    from dspmap_tpu_torch.parallel import (gather_state, make_sharded_step,
                                           make_shardmap_step, shard_state,
                                           state_shardings)
    from dspmap_tpu_torch.parallel.shard_step import shard_ctx

    cfg = case["cfg"]
    whole = T.state_from_numpy(case["init"], cfg, device="cpu")
    slab = shard_state(whole, mesh)
    back = T.state_to_numpy(gather_state(slab, mesh))
    shapes = {k: tuple(getattr(v, "shape", ()))
              for k, v in T.state_to_numpy(slab)["particles"].items()}
    pinned = make_sharded_step(cfg, mesh, device="cpu")
    plain = make_shardmap_step(cfg, mesh, device="cpu")
    a, b = slab, shard_state(whole, mesh)  # a generator each
    chain = []
    for frame in case["frames"]:
        a, out_a = pinned(a, T.Frame(*frame))
        b, out_b = plain(b, T.Frame(*frame))
        same = all(torch.equal(getattr(a.particles, k), getattr(b.particles, k))
                   for k in _PLANES) and torch.equal(a.weight_sum, b.weight_sum)
        chain.append((same, int(out_a.metrics["alive"]),
                      {k: tuple(x.shape) for k, x in
                       [("flags", a.particles.flags), ("weight_sum",
                                                       a.weight_sum),
                        ("future", a.future), ("vel_avg", a.vel_avg)]},
                      state_shardings(a)))
    try:
        pinned(whole, T.Frame(*case["frames"][0]))
        refused = None
    except ValueError as e:
        refused = str(e)
    shard = shard_ctx(cfg, mesh, "cpu")
    gen = torch.Generator()
    gen.manual_seed(5)
    d1 = T.make_draws(cfg, gen, "cpu", shard)
    gen.manual_seed(5)
    d2 = T.make_draws(cfg, gen, "cpu", shard)
    return dict(back=back, slab_shapes=shapes, chain=chain, refused=refused,
                draws=[x.numpy() for x in d1],
                draws_again=all(torch.equal(x, y) for x, y in zip(d1, d2)))


def _graph_safety_imports():
    """The CPU graph-safety tests' configurations, frames, setters and
    recording mode (they import no jax); the rank keeps its one thread."""
    import torch
    import test_torch_graph_safety as single
    import test_torch_graph_safety_multisensor as multi

    torch.set_num_threads(1)
    return single, multi


def _record_collectives(sink: list):
    """Wrap ``ShardCtx.psum``, ``_all_gather`` and ``gather_ring`` so that
    each call appends ``(name, shape, dtype)`` of its operand to ``sink``.
    Returns the function that puts them back."""
    from dspmap_tpu_torch.ops.common import ShardCtx

    saved = {k: getattr(ShardCtx, k) for k in ("psum", "_all_gather",
                                               "gather_ring")}

    def wrap(name, fn):
        def recorded(self, x, *args):
            sink.append((name, tuple(x.shape), str(x.dtype)) + args)
            return fn(self, x, *args)
        return recorded

    for k, fn in saved.items():
        setattr(ShardCtx, k, wrap(k, fn))
    return lambda: [setattr(ShardCtx, k, fn) for k, fn in saved.items()]


def _unaddressed(x):
    """``x`` (a recorded op: a nest of tuples and strings) with the
    addresses in object reprs taken out: a point-to-point op gets a new
    wrapper of the process group on each call."""
    import re

    if isinstance(x, str):
        return re.sub(r" at 0x[0-9a-f]+", "", x)
    if isinstance(x, (tuple, list)):
        return type(x)(_unaddressed(v) for v in x)
    return x


#: the state after :func:`graph_safety`'s first frame, by configuration,
#: exchange and whether it has one camera (a step makes new tensors, so the
#: cases can share it)
_WARM = {}


def graph_safety(case, mesh):
    """The sharded body (``make_body``, or ``make_multisensor_body`` for
    ``case["pattern"]``) on this rank's slab of ``case["name"]``'s
    configuration of ``test_torch_graph_safety.py`` with
    ``case["exchange"]``: one frame through the eager sharded step, then
    two frames that differ in pose, time step, point count and all six
    runtime parameters, each body under the recording dispatch mode with
    its collectives recorded.  Returns per frame the number of ops, the
    forbidden ops, the collectives, and the first ops where the two frames
    differ."""
    import dataclasses

    import torch
    import dspmap_tpu_torch as T
    from dspmap_tpu_torch import scalars
    from dspmap_tpu_torch.models import pipeline
    from dspmap_tpu_torch.parallel import make_shardmap_step, shard_state
    from dspmap_tpu_torch.parallel.shard_step import shard_ctx

    single, multi = _graph_safety_imports()
    cfg = dataclasses.replace(single.CONFIGS[case["name"]](),
                              mover_exchange=case["exchange"])
    pattern, n_sensors = case["pattern"], multi.N_SENSORS
    shard = shard_ctx(cfg, mesh, "cpu")
    f0, f1, f2 = single._frames(cfg)
    if pattern is None:
        frames = (f0, f1, f2)
        body = pipeline.make_body(cfg, True, shard)
    else:
        frames = (multi._two_cameras(f0), multi._two_cameras(f1, pattern),
                  multi._two_cameras(f2, pattern, fewer=23))
        body = pipeline.make_multisensor_body(cfg, n_sensors, pattern, shard)
    key = (case["name"], case["exchange"], pattern is None)
    if key not in _WARM:  # the patterns of two cameras share it
        sensors = None if pattern is None else n_sensors
        state = (T.init_state(cfg, seed=1, device="cpu") if sensors is None
                 else T.init_multisensor_state(cfg, sensors, seed=1,
                                               device="cpu"))
        warm = make_shardmap_step(cfg, mesh, device="cpu", n_sensors=sensors)
        state, out = warm(shard_state(state, mesh), frames[0])
        assert out.accepted
        _WARM[key] = state
    state = _WARM[key]
    gen = torch.Generator()
    gen.manual_seed(5)
    runs = []
    for k, frame in enumerate(frames[1:]):
        if k == 1:
            state = single._set_every_param(state)
        if pattern is None:
            pro = pipeline.prologue(state, frame, cfg)
            draws = T.make_draws(cfg, gen, "cpu", shard)
            f, i, points = scalars.stage(
                scalars.layout(cfg), *pro.blocks(cfg, state, frame.n_points),
                frame.points, "cpu")
            fs, points = scalars.FrameScalars(f[0], i[0]), points[0]
        else:
            pro = pipeline.multisensor_prologue(state, frame, cfg, n_sensors)
            assert pro.admitted == tuple(pattern)
            draws = T.make_multisensor_draws(cfg, n_sensors, gen, "cpu",
                                             shard)
            f, i, points = scalars.stage(scalars.layout(cfg, n_sensors),
                                         pro.f, pro.i, frame.points, "cpu")
            fs = scalars.FrameScalars(f, i)
        assert pro.accepted
        collectives = []
        restore = _record_collectives(collectives)
        try:
            with single._Record() as rec:
                out = body(state.particles, state.future, state.estimator,
                           fs, points, draws)
        finally:
            restore()
        state = pro.advance(state, particles=out.particles,
                            weight_sum=out.weight_sum, vel_avg=out.vel_avg,
                            future=out.future, estimator=out.estimator)
        runs.append((rec.ops, collectives, int(out.metrics["alive"]),
                     tuple(state.origin.tolist())))
    (ops1, c1, _, origin1), (ops2, c2, alive, origin2) = runs
    ops1, ops2 = ([_unaddressed(op) if op[0].startswith("c10d.") else op
                   for op in ops] for ops in (ops1, ops2))
    forbidden = case["forbidden"]
    differ = [k for k, (a, b) in enumerate(zip(ops1, ops2)) if a != b]
    return dict(n_ops=(len(ops1), len(ops2)),
                forbidden=[op[0] for ops in (ops1, ops2) for op in ops
                           if op[0].startswith(forbidden)][:5],
                differ=[(ops1[k], ops2[k]) for k in differ[:2]],
                collectives=(c1, c2), alive=alive,
                origin_moved=origin1 != origin2)


def shard_draws(case, mesh):
    """``make_draws`` (or ``make_multisensor_draws`` with
    ``case["n_sensors"]``) with this rank's ``ShardCtx``, drawn fresh and
    into given buffers from two equal generators: whether the numbers and
    the generators' advance are the same and the buffers the ones given,
    and a digest of the replicated and of the rank's own draws."""
    import hashlib

    import torch
    import dspmap_tpu_torch as T
    from dspmap_tpu_torch.models.pipeline import _map_draws, _particle_shape
    from dspmap_tpu_torch.parallel.shard_step import shard_ctx

    single, _ = _graph_safety_imports()
    cfg = single.CONFIGS[case["name"]]()
    shard = shard_ctx(cfg, mesh, "cpu")
    n = case.get("n_sensors")
    a, b = torch.Generator(), torch.Generator()
    a.manual_seed(11)
    b.manual_seed(11)

    def draw(gen, out=None):
        if n is None:
            return T.make_draws(cfg, gen, "cpu", shard, out=out)
        return T.make_multisensor_draws(cfg, n, gen, "cpu", shard, out=out)

    def flat(x):
        return ([] if x is None else [t for v in x for t in flat(v)]
                if isinstance(x, tuple) else [x])

    want = draw(a)
    given = _map_draws(lambda t: torch.full_like(t, -7.0), want)
    got = draw(b, given)
    w, g, o = flat(want), flat(got), flat(given)
    pool = _particle_shape(cfg, mesh.size)

    def digest(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.numpy().tobytes())
        return h.hexdigest()

    own = [t for t in w if tuple(t.shape[1:]) == pool]
    return dict(n=len(w), same=all(torch.equal(x, y) for x, y in zip(w, g)),
                buffers=len(g) == len(o) and all(x is y for x, y in zip(g, o)),
                gen_same=torch.equal(a.get_state(), b.get_state()),
                own_shapes=[tuple(t.shape) for t in own],
                replicated=digest([t for t in w if tuple(t.shape[1:]) != pool]),
                own=digest(own))


def graphed_refusals(case, mesh):
    """The graphed sharded constructors on this rank's gloo group: with a CUDA
    ``device`` (a ``torch.device``, no card needed) and with the CPU.
    Returns the messages they raise (``None`` where one builds)."""
    import torch
    from dspmap_tpu_torch.parallel import (make_graphed_sharded_step,
                                           make_graphed_shardmap_step)

    single, multi = _graph_safety_imports()
    cfg = single.CONFIGS["pool"]()
    said = {}
    for device in (torch.device("cuda", 0), "cpu"):
        for fn in (make_graphed_shardmap_step, make_graphed_sharded_step):
            for n_sensors in (None, multi.N_SENSORS):
                try:
                    fn(cfg, mesh, device=device, n_sensors=n_sensors)
                    said[fn.__name__, str(device), n_sensors] = None
                except ValueError as e:
                    said[fn.__name__, str(device), n_sensors] = str(e)
    return said


def weak(case, mesh):
    """``utils/shard_probe.py::weak_check`` in this rank on the CPU: the
    sharded step of ``case["cfg"]`` (a grown map) held on rank 0 to the
    same map on one device; returns the rank's record."""
    from dspmap_tpu_torch.utils import shard_probe

    return shard_probe.weak_check(case["cfg"], mesh, "cpu")


def _jobs(tmp: pathlib.Path, deadline: float):
    """The lists of cases :func:`post_jobs` writes, in turn, until the
    mark of :func:`wait_ranks` (written after the last job)."""
    k = 0
    while time.monotonic() < deadline:
        path = tmp / f"job{k}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                yield pickle.load(f)
            k += 1
        elif (tmp / "jobs.end").exists():
            return
        else:
            time.sleep(0.02)
    raise TimeoutError("no job and no end of the jobs")


def _main(tmp, rank, n):
    sys.modules["jax"] = None  # the ranks run the port alone
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # four ranks beside the test process
    from dspmap_tpu_torch.parallel import make_mesh

    tmp = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(n)
        out = [globals()[c["kind"]](c, mesh)
               for cases in _jobs(tmp, time.monotonic() + 600)
               for c in cases]
        with open(tmp / f"out{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
        assert not [m for m in sys.modules if m == "dspmap_tpu"
                    or m.startswith("dspmap_tpu.")]
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
