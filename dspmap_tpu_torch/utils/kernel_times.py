"""Times of the pool pass (K1), the pair passes (K3a, K3b), the segmented
scans (K4), a frame's relayout copies (K5) and the JV solve for the
checkout in the current directory, to set two versions of the kernels side
by side in one run on one card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 <path to this file> [label]

The package is taken from the current directory, not from where this file
lies, so the same file measures an older checkout too (``cd`` there first):
it uses only what every version of the port has had (``Particles``,
``ops.occupancy.pool_pass_cuda``, ``ops.update.update_pass1`` /
``update_pass2`` / ``prescale_pairs``, ``ops.compact.seg_scans_cuda``,
``ops.relayout.to_flat_cuda`` / ``from_flat_cuda``,
``ops.assignment.jv_solve_cuda``) and the batched relayout where the
checkout has it.  ``chip_smoke.py`` takes its timers (:func:`median_ms`,
:func:`device_ms`), its pool (:func:`populated_pool`), its K3 and K4
operands (:func:`pair_operands`, :func:`segscan_case`) and its JV costs
(:func:`jv_case`, :func:`jv_timed_cases`) from here.

Prints the card's name and power limit, then one JSON line a measurement:

* ``K1`` at the flagship's, the static preset's and the multi-neighbor
  preset's pool (18 x 175,104, 50 x 75,776, 60 x 75,776;
  :func:`populated_pool`);
* ``K3a`` and ``K3b`` at the three paths' shapes ``(rows, S_t, CK)``, called
  as the step calls them, with the operands scaled once for both passes,
  and ``bits``, a SHA-256 of the output's bytes (two checkouts whose pass
  gives the same bits print the same digest);
* ``K4`` at large_urban's 131,072 rows for the four calls of a compact
  frame, each with the column types the step passes (a checkout whose
  wrapper casts and stacks the columns first pays for that in ``ms``, as
  its frames did);
* ``K5_in``: a multi frame's seven planes (60 x 75,776; one i32, six f32)
  into flat working buffers -- one batched launch, or seven one-plane
  launches on a checkout without it -- beside seven ``clone()`` calls;
* ``K5_out``: one flat plane into a fresh plane, four distinct planes in
  turn, per plane, beside ``clone()``.
* ``jv_solve`` at the flagship's N = max_clusters = 16, every row
  augmented, on :func:`jv_timed_cases`' two costs, and ``no_rows``, the
  tie-heavy one with none augmented (the launch's floor): ``path_steps``
  (as :func:`jv_numpy` counts them), ``ns_per_path_step`` (``device_ms``
  over them) and ``bits``, a SHA-256 of ``p``.

``ms`` is the median of 20 calls by CUDA events around the wrapper,
``device_ms`` the median of the kernels' own durations in one call from
``torch.profiler``'s device-side events; ``clone_ms`` and
``clone_device_ms`` are the same two for the ``clone()`` calls.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

#: substrings of the ``__global__`` names of K1 and K5 in any version
KERNEL_NAMES = ("occupancy", "copy16")
#: the same for K3a, K3b, K4 and the JV solve
PASS1_NAMES, PASS2_NAMES, SEGSCAN_NAMES = ("pass1",), ("pass2",), ("segscan",)
JV_NAMES = ("jv_",)

#: (rows, S_t, CK) of the pair passes on the flagship and large_urban, the
#: static and the multi-neighbor paths
PAIR_SHAPES = {"flagship": (448, 64, 288), "static": (504, 32, 288),
               "multi": (4536, 16, 400)}
#: (n_tot, max_run, column types) of the compact step's four seg_scans
#: calls at large_urban (S = 10): occupancy_compact's two (reach 32), then
#: segment_table's in birth and in rebin (reach 16)
SEGSCAN_CALLS = (
    (2, 20, ("bool", "f32", "bool", "f32", "f32", "f32", "f32")),
    (2, 20, ("bool", "i32")),
    (0, 10, ("f32", "f32", "f32", "bool")),
    (0, 10, ("bool",)),
)
#: matches every kernel and copy the card ran
ANY_KERNEL = ("",)
#: the ``record_function`` range around :func:`device_ms`'s timed calls
_TIMED = "kernel_times.timed_calls"
#: traces :func:`device_ms` takes before it gives up on a call
DEVICE_MS_TRACES = 12


class ProfilerLostEvents(RuntimeError):
    """:func:`device_ms` found no whole number of kernels a call in any of
    its traces."""


def median_ms(fn, n: int = 20) -> float:
    """Median over ``n`` calls of ``fn`` of the time between two CUDA events
    around the call."""
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


def device_ms(fn, n: int = 20, names=KERNEL_NAMES) -> float:
    """Median over ``n`` calls of ``fn`` of the time the card spent, during
    one call, in kernels whose name holds one of ``names``
    (``torch.profiler``, device-side events).  The profiler now and then
    loses events (on an H100, of some 400 traces one came back without any
    device event and one with 139 kernels for 20 calls of 7; once three
    traces in a row lost some, and ten in a row one of 20 JV launches, each
    the only device work of its call): a trace that does not hold the same
    whole number of such kernels for each call is reported on the standard
    error and taken again, up to :data:`DEVICE_MS_TRACES` traces in all.
    Each trace opens with one small fill on the card before the timed
    calls, which run inside a ``record_function`` range; device events that
    start before that range (the fill) are dropped."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    primer = torch.zeros(1, device="cuda")
    for attempt in range(DEVICE_MS_TRACES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            primer.zero_()
            torch.cuda.synchronize()
            with record_function(_TIMED):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        start = next(e for e in events if e.name == _TIMED
                     and e.device_type == torch.autograd.DeviceType.CPU
                     ).time_range.start
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name != _TIMED and e.time_range.start >= start]
        own = sorted((e for e in device if any(k in e.name for k in names)),
                     key=lambda e: e.time_range.start)
        if own and len(own) % n == 0:
            break
        print(f"device_ms: trace {attempt + 1} holds {len(own)} kernel events "
              f"of {len(device)} device events for {n} calls",
              file=sys.stderr, flush=True)
    else:
        raise ProfilerLostEvents(f"{len(own)} kernel events in {n} calls, "
                                 f"{DEVICE_MS_TRACES} traces")
    k = len(own) // n
    return statistics.median(
        sum(e.device_time_total for e in own[i * k:(i + 1) * k]) / 1e3
        for i in range(n))


def populated_pool(cfg, rng, device):
    """A populated [S, V] pool, built like tests/test_pallas.py builds its
    occupancy pool: random voxels holding 1..S slots of valid/newborn
    particles with uniform weights, 30% of them moving in x or y (none
    under the static model)."""
    import numpy as np
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
    mv = valid & (rng.random((S, V)) < 0.3) & (cfg.motion_model != "static")
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


def pair_operands(rows, st, ck, sigma, rng, device):
    """``(pos, pts, w, cinv)`` of the pair passes: particles and points a
    metre around a centre a few metres out, each of the first ``S_t``
    points within a few sigma of a particle so that g is not all 0."""
    import numpy as np
    import torch

    centre = np.asarray([4.0, 0.5, 1.0], np.float32)
    pos = (centre + rng.normal(0, 1.0, (rows, st, 3))).astype(np.float32)
    pts = (centre + rng.normal(0, 1.0, (rows, ck, 3))).astype(np.float32)
    k = min(st, ck)
    pts[:, :k] = pos[:, :k] + rng.normal(
        0, 2 * sigma, (rows, k, 3)).astype(np.float32)
    w = (rng.random((rows, st)) * (rng.random((rows, st)) > 0.3))
    cinv = (rng.random((rows, ck)) * (rng.random((rows, ck)) > 0.5))
    return tuple(torch.from_numpy(x.astype(np.float32)).to(device)
                 for x in (pos, pts, w, cinv))


def segscan_case(P, types, max_run, device, seed=0):
    """``(cols, is_start, is_end, live)`` of one seg_scans call at ``P``
    rows: sorted runs of 1..max_run rows, six rows of one run repeated
    further on, a dead tail of a fifth of the rows, some -0.0 values; one
    column a type name in ``types`` (``f32``, ``bool`` or ``i32``)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + len(types) * 100 + max_run)
    key = np.repeat(np.arange(P), rng.integers(1, max_run + 1, P))[:P]
    if P > 5006:
        key[5000:5006] = key[11]
    key[-(P // 5):] = 1 << 30
    ne = key[1:] != key[:-1]
    is_start = np.concatenate([[True], ne])
    is_end = np.concatenate([ne, [True]]) & (key < 1 << 30)
    cols = []
    for name in types:
        if name == "bool":
            col = rng.random(P) < 0.6
        elif name == "i32":
            col = rng.integers(0, 9, P).astype(np.int32)
        else:
            col = rng.uniform(0, 1, P).astype(np.float32)
            col[::101] = -0.0
        cols.append(torch.from_numpy(col).to(device))
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return cols, t(is_start), t(is_end), t(key < 1 << 30)


#: the estimator's cost of an ungated pair at the default gate (1.5 m)
JV_GATED_OUT = 1.5 * 5000.0


def jv_case(N, rng):
    """A tie-heavy square cost ``[N, N]`` (numpy float32) for the JV solve:
    integers in {0, 1, 2, 3} on a third of the pairs and the estimator's
    cost of an ungated pair on the rest, so equal minima meet on most
    path steps."""
    import numpy as np

    small = rng.integers(0, 4, (N, N)).astype(np.float32)
    return np.where(rng.random((N, N)) < 1 / 3, small,
                    np.float32(JV_GATED_OUT)).astype(np.float32)


def jv_worst_chain(N):
    """The all-equal square cost ``[N, N]`` (numpy float32): row ``i``'s
    path visits each of the ``i - 1`` matched columns before the free one,
    so the solve walks the most path steps, ``N (N + 1) / 2``."""
    import numpy as np

    return np.full((N, N), JV_GATED_OUT, np.float32)


#: the seed of ``chip_smoke.py``'s tie-heavy JV instances at the flagship's
#: N and how many it checks before the one it times
JV_SEED, JV_INSTANCES = 16, 500


def jv_timed_cases(N):
    """The JV solve's two timed costs at ``N``: ``tie_heavy``, the
    :func:`jv_case` drawn after :data:`JV_INSTANCES` others from a
    generator of seed :data:`JV_SEED` (the one ``chip_smoke.py`` times
    after checking those), and ``worst_chain`` (:func:`jv_worst_chain`)."""
    import numpy as np

    rng = np.random.default_rng(JV_SEED)
    for _ in range(JV_INSTANCES):
        jv_case(N, rng)
    return {"tie_heavy": jv_case(N, rng), "worst_chain": jv_worst_chain(N)}


def jv_numpy(a, n_rows, R):
    """The JV solve of ``ops/assignment.py`` in numpy float32, its loops
    ending where the ``while_loop``s end: ``(p [N+1], path steps, unwind
    steps)``.  The steps are the work the kernel does for this cost,
    which ``chip_smoke.py`` counts into the kernel's bound."""
    import numpy as np

    N = a.shape[0]
    inf = np.float32(1.0e12)
    u = np.zeros(N + 1, np.float32)
    v = np.zeros(N + 1, np.float32)
    p = np.zeros(N + 1, np.int64)
    n_path = n_unwind = 0
    for i in range(1, min(int(n_rows), R) + 1):
        p[0] = i
        m_abs = np.full(N, inf, np.float32)
        way = np.zeros(N + 1, np.int64)
        used = np.zeros(N + 1, bool)
        d_use = np.zeros(N + 1, np.float32)
        j0, d_now = 0, np.float32(0.0)
        for _ in range(i):
            used[j0], d_use[j0] = True, d_now
            i0 = p[j0]
            cand = ((a[i0 - 1] - u[i0]) - v[1:]) + d_now
            better = ~used[1:] & (cand < m_abs)
            m_abs = np.where(better, cand, m_abs)
            way[1:] = np.where(better, j0, way[1:])
            masked = np.where(used[1:], inf, m_abs)
            j0 = int(np.argmin(masked)) + 1
            d_now = masked[j0 - 1]
            n_path += 1
            if p[j0] == 0:
                break
        amt = d_now - d_use[used]
        u[p[used]] += amt
        v[used] -= amt
        for _ in range(i):
            if j0 == 0:
                break
            p[j0], j0 = p[way[j0]], way[j0]
            n_unwind += 1
    return p, n_path, n_unwind


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.ops import (assignment, compact, occupancy,
                                      relayout, update)

    label = argv[0] if argv else os.path.basename(os.getcwd())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    device = torch.device("cuda", 0)

    def say(**kv):
        print(json.dumps({"label": label, "card": card, **kv}), flush=True)

    N = dm.example_node_settings(dm.dsp_dynamic()).max_clusters
    cases = jv_timed_cases(N)
    # and the launch's floor: the tie-heavy cost with no row to augment, as
    # the estimator hands it on a frame with no cluster to match
    for case, a_np, rows in (*((k, a, N) for k, a in cases.items()),
                             ("no_rows", cases["tie_heavy"], 0)):
        a = torch.from_numpy(a_np).to(device)
        n_rows = torch.tensor(rows, dtype=torch.int64, device=device)
        run = lambda: assignment.jv_solve_cuda(a, n_rows, N)  # noqa: E731
        steps = jv_numpy(a_np, rows, N)[1]
        d_ms = device_ms(run, names=JV_NAMES)
        say(kernel="jv_solve", case=case, N=N, n_rows=rows, path_steps=steps,
            ms=median_ms(run), device_ms=d_ms,
            ns_per_path_step=d_ms * 1e6 / steps if steps else None,
            bits=hashlib.sha256(run().cpu().numpy().tobytes()).hexdigest())

    configs = {
        "flagship": dm.example_node_settings(dm.dsp_dynamic()),
        "static": dm.example_node_settings(dm.dsp_static()),
        "multi": dm.example_node_settings(dm.dsp_dynamic_multi_neighbors()),
    }
    for name, cfg in configs.items():
        pool = populated_pool(cfg, np.random.default_rng(0), device)
        run = lambda: occupancy.pool_pass_cuda(pool, cfg, False)  # noqa: E731
        say(kernel="K1", path=name, S=cfg.slots_per_voxel,
            V=cfg.storage_voxels, ms=median_ms(run), device_ms=device_ms(run))
        del pool

    for name, (rows, st, ck) in PAIR_SHAPES.items():
        sigma = float(np.float32(configs[name].sigma_ob))
        pos, pts, w, cinv = pair_operands(rows, st, ck, sigma,
                                          np.random.default_rng(0), device)
        scaled = update.prescale_pairs(pos, pts, sigma)
        for kernel, fn, vec, names in (
                ("K3a", update.update_pass1, w, PASS1_NAMES),
                ("K3b", update.update_pass2, cinv, PASS2_NAMES)):
            run = lambda: fn(pos, vec, pts, sigma, scaled)  # noqa: E731
            bits = hashlib.sha256(run().cpu().numpy().tobytes()).hexdigest()
            say(kernel=kernel, path=name, rows=rows, S_t=st, CK=ck,
                ms=median_ms(run), device_ms=device_ms(run, names=names),
                bits=bits)

    P = dm.large_urban().compact_capacity
    for n_tot, max_run, types in SEGSCAN_CALLS:
        cols, st, en, _ = segscan_case(P, types, max_run, device)
        run = lambda: compact.seg_scans_cuda(cols, st, en, max_run, n_tot)  # noqa: E731
        say(kernel="K4", P=P, columns=len(types), n_tot=n_tot,
            max_run=max_run, types=",".join(types), ms=median_ms(run),
            device_ms=device_ms(run, names=SEGSCAN_NAMES))

    cfg = configs["multi"]
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    rng = np.random.default_rng(5)
    planes = [torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, (S, V)).astype(np.int32)).to(device).view(dtype)
        for dtype in [torch.int32] + [torch.float32] * 6]
    batched = hasattr(relayout, "to_flat_many_cuda")
    if batched:
        copy_in = lambda: relayout.to_flat_many_cuda(planes)  # noqa: E731
    else:
        copy_in = lambda: [relayout.to_flat_cuda(x) for x in planes]  # noqa: E731
    clones = lambda xs: (lambda: [x.clone() for x in xs])  # noqa: E731
    say(kernel="K5_in", planes=len(planes), launches=1 if batched else 7,
        ms=median_ms(copy_in), device_ms=device_ms(copy_in),
        clone_ms=median_ms(clones(planes)),
        clone_device_ms=device_ms(clones(planes), names=ANY_KERNEL))
    flats = [relayout.to_flat_cuda(x) for x in planes[1:5]]
    copy_out = lambda: [relayout.from_flat_cuda(f, S, V) for f in flats]  # noqa: E731
    n = len(flats)
    say(kernel="K5_out", planes=1, launches=1, ms=median_ms(copy_out) / n,
        device_ms=device_ms(copy_out) / n,
        clone_ms=median_ms(clones(flats)) / n,
        clone_device_ms=device_ms(clones(flats), names=ANY_KERNEL) / n)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
