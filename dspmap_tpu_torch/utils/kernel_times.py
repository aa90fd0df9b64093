"""Times of the pool pass (K1) and of a frame's relayout copies (K5) for the
checkout in the current directory, to set two versions of the kernels side
by side in one run on one card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 <path to this file> [label]

The package is taken from the current directory, not from where this file
lies, so the same file measures an older checkout too (``cd`` there first):
it uses only what every version of the port has had (``Particles``,
``ops.occupancy.pool_pass_cuda``, ``ops.relayout.to_flat_cuda`` /
``from_flat_cuda``) and the batched relayout where the checkout has it.
``chip_smoke.py`` takes its timers (:func:`median_ms`, :func:`device_ms`)
and its pool (:func:`populated_pool`) from here.

Prints the card's name and power limit, then one JSON line a measurement:

* ``K1`` at the flagship's, the static preset's and the multi-neighbor
  preset's pool (18 x 175,104, 50 x 75,776, 60 x 75,776;
  :func:`populated_pool`);
* ``K5_in``: a multi frame's seven planes (60 x 75,776; one i32, six f32)
  into flat working buffers -- one batched launch, or seven one-plane
  launches on a checkout without it -- beside seven ``clone()`` calls;
* ``K5_out``: one flat plane into a fresh plane, four distinct planes in
  turn, per plane, beside ``clone()``.

``ms`` is the median of 20 calls by CUDA events around the wrapper,
``device_ms`` the median of the kernels' own durations in one call from
``torch.profiler``'s device-side events; ``clone_ms`` and
``clone_device_ms`` are the same two for the ``clone()`` calls.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

#: substrings of the ``__global__`` names of K1 and K5 in any version
KERNEL_NAMES = ("occupancy", "copy16")
#: matches every kernel and copy the card ran
ANY_KERNEL = ("",)


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
    device event and one with 139 kernels for 20 calls of 7): a trace that
    does not hold the same whole number of such kernels for each call is
    reported on the standard error and taken again; the third such trace
    raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        own = sorted((e for e in device if any(k in e.name for k in names)),
                     key=lambda e: e.time_range.start)
        if own and len(own) % n == 0:
            break
        print(f"device_ms: trace {attempt + 1} holds {len(own)} kernel events "
              f"of {len(device)} device events for {n} calls",
              file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"{len(own)} kernel events in {n} calls, 3 traces")
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


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.ops import occupancy, relayout

    label = argv[0] if argv else os.path.basename(os.getcwd())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    device = torch.device("cuda", 0)

    def say(**kv):
        print(json.dumps({"label": label, "card": card, **kv}), flush=True)

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
