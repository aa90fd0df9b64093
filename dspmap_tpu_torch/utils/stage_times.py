"""Where a frame's time goes on the card: per-stage times of the step.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 -m dspmap_tpu_torch.utils.stage_times [flagship large_urban static multi]

For each named path (default: all four, at full width, on the synthetic
street sequence, seed 0) it prints one JSON line with

* ``frame_ms``: median frame time of the step as users run it (host clock
  around a step that ends in one ``torch.cuda.synchronize()``), over two
  blocks of 8 frames that alternate with the synced blocks below;
* ``stage_ms``: median time of each stage of ``models/pipeline.py`` with a
  synchronize before and after it, and ``synced_frame_ms``, the frame time
  of those frames;
* ``device_busy_ms``: the summed duration of every kernel and copy the card
  ran in one frame (``torch.profiler``, device-side events only), and
  ``device_idle_share = 1 - device_busy_ms / frame_ms`` of that frame;
* ``kernels_per_frame``: how many kernels and copies that frame launched;
* ``own_kernels``: for each of the port's hand-written kernels that ran in
  that frame, ``[launches, summed device microseconds]``;
* ``copies``: how many copies of each kind (as the profiler names them:
  device to host, pageable or pinned host to device, device to device)
  that frame made.

The first line is the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from .. import (Frame, dsp_dynamic, dsp_dynamic_multi_neighbors, dsp_static,
                example_node_settings, init_state, large_urban, make_step)
from ..models import pipeline
from . import sim

#: the stage functions as ``models/pipeline.py`` names them
STAGES = ("project_points", "estimate_velocities", "sweep", "sweep_compact",
          "flatten_pool", "rebin_and_register", "rebin_compact",
          "register_fov_compact", "measurement_update", "particle_birth",
          "particle_birth_compact", "occupancy_and_resample",
          "occupancy_compact")
WARMUP, TIMED = 5, 8
#: the ``__global__`` functions of ``csrc/*.cu``
OWN_KERNELS = ("occupancy_tile_kernel", "sweep_kernel", "pass1_kernel",
               "pass2_kernel", "segscan_warp_kernel", "segscan_tile_kernel",
               "copy16_kernel")


def configs() -> dict:
    return {
        "flagship": example_node_settings(dsp_dynamic()),
        "large_urban": large_urban(),
        "static": example_node_settings(dsp_static()),
        "multi": example_node_settings(dsp_dynamic_multi_neighbors()),
    }


def _timed(fn, sink: list):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def measure(cfg) -> dict:
    """The measurements of the module docstring for one configuration."""
    step = make_step(cfg)
    frames = [Frame(*f) for f in sim.generate_sequence(
        WARMUP + 4 * TIMED + 2, cfg, seed=0)]
    state = init_state(cfg, seed=0)

    def run(frame):
        nonlocal state
        t0 = time.perf_counter()
        state, out = step(state, frame)
        torch.cuda.synchronize()
        if not out.accepted:
            raise RuntimeError("frame rejected")
        return (time.perf_counter() - t0) * 1e3

    # plain and synced blocks in turns (plain, synced, plain, synced), so
    # that a drift of the host's speed during the run shows in both
    it = iter(frames)
    for _ in range(WARMUP):
        run(next(it))
    sinks = {name: [] for name in STAGES}
    originals = {name: getattr(pipeline, name) for name in STAGES}
    frame_blocks, synced_blocks = [], []
    for _ in range(2):
        frame_blocks.append([run(next(it)) for _ in range(TIMED)])
        try:
            for name, sink in sinks.items():
                setattr(pipeline, name, _timed(originals[name], sink))
            synced_blocks.append([run(next(it)) for _ in range(TIMED)])
        finally:
            for name, fn in originals.items():
                setattr(pipeline, name, fn)
    frame_ms = frame_blocks[0] + frame_blocks[1]
    synced_ms = synced_blocks[0] + synced_blocks[1]
    stage_ms = {name: statistics.median(sink)
                for name, sink in sinks.items() if sink}

    run(next(it))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiled_ms = run(next(it))
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in device) / 1e3
    own, copies = {}, {}
    for e in device:
        if e.name.startswith("Memcpy"):
            copies[e.name] = copies.get(e.name, 0) + 1
        name = next((k for k in OWN_KERNELS if k in e.name), None)
        if name:
            n, us = own.get(name, (0, 0.0))
            own[name] = (n + 1, us + e.device_time_total)
    return dict(frame_ms=statistics.median(frame_ms),
                frame_ms_min=min(frame_ms), frame_ms_max=max(frame_ms),
                frame_ms_by_block=[statistics.median(b) for b in frame_blocks],
                synced_frame_ms=statistics.median(synced_ms),
                synced_frame_ms_by_block=[statistics.median(b)
                                          for b in synced_blocks],
                stage_ms=stage_ms, profiled_frame_ms=profiled_ms,
                device_busy_ms=busy_ms, kernels_per_frame=len(device),
                own_kernels=own, copies=copies,
                device_idle_share=(1.0 - busy_ms / profiled_ms
                                   if device else None))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("stage_times: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    all_configs = configs()
    for name in argv or list(all_configs):
        print(json.dumps({"path": name, **measure(all_configs[name])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
