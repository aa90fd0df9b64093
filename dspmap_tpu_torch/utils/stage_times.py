"""Where a frame's time goes on the card: per-stage times of the step.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 -m dspmap_tpu_torch.utils.stage_times [flagship large_urban static multi noisy multisensor_2cam multisensor_compact]

For each named path (default: all seven, at full width, on the synthetic
street sequence, seed 0; ``multisensor_2cam`` and ``multisensor_compact``
run ``make_multisensor_step`` with two cameras that share each frame's
cloud and pose, as ``bench.py``'s two-camera cell does, on the flagship's
and on large_urban's configuration) it prints one JSON line with

* ``frame_ms``: median frame time of the step as users run it (host clock
  around a step that ends in one ``torch.cuda.synchronize()``), over two
  blocks of 8 frames that alternate with the synced blocks below;
* ``stage_ms``: median time of each stage of ``models/pipeline.py`` with a
  synchronize before and after it (a stage that runs once a sensor also
  under ``name[i]`` for sensor i), and ``synced_frame_ms``, the frame time
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
                example_node_settings, init_multisensor_state, init_state,
                large_urban, make_multisensor_step, make_step, stack_frames)
from ..models import pipeline
from . import sim

#: the stage functions as ``models/pipeline.py`` names them
STAGES = ("project_points", "estimate_velocities", "sweep", "sweep_compact",
          "flatten_pool", "rebin_and_register", "propagate", "rebin",
          "register_fov", "rebin_compact", "fov_geometry_compact",
          "register_fov_compact", "measurement_update", "particle_birth",
          "particle_birth_compact", "occupancy_and_resample",
          "occupancy_compact")
#: the cameras of the multi-sensor path
SENSORS = 2
WARMUP, TIMED = 5, 8
#: the ``__global__`` functions of ``csrc/*.cu``
OWN_KERNELS = ("occupancy_tile_kernel", "sweep_kernel", "pass1_kernel",
               "pass2_kernel", "segscan_warp_kernel", "segscan_tile_kernel",
               "copy16_kernel", "jv_warp_kernel", "jv_kernel")


def own_kernels(device_events) -> dict:
    """``{name in OWN_KERNELS: (launches, device µs)}`` over the profiler's
    device events ``device_events``."""
    own = {}
    for e in device_events:
        name = next((k for k in OWN_KERNELS if k in e.name), None)
        if name:
            n, us = own.get(name, (0, 0.0))
            own[name] = (n + 1, us + e.device_time_total)
    return own


def configs() -> dict:
    return {
        "flagship": example_node_settings(dsp_dynamic()),
        "large_urban": large_urban(),
        "static": example_node_settings(dsp_static()),
        "multi": example_node_settings(dsp_dynamic_multi_neighbors()),
        "noisy": example_node_settings(
            dsp_dynamic(limit_motion_to_xy_plane=False)),
        "multisensor_2cam": example_node_settings(dsp_dynamic()),
        "multisensor_compact": large_urban(),
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


def measure(cfg, n_sensors=None) -> dict:
    """The measurements of the module docstring for one configuration;
    ``n_sensors`` cameras through the multi-sensor step, or ``None`` for
    ``make_step``."""
    frames = [Frame(*f) for f in sim.generate_sequence(
        WARMUP + 4 * TIMED + 2, cfg, seed=0)]
    if n_sensors is None:
        step = make_step(cfg)
        state = init_state(cfg, seed=0)
    else:
        step = make_multisensor_step(cfg, n_sensors)
        state = init_multisensor_state(cfg, n_sensors, seed=0)
        frames = [stack_frames([f] * n_sensors) for f in frames]

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
    stage_ms = {}
    for name, sink in sinks.items():
        if not sink:
            continue
        stage_ms[name] = statistics.median(sink)
        per_frame = len(sink) // len(synced_ms)
        for i in range(per_frame if per_frame > 1 else 0):
            stage_ms[f"{name}[{i}]"] = statistics.median(sink[i::per_frame])

    run(next(it))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiled_ms = run(next(it))
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in device) / 1e3
    copies = {}
    for e in device:
        if e.name.startswith("Memcpy"):
            copies[e.name] = copies.get(e.name, 0) + 1
    own = own_kernels(device)
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
        n_sensors = SENSORS if name.startswith("multisensor") else None
        print(json.dumps({"path": name,
                          **measure(all_configs[name], n_sensors)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
