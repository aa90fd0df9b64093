"""Where a frame's time goes on the card: the program's own stage marks and
host spans of each path's graphed step.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 -m dspmap_tpu_torch.utils.stage_times [flagship large_urban static multi noisy multisensor_2cam multisensor_compact]

For each named path (default: all seven, at full width, on the synthetic
street sequence, seed 0; ``multisensor_2cam`` and ``multisensor_compact``
run ``make_graphed_multisensor_step`` with two cameras that share each
frame's cloud and pose, on the flagship's and on large_urban's
configuration) it builds two graphed steps (``make_graphed_step``,
``make_graphed_multisensor_step``), one with the program's tracing off and
one with it on (``utils/profiling.py``), each on its own state over the
same frames, and prints one JSON line with

* ``frame_ms`` and ``traced_frame_ms``: median frame time of each step as
  users run it (host clock around a step that ends in one
  ``torch.cuda.synchronize()``), over two blocks of frames a step, the
  blocks of the two steps in turns;
* ``stage_ms``: median device milliseconds of each stage of the traced
  step's graph, from its stage marks (a stage run once a camera summed
  over the cameras), and ``stages_total_ms``, the median time from the
  graph's first mark to its last;
* ``span_ms``: median host milliseconds of each span of the traced step
  (``step`` and its children ``step.marks``, ``step.prologue``,
  ``step.draws``, ``step.load``, ``step.launch``, ``step.advance``) and of
  the readout (``readout``, ``get_occupancy_map`` run after each frame);
  ``traced_frames`` and ``unmeasured`` count the frames read and those
  whose marks were not;
* ``device_busy_ms``: the summed duration of every kernel and copy the card
  ran in one frame of the untraced step (``torch.profiler``, device-side
  events only), and ``device_idle_share = 1 - device_busy_ms / frame_ms``
  of that frame;
* ``kernels_per_frame``: how many kernels and copies that frame launched;
* ``own_kernels``: for each of the port's hand-written kernels that ran in
  that frame, ``[launches, summed device microseconds]``;
* ``copies``: how many copies of each kind (as the profiler names them:
  device to host, pageable or pinned host to device, device to device)
  that frame made;
* ``cluster_sweeps``: the sweeps the clustering kernel ran, over its runs,
  in the timed frames of both steps (its counter on the card;
  ``ops/cluster.py::sweeps_run``), ``None`` where the estimator is off.

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
                example_node_settings, get_occupancy_map,
                init_multisensor_state, init_state, large_urban,
                make_graphed_multisensor_step, make_graphed_step,
                stack_frames)
from ..ops import cluster
from . import profiling, sim

#: the cameras of the multi-sensor path
SENSORS = 2
WARMUP, TIMED = 5, 20
#: the ``__global__`` functions of ``csrc/*.cu``
OWN_KERNELS = ("occupancy_tile_kernel", "sweep_kernel", "pass1_kernel",
               "pass2_kernel", "segscan_warp_kernel", "segscan_tile_kernel",
               "copy16_kernel", "jv_warp_kernel", "jv_kernel",
               "cluster_bits_kernel", "cluster_propagate_kernel",
               "cluster_labels_kernel")


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


class _Run:
    """One graphed step on its own state, over the path's frames, each
    called with tracing ``traced`` (so its graph, captured at its first
    frame, holds the stage marks or not)."""

    def __init__(self, cfg, n_sensors, traced: bool):
        self.cfg = cfg
        if n_sensors is None:
            self.step = make_graphed_step(cfg)
            self.state = init_state(cfg, seed=0)
        else:
            self.step = make_graphed_multisensor_step(cfg, n_sensors)
            self.state = init_multisensor_state(cfg, n_sensors, seed=0)
        self.traced = traced

    def __call__(self, frame) -> float:
        profiling.tracing(self.traced)
        t0 = time.perf_counter()
        state, out = self.step(self.state, frame)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not out.accepted:
            raise RuntimeError("frame rejected")
        *_, self.state = get_occupancy_map(state, self.cfg)
        torch.cuda.synchronize()
        return ms


def measure(cfg, n_sensors=None) -> dict:
    """The measurements of the module docstring for one configuration;
    ``n_sensors`` cameras through the multi-sensor step, or ``None`` for
    the one-camera step."""
    frames = [Frame(*f) for f in sim.generate_sequence(
        WARMUP + 2 * TIMED + 2, cfg, seed=0)]
    if n_sensors is not None:
        frames = [stack_frames([f] * n_sensors) for f in frames]
    plain, traced = _Run(cfg, n_sensors, False), _Run(cfg, n_sensors, True)
    try:
        for frame in frames[:WARMUP]:
            plain(frame)
            traced(frame)
        profiling.spans()  # the warm-up's records, the capture's among them
        sweeps0, runs0 = cluster.sweeps_run("cuda")
        # the two steps' blocks in turns (plain, traced, plain, traced), so
        # that a drift of the host's speed during the run shows in both
        frame_ms, traced_ms = [], []
        for b in range(2):
            block = frames[WARMUP + b * TIMED:WARMUP + (b + 1) * TIMED]
            frame_ms += [plain(frame) for frame in block]
            traced_ms += [traced(frame) for frame in block]
        summary = profiling.summarize(profiling.spans())
        sweeps1, runs1 = cluster.sweeps_run("cuda")

        plain(frames[-2])
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            profiled_ms = plain(frames[-1])
    finally:
        profiling.tracing(False)
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in device) / 1e3
    copies = {}
    for e in device:
        if e.name.startswith("Memcpy"):
            copies[e.name] = copies.get(e.name, 0) + 1
    return dict(frame_ms=statistics.median(frame_ms),
                traced_frame_ms=statistics.median(traced_ms),
                stage_ms=summary["stages"],
                stages_total_ms=summary["stages_total"],
                span_ms=summary["spans"], traced_frames=summary["frames"],
                unmeasured=summary["unmeasured"],
                profiled_frame_ms=profiled_ms, device_busy_ms=busy_ms,
                kernels_per_frame=len(device), own_kernels=own_kernels(device),
                copies=copies,
                cluster_sweeps=((sweeps1 - sweeps0) / (runs1 - runs0)
                                if runs1 > runs0 else None),
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
