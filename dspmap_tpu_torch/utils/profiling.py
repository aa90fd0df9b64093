"""Tracing/profiling helpers on ``torch.profiler`` (the counterparts of
``dspmap_tpu/utils/profiling.py``; the reference's instrumentation is
clock() prints + a /map_update_time topic).

* :func:`timed_steps` -- wall time per frame, each ending on the device: the
  step returns before the card has finished, so the clock stops after
  :func:`force_sync` reads one element of the result back,
* :func:`trace` -- context manager around ``torch.profiler`` writing a
  gzipped Chrome trace (``chrome://tracing``, Perfetto),
* :func:`summarize_device_trace` -- device time of a captured trace by
  (launching op, kernel).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gzip
import json
import os
import shutil
import time
from pathlib import Path

import torch

#: trace event categories of the work the device ran
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_SUFFIX = ".pt.trace.json.gz"


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        items = tree.values()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = (getattr(tree, f.name) for f in dataclasses.fields(tree))
    elif isinstance(tree, (tuple, list)):
        items = tree
    else:
        return None
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def force_sync(tree) -> float:
    """Genuinely wait for device results: read back one element of the
    first tensor of ``tree`` (a tensor, or a tuple, list, dict or dataclass
    holding tensors)."""
    leaf = _first_tensor(tree)
    if leaf is None:
        raise TypeError(f"no tensor in {type(tree).__name__}")
    return float(leaf.reshape(-1)[0])


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: host ops, and the card's kernels and copies where
    there is a card.  Writes ``<log_dir>/<time in ns>.pt.trace.json.gz``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    plain = out / f"{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(plain))
    with open(plain, "rb") as src, gzip.open(f"{plain}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(plain)


def timed_steps(step, state, frames, sync_every: int = 1):
    """Run ``step`` over ``frames`` returning (state, wall_seconds_per_frame).

    ``sync_every=1`` gives per-frame latency; larger values amortize the
    sync cost for throughput measurements.
    """
    walls = []
    t0 = time.perf_counter()
    for i, frame in enumerate(frames):
        state, out = step(state, frame)
        if (i + 1) % sync_every == 0:
            force_sync(out.weight_sum)
            walls.append((time.perf_counter() - t0) / sync_every)
            t0 = time.perf_counter()
    return state, walls


def summarize_device_trace(log_dir: str, top: int = 25):
    """Aggregate device time by (launching op, kernel or copy name) from the
    newest trace under ``log_dir``.  Returns a sorted list of ``(ms, op,
    kernel)``, longest first, at most ``top`` of them.

    A device event names the host call that enqueued it by its correlation
    id; that CUDA API call holds the external id of the innermost profiled
    op around it, the role the source line plays in the JAX package's
    summary.  A device event without such an op counts under
    ``"?"``: the port's own kernels, launched through ``ctypes`` outside
    any op, are known by their kernel names."""
    files = sorted(Path(log_dir).glob(f"*{TRACE_SUFFIX}"),
                   key=lambda p: (p.stat().st_mtime_ns, p.name))
    if not files:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with gzip.open(files[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    complete = [e for e in events if e.get("ph") == "X"]
    ops = {e["args"]["External id"]: e["name"] for e in complete
           if e.get("cat") in ("cpu_op", "user_annotation")
           and "External id" in e.get("args", {})}
    calls = {e["args"]["correlation"]: e["args"].get("External id")
             for e in complete
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    agg = collections.Counter()
    for e in complete:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        args = e.get("args", {})
        ext = calls.get(args.get("correlation"))
        op = ops.get(ext if ext is not None else args.get("External id"), "?")
        agg[(op, e["name"])] += float(e.get("dur", 0.0)) / 1e3
    return sorted(((ms, op, name) for (op, name), ms in agg.items()),
                  reverse=True)[:top]
