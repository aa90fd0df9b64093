"""The device trace of the profiled frames, reduced to what the per-layer
metrics read.

The benchmark profiles a stretch of steady frames with ``torch.profiler``
(host ops and the card's kernels and copies) and marks each frame, and
within it each call it makes, with a ``record_function`` range of its own:
``portbench.frame`` around a frame, ``portbench.step_call``,
``portbench.sync``, ``portbench.readout`` and ``portbench.host_copy``
inside it.  :func:`reduce` reads the exported Chrome trace: the wall span
from the first frame's start to the last frame's end, the device's busy
time within it (the union of its kernels, copies and sets), its events by
name, and the idle gaps between device events, each labelled by the
innermost mark the host was in at the gap's middle.
"""

from __future__ import annotations

import collections
import dataclasses
import json

#: trace event categories of the work the device ran
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
FRAME = "portbench.frame"
MARKS = ("portbench.step_call", "portbench.sync", "portbench.readout",
         "portbench.host_copy")


@dataclasses.dataclass
class Trace:
    frames: int
    window_s: float
    busy_s: float
    events: int  # device events in the span
    seconds_by_name: dict  # device seconds by event name
    count_by_name: dict  # device events by name
    gaps: list  # [(label, seconds)], longest first

    def seconds_matching(self, part: str) -> float:
        return sum(s for n, s in self.seconds_by_name.items() if part in n)

    def count_matching(self, part: str) -> int:
        return sum(c for n, c in self.count_by_name.items() if part in n)


def _union(spans):
    """Merged ``[start, end]`` intervals of sorted-by-start ``spans``."""
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(path: str) -> Trace:
    """Reduce the Chrome trace at ``path`` (times in microseconds)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == FRAME)
    if not frames:
        raise ValueError("the trace holds no marked frame")
    lo, hi = frames[0][0], frames[-1][1]
    marks = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("name") in MARKS)
    device = []
    seconds, counts = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if s + d < lo or s > hi:
            continue
        device.append((max(s, lo), min(s + d, hi)))
        seconds[e["name"]] += d * 1e-6
        counts[e["name"]] += 1
    busy = _union(sorted(device))
    gaps = []
    edges = [lo] + [x for b in busy for x in b] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        inside = [m for m in marks if m[0] <= mid <= m[1]]
        label = (min(inside, key=lambda m: m[1] - m[0])[2]
                 if inside else "between_frames")
        gaps.append((label.replace("portbench.", ""), (e - s) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Trace(frames=len(frames), window_s=(hi - lo) * 1e-6,
                 busy_s=sum(e - s for s, e in busy) * 1e-6,
                 events=len(device), seconds_by_name=dict(seconds),
                 count_by_name=dict(counts), gaps=gaps)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, ``[name, seconds]`` each."""
    ops = sorted(trace.seconds_by_name.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in trace.gaps[:top]]}
