"""Tracing/profiling helpers on ``torch.profiler`` (the counterparts of
``dspmap_tpu/utils/profiling.py``; the reference's instrumentation is
clock() prints + a /map_update_time topic).

* :func:`timed_steps` -- wall time per frame, each ending on the device: the
  step returns before the card has finished, so the clock stops after
  :func:`force_sync` reads one element of the result back,
* :func:`trace` -- context manager around ``torch.profiler`` writing a
  gzipped Chrome trace (``chrome://tracing``, Perfetto),
* :func:`summarize_device_trace` -- device time of a captured trace by
  (launching op, kernel),
* the program's own tracing, off by default: :func:`tracing` turns it on
  for the process (before a graphed step's first frame, which captures
  its graph with the stage marks), :func:`span` times a block of host code,
  :func:`mark` ends a stage of the device body, and :func:`spans` reads
  and clears what was recorded.

A span records its name, the span around it, its frame (a frame starts
with each ``span("step", frame=True)``) and its start and end on
``time.perf_counter_ns()``; while ``torch.profiler`` records, it is also a
``record_function`` range ``dspmap.<name>`` in the exported Chrome trace,
on the clock of the card's kernels.  A mark is an external timing event
recorded into the CUDA graph being captured (each replay times the
stages on the card), a timing event on an eager CUDA stream, or a host
clock read on the CPU, where every op runs synchronously.  The marks of a
frame are read once the frame's last mark has completed, at the start of
the next frame (the child span ``step.marks``) or in :func:`spans`; a
frame whose marks have not completed then is counted as unmeasured and not
waited for, and so is a frame whose marks would be read while
``torch.profiler`` records.  With tracing off a span or a mark costs one
flag check, and a graph captured then holds no mark.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gzip
import json
import os
import shutil
import statistics
import time
from pathlib import Path
from typing import NamedTuple

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


# --- the program's own tracing -------------------------------------------

#: records the buffer keeps between two reads (:func:`spans`); the rest
#: are counted as dropped
CAPACITY = 1 << 17
#: the label of a frame's first mark, which ends no stage
START = "start"

_ON = False


class Span(NamedTuple):
    """A timed block of host code."""

    name: str
    parent: str | None  # the span it ran in
    frame: int
    start_ns: int
    end_ns: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Stages(NamedTuple):
    """A frame's device stages from its marks: ``marks`` is ``((stage,
    ms), ...)`` in the order the body ran them, each the time from the mark
    before (a stage run once a camera appears once a camera)."""

    frame: int
    marks: tuple

    @property
    def total_ms(self) -> float:
        """The time from the frame's first mark to its last."""
        return sum(ms for _, ms in self.marks)

    def ms(self) -> dict:
        """Milliseconds by stage, summed over the stage's runs."""
        out = {}
        for stage, ms in self.marks:
            out[stage] = out.get(stage, 0.0) + ms
        return out


class Records(NamedTuple):
    """What :func:`spans` returns."""

    spans: list  # [Span], in the order they ended
    stages: list  # [Stages], in frame order
    dropped: int  # records the buffer's cap dropped
    unmeasured: int  # frames whose marks had not completed when read


class _Tracer:
    def __init__(self):
        self.frame = 0
        self.records, self.dropped, self.unmeasured = [], 0, 0
        self.open, self.marks, self.pending = [], [], []

    def keep(self, record) -> None:
        if len(self.records) < CAPACITY:
            self.records.append(record)
        else:
            self.dropped += 1

    def mark(self, stage: str, device) -> None:
        if len(self.marks) >= CAPACITY:
            self.dropped += 1
        elif torch.device(device).type == "cuda":
            event = torch.cuda.Event(
                enable_timing=True,
                external=torch.cuda.is_current_stream_capturing())
            event.record()
            self.marks.append((stage, event))
        else:
            self.marks.append((stage, time.perf_counter_ns()))

    def settle(self) -> None:
        """Read every pending frame's marks whose last mark has completed;
        count the others unmeasured."""
        for frame, marks in self.pending:
            stamps = [m for _, m in marks]
            if isinstance(stamps[-1], int):
                ms = [(b - a) * 1e-6 for a, b in zip(stamps, stamps[1:])]
            elif stamps[-1].query():
                # some 5-9 µs of the host's time a pair on an H100
                ms = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
            else:
                self.unmeasured += 1
                continue
            self.keep(Stages(frame, tuple(
                (stage, t) for (stage, _), t in zip(marks[1:], ms))))
        self.pending = []


_tracer = _Tracer()


#: the span of a process that does not trace
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "frame", "parent", "scope", "start")

    def __init__(self, name: str, frame: bool):
        self.name, self.frame = name, frame

    def __enter__(self):
        t = _tracer
        if self.frame:
            t.frame += 1
        self.parent = t.open[-1] if t.open else None
        t.open.append(self.name)
        self.scope = None
        if torch.autograd._profiler_enabled():
            self.scope = torch.profiler.record_function(f"dspmap.{self.name}")
            self.scope.__enter__()
        self.start = time.perf_counter_ns()
        if self.frame and t.pending:
            if self.scope is None:
                # the last frame's marks, before this frame's launch
                # overwrites a graph's: the child span <name>.marks times
                # the reading
                with _Span(f"{self.name}.marks", False):
                    t.settle()
            else:
                # under torch.profiler, whose trace holds the card's
                # timeline, reading a frame's events takes about a
                # millisecond on an H100: the frames are left unmeasured
                t.unmeasured += len(t.pending)
                t.pending = []
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        t = _tracer
        t.open.pop()
        t.keep(Span(self.name, self.parent, t.frame, self.start, end))
        if self.frame and t.marks:  # an eager step's marks
            t.pending.append((t.frame, t.marks))
            t.marks = []
        return False


def tracing(on: bool = True) -> None:
    """Turn the program's tracing on or off for the process; what was
    recorded stays until :func:`spans` reads it.  A graphed step records
    its stage marks only if its graph was captured with tracing on: turn it
    on before the step's first frame."""
    global _ON
    _ON = bool(on)


def span(name: str, frame: bool = False):
    """``with span("step.load"):`` times the block while tracing is on.
    ``frame=True`` starts a new frame (the step's outermost span) and reads
    the marks of the frames before it, timed as its child
    ``<name>.marks``."""
    return _Span(name, frame) if _ON else _NULL


def mark(stage: str, device) -> None:
    """End ``stage`` of the device body on ``device`` while tracing is on
    (the label of the first mark of a frame, :data:`START`, ends none)."""
    if _ON:
        _tracer.mark(stage, device)


def take_marks() -> list:
    """The marks recorded since the last take (a graph's, taken after its
    capture), cleared."""
    marks, _tracer.marks = _tracer.marks, []
    return marks


def replayed(marks: list) -> None:
    """A graph holding ``marks`` was launched for the current frame: its
    marks are read at the start of the next frame's outermost span, before
    that frame's launch overwrites them, or by :func:`spans`."""
    if _ON and marks:
        _tracer.pending.append((_tracer.frame, marks))


def spans() -> Records:
    """The host spans and the frames' device stages recorded since the last
    read, read and then cleared."""
    t = _tracer
    t.settle()
    spans_, stages = [], []
    for r in t.records:
        (stages if isinstance(r, Stages) else spans_).append(r)
    out = Records(spans_, stages, t.dropped, t.unmeasured)
    t.records, t.dropped, t.unmeasured = [], 0, 0
    return out


def summarize(records: Records) -> dict:
    """Medians over the frames of ``records`` that captured no graph (no
    ``step.capture`` span): each span's ms a frame (``spans``), each
    stage's (``stages``) and the first mark to the last (``stages_total``),
    with the count of ``frames`` and of ``unmeasured`` ones."""
    capturing = {s.frame for s in records.spans if s.name == "step.capture"}
    by_span = collections.defaultdict(dict)
    for s in records.spans:
        if s.frame not in capturing:
            by_span[s.name][s.frame] = by_span[s.name].get(s.frame, 0.0) + s.ms
    by_stage = collections.defaultdict(list)
    totals = []
    for st in records.stages:
        if st.frame not in capturing:
            for stage, ms in st.ms().items():
                by_stage[stage].append(ms)
            totals.append(st.total_ms)
    median = statistics.median
    return {"spans": {k: median(v.values()) for k, v in by_span.items()},
            "stages": {k: median(v) for k, v in by_stage.items()},
            "stages_total": median(totals) if totals else None,
            "frames": len(totals), "unmeasured": records.unmeasured}
