"""One run of one cell: set-up, the measured window, the profiled frames of
a traced run, and the comparison that decides ``correct``.

The window drives the per-frame sequence that ``io/replay.py::replay``
runs: the graphed step, a wait for its ``weight_sum``, the occupancy
readout, and the occupied mask copied to the host.  The loop is closed:
the next frame goes in once the last frame's mask is on the host, as a
planner waits for its map.  Frames are rendered in set-up from the seed;
the step draws its random numbers from the state's generator, except on
the frames that are compared, which take draws the benchmark makes from
the seed (the step's ``draws`` argument) so that the reference can be
handed the same.

Which frames are compared is drawn from the seed: frame 0, from both
sides' own fresh states (the start), and ``compare_frames`` frames of the
window at times drawn uniformly over it.  Around a compared frame the
state before it and after it and its readout are copied to the host, off
the frame's clock.  Once the window has closed and the peak memory has
been read, the program is freed and the reference computes each compared
frame from the program's state before it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import devtrace, judge
from .traffic import generator

FORBIDDEN = ("jax", "jaxlib", "flax", "dspmap_tpu")
GIB = float(1 << 30)


def derived_seed(seed: int, *tags) -> int:
    """A 63-bit seed from the run's seed and ``tags``."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@contextlib.contextmanager
def mark(name: str, on: bool):
    if on:
        with torch.profiler.record_function(f"portbench.{name}"):
            yield
    else:
        yield


@dataclasses.dataclass
class Compared:
    index: int
    frame: tuple  # the rendered frame
    draws: object  # on the card until the window has closed
    before: object  # state tree, None for frame 0 (each side's own start)
    after: object = None
    readout: dict = None


@dataclasses.dataclass
class Run:
    """What a run measured, for the metrics' readers."""

    cell: dict
    config_file: dict
    cameras: int
    spec: object
    frame_ms: list = dataclasses.field(default_factory=list)
    host_ms: list = dataclasses.field(default_factory=list)
    readout_ms: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    capture_ms: dict = dataclasses.field(default_factory=dict)
    pool_bytes: dict = dataclasses.field(default_factory=dict)
    trace: object = None

    def roofline(self, kernel: str):
        return self.spec.module("roofline", kernel)


class Cell:
    """Set-up and frames of one cell on ``device``; ``wrap_step`` (tests
    only) wraps the program's step."""

    def __init__(self, spec, name: str, seed: int, device, wrap_step=None):
        from . import program  # the program under test: after the card check

        self.program = program
        self.spec, self.name, self.seed = spec, name, int(seed)
        cell = spec.cell(name)
        self.config_file = spec.config(cell["config"])
        self.mix = spec.traffic(cell["traffic"])
        self.workload = spec.workload(name)
        self.cameras = int(self.mix["cameras"])
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        builder = self.config_file["builder"]
        self.cfg = program.build_config(builder)
        want = self.config_file["config"]
        got = program.config_values(self.cfg)
        if got != want:
            diff = sorted(k for k in want.keys() | got.keys()
                          if want.get(k) != got.get(k))
            raise ValueError(f"the program's configuration differs from "
                             f"{cell['config']}'s file in {diff}")
        # the configuration's own plain reference (its file's
        # ``reference``), which derives the shapes again
        self.ref = spec.reference(cell["config"])
        self.ref_cfg = self.ref.config(want)
        shapes = self.ref.shapes(self.ref_cfg)
        if shapes != self.config_file["shapes"]:
            raise ValueError(f"the reference's shapes {shapes} differ from "
                             f"{cell['config']}'s file")
        self.make_draws = getattr(self.ref, "make_draws", make_draws)
        self.threshold = float(self.workload["threshold"])
        self.lap = generator.render_lap(
            self.mix, derived_seed(seed, "traffic"), self.cfg.max_input_points,
            self.cfg.half_fov_h_deg, self.cfg.half_fov_v_deg)
        self.start_pos = self.lap.frame(0)[2][0]
        self.state = program.init_state(self.cfg, self.cameras,
                                        derived_seed(seed, "state"),
                                        self.start_pos, self.device)
        step = program.make_step(self.cfg, self.cameras, self.device)
        self.step = wrap_step(step) if wrap_step else step
        self.graphed = step
        self.index = 0
        self.compared = []
        self.run = Run(cell, self.config_file, self.cameras, spec)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.current_stream().synchronize()

    def frame(self, compare: bool = False, counters: bool = False,
              marks: bool = False):
        """Hand the next frame to the step and read its map; returns
        ``(accepted, frame ms, host ms, readout ms, bookkeeping s)``, the
        last the seconds spent outside the frame's clock on the comparison's
        copies and draws and on the counters' read-back, which no user
        pays."""
        i = self.index
        self.index += 1
        rendered = self.lap.frame(i)
        frame = self.program.frame(self.cameras, *rendered)
        draws = None
        b0 = time.perf_counter()
        if compare:
            draws = self.make_draws(self.ref_cfg, self.cameras,
                                    derived_seed(self.seed, "draws", i),
                                    self.device)
            before = None if i == 0 else self.program.to_tree(self.state)
            rec = Compared(i, rendered, draws, before)
            self.sync()
        b1 = time.perf_counter()
        with mark("frame", marks):
            t0 = time.perf_counter()
            with mark("step_call", marks):
                state, out = self.step(self.state, frame, draws)
            t1 = time.perf_counter()
            with mark("sync", marks):
                self.sync()
            t2 = time.perf_counter()
            with mark("readout", marks):
                occ, centers, future, cleared = self.program.readout(
                    state, self.cfg, self.threshold)
            with mark("host_copy", marks):
                mask = occ.cpu().numpy()
            t3 = time.perf_counter()
        if counters:
            names = sorted(out.metrics)
            vals = torch.stack([out.metrics[k].to(torch.float64)
                                for k in names]).cpu().numpy()
            for k, v in zip(names, vals):
                self.run.counters.setdefault(k, []).append(float(v))
        if compare:
            rec.after = self.program.to_tree(state)
            rec.readout = {"occupied": mask, "centers": centers.cpu().numpy(),
                           "future": future.cpu().numpy()}
            self.compared.append(rec)
        self.state = cleared
        return (bool(out.accepted), (t3 - t0) * 1e3, (t1 - t0) * 1e3,
                (t3 - t2) * 1e3, (b1 - b0) + (time.perf_counter() - t3))

    def step_counters(self) -> None:
        step = self.graphed
        self.run.capture_ms = dict(getattr(step, "capture_ms", {}))
        self.run.pool_bytes = dict(getattr(step, "pool_bytes", {}))

    def release(self) -> None:
        self.program.release(self.graphed)
        self.state = self.step = self.graphed = None
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def judge(self):
        """The worst reading of each compared number over the compared
        frames."""
        readings = []
        for rec in self.compared:
            mine = self.reference_frame(rec)
            readings.append(judge.compare(
                (rec.after, rec.readout), mine, self.cfg.voxel_resolution,
                start=rec.before is None))
        return judge.worst(readings)

    def reference_frame(self, rec: Compared, control: bool = False):
        """The reference's result of a compared frame, from the program's
        state before it (frame 0: the reference's own fresh map)."""
        before = rec.before if rec.before is not None else self.ref.init_tree(
            self.ref_cfg, self.cameras, self.start_pos)
        return self.ref.run(self.ref_cfg, self.cameras, before, rec.frame,
                            rec.draws, self.threshold, control=control)


def make_draws(c, cameras: int, seed: int, device):
    """A frame's random draws, in the structure the program's step takes
    them, from a generator on ``device`` seeded by ``seed``: per camera
    ``(fresh [C] on [0.1, 1), noise_p, noise_v [P, n_b, 3] standard normal,
    noise_u [P, n_b, 3] on [-1, 1))``; several cameras as ``(None, (one
    tuple a camera))``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shape = (c.max_input_points, c.newborn_particles_per_point, 3)

    def one():
        fresh = torch.rand((c.max_clusters,), generator=gen,
                           device=device) * 0.9 + 0.1
        noise_p = torch.randn(shape, generator=gen, device=device)
        noise_v = torch.randn(shape, generator=gen, device=device)
        noise_u = torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
        return fresh, noise_p, noise_v, noise_u

    if cameras == 1:
        return one()
    return None, tuple(one() for _ in range(cameras))


def window_samples(seed: int, seconds: float, n: int) -> list:
    """The times in the window at which a frame is compared."""
    rng = np.random.default_rng(derived_seed(seed, "samples"))
    return sorted(rng.uniform(0.0, seconds, n).tolist())


def measure(cell: Cell, seconds: float, traced: bool, started: float):
    """Set-up's frames (frame 0, compared, and the warm-up) and the window
    of ``seconds``: ``(setup_s, window_s, attempted, failed)``; the
    window's frame times land in ``cell.run``."""
    wl = cell.workload
    ok, *_ = cell.frame(compare=True)
    failed = int(not ok)
    for _ in range(int(wl["warmup_frames"])):
        cell.frame()
    cell.sync()
    setup_s = time.time() - started

    samples = window_samples(cell.seed, seconds, int(wl["compare_frames"]))
    attempted = 0
    # the window's time is the frames' alone: the comparison's copies and
    # draws, which no user pays, are taken out of it as they happen
    t0 = time.perf_counter()
    aside = 0.0
    window = 0.0
    # a sample still due when the time is up takes the next frame, which
    # the window then counts
    while window < seconds or samples:
        due = bool(samples) and window >= samples[0]
        if due:
            samples.pop(0)
        attempted += 1
        try:
            ok, ms, host, read, kept = cell.frame(compare=due,
                                                  counters=traced)
        except Exception:  # a frame that raises is a failed frame
            traceback.print_exc()
            failed += 1
            break
        failed += not ok
        aside += kept
        cell.run.frame_ms.append(ms)
        cell.run.host_ms.append(host)
        cell.run.readout_ms.append(read)
        window = time.perf_counter() - t0 - aside
    return setup_s, window, attempted, failed


def run_cell(spec, name: str, seed: int, seconds: float, traced: bool,
             started: float, device="cuda", wrap_step=None) -> dict:
    """One run; returns the result line's object (with ``compared``, the
    numbers beside their limits, and ``_lines``, the same as text)."""
    cell = Cell(spec, name, seed, device, wrap_step)
    wl = cell.workload
    setup_s, window_s, attempted, failed = measure(cell, seconds, traced,
                                                   started)
    frame_ms = cell.run.frame_ms

    if cell.cuda:
        cell.sync()
        peak = torch.cuda.max_memory_reserved(cell.device)
    else:
        peak = 0
    breakdown = None
    if traced and not failed:
        cell.run.trace = profile(cell, int(wl["profiled_frames"]))
        breakdown = devtrace.breakdown(cell.run.trace)
    cell.step_counters()
    cell.release()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")

    t_ref = time.perf_counter()
    numbers = cell.judge()
    print(f"reference: {len(cell.compared)} frames in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    limits = wl["limits"]
    correct, lines = judge.verdict(numbers, limits)
    correct = correct and failed == 0 and attempted > 0

    if traced:
        metrics = {}
        for m in spec.per_layer(name):
            value = spec.module("metrics", m["name"]).read(cell.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "frames_per_s": len(frame_ms) / window_s,
            "frame_ms_p95": float(np.percentile(frame_ms, 95)),
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(name)}
    dev = {"platform": "gpu" if cell.cuda else "cpu",
           "kind": (torch.cuda.get_device_name(cell.device) if cell.cuda
                    else "cpu"),
           "count": int(cell.run.cell["chips"]),
           "memory_peak_bytes": int(peak)}
    if cell.run.trace is not None:
        dev["busy_s"] = cell.run.trace.busy_s
        dev["window_s"] = cell.run.trace.window_s
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": numbers.get(k), "limit": limits[k]}
                       for k in limits}
    out["_lines"] = lines
    return out


def profile(cell: Cell, n: int):
    """Profile ``n`` frames after the window and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if cell.cuda:
        activities.append(ProfilerActivity.CUDA)
    cell.sync()
    with torch_profile(activities=activities) as prof:
        for _ in range(n):
            cell.frame(marks=True)
        cell.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return devtrace.reduce(path)
    finally:
        os.remove(path)
