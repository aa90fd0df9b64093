"""The step compiled once and replayed every frame: the counterpart of the
JAX package's ``jax.jit(make_step(cfg), donate_argnums=0)``.

Every entry point of the JAX package wraps the step so: one compiled
program, dispatched once a frame, with the state's buffers donated to it.
:func:`make_graphed_step` captures the device body of
:func:`~.pipeline.make_step` (``pipeline.make_body``) once as a CUDA graph
over static buffers -- the state's tensors, the frame's blocks and points
(``scalars.py``) and the random draws -- and replays it each frame,
so the host launches one graph where the eager step launches some two
thousand kernels and copies.  The graph ends by copying the new state into
the static state tensors: the returned state aliases them (the donation),
and a state returned before is stale after the next call.

What stays on the host each frame: the prologue (admission control, the
window origin, the time step, the frame's rotation; ``pipeline.prologue``),
the draws from ``state.gen`` -- made outside the graph into the static draw
buffers, so the generator advances exactly as in the eager step -- and one
staged copy of the frame from pinned buffers the object owns.  The runtime
parameters travel in the frame's float block, so a live setter between
frames takes effect without a new capture.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..config import MapConfig
from .. import scalars
from ..state import (EstimatorState, MapState, Particles, _PLANES,
                     tensor_leaves)
from .pipeline import (Frame, StepOutput, _on_device, _rejected, make_body,
                       make_draws, prologue)


class GraphedStep:
    """``step(state, frame, draws=None) -> (state, StepOutput)``, one CUDA
    graph a frame; see :func:`make_graphed_step`."""

    def __init__(self, cfg: MapConfig, with_metrics: bool = True,
                 admission_control: bool = True):
        cfg.validate()
        self.cfg = cfg
        self.with_metrics = with_metrics
        self.admission_control = admission_control
        self._body = make_body(cfg, with_metrics)
        self._layout = scalars.layout(cfg)
        #: graphs captured by this object: 1 after the first accepted frame
        self.captures = 0
        #: host milliseconds of the capture (warm-up run included)
        self.capture_ms = None
        self._graph = None

    # -- static buffers ----------------------------------------------------
    def _allocate(self, state: MapState) -> None:
        dev = state.device
        self._static = {
            k: torch.empty_like(v, memory_format=torch.contiguous_format)
            for k, v in tensor_leaves(state).items()}
        self._draws = None  # shaped by the first frame's draws
        n = self._layout.nbytes
        self._host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        self._frame = torch.empty(n, dtype=torch.uint8, device=dev)
        f, i, points = self._layout.views(self._frame)
        self._fs = scalars.FrameScalars(f[0], i[0])
        self._points = points[0]
        self._copied = torch.cuda.Event()

    def _load_state(self, state: MapState) -> None:
        for k, v in tensor_leaves(state).items():
            static = self._static[k]
            if v.shape != static.shape or v.dtype != static.dtype:
                raise ValueError(
                    f"state leaf {k} is {tuple(v.shape)} {v.dtype}; the graph "
                    f"was captured for {tuple(static.shape)} {static.dtype}")
            if v is not static:
                static.copy_(v)

    def _load_draws(self, state: MapState, draws) -> None:
        dev = state.device
        if draws is None:
            if self._draws is not None:
                make_draws(self.cfg, state.gen, dev, out=self._draws)
                return
            draws = make_draws(self.cfg, state.gen, dev)
        draws = _on_device(draws, dev)
        if self._draws is None:
            self._draws = tuple(torch.empty_like(d) for d in draws)
        if [d.shape for d in draws] != [d.shape for d in self._draws]:
            raise ValueError(
                f"draws of shapes {[tuple(d.shape) for d in draws]}; the "
                f"graph takes {[tuple(d.shape) for d in self._draws]}")
        for static, d in zip(self._draws, draws):
            static.copy_(d)

    def _load_frame(self, pro, state: MapState, frame: Frame) -> None:
        self._copied.synchronize()  # the last frame's copy has read the host
        self._layout.pack(self._host.numpy(),
                          *pro.blocks(self.cfg, state, frame.n_points),
                          frame.points)
        self._frame.copy_(self._host, non_blocking=True)
        self._copied.record()

    def _particles(self) -> Particles:
        return Particles(**{n: self._static[f"particles.{n}"]
                            for n in _PLANES})

    def _estimator(self) -> EstimatorState:
        return EstimatorState(**{
            f.name: self._static[f"estimator.{f.name}"]
            for f in dataclasses.fields(EstimatorState)})

    def _run_body(self):
        return self._body(self._particles(), self._static["future"],
                          self._estimator(), self._fs, self._points,
                          self._draws)

    def _store(self, out) -> None:
        """The new state into the static state tensors (inside the graph)."""
        for k, v in tensor_leaves(out).items():
            self._static[k].copy_(v)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # lazy initialisation, off the graph
            self._run_body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._run_body()
            self._store(out)
        self._graph, self._out = graph, out
        self.captures += 1
        torch.cuda.synchronize()
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def release(self) -> None:
        """Free the graph, its memory pool and the static buffers; the next
        accepted frame captures anew."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._out = None
        self._static = self._draws = self._host = self._frame = None

    # -- the step ----------------------------------------------------------
    def __call__(self, state: MapState, frame: Frame, draws=None):
        if state.device.type != "cuda":
            raise ValueError("the graphed step runs on the CUDA card; a CPU "
                             "state takes make_step")
        cfg = self.cfg
        pro = prologue(state, frame, cfg)
        if self.admission_control and not pro.accepted:
            return state, _rejected(state, cfg, self.with_metrics)
        if self._graph is None:
            self._allocate(state)
        self._load_state(state)
        self._load_draws(state, draws)
        self._load_frame(pro, state, frame)
        if self._graph is None:
            self._capture()
        self._graph.replay()
        st = self._static
        new_state = pro.advance(
            state, particles=self._particles(), weight_sum=st["weight_sum"],
            vel_avg=st["vel_avg"], future=st["future"],
            estimator=self._estimator())
        return new_state, StepOutput(pro.accepted, st["weight_sum"],
                                     self._out.metrics, self._out.cloud)


def make_graphed_step(cfg: MapConfig, with_metrics: bool = True,
                      admission_control: bool = True) -> GraphedStep:
    """Build ``step(state, frame, draws=None) -> (state, StepOutput)``:
    :func:`~.pipeline.make_step`'s step as one CUDA graph a frame, the
    counterpart of ``jax.jit(make_step(cfg), donate_argnums=0)``, with the
    same bits as the eager step on the same frames and draws.

    Like ``jit``, it captures at the first accepted frame (after one eager
    run of the body on a side stream) and then replays; ``captures`` counts
    the graphs it made (1) and ``capture_ms`` times the capture.  Each call
    runs the host prologue; a frame that admission control rejects returns
    the state and zeros without a replay.  ``draws`` (see
    :func:`~.pipeline.make_draws`) are copied into the graph's draw buffers;
    ``None`` draws them from ``state.gen`` into those buffers, advancing the
    generator as the eager step does.

    Contract:

    * donation: the returned state's tensors are the graph's static state
      tensors, and the next call overwrites them: a state returned before
      (and the state passed in, if the caller keeps it) is stale then.  A
      state whose tensors are not the static ones (a fresh state, a loaded
      checkpoint, the state after ``clear_future_prediction``) is copied in
      first;
    * ``StepOutput.weight_sum``, the metrics and the estimator cloud are the
      graph's static outputs, valid until the next call: clone them to keep
      them;
    * a live setter (``set_detection_probability`` and the others) between
      frames takes effect without a new capture;
    * it raises on a state that is not on a CUDA card (the CPU runs
      ``make_step``) and on a state whose shapes differ from the captured
      ones; a capture that fails raises, and nothing falls back to the eager
      step.  ``release()`` frees the graph and its memory."""
    return GraphedStep(cfg, with_metrics, admission_control)
