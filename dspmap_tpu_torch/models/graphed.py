"""The step compiled once and replayed every frame: the counterpart of the
JAX package's ``jax.jit(make_step(cfg), donate_argnums=0)`` and of
``jax.jit(make_multisensor_step(cfg, n), donate_argnums=0)``.

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

:func:`make_graphed_multisensor_step` does the same for the multi-sensor
step, with one graph for each pattern of admitted cameras
(``pipeline.make_multisensor_body``), captured at the pattern's first
frame: the JAX step takes a skipped camera's branch of a ``lax.cond``
inside its one program, a graph has no branch.  Each graph has a memory
pool of its own (patterns replay in any order, and PyTorch keeps a shared
pool safe only for graphs replayed in the order of their capture); all
of them read and write the one set of static buffers.

Both take a ``shard`` (a :class:`~..ops.common.ShardCtx`), which makes
them one rank's step of the sharded step, the counterpart of
``jax.jit(shard_map(body), donate_argnums=0)`` (built for a mesh by
``make_graphed_shardmap_step`` in ``parallel/shard_step.py``): the static
buffers are the rank's slab and draws, and each graph holds the rank's
collectives, which therefore must be NCCL's (they run on the card's
stream).

What stays on the host each frame: the prologue (admission control, the
window origin, the time step, the frame's rotation; ``pipeline.prologue``,
``pipeline.multisensor_prologue``), the draws from ``state.gen`` -- made
outside the graph into the static draw buffers, so the generator advances
exactly as in the eager step -- and one staged copy of the frame from
pinned buffers the object owns.  The runtime parameters travel in the
frame's float block, so a live setter between frames takes effect without
a new capture.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..config import MapConfig
from .. import scalars
from ..state import (EstimatorState, MapState, Particles, _PLANES,
                     tensor_leaves)
from .pipeline import (Frame, StepOutput, _map_draws, _on_device,
                       _particle_shape, _rejected, _rejected_multisensor,
                       make_body, make_draws, make_multisensor_body,
                       make_multisensor_draws, multisensor_prologue, prologue)


def _flat(x) -> list:
    """The draws of a nest of tuples, in order (``None`` left out)."""
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [x]


class _GraphedBase:
    """What the graphed steps share: the static buffers, the frame's staged
    copy, the draws, one graph a pattern of admitted cameras (one camera:
    the pattern ``(True,)``) and its capture.  With ``shard`` (a
    :class:`~..ops.common.ShardCtx`) it is one rank's step of the sharded
    step: the state is the rank's slab and the graphs hold the rank's
    collectives.  ``eager`` names the eager step a CPU state takes."""

    def __init__(self, cfg: MapConfig, layout: scalars.FrameLayout,
                 shard, eager: str):
        cfg.validate()
        self.cfg = cfg
        self.shard = shard
        self.eager = eager
        self._layout = layout
        #: graphs captured by this object (one a pattern seen)
        self.captures = 0
        #: pattern -> host milliseconds of its capture (warm-up run included)
        self.capture_ms = {}
        #: pattern -> bytes its graph's private memory pool reserved
        self.pool_bytes = {}
        #: pattern -> bytes still allocated after its capture (the outputs)
        self.kept_bytes = {}
        self._graphs = {}  # pattern -> (CUDAGraph, the body's outputs)
        self._static = None

    def _check_device(self, state: MapState) -> None:
        if state.device.type != "cuda":
            raise ValueError("the graphed step runs on the CUDA card; a CPU "
                             f"state takes {self.eager}")

    # -- static buffers ----------------------------------------------------
    def _allocate(self, state: MapState) -> None:
        dev = state.device
        if self.shard is not None:
            want = _particle_shape(self.cfg, self.shard.n_shards)
            got = tuple(state.particles.flags.shape)
            if got != want:
                raise ValueError(
                    f"particle planes of {got}; a slab of "
                    f"{self.shard.n_shards} ranks has {want} (shard_state)")
        self._static = {
            k: torch.empty_like(v, memory_format=torch.contiguous_format)
            for k, v in tensor_leaves(state).items()}
        self._draws = None  # shaped by the first frame's draws
        n = self._layout.nbytes
        self._host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        self._frame = torch.empty(n, dtype=torch.uint8, device=dev)
        self._fs, self._points = self._frame_views(
            *self._layout.views(self._frame))
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
                self._make_draws(state.gen, dev, out=self._draws)
                return
            draws = self._make_draws(state.gen, dev)
        draws = _map_draws(lambda d: _on_device((d,), dev)[0], draws)
        if self._draws is None:
            self._draws = _map_draws(torch.empty_like, draws)
        got, static = _flat(draws), _flat(self._draws)
        if [d.shape for d in got] != [d.shape for d in static]:
            raise ValueError(
                f"draws of shapes {[tuple(d.shape) for d in got]}; the "
                f"graph takes {[tuple(d.shape) for d in static]}")
        for s, d in zip(static, got):
            s.copy_(d)

    def _load_frame(self, f, i, points) -> None:
        self._copied.synchronize()  # the last frame's copy has read the host
        self._layout.pack(self._host.numpy(), f, i, points)
        self._frame.copy_(self._host, non_blocking=True)
        self._copied.record()

    def _particles(self) -> Particles:
        return Particles(**{n: self._static[f"particles.{n}"]
                            for n in _PLANES})

    def _estimator(self) -> EstimatorState:
        return EstimatorState(**{
            f.name: self._static[f"estimator.{f.name}"]
            for f in dataclasses.fields(EstimatorState)})

    def _store(self, out) -> None:
        """The new state into the static state tensors (inside the graph)."""
        for k, v in tensor_leaves(out).items():
            self._static[k].copy_(v)

    def _capture(self, pattern, body) -> None:
        def run():
            return body(self._particles(), self._static["future"],
                        self._estimator(), self._fs, self._points,
                        self._draws)

        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # lazy initialisation, off the graph
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a private memory pool of its own; "thread_local": ProcessGroupNCCL's
        # watchdog thread queries CUDA events while the capture is open, which
        # the default "global" mode makes an error of
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved()
            allocated = torch.cuda.memory_allocated()
            out = run()
            self._store(out)
        self._graphs[pattern] = (graph, out)
        self.captures += 1
        torch.cuda.synchronize()
        self.capture_ms[pattern] = (time.perf_counter() - t0) * 1e3
        self.pool_bytes[pattern] = torch.cuda.memory_reserved() - reserved
        self.kept_bytes[pattern] = torch.cuda.memory_allocated() - allocated

    def _replay(self, state: MapState, draws, blocks, points, pattern,
                build):
        """Load the state, the draws and the frame into the static buffers,
        capture ``build()``'s body for ``pattern`` if it has no graph yet,
        and replay that pattern's graph.  Returns the graph's outputs."""
        if self._static is None:
            self._allocate(state)
        self._load_state(state)
        self._load_draws(state, draws)
        self._load_frame(*blocks, points)
        if pattern not in self._graphs:
            self._capture(pattern, build())
        graph, out = self._graphs[pattern]
        graph.replay()
        return out

    def _advance(self, pro, state: MapState) -> MapState:
        st = self._static
        return pro.advance(
            state, particles=self._particles(), weight_sum=st["weight_sum"],
            vel_avg=st["vel_avg"], future=st["future"],
            estimator=self._estimator())

    def release(self) -> None:
        """Free every graph, their memory pools and the static buffers; the
        next accepted frame captures anew."""
        for graph, _ in self._graphs.values():
            graph.reset()
        self._graphs = {}
        self._static = self._draws = self._host = self._frame = None


class GraphedStep(_GraphedBase):
    """``step(state, frame, draws=None) -> (state, StepOutput)``, one CUDA
    graph a frame; see :func:`make_graphed_step`."""

    def __init__(self, cfg: MapConfig, with_metrics: bool = True,
                 admission_control: bool = True, shard=None,
                 eager: str = "make_step"):
        super().__init__(cfg, scalars.layout(cfg), shard, eager)
        self.with_metrics = with_metrics
        self.admission_control = admission_control

    def _frame_views(self, f, i, points):
        return scalars.FrameScalars(f[0], i[0]), points[0]

    def _make_draws(self, gen, device, out=None):
        return make_draws(self.cfg, gen, device, self.shard, out=out)

    # -- the step ----------------------------------------------------------
    def __call__(self, state: MapState, frame: Frame, draws=None):
        self._check_device(state)
        cfg = self.cfg
        pro = prologue(state, frame, cfg)
        if self.admission_control and not pro.accepted:
            return state, _rejected(state, cfg, self.with_metrics)
        out = self._replay(state, draws,
                           pro.blocks(cfg, state, frame.n_points),
                           frame.points, (True,),
                           lambda: make_body(cfg, self.with_metrics,
                                             self.shard))
        return self._advance(pro, state), StepOutput(
            pro.accepted, self._static["weight_sum"], out.metrics, out.cloud)


def make_graphed_step(cfg: MapConfig, with_metrics: bool = True,
                      admission_control: bool = True) -> GraphedStep:
    """Build ``step(state, frame, draws=None) -> (state, StepOutput)``:
    :func:`~.pipeline.make_step`'s step as one CUDA graph a frame, the
    counterpart of ``jax.jit(make_step(cfg), donate_argnums=0)``, with the
    same bits as the eager step on the same frames and draws.

    Like ``jit``, it captures at the first accepted frame (after one eager
    run of the body on a side stream) and then replays; ``captures`` counts
    the graphs it made (1), ``capture_ms[(True,)]`` times the capture and
    ``pool_bytes[(True,)]`` gives its memory pool.  Each call
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


class GraphedMultisensorStep(_GraphedBase):
    """``step(state, frames, draws=None) -> (state, StepOutput)``, one CUDA
    graph a pattern of admitted cameras; see
    :func:`make_graphed_multisensor_step`."""

    def __init__(self, cfg: MapConfig, n_sensors: int, shard=None,
                 eager: str = "make_multisensor_step"):
        super().__init__(cfg, scalars.layout(cfg, n_sensors), shard, eager)
        self.n_sensors = n_sensors

    def _frame_views(self, f, i, points):
        return scalars.FrameScalars(f, i), points

    def _make_draws(self, gen, device, out=None):
        return make_multisensor_draws(self.cfg, self.n_sensors, gen, device,
                                      self.shard, out=out)

    def __call__(self, state: MapState, frames: Frame, draws=None):
        self._check_device(state)
        cfg, n = self.cfg, self.n_sensors
        pro = multisensor_prologue(state, frames, cfg, n)
        for f in dataclasses.fields(EstimatorState):
            shape = tuple(getattr(state.estimator, f.name).shape)
            if shape[:1] != (n,):
                raise ValueError(f"estimator.{f.name} is {shape}; a state "
                                 f"of {n} sensors has a leading [{n}] axis "
                                 "(init_multisensor_state)")
        if not pro.accepted:
            return state, _rejected_multisensor(state, cfg)
        out = self._replay(state, draws, (pro.f, pro.i), frames.points,
                           pro.admitted,
                           lambda: make_multisensor_body(cfg, n,
                                                         pro.admitted,
                                                         self.shard))
        return self._advance(pro, state), StepOutput(
            True, self._static["weight_sum"], out.metrics, ())


def make_graphed_multisensor_step(cfg: MapConfig,
                                  n_sensors: int) -> GraphedMultisensorStep:
    """Build ``step(state, frames, draws=None) -> (state, StepOutput)``:
    :func:`~.pipeline.make_multisensor_step`'s step as CUDA graphs, the
    counterpart of ``jax.jit(make_multisensor_step(cfg, n_sensors),
    donate_argnums=0)``, with the same bits as the eager step on the same
    frames and draws.

    One graph for each pattern of admitted cameras (a camera with an
    invalid quaternion is skipped), captured at the pattern's first frame
    (one eager run of its body on a side stream, then the capture) and
    replayed from then on, each in a memory pool of its own: with two
    cameras at most three graphs.  ``captures`` counts them;
    ``capture_ms``, ``pool_bytes`` and ``kept_bytes`` give each pattern's
    capture time, pool size and the bytes of its outputs.  A frame that
    admission control rejects returns the state and zeros (the occupancy
    stage's metrics) without a replay.  ``draws`` (see
    :func:`~.pipeline.make_multisensor_draws`) are shape-checked and copied
    into the graphs' draw buffers; ``None`` draws them from ``state.gen``
    into those buffers, every camera's, advancing the generator as the
    eager step does.

    The contract is :func:`make_graphed_step`'s: every pattern's graph
    ends by copying the new state into the one set of static state
    tensors, which the returned state aliases (a state whose tensors are
    not those is copied in first); the outputs are valid until the next
    call; a live setter takes effect without a new capture.  It raises on a
    state that is not on a CUDA card (the CPU runs
    ``make_multisensor_step``), on frames of another ``n_sensors`` and on a
    state or draws of other shapes; a capture that fails raises, and
    nothing falls back to the eager step.  ``release()`` frees every
    pattern's graph."""
    return GraphedMultisensorStep(cfg, n_sensors)
