"""The program's own tracing (``dspmap_tpu_torch/utils/profiling.py``:
``tracing``, ``span``, ``mark``, ``spans``) on the CPU, where a stage mark
is a host clock read: off, the step records nothing and gives the same
bits as with it on; on, each eager frame marks its stages once each in the
body's order (a rig's per-camera stages once a camera), the host spans nest
under their frame and show in a ``torch.profiler`` trace as ``dspmap.*``
ranges (the marks falling due under it left unread), and the buffer's cap
drops and counts; ``utils/stage_times.py`` shows the marks in a profile as
``mark.*`` ranges and charges each kernel to the stage its launch ends in.

Marked ``cuda``: the graphed flagship step on a card, its stage marks
recorded into the captured graph.  On a machine with an H100 run
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``."""

import gzip
import json

import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch.utils import profiling, sim
from dspmap_tpu_torch.utils.parity import differing_leaves, differing_outputs

torch.set_num_threads(2)

KW = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=512,
          mover_capacity=4096, pyramid_slot_capacity=64, max_clusters=8)
ARMS = {
    "pool": {},
    "compact": dict(layout="compact"),
    "noisy": dict(limit_motion_to_xy_plane=False),
}
#: the one-camera body's stages in the order it runs them
STAGES = ("stage.observe", "stage.estimate", "stage.predict",
          "stage.update", "stage.birth", "stage.occupancy")


@pytest.fixture
def traced():
    """Tracing on for the test, off and the buffer empty after it."""
    profiling.spans()
    profiling.tracing(True)
    try:
        yield
    finally:
        profiling.tracing(False)
        profiling.spans()


def _cfg(**kw):
    return T.example_node_settings(T.dsp_dynamic(**KW, **kw))


def _run(step, state, frames, cfg):
    outs = []
    for f in frames:
        state, out = step(state, f)
        assert out.accepted
        outs.append(out)
        *_, state = T.get_occupancy_map(state, cfg)
    return state, outs


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_tracing_off_records_nothing_and_on_gives_the_same_bits(arm):
    cfg = _cfg(**ARMS[arm])
    frames = [T.Frame(*f) for f in sim.generate_sequence(3, cfg, seed=7)]
    profiling.spans()
    step = T.make_step(cfg)
    plain = _run(step, T.init_state(cfg, seed=1, device="cpu"), frames, cfg)
    assert profiling.spans() == profiling.Records([], [], 0, 0)
    profiling.tracing(True)
    try:
        traced = _run(step, T.init_state(cfg, seed=1, device="cpu"), frames,
                      cfg)
    finally:
        profiling.tracing(False)
    records = profiling.spans()
    assert len(records.stages) == 3
    assert differing_leaves(plain[0], traced[0]) == []
    for a, b in zip(plain[1], traced[1]):
        assert differing_outputs(a, b) == []


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_each_eager_frame_marks_every_stage_once_in_order(arm, traced):
    cfg = _cfg(**ARMS[arm])
    frames = [T.Frame(*f) for f in sim.generate_sequence(3, cfg, seed=7)]
    _run(T.make_step(cfg), T.init_state(cfg, seed=1, device="cpu"), frames,
         cfg)
    records = profiling.spans()
    assert records.dropped == 0 and records.unmeasured == 0
    steps = [s for s in records.spans if s.name == "step"]
    assert [s.parent for s in steps] == [None] * 3
    frame_ids = [s.frame for s in steps]
    assert frame_ids == sorted(set(frame_ids))
    readouts = [s for s in records.spans if s.name == "readout"]
    assert [s.frame for s in readouts] == frame_ids
    # each frame after the first reads the marks of the one before
    reads = [s for s in records.spans if s.name == "step.marks"]
    assert [(s.frame, s.parent) for s in reads] == [(f, "step")
                                                    for f in frame_ids[1:]]
    assert [st.frame for st in records.stages] == frame_ids
    for st, step in zip(records.stages, steps):
        assert tuple(stage for stage, _ in st.marks) == STAGES
        assert all(ms >= 0.0 for _, ms in st.marks)
        assert st.total_ms == pytest.approx(sum(st.ms().values()))
        assert st.total_ms <= step.ms


def test_a_rig_marks_the_camera_stages_once_a_camera(traced):
    """Two cameras: prediction once, then each camera's observe, estimate,
    FOV registration (under ``stage.predict``), update and birth, then one
    occupancy; a skipped camera marks nothing."""
    cfg = _cfg()
    frames = [T.stack_frames([T.Frame(*f)] * 2)
              for f in sim.generate_sequence(3, cfg, seed=7)]
    skip = frames[2].quat.copy()
    skip[1] = float("nan")
    frames[2] = frames[2]._replace(quat=skip)
    _run(T.make_multisensor_step(cfg, 2),
         T.init_multisensor_state(cfg, 2, seed=0, device="cpu"), frames, cfg)
    records = profiling.spans()
    camera = ("stage.observe", "stage.estimate", "stage.predict",
              "stage.update", "stage.birth")
    want = [("stage.predict",) + camera * cameras + ("stage.occupancy",)
            for cameras in (2, 2, 1)]
    assert [tuple(s for s, _ in st.marks) for st in records.stages] == want
    per_frame = records.stages[0].ms()
    assert sorted(per_frame) == sorted(STAGES)
    assert sum(per_frame.values()) == pytest.approx(records.stages[0].total_ms)


def test_host_spans_nest_and_show_in_a_chrome_trace(tmp_path, traced):
    cfg = _cfg()
    state = T.init_state(cfg, seed=1, device="cpu")
    frame = T.Frame(*next(sim.generate_sequence(1, cfg, seed=7)))
    step = T.make_step(cfg)
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            state, _ = step(state, frame)
        *_, state = T.get_occupancy_map(state, cfg)
        step(state, frame._replace(timestamp=frame.timestamp + 0.1))
    records = profiling.spans()
    # the first frame's marks fell due under the profiler: unread
    assert records.unmeasured == 1 and len(records.stages) == 1
    by_name = {s.name: s for s in records.spans[::-1]}  # the first of each
    assert "step.marks" not in by_name
    assert by_name["step"].parent == "outer"
    assert by_name["readout"].parent is None
    outer, inner = by_name["outer"], by_name["step"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    (path,) = tmp_path.glob("*" + profiling.TRACE_SUFFIX)
    with gzip.open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"dspmap.outer", "dspmap.step", "dspmap.readout"} <= names
    # off: no range in the trace, no record
    profiling.tracing(False)
    with profiling.trace(str(tmp_path / "off")):
        with profiling.span("outer"):
            step(state, frame)
    (path,) = (tmp_path / "off").glob("*" + profiling.TRACE_SUFFIX)
    with gzip.open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert not any(str(n).startswith("dspmap.") for n in names)
    assert profiling.spans() == profiling.Records([], [], 0, 0)


def test_the_buffer_drops_what_its_cap_does_not_hold(monkeypatch, traced):
    monkeypatch.setattr(profiling, "CAPACITY", 5)
    for _ in range(8):
        with profiling.span("a"):
            pass
    records = profiling.spans()
    assert len(records.spans) == 5 and records.dropped == 3
    assert profiling.spans() == profiling.Records([], [], 0, 0)
    # a frame's stages count as one record: four frames make four steps,
    # three reads of the frame before (step.marks) and four stages
    for _ in range(4):
        with profiling.span("step", frame=True):
            profiling.mark(profiling.START, "cpu")
            profiling.mark("stage.a", "cpu")
    records = profiling.spans()
    assert len(records.spans) + len(records.stages) == 5
    assert records.dropped == 4 + 3 + 4 - 5


def test_summarize_leaves_out_the_frames_that_captured():
    span = profiling.Span
    records = profiling.Records(
        spans=[span("step.capture", "step", 1, 0, 9_000_000),
               span("step", None, 1, 0, 10_000_000),
               span("step", None, 2, 0, 2_000_000),
               span("step", None, 3, 0, 4_000_000),
               span("step.load", "step", 3, 0, 500_000),
               span("step.load", "step", 3, 0, 500_000)],
        stages=[profiling.Stages(1, (("stage.a", 5.0),)),
                profiling.Stages(2, (("stage.a", 1.0), ("stage.a", 1.0))),
                profiling.Stages(3, (("stage.a", 3.0),))],
        dropped=0, unmeasured=1)
    got = profiling.summarize(records)
    assert got["spans"] == {"step": 3.0, "step.load": 1.0}
    assert got["stages"] == {"stage.a": 2.5}
    assert got["stages_total"] == 2.5
    assert got["frames"] == 2 and got["unmeasured"] == 1


def test_marks_in_profile_leave_a_range_a_mark(traced):
    """Under ``stage_times.marks_in_profile`` an eager frame's stage marks
    show in ``torch.profiler``'s host timeline as ``mark.<stage>``, once
    each; after the block ``profiling.mark`` is the program's again."""
    from dspmap_tpu_torch.utils import stage_times

    cfg = _cfg()
    state = T.init_state(cfg, seed=1, device="cpu")
    frame = T.Frame(*next(sim.generate_sequence(1, cfg, seed=7)))
    real = profiling.mark
    with stage_times.marks_in_profile(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        T.make_step(cfg)(state, frame)
    assert profiling.mark is real
    names = [e.name for e in prof.events() if e.name.startswith("mark.")]
    assert sorted(names) == sorted(
        ["mark." + profiling.START] + ["mark." + s for s in STAGES])


def test_attribute_charges_a_kernel_to_the_stage_its_launch_ends_in():
    """``stage_times.attribute``: a kernel, copy or set is charged, by its
    launch's correlation, to the first mark after the launch (past the
    last mark to ``after_last_mark``), per frame, with its costliest
    names; host ranges and unmatched device events are not charged."""
    from dspmap_tpu_torch.utils import stage_times

    def x(name, ts, cat=None, dur=0.0, corr=None):
        e = {"ph": "X", "name": name, "ts": ts, "dur": dur}
        if cat:
            e["cat"] = cat
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [x("mark.stage.start", 0), x("mark.stage.a", 10),
              x("mark.stage.b", 20),
              x("cudaLaunchKernel", 5, "cuda_runtime", corr=1),
              x("cudaLaunchKernel", 7, "cuda_runtime", corr=2),
              x("cudaMemcpyAsync", 15, "cuda_runtime", corr=3),
              x("cudaLaunchKernel", 25, "cuda_runtime", corr=4),
              x("k1", 100, "kernel", 3000.0, 1),
              x("k2", 104, "kernel", 1000.0, 2),
              x("Memcpy DtoH", 108, "gpu_memcpy", 2000.0, 3),
              x("k1", 110, "kernel", 500.0, 4),
              x("k3", 112, "kernel", 9000.0, 99),
              x("dspmap.step", 0, "user_annotation", 30.0)]
    got = stage_times.attribute(events, frames=2, top=1)
    assert got == {"stage.a": {"ms": 2.0, "top": [["k1", 1.5]]},
                   "stage.b": {"ms": 1.0, "top": [["Memcpy DtoH", 1.0]]},
                   "after_last_mark": {"ms": 0.25, "top": [["k1", 0.25]]}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graphed_step_times_its_stages_on_the_card(card):
    """With tracing on, the flagship's graph holds its stage marks: every
    stage's device ms is positive and their sum is within 2% of the
    graph's first mark to its last; the host spans split the call.  A step
    built with tracing off records no mark, even when tracing is on."""
    cfg = T.example_node_settings(T.dsp_dynamic())
    frames = [T.Frame(*f) for f in sim.generate_sequence(12, cfg, seed=0)]

    def run(traced_capture):
        """The frames with tracing on, the first (which captures) with
        tracing ``traced_capture``."""
        profiling.tracing(traced_capture)
        step = T.make_graphed_step(cfg)
        state = T.init_state(cfg, seed=0)
        try:
            for f in frames:
                state, out = step(state, f)
                assert out.accepted
                *_, state = T.get_occupancy_map(state, cfg)
                torch.cuda.synchronize()
                profiling.tracing(True)
        finally:
            profiling.tracing(False)
            step.release()
        return profiling.spans()

    profiling.spans()
    records = run(True)
    got = profiling.summarize(records)
    assert records.unmeasured == 0 and got["frames"] == len(frames) - 1
    stages = got["stages"]
    assert sorted(stages) == sorted(STAGES + ("stage.store",))
    assert all(ms > 0.0 for ms in stages.values())
    assert sum(stages.values()) == pytest.approx(got["stages_total"],
                                                 rel=0.02)
    children = {"step.marks", "step.prologue", "step.draws", "step.load",
                "step.launch", "step.advance"}
    assert children | {"step", "readout"} == set(got["spans"])
    capturing = {s.frame for s in records.spans if s.name == "step.capture"}
    for step in (s for s in records.spans
                 if s.name == "step" and s.frame not in capturing):
        inner = [s for s in records.spans
                 if s.frame == step.frame and s.parent == "step"]
        assert {s.name for s in inner} >= children
        assert all(step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
                   for s in inner)

    records = run(False)
    assert records.stages == [] and records.unmeasured == 0
    steps = [s for s in records.spans if s.name == "step"]
    assert len(steps) == len(frames) - 1
