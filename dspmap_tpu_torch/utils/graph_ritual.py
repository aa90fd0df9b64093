"""A graphed step held against its eager step, frame by frame on the same
draws: the ritual that ``chip_smoke.py``'s ``graph`` phase runs on one card
(``make_graphed_step``, ``make_graphed_multisensor_step``) and
:mod:`.shard_probe` runs on every rank of a mesh
(``make_graphed_shardmap_step``).

:func:`sequence` gives a path's frames of the synthetic street, one
camera's or several cameras' (stacked, a leading camera axis);
:func:`ritual_frames` makes the ritual's :data:`FRAMES` frames from them:
frame :data:`REJECTED` a pose jump of :data:`JUMP_M` m that admission
control rejects and, for several cameras, the frames of
:func:`some_cameras` with cameras skipped (:func:`cameras`).
:func:`in_turns` runs them through the eager and the graphed step in turns,
each from its own state and generator, a live setter changing
``p_detection`` to :data:`P_SETTER` before frame :data:`SETTER`, and checks
that every leaf, the generators and, on an accepted frame, every output
are bit-equal after each frame, that the graphed step captured once a
pattern of admitted cameras and that the host launched no kernel during a
replay.  :func:`busy` profiles one call on the card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import kernels
from ..models.pipeline import Frame, set_detection_probability, stack_frames
from ..state import HOST_LEAVES, MapState, tensor_leaves
from . import sim
from .parity import differing_outputs
from .rig import surround_sequence

#: the ritual's frames, the one rejected (camera 0's on two cameras), the
#: one before which the setter runs, and the seed of both generators
FRAMES, REJECTED, SETTER, SEED = 8, 3, 5, 2
#: the pose jump of the rejected frame, metres along x (admission rejects
#: more than 10 m)
JUMP_M = 12.0
#: the detection probability the setter sets
P_SETTER = 0.85


def pattern_label(admitted) -> str:
    """``"10"`` for camera 0 admitted and camera 1 skipped."""
    return "".join("1" if a else "0" for a in admitted)


def some_cameras(n_sensors: int) -> dict:
    """The ritual's frames of ``n_sensors`` cameras that skip some: ritual
    frame -> the cameras admitted.  Camera 0 alone at frame 2 and the last
    camera alone at frame 6 (the two-camera paths' frames) and, from three
    cameras on, every other camera from camera 0 at frame 4 (on a surround
    rig of four, the front and the back camera)."""
    alone = lambda k: tuple(c == k for c in range(n_sensors))  # noqa: E731
    out = {2: alone(0), 6: alone(n_sensors - 1)}
    if n_sensors > 2:
        out[4] = tuple(c % 2 == 0 for c in range(n_sensors))
    return dict(sorted(out.items()))


def sequence(n_frames: int, cfg, n_sensors=None, rig=False) -> list:
    """Frames 0 to ``n_frames - 1`` of the synthetic street (seed 0):
    ``sim.generate_sequence``'s for one camera (``n_sensors`` None); for
    ``n_sensors`` cameras its frame given to every camera (they share its
    cloud and pose, the rule of ``bench.py``'s two-camera cell) or, with
    ``rig``, the frames of ``utils/rig.py``'s surround rig (each camera its
    own cloud), each a frame of ``stack_frames``' form."""
    if rig:
        return [Frame(*f) for f in surround_sequence(n_frames, cfg,
                                                      n_sensors, seed=0)]
    frames = [Frame(*f) for f in sim.generate_sequence(n_frames, cfg, seed=0)]
    if n_sensors is None:
        return frames
    return [stack_frames([f] * n_sensors) for f in frames]


def cameras(frame, admitted):
    """``frame``, a frame of ``len(admitted)`` cameras (``stack_frames``'
    form), with the cameras not ``admitted`` skipped: their quaternions
    NaN, which admission skips alone (a zero quaternion passes its test of
    every component within +-1.001)."""
    if len(frame.quat) != len(admitted):
        raise ValueError(f"a frame of {len(frame.quat)} cameras, "
                         f"{len(admitted)} patterns")
    quat = np.array(frame.quat, np.float32)
    quat[~np.asarray(admitted, bool)] = np.nan
    return frame._replace(quat=quat)


def ritual_frames(frames, n_sensors=None):
    """``(frames, patterns)``: the :data:`FRAMES` frames ``frames`` (of
    ``n_sensors`` cameras each, :func:`sequence`'s) with frame
    :data:`REJECTED` moved :data:`JUMP_M` m along x and, for several
    cameras, the cameras of :func:`some_cameras` skipped
    (:func:`cameras`); ``patterns`` holds the cameras each frame admits."""
    frames = list(frames)
    if len(frames) != FRAMES:
        raise ValueError(f"{len(frames)} frames; the ritual takes {FRAMES}")
    jump = frames[REJECTED]
    frames[REJECTED] = jump._replace(
        sensor_pos=jump.sensor_pos + np.float32([JUMP_M, 0.0, 0.0]))
    if n_sensors is None:
        return frames, [(True,)] * FRAMES
    some = some_cameras(n_sensors)
    patterns = [some.get(k, (True,) * n_sensors) for k in range(FRAMES)]
    return [cameras(f, p) for f, p in zip(frames, patterns)], patterns


def differing_on_card(a: MapState, b: MapState) -> list:
    """The leaves of two states that differ: tensors by their bits (compared
    on their device), the host copies of pose and time and the runtime
    parameters on the host."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    x, y = tensor_leaves(a), tensor_leaves(b)
    differ = [k for k in x if x[k].shape != y[k].shape
              or x[k].dtype != y[k].dtype
              or not torch.equal(bits(x[k]), bits(y[k]))]
    differ += [k for k in HOST_LEAVES
               if np.asarray(getattr(a, k)).tobytes()
               != np.asarray(getattr(b, k)).tobytes()]
    if a.params != b.params:
        differ.append("params")
    return differ


@dataclasses.dataclass
class Turns:
    """What :func:`in_turns` saw: the last states and outputs of both
    steps, the checks that failed, the leaves and outputs that differed
    after each frame, by pattern label the launches and host ms of the
    call that captured it, the host launches of each replay, and the
    host ms of both steps on each frame of every camera after its
    pattern's capture."""
    a: MapState
    b: MapState
    out_a: object = None
    out_b: object = None
    failed: list = dataclasses.field(default_factory=list)
    bits: list = dataclasses.field(default_factory=list)
    capture_launches: dict = dataclasses.field(default_factory=dict)
    capture_call_ms: dict = dataclasses.field(default_factory=dict)
    replay_launches: list = dataclasses.field(default_factory=list)
    eager_ms: list = dataclasses.field(default_factory=list)
    graphed_ms: list = dataclasses.field(default_factory=list)


def in_turns(eager, graphed, a, b, frames, patterns, *, together=None,
             after_eager=None, at_setter=None) -> Turns:
    """The ritual's frames (:func:`ritual_frames`) through ``eager`` from
    state ``a`` and through its graphed form ``graphed`` (``captures`` a
    pattern seen) from ``b``, frame by frame; ``a`` and ``b`` hold equal
    states and two equal generators, from which each step draws.  Before
    each timed call runs ``together()`` (a sync of the card by default; a
    mesh's ranks meet there too); after the eager call of an accepted
    frame, outside the timed span, ``after_eager(k, frame, state,
    output)``; with the setter, ``at_setter()``.  The host clock of each
    call ends in ``torch.cuda.synchronize()``."""
    together = together or torch.cuda.synchronize
    t = Turns(a, b)

    def require(cond, what):
        if not cond:
            t.failed.append(what)

    for k, frame in enumerate(frames):
        if k == SETTER:
            t.a = set_detection_probability(t.a, P_SETTER)
            t.b = set_detection_probability(t.b, P_SETTER)
            if at_setter is not None:
                at_setter()
        together()
        t0 = time.perf_counter()
        t.a, t.out_a = eager(t.a, frame)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        accepted = bool(t.out_a.accepted)
        if accepted and after_eager is not None:
            after_eager(k, frame, t.a, t.out_a)
        together()
        kernels.reset_launch_counts()
        t2 = time.perf_counter()
        t.b, t.out_b = graphed(t.b, frame)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launched = dict(kernels.LAUNCHES)
        require(accepted == (k != REJECTED), f"frame {k}: accepted {accepted}")
        label = pattern_label(patterns[k])
        if accepted and label not in t.capture_launches:
            t.capture_launches[label] = launched
            t.capture_call_ms[label] = (t3 - t2) * 1e3
        elif accepted:
            t.replay_launches.append(sum(launched.values()))
            if all(patterns[k]):
                t.eager_ms.append((t1 - t0) * 1e3)
                t.graphed_ms.append((t3 - t2) * 1e3)
        differ = differing_on_card(t.a, t.b)
        if not torch.equal(t.a.gen.get_state(), t.b.gen.get_state()):
            differ.append("gen")
        if accepted:
            differ += differing_outputs(t.out_a, t.out_b)
        t.bits.append(differ)
        require(not differ, f"frame {k}: graphed against eager differ in "
                f"{differ}")
    want = len(set(patterns))
    require(graphed.captures == len(t.capture_launches) == want,
            f"{graphed.captures} captures, {want} patterns")
    require(not any(t.replay_launches),
            f"host launches during replays {t.replay_launches}")
    return t


def busy(fn) -> dict:
    """One call of ``fn`` under the profiler: the card's busy ms (the sum of
    its device events) and their count, the NCCL kernels' ms and count, and
    ``own_kernels``: the launches and device µs of each of the port's own
    kernels that ran (``stage_times.own_kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    from .stage_times import own_kernels

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in device if "nccl" in e.name.lower()]
    return dict(device_busy_ms=sum(e.device_time_total for e in device) / 1e3,
                device_events=len(device),
                nccl_ms=sum(e.device_time_total for e in nccl) / 1e3,
                nccl_kernels=len(nccl), own_kernels=own_kernels(device))
