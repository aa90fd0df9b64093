"""One step on the card held against the same step on the CPU.

The updated weights and the newborn weight ``w_b * sum 1/C(z)`` of a card
step and of a CPU step differ in their last bits (the CPU's pair passes
use the ``|a|^2 + |b|^2 - 2ab`` form, the kernels coordinate
differences): the newborn weight's last bit decides which copies survive
the resample of voxels full of equal-weight newborns, and an updated weight
on the other side of the cull threshold reorders the compact layout's
sorted rows.  So a CPU step is held to a card step given the card's
update: :func:`updates_recorded` keeps the particles and ``norm_coeff``
that each ``measurement_update`` of the card step returns, and
:func:`updates_pinned` hands them, in the same order, to the CPU step in
place of its own, so that the comparison holds birth and occupancy alone.
:func:`agreement` measures the two results, which
:func:`missed_bars` holds to :data:`PINNED_BARS` (or to
:func:`free_bars` where the CPU step keeps its own update).
:func:`placed_alike` reads the compact layout's population by voxel, and
:func:`rows_parted` where two such populations part, row by row;
:func:`particles_recorded` keeps the particles that given stages of a step
take in, so that the rows can be compared stage by stage;
:func:`differing_leaves` compares two states bit for bit and
:func:`differing_outputs` two step outputs; :func:`counters_recorded`
adds up what a step's budgets dropped.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import geometry
from ..models import pipeline
from ..ops.common import padded_buffer
from ..state import FLAG_DEAD, state_to_numpy

#: the bars of a card step against a CPU step given the card's update:
#: the least shares of equal particle flags and of ``weight_sum`` and the
#: future grid within rtol 1e-4, and the most relative alive difference
PINNED_BARS = dict(flags_equal=0.999, weight_sum_close=0.999,
                   future_close=0.999, alive_rel=0.005)


@contextlib.contextmanager
def _stage_wrapped(name, wrap):
    stage = getattr(pipeline, name)
    setattr(pipeline, name, wrap(stage))
    try:
        yield
    finally:
        setattr(pipeline, name, stage)


def updates_recorded(sink: list):
    """Within the block, each ``measurement_update`` of a step appends a
    copy of its particles and ``norm_coeff`` to ``sink`` (one a sensor, in
    sensor order)."""
    def wrap(update):
        def recorded(*a, **kw):
            p, norm_coeff, stats = update(*a, **kw)
            sink.append((p.clone(), norm_coeff.clone()))
            return p, norm_coeff, stats
        return recorded
    return _stage_wrapped("measurement_update", wrap)


def updates_pinned(pending: list):
    """Within the block, each ``measurement_update`` of a step runs, then
    returns the next particles and ``norm_coeff`` of ``pending`` (removed
    from it), moved to the step's device, in place of its own; its
    counters stay its own.  Birth takes that ``norm_coeff``.  A plane the
    update returns as a working buffer (``ops/common.py::padded_buffer``)
    takes the pinned plane in place, so that the later stages write into
    it as they would."""
    def wrap(update):
        def pinned(*a, **kw):
            p, norm_coeff, stats = update(*a, **kw)
            q, nc = pending.pop(0)
            planes = {}
            for f in dataclasses.fields(p):
                mine = getattr(p, f.name)
                theirs = getattr(q, f.name).to(mine.device)
                if padded_buffer(mine) is not None:
                    mine.copy_(theirs)
                else:
                    planes[f.name] = theirs
            return (dataclasses.replace(p, **planes),
                    nc.to(norm_coeff.device), stats)
        return pinned
    return _stage_wrapped("measurement_update", wrap)


@contextlib.contextmanager
def particles_recorded(names, sink: dict):
    """Within the block, each call of a stage of ``models/pipeline.py``
    named in ``names`` appends a copy of the particles it takes (its first
    argument) to ``sink[name]``."""
    def wrap(name):
        def outer(stage):
            def recorded(p, *a, **kw):
                sink.setdefault(name, []).append(p.clone())
                return stage(p, *a, **kw)
            return recorded
        return outer

    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(_stage_wrapped(name, wrap(name)))
        yield


#: the stages of ``models/pipeline.py`` that count what a budget drops
COUNTING_STAGES = ("rebin", "rebin_compact", "rebin_exchange_compact",
                   "rebin_and_register", "register_fov",
                   "register_fov_compact", "measurement_update",
                   "particle_birth", "particle_birth_compact",
                   "occupancy_and_resample", "occupancy_compact")


@contextlib.contextmanager
def counters_recorded(sink: dict):
    """Within the block, each counter of what a budget dropped (a stage's
    counter with ``overflow`` or ``killed`` in its name) that a stage of
    :data:`COUNTING_STAGES` returns is added to ``sink[name]`` (a 0-d tensor
    on the step's device), summed over the stages and the cameras.  A stage
    that the step calls with ``with_metrics=False`` (the two-camera step's
    per-camera stages) counts for the sink alone: the step gets the empty
    counters it asked for.  On a rank of the sharded step the counters are
    the rank's."""
    def wrap(stage):
        def counted(*a, **kw):
            asked = kw.get("with_metrics", True)
            if "with_metrics" in kw:
                kw = dict(kw, with_metrics=True)
            out = stage(*a, **kw)
            for k, v in out[-1].items():
                if "overflow" in k or "killed" in k:
                    sink[k] = sink.get(k, 0) + v
            return out if asked else (*out[:-1], {})
        return counted

    with contextlib.ExitStack() as stack:
        for name in COUNTING_STAGES:
            stack.enter_context(_stage_wrapped(name, wrap))
        yield


def agreement(card, cpu) -> dict:
    """The measures of one step's result on the card against the CPU's:
    ``(state, StepOutput)`` pairs, the second on the CPU.  The share of
    equal particle flags, the alive counts and their relative difference,
    the shares of ``weight_sum`` and of the future grid within rtol 1e-4
    (atol 1e-7 and 1e-6), and the share of the future grid equal bit for
    bit."""
    (g_state, g_out), (c_state, c_out) = card, cpu
    close = lambda a, b, atol: float(torch.isclose(  # noqa: E731
        a.cpu(), b, rtol=1e-4, atol=atol).float().mean())
    ga, ca = int(g_out.metrics["alive"]), int(c_out.metrics["alive"])
    return dict(
        flags_equal=float((g_state.particles.flags.cpu()
                           == c_state.particles.flags).float().mean()),
        alive_card=ga, alive_cpu=ca, alive_rel=abs(ga - ca) / max(ca, 1),
        weight_sum_close=close(g_state.weight_sum, c_state.weight_sum, 1e-7),
        future_close=close(g_state.future, c_state.future, 1e-6),
        future_bit_equal=float((g_state.future.cpu().view(torch.int32)
                                == c_state.future.view(torch.int32))
                               .float().mean()))


def free_bars(cfg) -> dict:
    """The bars of a card step against a CPU step that keeps its own
    newborn weight: alive within 2%, and in the compact layout, whose flags
    are compared over the live array's rows rather than over mostly empty
    pool slots, flags on 99.5%."""
    return dict(PINNED_BARS, alive_rel=0.02,
                flags_equal=0.995 if cfg.layout == "compact" else 0.999)


def missed_bars(m: dict, bars: dict = PINNED_BARS) -> list:
    """The names of the bars that :func:`agreement`'s measures ``m`` miss
    (``alive_rel`` is a most, every other bar a least)."""
    return [k for k, bar in bars.items()
            if (m[k] > bar if k == "alive_rel" else m[k] < bar)]


def placed_alike(card, cpu, cfg) -> float:
    """The share of ``cpu``'s particles (a ``Particles``) that ``card``
    places in the same voxels: one minus the summed per-voxel count
    differences over ``cpu``'s alive count."""
    def counts(p):
        cell = geometry.storage_index_planar(*geometry.world_voxel_planar(
            p.px, p.py, p.pz, cfg), cfg)
        return torch.bincount(cell[p.flags != 0].long(),
                              minlength=cfg.storage_voxels).cpu()

    a, b = counts(card), counts(cpu)
    return 1.0 - int((a - b).abs().sum()) / max(int(b.sum()), 1)


def rows_parted(card, cpu, cfg, most: int = 8) -> dict:
    """Where two compact populations (``Particles`` of ``[P]`` rows, the
    first on any device) part, row by row:

    * ``rows_differing``: the rows whose flags differ, with the first and
      the last of them (None if none);
    * ``card_only`` / ``cpu_only``: the rows alive on one side only;
    * ``cell_differing``: the rows alive on both whose cells differ (a
      shift of the rows), and ``payload_differing``: those alive on both in
      the same cell whose position, velocity or weight differs in any bit;
    * ``cull_differing``: the rows alive on both that the cull of
      ``occupancy_compact`` (weight below ``cfg.weight_cull_threshold``)
      takes on one side only, the first ``most`` of them in ``cull_rows``
      as ``[row, cell, card weight, CPU weight]``: such a row sorts to the
      tail on one side only, so every later row of the sorted view moves;
    * ``cells_off``: the cells whose alive counts differ, ``[cell, card
      count, CPU count, card's first row, CPU's first row]`` (-1 where a
      side holds none), the first ``most`` in row order, and their number
      ``n_cells_off``.
    """
    def rows(p):
        flags = p.flags.cpu().numpy()
        cell = geometry.storage_index_planar(*geometry.world_voxel_planar(
            p.px, p.py, p.pz, cfg), cfg).cpu().numpy().astype(np.int64)
        pay = np.stack([getattr(p, n).cpu().numpy().view(np.int32) for n in
                        ("px", "py", "pz", "vx", "vy", "vz", "weight")])
        return flags, np.where(flags != FLAG_DEAD, cell, -1), pay

    (fa, ca, pa), (fb, cb, pb) = rows(card), rows(cpu)
    differ = np.flatnonzero(fa != fb)
    both = (ca >= 0) & (cb >= 0)
    wa, wb = pa[6].view(np.float32), pb[6].view(np.float32)
    thr = np.float32(cfg.weight_cull_threshold)
    cull = np.flatnonzero(both & ((wa < thr) != (wb < thr)))
    na = np.bincount(ca[ca >= 0], minlength=cfg.storage_voxels)
    nb = np.bincount(cb[cb >= 0], minlength=cfg.storage_voxels)
    off = np.flatnonzero(na != nb)

    def first_rows(cell):
        u, at = np.unique(cell, return_index=True)
        found = dict(zip(u.tolist(), at.tolist()))
        return [found.get(int(v), -1) for v in off]

    cells = sorted(([int(v), int(na[v]), int(nb[v]), x, y] for v, x, y in
                    zip(off, first_rows(ca), first_rows(cb))),
                   key=lambda r: min(x for x in r[3:] if x >= 0))
    return dict(
        rows_differing=int(len(differ)),
        first_differing_row=int(differ[0]) if len(differ) else None,
        last_differing_row=int(differ[-1]) if len(differ) else None,
        card_only=int(((ca >= 0) & (cb < 0)).sum()),
        cpu_only=int(((ca < 0) & (cb >= 0)).sum()),
        cell_differing=int((both & (ca != cb)).sum()),
        payload_differing=int((both & (ca == cb)
                               & (pa != pb).any(0)).sum()),
        cull_differing=int(len(cull)),
        cull_rows=[[int(r), int(ca[r]), float(wa[r]), float(wb[r])]
                   for r in cull[:most]],
        cells_off=cells[:most], n_cells_off=int(len(off)))


def leaves(state) -> dict:
    """Every leaf of a state as numpy, by its path in the JAX state."""
    out = {}
    for key, value in state_to_numpy(state).items():
        if isinstance(value, dict):
            out.update({f"{key}.{k}": np.asarray(v) for k, v in value.items()})
        else:
            out[key] = np.asarray(value)
    return out


def differing_leaves(a, b) -> list:
    """The leaves in which two states differ, by bits, shape or dtype (a
    leaf of one state only among them)."""
    x, y = leaves(a), leaves(b)
    return sorted(k for k in x.keys() | y.keys()
                  if k not in x or k not in y or x[k].dtype != y[k].dtype
                  or x[k].shape != y[k].shape
                  or x[k].tobytes() != y[k].tobytes())


def differing_outputs(a, b) -> list:
    """The fields of two ``StepOutput``s that differ by bits (a field of
    one output only among them)."""
    def fields(out):
        got = {"accepted": np.asarray(out.accepted),
               "weight_sum": out.weight_sum.cpu().numpy()}
        got.update({f"metrics.{k}": v.cpu().numpy()
                    for k, v in out.metrics.items()})
        got.update({f"estimator_cloud.{i}": v.cpu().numpy()
                    for i, v in enumerate(out.estimator_cloud)})
        return got

    x, y = fields(a), fields(b)
    return sorted(k for k in x.keys() | y.keys()
                  if k not in x or k not in y or x[k].dtype != y[k].dtype
                  or x[k].tobytes() != y[k].tobytes())
