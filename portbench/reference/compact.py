"""The compact layout's reference: one frame of the map in plain NumPy with
the particles in ``[P]`` rows, written from the layout's semantics (the
JAX package's ``ops/compact.py`` and the compact arms of its
``models/pipeline.py``, read as the specification) and independent of the
program under test.  A configuration names it with ``"reference":
"compact"`` in its file.

The per-voxel semantics are those of the pool layout (:mod:`.dsp`); what
the layout adds is where a particle lives and in what order the rows are
walked, each defined once below:

* the rows (:func:`rows`): the state's ``[P]`` planes, a row alive where
  its flag is not 0, in the order the state holds them;
* the storage cell (:func:`cell`): derived from the row's world position
  (coordinates times ``1 / resolution``, toroidal), so a particle that
  moves changes its cell and never its row;
* survival in a full voxel (:func:`rebin`): a voxel holds ``S`` particles;
  the rows that stay in their voxel keep their claim, the movers rank
  behind them in row order, the newborns (:func:`insert`) behind the
  voxel's alive rows in the order of the frame's points;
* the pyramid kill (:func:`register`): the compacted in-FOV rows grouped by
  pyramid in row order, those ranked at or over the pyramid's capacity
  killed;
* the resample walk (:func:`occupancy`): over the alive rows sorted by
  cell, in row order inside a voxel;
* the output (:func:`occupancy`): defragmented, the rows sorted by cell
  (dead rows last) with the resample's copies in the first holes;
* the row budget ``P``: the newborns land in the free rows first to last
  and the copies in the holes first to last, each "the first ``n`` in the
  defined order";
* the future (:func:`occupancy`, through :func:`.dsp.future`): the old
  particles' weight at each of the ``T`` horizons;
* the readout (:func:`.dsp.readout`): over ``voxel_num``.

The other processing budgets (FOV buffer, update spill tier, movers,
future movers) are applied as :mod:`.dsp` applies them.  Every float is
float32, as the configuration states; the resample's in-voxel walk adds
in the order the specification gives it (:func:`walk_sums`); every other
sum that the semantics leave unordered is taken in float64 and rounded
once.  The
layout-free stages (projection, clustering, assignment, the estimate, the
likelihood and the update, the newborn table) are :mod:`.dsp`'s.

Scope: limit-xy constant-velocity prediction, one camera or several
(prediction and rebin once, then each camera's FOV registration, update
and birth in turn).  The control is :mod:`.step`'s: the reference in
bfloat16 with the clustering's Gram product on TF32.
"""

from __future__ import annotations

import types

import numpy as np

from . import dsp, step as plain

F32 = dsp.F32
DEAD, VALID, NEWBORN = dsp.DEAD, dsp.VALID, dsp.NEWBORN


def config(values: dict) -> types.SimpleNamespace:
    """The configuration's values and sizes, with ``P`` the rows."""
    c = dsp.derive(values)
    if c.layout != "compact" or not c.limit_motion_to_xy_plane or (
            c.motion_model != "constant_velocity"):
        raise ValueError("the compact reference covers the compact layout "
                         "with limit-xy constant-velocity prediction only")
    c.P = (c.particle_capacity if c.particle_capacity is not None
           else min(c.S * c.V, 1 << 16))
    return c


def shapes(c) -> dict:
    return plain.shapes(c, "compact", c.P)


def init_tree(c, cameras: int, sensor_pos):
    """A fresh map centred at ``sensor_pos``: ``P`` dead rows."""
    return dsp.init_tree(c, cameras, sensor_pos, rows=c.P)


def run(c, cameras: int, tree, frame, draws, threshold: float,
        control: bool = False):
    """:func:`.step.run` with this layout's frame."""
    return plain.run_with(step, c, tree, frame, draws, threshold, control)


# ------------------------------------------------------------- the rows

def rows(tree) -> dict:
    """The ``[P]`` rows as the state holds them: one plane a field, row
    ``i`` of every plane one particle, alive where ``flags != 0``, in the
    state's order (copied)."""
    return dsp.planes(tree)


def cell(R, c):
    """Each row's storage cell, derived from its world position."""
    return dsp.cell_of(*dsp.voxel_of_mul(R["px"], R["py"], R["pz"], c), c)


def per_cell(cells, values, c):
    """Sums of ``values`` over the rows of each of the ``V`` cells, taken
    in float64 and rounded once."""
    return np.bincount(cells, weights=np.asarray(values, np.float64),
                       minlength=c.V).astype(F32)


# ------------------------------------------------ prediction and rebin

def sweep(R, c, dt, origin, pos, quat):
    """The limit-xy advance of the alive rows, the window test (rows that
    leave die) and each row's new cell, whether it moved to another cell,
    and its pyramid and FOV flag from the camera at ``pos``."""
    R["vz"] = np.zeros_like(R["vz"])
    valid = R["flags"] != DEAD
    old_cell = cell(R, c)
    for a in ("x", "y", "z"):
        R["p" + a] = np.where(valid, R["p" + a] + R["v" + a] * dt,
                              R["p" + a]).astype(F32)
    wx, wy, wz = dsp.voxel_of_mul(R["px"], R["py"], R["pz"], c)
    alive = valid & dsp.inside(wx, wy, wz, origin, c)
    R["flags"] = np.where(valid & ~alive, DEAD, R["flags"]).astype(np.int32)
    new_cell = dsp.cell_of(wx, wy, wz, c)
    pyr, fov = geometry(R, pos, quat, c)
    return types.SimpleNamespace(cell=new_cell,
                                 mover=alive & (new_cell != old_cell),
                                 pyr=pyr, fov=fov & alive)


def geometry(R, pos, quat, c):
    """``(pyramid, in FOV)`` of every row from the camera at ``pos``."""
    R_ = dsp.conj_matrix(quat)
    return dsp.pyramid(*dsp.to_sensor(R_, R["px"], R["py"], R["pz"], pos),
                       c)


def rebin(R, sw, c):
    """Survival in a full voxel: the stayers keep their claim; the movers,
    the first ``mover_capacity`` in row order (the others die), rank
    behind the stayers of their new voxel in row order and die at rank
    ``S`` or over."""
    alive = R["flags"] != DEAD
    stay = np.bincount(sw.cell[alive & ~sw.mover], minlength=c.V)
    movers = np.flatnonzero(sw.mover & alive)
    R["flags"][movers[c.mover_capacity:]] = DEAD
    movers = movers[:c.mover_capacity]
    dest = sw.cell[movers]
    full = stay[dest] + dsp.ranks_by_key(dest) >= c.S
    R["flags"][movers[full]] = DEAD


# ------------------------------------------------------ FOV and update

def register(R, pyr, fov, pos, c):
    """FOV registration: the alive in-FOV rows, the first ``fov_cap`` in
    row order, grouped by pyramid in that order; the rows ranked at or over
    the pyramid's capacity die, the others are the update's (dense tier,
    then the spill tier in the grouped order)."""
    cand = dsp.first(fov & (R["flags"] != DEAD), c.fov_cap)
    cand = cand[np.argsort(pyr[cand], kind="stable")]
    g = pyr[cand]
    rank = dsp.ranks_by_key(g)
    R["flags"][cand[rank >= c.pyr_slots]] = DEAD
    p = np.stack([R["px"][cand], R["py"][cand], R["pz"][cand]], 1)
    return dsp.registered(cand, p, R["weight"][cand], g, rank,
                          np.ones(len(cand), bool), pos, c)


# ------------------------------------------------------------- birth

def birth(R, obs_world, est, norm, origin, draws, c):
    """Newborns with the Dempster-Shafer arbitration against the classes'
    weights of the alive rows in their voxel, inserted behind the voxel's
    alive rows (:func:`insert`)."""
    w_new = F32(F32(c.newborn_particle_weight) * norm)
    ok, pcell = dsp.birth_cells(obs_world, est[2], origin, c)
    fl = R["flags"]
    alive = fl != DEAD
    considered = alive & (fl != NEWBORN)
    l1 = F32(0) + np.abs(R["vx"]) + np.abs(R["vy"])
    wc = np.where(considered, R["weight"], F32(0)).astype(F32)
    rc = cell(R, c)[alive]
    ws_v = per_cell(rc, np.where(l1 < F32(0.1), wc, F32(0))[alive], c)
    wm_v = per_cell(rc, np.where((l1 >= F32(0.1)) & (l1 < F32(0.5)), wc,
                                 F32(0))[alive], c)
    wd_v = per_cell(rc, np.where(l1 >= F32(0.5), wc, F32(0))[alive], c)
    ws = np.where(ok, ws_v[pcell], F32(0))
    wm = np.where(ok, wm_v[pcell], F32(0))
    wd = np.where(ok, wd_v[pcell], F32(0))
    pos, vel, cand_ok, dest = dsp.newborns(obs_world, est, ok, ws, wm, wd,
                                           draws, origin, c)
    insert(R, pos, vel, w_new, cand_ok, dest, np.bincount(rc, minlength=c.V),
           c)


def insert(R, pos, vel, w, ok, dest, count, c):
    """The newborns into free rows: a candidate ranks among those bound
    for its voxel in candidate order and may land while its rank is under
    the voxel's free slots (``S`` less ``count``, its alive rows); those
    that may land, ordered by voxel and then candidate, take the free rows
    first to last, and the row budget drops the rest."""
    idx = np.flatnonzero(ok)
    room = np.maximum(c.S - count[dest[idx]], 0)
    idx = idx[dsp.ranks_by_key(dest[idx]) < room]
    idx = idx[np.argsort(dest[idx], kind="stable")]
    free = np.flatnonzero(R["flags"] == DEAD)
    n = min(len(idx), len(free))
    idx, to = idx[:n], free[:n]
    dsp.write(R, to, pos[idx], vel[idx], np.full(n, w, F32), NEWBORN)


# --------------------------------------------- occupancy and resample

def walk_sums(w, start, max_run: int):
    """Each row's cumulative weight over the rows of its voxel up to it, in
    the order the layout's specification adds them (``_seg_cumsum``): a
    segmented doubling scan, a row adding in turn the sum of the 1, 2, 4,
    ... rows before it in its voxel, in float32.  The order matters: a
    voxel of equal weights (a frame's newborns) puts the resample's comb
    points on ties, and the side of a tie a copy falls on turns on it.
    ``start`` marks each voxel's first row; a voxel holds at most
    ``max_run`` rows."""
    s, b = w.astype(F32), start.copy()
    d = 1
    while d < max_run:
        ps = np.concatenate([np.zeros(d, F32), s[:-d]])[:len(s)]
        pb = np.concatenate([np.ones(d, bool), b[:-d]])[:len(b)]
        s = np.where(b, s, (s + ps).astype(F32))
        b = b | pb
        d *= 2
    return s


def occupancy(R, fut_in, origin, c):
    """Cull, the voxels' aggregates, the future and the systematic resample
    over the alive rows sorted by cell (row order inside a voxel); returns
    the defragmented rows, ``weight_sum``, ``vel_avg`` and the future."""
    fl, w = R["flags"], R["weight"]
    valid = (fl != DEAD) & (w >= F32(c.weight_cull_threshold))
    old = valid & (fl != NEWBORN)
    moving = old & ((R["vx"] != 0) | (R["vy"] != 0) | (R["vz"] != 0))
    cells = cell(R, c)

    # the sorted view: alive rows grouped by cell in row order, dead last
    order = np.argsort(np.where(valid, cells, c.V), kind="stable")
    n_alive = int(valid.sum())
    s = order[:n_alive]
    key = cells[s]
    start = np.ones(n_alive, bool)
    start[1:] = key[1:] != key[:-1]
    run = np.cumsum(start) - 1  # each sorted row's voxel run
    first_row = np.flatnonzero(start)
    n = np.bincount(run)[run]  # its voxel's alive rows

    # the walk: each row's cumulative weight in its voxel
    ws_ = w[s]
    hi = walk_sums(ws_, start, 2 * c.S)
    last = np.append(first_row[1:], n_alive) - 1
    tot = hi[last][run]  # the voxel's weight, the walk's end

    weight_sum = np.zeros(c.V, F32)
    weight_sum[key[start]] = hi[last]
    oc = cells[old]
    n_old = np.bincount(oc, minlength=c.V).astype(F32)
    denom = np.maximum(n_old, F32(1))
    vel_avg = (np.stack([per_cell(oc, R[f][old], c) / denom
                         for f in ("vx", "vy", "vz")], -1)
               * (n_old > 0)[:, None]).astype(F32)
    static_w = per_cell(cells[old & ~moving], w[old & ~moving], c)
    fm = dsp.first(moving, c.mover_capacity)
    fut = dsp.future(fut_in, static_w, R, fm, np.ones(len(fm), bool),
                     origin, c)

    # the resample (dsp_dynamic.h:975-1057) on the walk
    do_rs = n >= c.resample_min_count
    n_target = np.minimum(n, c.max_particles_per_voxel)
    wa = np.where(do_rs, tot / np.maximum(n_target, 1).astype(F32),
                  F32(1)).astype(F32)
    lo = (hi - ws_).astype(F32)

    def n_grid(x):  # comb points wa * (k + 1/2) strictly below x
        return np.maximum(np.ceil(x / wa - F32(0.5)), F32(0)).astype(np.int64)

    copies = np.where(do_rs, n_grid(hi) - n_grid(lo), 0)
    kept = do_rs & (copies >= 1)
    dropped = do_rs & (copies == 0)
    extra = np.maximum(copies - 1, 0)
    before = np.cumsum(extra) - extra  # extra demand before the row ...
    before -= (np.cumsum(extra) - extra)[first_row][run]  # ... in its voxel
    free = np.maximum(c.S - n + np.bincount(run, dropped)[run], 0)
    placed = np.clip(free - before, 0, extra).astype(np.int64)
    new_w = np.where(kept, wa * (F32(1) + (extra - placed).astype(F32)),
                     ws_).astype(F32)

    # the defragmented output: the sorted view, the survivors' weights,
    # the copies in the first holes (the row budget of the copies)
    out = {f: R[f][order].copy() for f in dsp.PLANES if f != "t"}
    out["t"] = R["t"]
    live = np.zeros(c.P, bool)
    live[:n_alive] = ~dropped
    out["flags"] = live.astype(np.int32)
    out["weight"] = np.zeros(c.P, F32)
    out["weight"][:n_alive] = np.where(dropped, F32(0), new_w)
    src = np.repeat(np.arange(n_alive), placed)
    holes = np.flatnonzero(~live)[:min(c.mover_capacity, c.P)]
    m = min(len(src), len(holes))
    src, holes = src[:m], holes[:m]
    for f in ("px", "py", "pz", "vx", "vy", "vz"):
        out[f][holes] = out[f][src]
    out["weight"][holes] = wa[src]
    out["flags"][holes] = VALID
    return out, weight_sum, vel_avg, fut


# ------------------------------------------------------------- the frame

def step(tree, frame, draws, c, tf32=False):
    """One frame from the state ``tree`` (as :func:`.dsp.step` takes it,
    with ``[P]`` particle planes): the state after it."""
    points, n_pts, pos, quat, t = (np.asarray(x) for x in frame)
    cams = points.shape[0]
    f = dsp.admit(tree, pos, quat, t, c)
    if f is None:
        return tree
    R = rows(tree)
    sw = sweep(R, c, f.dt, f.origin, pos[0], quat[0])
    rebin(R, sw, c)
    if cams == 1:
        per, d_of = [tree.estimator], [draws]
    else:
        per, d_of = dsp.tracks(tree.estimator, cams), list(draws[1])
    for i in range(cams):
        if not f.q_ok[i]:
            continue
        obs, expected, est_out, per[i] = dsp._camera(
            points[i].astype(F32), int(n_pts[i]), pos[i], quat[i], per[i],
            f.dt, d_of[i][0], c, tf32)
        pyr, fov = ((sw.pyr, sw.fov) if cams == 1
                    else geometry(R, pos[i], quat[i], c))
        upd = register(R, pyr, fov, pos[i], c)
        R["weight"], norm = dsp.update(R["weight"], upd, obs, expected, c)
        birth(R, obs.world, est_out, norm, f.origin, d_of[i], c)
    estimator = per[0] if cams == 1 else dsp.stack_tracks(per)
    out, weight_sum, vel_avg, fut = occupancy(R, tree.future, f.origin, c)
    return dsp.after(tree, f, pos, out, weight_sum, vel_avg, fut, estimator)
