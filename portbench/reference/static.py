"""The static map's reference: one frame of upstream's Type-I map
(``include/dsp_static.h``) in plain NumPy on the CPU, in float32, written
from its per-frame semantics -- the JAX package's static branches and the
dynamic reference :mod:`.dsp`, read as the specification -- and
independent of the program under test.  A configuration names it with
``"reference": "static"`` in its file.

It imports nothing of JAX, of the JAX package, of the port or of PyTorch:
like every reference of the benchmark it is NumPy and the standard
library, so no matrix product can fall to TF32.  Of :mod:`.dsp` it takes
only :func:`.dsp.derive`, the sizes that follow from a configuration's
values, and :func:`.dsp.to_bf16`, the control's rounding.  Every stage is
defined once below:

* admission (:func:`admit`): a valid quaternion, a pose jump within 10 m
  and a time step within [0, 10] s, or the frame is rejected and the state
  kept;
* the window and the zero-velocity prediction (:func:`register`): the
  velocities set to zero (st:640-646), so no particle advances; the window
  follows the sensor and a particle outside it dies;
* FOV registration (:func:`register`): one candidate buffer in flat order
  (the first ``fov_cap`` particles that changed voxel or lie in the FOV),
  the movers (a newborn's voxel is taken by division, the window's by
  multiplication, so one at a voxel's face can change voxel) relocated
  into the first empty slots of their new voxels, the FOV particles
  ranked by pyramid in the buffer's order, those at or over the pyramid
  capacity killed;
* the update (:func:`update`): the SMC-PHD pair sums over each pyramid's
  3x3 neighbourhood, the dense tier (rank under ``dense_slots``) and the
  first ``particle_spill_capacity`` of the spill tier in one sum, since
  the two tiers are one arithmetic; a particle beyond its pyramid's
  farthest point by more than the occlusion slack (the voxel size, st:744)
  keeps its weight;
* birth (:func:`birth`): no estimator (st:1285-1309: every point static
  with v = 0), ``n_b`` newborns a point in the point's window voxel, each
  at the point plus the position noise, all with v = 0 (st:804-824), into
  the first empty slots of their voxels in point-major order;
* occupancy and the resample (:func:`occupancy`): the cull, the per-voxel
  walk over the slots in slot order, the systematic resample;
* the future (:func:`future`): every particle is static, so each of the
  ``T`` horizons holds the voxel's old particles' weight;
* the readout (:func:`readout`): the map in the window's own voxel order.

Departures from upstream, each as the repository specifies them for its
ports: a world-aligned toroidal window of ``S`` slots a voxel stored
``[S, V]``; birth classifies every point against the pool before the
frame's births; the processing budgets (FOV buffer, movers, spill tier,
observation tiers) are part of the result, each as "the first ``n`` in the
defined order"; the newborn static floor of 0.2 (st:791) picks how many of
a point's newborns are static in the dynamic model and changes nothing
here, where all of them are.  Sums that the semantics leave unordered are
taken in float64 and rounded once; the slot walk adds in float32 in slot
order.

The random numbers come in as the harness's draws, ``(fresh, noise_p,
noise_v, noise_u)``; with the estimator off only ``noise_p`` ``[P, n_b,
3]``, standard normal, is read.  One camera.  With ``control=True``
:func:`run` computes the same with every float32 value of the state, the
frame's points and the draws, and of what the frame returns, rounded to
bfloat16: a program that computed so must come out not correct.
"""

from __future__ import annotations

import math
import types

import numpy as np

from .dsp import derive, to_bf16

F32 = np.float32
I64 = np.int64
DEAD, VALID, NEWBORN = 0, 1, 3
PLANES = ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")
VEL = ("vx", "vy", "vz")


def _f(x) -> np.float32:
    """A float32 constant, rounded once from ``x``."""
    return F32(x)


#: ``(1/sqrt(pi))^3``: the reference's standard-normal product without the
#: ``1/sigma`` factor (dsp_dynamic.h:1282-1301)
PDF3 = _f((1.0 / math.sqrt(math.pi)) ** 3)


def config(values: dict) -> types.SimpleNamespace:
    """The configuration's values (a configuration file's ``config``) and
    the sizes that follow from them."""
    c = derive(values)
    if (c.layout != "pool" or c.motion_model != "static"
            or c.estimator_enabled):
        raise ValueError("the static reference covers the pool layout's "
                         "static model with the estimator off")
    return c


def shapes(c) -> dict:
    """The sizes a configuration file's ``shapes`` states."""
    return {"storage_voxels": c.V, "slots_per_voxel": c.S,
            "n_pyramids": c.n_pyr, "layout": "pool", "compact_capacity": None,
            "max_input_points": c.max_input_points, "n_horizons": c.T}


# ---------------------------------------------------------------- geometry

def _sq(x: np.ndarray) -> np.ndarray:
    """``|x|^2`` over the last axis of length 3, added left to right."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def window_origin(pos, c) -> np.ndarray:
    """The window's low corner in world voxels, the sensor at its centre."""
    half = np.asarray(c.half_extent, F32)
    return np.floor((np.asarray(pos, F32) - half)
                    / _f(c.voxel_resolution) + _f(0.5)).astype(I64)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``q * v * q^-1`` for a unit quaternion ``q`` (wxyz), vectors
    ``v [..., 3]``."""
    w, u = q[0], q[1:]
    t = _f(2.0) * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def conj_matrix(q) -> list:
    """The rotation matrix of the conjugate of ``q`` (world to sensor), as
    float32 values."""
    w, x, y, z = _f(q[0]), _f(-q[1]), _f(-q[2]), _f(-q[3])
    one, two = _f(1), _f(2)
    return [[one - two * (y * y + z * z), two * (x * y - w * z),
             two * (x * z + w * y)],
            [two * (x * y + w * z), one - two * (x * x + z * z),
             two * (y * z - w * x)],
            [two * (x * z - w * y), two * (y * z + w * x),
             one - two * (x * x + y * y)]]


def to_sensor(R, px, py, pz, pos):
    """World coordinates in the sensor's frame."""
    ex, ey, ez = px - _f(pos[0]), py - _f(pos[1]), pz - _f(pos[2])
    return tuple(_f(R[i][0]) * ex + _f(R[i][1]) * ey + _f(R[i][2]) * ez
                 for i in range(3))


def pyramid(sx, sy, sz, c):
    """``(pyramid cell, in FOV)`` of sensor-frame coordinates: ``atan2(y,
    x)`` and ``atan2(z, x)`` cut at the angle resolution
    (dsp_dynamic.h:1329-1367); cell ``h * n_v + v``, ``v`` downward."""
    az = np.arctan2(sy, sx)
    el = np.arctan2(sz, sx)
    half_h, half_v, res = _f(c.half_h), _f(c.half_v), _f(c.res_rad)
    in_fov = (np.abs(az) <= half_h) & (np.abs(el) <= half_v) & (sx > _f(0))
    h = np.clip(np.floor((az + half_h) / res).astype(I64), 0, c.n_h - 1)
    v = np.clip(np.floor((half_v - el) / res).astype(I64), 0, c.n_v - 1)
    return h * c.n_v + v, in_fov


def voxel_of_mul(px, py, pz, c):
    """World voxel as the window and the future take it: coordinates
    times ``1 / resolution``."""
    inv = _f(1.0 / c.voxel_resolution)
    return tuple(np.floor(p * inv).astype(I64) for p in (px, py, pz))


def voxel_of_div(pos, c) -> np.ndarray:
    """World voxel as birth takes it: coordinates over the resolution."""
    return np.floor(pos / _f(c.voxel_resolution)).astype(I64)


def inside(wx, wy, wz, origin, c) -> np.ndarray:
    rx, ry, rz = wx - origin[0], wy - origin[1], wz - origin[2]
    return ((rx >= 0) & (rx < c.nx) & (ry >= 0) & (ry < c.ny)
            & (rz >= 0) & (rz < c.nz))


def cell_of(wx, wy, wz, c) -> np.ndarray:
    """Toroidal storage cell, z-major, x fastest (dsp_dynamic.h:1067)."""
    return ((np.mod(wz, c.nz) * c.ny + np.mod(wy, c.ny)) * c.nx
            + np.mod(wx, c.nx)).astype(I64)


# ------------------------------------------------------------- ordering

def ranks_by_key(key: np.ndarray) -> np.ndarray:
    """Each entry's rank among the entries of equal key, in index order."""
    n = key.shape[0]
    out = np.zeros(n, I64)
    if not n:
        return out
    order = np.argsort(key, kind="stable")
    sk = key[order]
    idx = np.arange(n)
    start = np.ones(n, bool)
    start[1:] = sk[1:] != sk[:-1]
    run = np.maximum.accumulate(np.where(start, idx, 0))
    out[order] = idx - run
    return out


def first(mask: np.ndarray, n: int) -> np.ndarray:
    """Indices of the first ``n`` true entries."""
    return np.flatnonzero(mask)[:n]


def allocate(flags: np.ndarray, cell: np.ndarray, ok: np.ndarray):
    """Each candidate's slot, in arrival order: the candidate ranked ``r``
    among those bound for its voxel takes the voxel's ``r``-th empty slot
    (dsp_dynamic.h:1183-1201); ``-1`` where the voxel is full or the
    candidate not ``ok``.  Returns flat ``s * V + v`` positions."""
    S, V = flags.shape
    out = np.full(cell.shape[0], -1, I64)
    idx = np.flatnonzero(ok)
    if not idx.size:
        return out
    dest = cell[idx]
    r = ranks_by_key(dest)
    empty = (flags[:, dest] == DEAD).astype(I64)  # [S, M]
    cum = np.cumsum(empty, 0)
    has = r < cum[-1]
    slot = np.argmax(cum > r[None, :], 0)
    out[idx[has]] = slot[has] * V + dest[has]
    return out


def _put(plane: np.ndarray, flat: np.ndarray, values) -> None:
    plane.reshape(-1)[flat] = values


# ------------------------------------------------------------- ingest

def project(points, n: int, pos, quat, c) -> types.SimpleNamespace:
    """The frame's points binned into pyramids (dsp_dynamic.h:234-293):
    per point its world position, pyramid and whether the update reads it
    (the first ``obs_dense`` of a pyramid, and up to the pyramid's point
    capacity in the first ``obs_spill_capacity`` pyramids holding more),
    and per pyramid the farthest range (-1 where it has no point)."""
    P = points.shape[0]
    pyr, in_fov = pyramid(points[:, 0], points[:, 1], points[:, 2], c)
    valid = (np.arange(P) < n) & in_fov
    world = pos + quat_rotate(quat, points)
    rng = np.sqrt(_sq(points))
    max_range = np.full(c.n_pyr, -1.0, F32)
    np.maximum.at(max_range, pyr[valid], rng[valid])
    counts = np.bincount(pyr[valid], minlength=c.n_pyr)
    rank = np.full(P, c.max_obs_points_per_pyramid, I64)
    rank[valid] = ranks_by_key(pyr[valid])
    has_spill = np.zeros(c.n_pyr, bool)
    has_spill[first(counts > c.obs_dense, c.obs_spill_capacity)] = True
    dense = valid & (rank < c.obs_dense)
    spill = (valid & (rank >= c.obs_dense)
             & (rank < c.max_obs_points_per_pyramid) & has_spill[pyr])
    return types.SimpleNamespace(world=world, valid=valid, pyr=pyr,
                                 used=dense | spill, max_range=max_range,
                                 n_valid=int(valid.sum()))


# ------------------------------------------ prediction and registration

def register(P_: dict, c, origin, pos, quat):
    """The zero-velocity prediction, the window and FOV registration, on
    the planes ``P_`` in place.  Returns the update's particles (flat
    slot, position, weight, pyramid and range from the sensor)."""
    S, V = P_["flags"].shape
    SV = S * V
    for name in VEL:  # the prediction: v = 0 (st:640-646)
        P_[name] = np.zeros_like(P_[name])
    fl = P_["flags"]
    valid = fl != DEAD
    wx, wy, wz = voxel_of_mul(P_["px"], P_["py"], P_["pz"], c)
    ins = inside(wx, wy, wz, origin, c)
    fl = np.where(valid & ~ins, DEAD, fl).astype(fl.dtype)
    new_cell = cell_of(wx, wy, wz, c)
    mover = valid & ins & (new_cell != np.arange(V)[None, :])
    R = conj_matrix(quat)
    pyr, in_fov = pyramid(*to_sensor(R, P_["px"], P_["py"], P_["pz"], pos),
                          c)
    fov = valid & ins & in_fov
    cand = first((mover | fov).reshape(-1), c.fov_cap)
    rav = lambda x: x.reshape(-1)[cand]  # noqa: E731
    is_mover, is_fov = rav(mover), rav(fov)
    c_pyr = rav(pyr)
    c_pos = np.stack([rav(P_["px"]), rav(P_["py"]), rav(P_["pz"])], 1)
    c_w = rav(P_["weight"])
    fl = np.where(mover, DEAD, fl).astype(fl.dtype)  # every mover leaves
    mov = first(is_mover, c.mover_capacity)
    new_flat = allocate(fl, rav(new_cell)[mov], np.ones(mov.shape[0], bool))
    flat = cand.copy()
    flat[mov] = np.where(new_flat >= 0, new_flat, SV)
    sel = is_fov & (flat < SV)
    rank = ranks_by_key(np.where(sel, c_pyr, c.n_pyr))
    kill = sel & (rank >= c.pyr_slots)
    P_["flags"] = fl
    landed = new_flat >= 0
    dst, src = new_flat[landed], mov[landed]
    for k, name in enumerate(("px", "py", "pz")):
        _put(P_[name], dst, c_pos[src, k])
    for name in VEL:
        _put(P_[name], dst, _f(0))
    _put(P_["weight"], dst, c_w[src])
    _put(P_["flags"], dst, np.where(kill[src], DEAD, VALID))
    _put(P_["flags"], flat[kill & ~is_mover], DEAD)
    dense = sel & (rank < c.dense_slots)
    spill = first(sel & (rank >= c.dense_slots) & (rank < c.pyr_slots),
                  c.particle_spill_capacity)
    take = dense.copy()
    take[spill] = True
    p = c_pos[take]
    return types.SimpleNamespace(
        slot=flat[take], pos=p, w=c_w[take], pyr=c_pyr[take],
        rng=np.sqrt(_sq(p - np.asarray(pos, F32)[None, :])))


# ----------------------------------------------------- measurement update

def neighbours(pyr: np.ndarray, c) -> np.ndarray:
    """``[M, 9]`` neighbour cells of pyramid cells (grid-clipped; -1)."""
    r = c.pyramid_neighbor_radius
    h, v = pyr // c.n_v, pyr % c.n_v
    out = []
    for dh in range(-r, r + 1):
        for dv in range(-r, r + 1):
            nh, nv = h + dh, v + dv
            ok = (nh >= 0) & (nh < c.n_h) & (nv >= 0) & (nv < c.n_v)
            out.append(np.where(ok, nh * c.n_v + nv, -1))
    return np.stack(out, 1)


def pairs(part_pyr: np.ndarray, obs_pyr: np.ndarray, c):
    """Every (particle, point) pair whose pyramids are neighbours."""
    order = np.argsort(obs_pyr, kind="stable")
    counts = np.bincount(obs_pyr, minlength=c.n_pyr)
    starts = np.cumsum(counts) - counts
    nb = neighbours(part_pyr, c)
    pi, zi = [], []
    for k in range(nb.shape[1]):
        q = nb[:, k]
        cnt = np.where(q >= 0, counts[np.maximum(q, 0)], 0)
        tot = int(cnt.sum())
        if not tot:
            continue
        rows = np.repeat(np.arange(q.shape[0]), cnt)
        off = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        pi.append(rows)
        zi.append(order[starts[q[rows]] + off])
    if not pi:
        return np.zeros(0, I64), np.zeros(0, I64)
    return np.concatenate(pi), np.concatenate(zi)


def likelihood(x, z, sigma) -> np.ndarray:
    """``g(z | x)``: the standard-normal product over ``|x - z|^2`` in the
    Gram form on coordinates over sigma, as the configuration's float32
    computes it."""
    a, b = x / sigma, z / sigma
    ab = a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]
    d2 = _sq(a) + _sq(b) - _f(2.0) * ab
    return PDF3 * np.exp(_f(-0.5) * np.maximum(d2, _f(0)))


def _sum64(index, values, n: int) -> np.ndarray:
    """Per index, the sum of ``values`` in float64, rounded once."""
    return np.bincount(index, weights=values.astype(np.float64),
                       minlength=n).astype(F32)


def update(weight: np.ndarray, upd, obs, expected_newborn, c):
    """The SMC-PHD update (dsp_dynamic.h:704-793) of the registered
    particles ``upd`` by the points the update reads; returns the new
    weight plane (flat) and ``sum_z 1/C(z)``."""
    sigma, p_d = _f(c.sigma_ob), _f(c.p_detection)
    e_birth = F32(expected_newborn + _f(c.kappa))
    zi_all = np.flatnonzero(obs.used)
    z_pos, z_pyr = obs.world[zi_all], obs.pyr[zi_all]
    pi, zi = pairs(upd.pyr, z_pyr, c)
    g = likelihood(upd.pos[pi], z_pos[zi], sigma)
    c_sum = _sum64(zi, g * upd.w[pi], zi_all.shape[0])
    cinv = _f(1) / (c_sum * p_d + e_birth)
    norm = F32(cinv.astype(np.float64).sum())
    s2 = _sum64(pi, g * cinv[zi], upd.slot.shape[0])
    factor = (_f(1) - p_d) + p_d * s2
    far = obs.max_range[upd.pyr]
    live = ~((far > _f(0)) & (upd.rng > far + _f(c.occlusion_slack)))
    out = weight.copy()
    out[upd.slot[live]] = upd.w[live] * factor[live]
    return out, norm


# ------------------------------------------------------------- birth

def birth(P_: dict, obs, norm, origin, noise_p, c) -> None:
    """Static newborns (dsp_static.h:780-829) around the frame's points, on
    the planes ``P_`` in place: ``n_b`` a point whose voxel (coordinates
    over the resolution) lies in the window, each at the point plus the
    position noise, v = 0, weight ``newborn weight * sum_z 1/C(z)``, in the
    first empty slots of its own voxel, point-major."""
    w_new = F32(_f(c.newborn_particle_weight) * norm)
    wv = voxel_of_div(obs.world, c)
    ok = obs.valid & inside(wv[:, 0], wv[:, 1], wv[:, 2], origin, c)
    pos = (obs.world[:, None, :] + noise_p * _f(c.position_noise_std))
    pos = pos.reshape(-1, 3)
    cand_ok = np.repeat(ok, c.n_b)
    wv = voxel_of_div(pos, c)
    cand_ok &= inside(wv[:, 0], wv[:, 1], wv[:, 2], origin, c)
    dest = cell_of(wv[:, 0], wv[:, 1], wv[:, 2], c)
    flat = allocate(P_["flags"], dest, cand_ok)
    put = flat >= 0
    dst = flat[put]
    for k, name in enumerate(("px", "py", "pz")):
        _put(P_[name], dst, pos[put, k])
    for name in VEL:
        _put(P_[name], dst, _f(0))
    _put(P_["weight"], dst, w_new)
    _put(P_["flags"], dst, NEWBORN)


# --------------------------------------------- occupancy and resample

def occupancy(P_: dict, c):
    """Cull, per-voxel aggregates and the systematic resample
    (dsp_dynamic.h:924-1057), over the slot axis in slot order.  Returns
    the new planes, ``weight_sum``, ``vel_avg`` and the old particles'
    weight a voxel that stand still (all of them in this model)."""
    fl, w = P_["flags"], P_["weight"]
    S, V = fl.shape
    fl = np.where((fl != DEAD) & (w < _f(c.weight_cull_threshold)),
                  DEAD, fl).astype(fl.dtype)
    valid = fl != DEAD
    old = valid & (fl != NEWBORN)
    wv = np.where(valid, w, _f(0))
    hi = np.empty_like(wv)
    weight_sum = np.zeros(V, F32)
    for s in range(S):  # the slot walk (dsp_dynamic.h:968-974)
        weight_sum = weight_sum + wv[s]
        hi[s] = weight_sum
    lo = hi - wv
    n_old = old.sum(0).astype(F32)
    vel_sums = [np.where(old, P_[f], _f(0)).sum(0, dtype=F32) for f in VEL]
    moving = old & ((P_["vx"] != 0) | (P_["vy"] != 0) | (P_["vz"] != 0))
    still_w = np.where(old & ~moving, w, _f(0)).sum(0, dtype=F32)
    count = valid.sum(0)
    do_rs = count >= c.resample_min_count
    n_target = np.maximum(np.minimum(count, c.max_particles_per_voxel),
                          1).astype(F32)
    wa = np.where(do_rs, weight_sum / n_target, _f(1))

    def n_grid(x):  # comb points wa * (k + 1/2) strictly below x
        return np.maximum(np.ceil(x / wa - _f(0.5)), _f(0)).astype(I64)

    copies = np.where(valid & do_rs, n_grid(hi) - n_grid(lo), 0)
    kept = valid & do_rs & (copies >= 1)
    dropped = valid & do_rs & (copies == 0)
    extra = np.maximum(copies - 1, 0)
    free = ~valid | dropped
    free_rank = np.cumsum(free, 0, dtype=I64) - free
    total_free = free.sum(0)
    demand_end = np.cumsum(extra, 0)
    total_extra = demand_end[-1]
    # the free slot ranked f takes a copy of the slot whose demand covers
    # f: the number of slots whose demand ends at or below f
    src = np.zeros((S, V), I64)
    for s in range(S):
        src += demand_end[s][None, :] <= free_rank
    filled = (free & (free_rank < np.minimum(total_extra, total_free))
              & do_rs)
    placed = np.minimum(np.maximum(
        total_free[None, :] - (demand_end - extra), 0), extra)
    unplaced = (extra - placed).astype(F32)
    new_w = np.where(kept, wa * (_f(1) + unplaced), w)
    new_w = np.where(filled, wa, new_w).astype(F32)
    new_fl = np.where(valid, VALID, fl)
    new_fl = np.where(dropped, DEAD, new_fl)
    new_fl = np.where(filled, VALID, new_fl).astype(P_["flags"].dtype)
    rows = np.minimum(src, S - 1)
    out = {"flags": new_fl, "weight": new_w, "t": P_["t"]}
    for f in ("px", "py", "pz") + VEL:
        out[f] = np.where(filled, np.take_along_axis(P_[f], rows, 0), P_[f])
    denom = np.maximum(n_old, _f(1))
    vel_avg = (np.stack([s / denom for s in vel_sums], -1)
               * (n_old > 0).astype(F32)[:, None])
    return out, weight_sum, vel_avg, still_w


def future(fut_in: np.ndarray, still_w: np.ndarray) -> np.ndarray:
    """Each horizon's weight a voxel (dsp_dynamic.h:950-964): with every
    particle at rest, the voxel's old particles' weight at every one of
    the ``T`` horizons, added to what the state held."""
    return fut_in + still_w[None, :]


def readout(weight_sum, fut, origin, c, threshold: float) -> dict:
    """The occupancy map and future status in the window's own voxel order
    (z-major, x fastest from its low corner; dsp_dynamic.h:405-426)."""
    v = np.arange(c.voxel_num)
    ex, ey, ez = v % c.nx, (v // c.nx) % c.ny, v // (c.nx * c.ny)
    o = np.asarray(origin, I64)
    wx, wy, wz = o[0] + ex, o[1] + ey, o[2] + ez
    gather = cell_of(wx, wy, wz, c)
    occupied = weight_sum[gather] > _f(threshold)
    centers = ((np.stack([wx, wy, wz], -1).astype(F32) + _f(0.5))
               * _f(c.voxel_resolution))
    return {"occupied": occupied, "centers": centers,
            "future": np.ascontiguousarray(fut[:, gather].T)}


# ------------------------------------------------------------- the frame

def admit(tree, pos, quat, t, c):
    """Admission control (dsp_dynamic.h:193-208): ``None`` where the frame
    is rejected, else ``dt``, ``t0``, ``origin`` and ``update_time``."""
    pos, quat = np.asarray(pos, F32), np.asarray(quat, F32)
    t0 = F32(t)
    last_pos = (np.asarray(tree.last_sensor_pos, F32) if tree.initialized
                else pos)
    last_t = F32(tree.last_timestamp) if tree.initialized else t0
    dt = F32(t0 - last_t)
    if not ((np.abs(quat) <= F32(1.001)).all()
            and (np.abs(pos - last_pos) <= F32(10)).all()
            and F32(0) <= dt <= F32(10)):
        return None
    return types.SimpleNamespace(
        dt=dt, t0=t0, origin=window_origin(pos, c),
        update_time=F32(F32(tree.update_time) + dt))


def step(tree, points, n: int, pos, quat, t, noise_p, c):
    """One frame from the state ``tree`` (numpy arrays as the program's
    state reads back): ``(the new planes, weight_sum, vel_avg, future,
    admission's values)``, or ``None`` where admission rejects the
    frame."""
    a = admit(tree, pos, quat, t, c)
    if a is None:
        return None
    P_ = {k: np.array(getattr(tree.particles, k)) for k in PLANES}
    pos32, quat32 = np.asarray(pos, F32), np.asarray(quat, F32)
    obs = project(points, n, pos32, quat32, c)
    expected = (_f(c.newborn_particle_weight) * _f(obs.n_valid)) * _f(c.n_b)
    upd = register(P_, c, a.origin, pos, quat)
    w, norm = update(P_["weight"].reshape(-1), upd, obs, expected, c)
    P_["weight"] = w.reshape(P_["flags"].shape)
    birth(P_, obs, norm, a.origin, noise_p, c)
    new, weight_sum, vel_avg, still_w = occupancy(P_, c)
    fut = future(np.asarray(tree.future, F32), still_w)
    return new, weight_sum, vel_avg, fut, a


def _bf16(x):
    """float32 values rounded to bfloat16, nearest even; others kept."""
    return to_bf16(x) if np.asarray(x).dtype == F32 else x


def _round_tree(tree):
    """``tree`` with every float32 array in it rounded to bfloat16."""
    if isinstance(tree, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: _round_tree(v)
                                        for k, v in vars(tree).items()})
    if isinstance(tree, np.ndarray) and tree.dtype == F32:
        return to_bf16(tree)
    return tree


def _numpy(x) -> np.ndarray:
    """A draw as a float32 numpy array (a tensor is read back)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, F32)


def run(c, cameras: int, tree, frame, draws, threshold: float,
        control: bool = False):
    """One frame from the state ``tree``: ``(state after it as a tree of
    numpy arrays, readout)`` with the readout ``{"occupied": bool [V],
    "centers": f32 [V, 3], "future": f32 [V, T]}`` at ``threshold``.
    ``control`` computes it in bfloat16 (see the module's docstring)."""
    if cameras != 1:
        raise ValueError("the static reference takes one camera")
    points, n, pos, quat, t = frame
    noise_p = _numpy(draws[1])
    points = np.asarray(points[0], F32)
    round_ = _bf16 if control else (lambda x: x)
    if control:
        tree = _round_tree(tree)
    got = step(tree, round_(points), int(np.asarray(n)[0]),
               np.asarray(pos)[0], np.asarray(quat)[0], np.asarray(t)[0],
               round_(noise_p), c)
    if got is None:
        after = tree
        ws, fut = np.asarray(tree.weight_sum), np.asarray(tree.future)
        origin = np.asarray(tree.origin)
    else:
        new, ws, vel_avg, fut, a = got
        origin = a.origin.astype(np.int32)
        p0 = np.asarray(pos, F32)[0]
        after = types.SimpleNamespace(
            particles=types.SimpleNamespace(**{
                k: round_(v) for k, v in new.items()}),
            weight_sum=round_(ws), vel_avg=round_(vel_avg),
            future=round_(fut), sensor_pos=p0.copy(),
            last_sensor_pos=p0.copy(), origin=origin,
            update_time=a.update_time, last_timestamp=a.t0,
            update_counter=int(tree.update_counter) + 1,
            initialized=True, estimator=tree.estimator)
    out = readout(ws, fut, origin, c, threshold)
    return after, {k: round_(v) for k, v in out.items()}


def init_tree(c, cameras: int, sensor_pos):
    """A fresh map centred at ``sensor_pos``: no particles, ``[S, V]``
    planes."""
    if cameras != 1:
        raise ValueError("the static reference takes one camera")
    z = lambda dt=F32: np.zeros((c.S, c.V), dt)  # noqa: E731
    pos = np.asarray(sensor_pos, F32)
    C = c.max_clusters
    return types.SimpleNamespace(
        particles=types.SimpleNamespace(
            flags=z(np.int32), px=z(), py=z(), pz=z(), vx=z(), vy=z(),
            vz=z(), weight=z(), t=z()),
        weight_sum=np.zeros(c.V, F32), vel_avg=np.zeros((c.V, 3), F32),
        future=np.zeros((c.T, c.V), F32), sensor_pos=pos,
        last_sensor_pos=pos.copy(),
        origin=window_origin(pos, c).astype(np.int32),
        update_time=F32(0), last_timestamp=F32(0), update_counter=0,
        initialized=False,
        estimator=types.SimpleNamespace(
            prev_centers=np.zeros((C, 3), F32),
            prev_point_num=np.zeros(C, np.int32),
            prev_intensity=np.zeros(C, F32),
            prev_valid=np.zeros(C, bool)))
