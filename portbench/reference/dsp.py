"""One frame of the DSP map in plain NumPy, written from the map's
per-frame semantics and independent of the program under test.

The semantics are those of the upstream ``DSPMap::update``
(``include/dsp_dynamic.h:181-353``) as the repository specifies them for
its ports: a world-aligned toroidal voxel window, ``S`` particle slots a
voxel stored slots-major ``[S, V]``, FOV pyramids, the SMC-PHD update, the
Dempster-Shafer birth and the per-voxel systematic resample.  Each stage
below is written as a plain computation over whole arrays: a sort where an
order is defined, a loop where the semantics are sequential.  The program's
processing budgets (candidate, mover, spill and observation buffers) are
part of the result where they overflow, so they are applied here too, each
as "the first ``n`` in the defined order".

Scope: the pool layout with the deterministic (limit-xy) constant-velocity
prediction, one camera (the fused sweep path) or several (prediction and
rebin once, then each camera's FOV registration, update and birth in
turn).  Its layout-free stages (ingest, the estimator, the update, the
newborn table, admission) are also the compact layout's (:mod:`.compact`).
Every float is float32, as the configuration states; sums that the
semantics leave unordered are taken in float64 and rounded once.

The random numbers come in as ``draws`` (the benchmark makes them and hands
the same to the program): per camera ``(fresh [C] on [0.1, 1), noise_p,
noise_v [P, n_b, 3] standard normal, noise_u [P, n_b, 3] on [-1, 1))``.
"""

from __future__ import annotations

import itertools
import math
import types

import numpy as np

F32 = np.float32
DEAD, VALID, NEWBORN = 0, 1, 3
PDF3 = F32((1.0 / math.sqrt(math.pi)) ** 3)  # dsp_dynamic.h:1284, cubed


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def config(values: dict) -> types.SimpleNamespace:
    """The configuration's values (a configuration file's ``config``) and
    the sizes that follow from them."""
    c = derive(values)
    if c.layout != "pool" or not c.limit_motion_to_xy_plane or (
            c.motion_model != "constant_velocity"):
        raise ValueError("the reference covers the pool layout with limit-xy "
                         "constant-velocity prediction only")
    return c


def derive(values: dict) -> types.SimpleNamespace:
    """The configuration's values and the sizes that follow from them in
    either layout (``V`` the storage voxels, ``S`` the slots a voxel)."""
    c = types.SimpleNamespace(**values)
    c.voxel_num = c.nx * c.ny * c.nz
    c.S = c.max_particles_per_voxel * c.voxel_slot_safety_factor
    base = _round_up(c.voxel_num, 1024)
    big = _round_up(c.voxel_num, 65536)
    c.V = big if (c.S * base * 4 >= (16 << 20) and big <= base * 1.04) \
        else base
    c.n_h = 2 * c.half_fov_h_deg // c.angle_resolution_deg
    c.n_v = 2 * c.half_fov_v_deg // c.angle_resolution_deg
    c.n_pyr = c.n_h * c.n_v
    c.res_rad = math.radians(c.angle_resolution_deg)
    c.half_h = math.radians(c.half_fov_h_deg)
    c.half_v = math.radians(c.half_fov_v_deg)
    r = c.voxel_resolution
    c.half_extent = (c.nx * r * 0.5, c.ny * r * 0.5, c.nz * r * 0.5)
    c.T = len(c.prediction_horizons)
    if c.pyramid_slot_capacity is not None:
        c.pyr_slots = c.pyramid_slot_capacity
    else:
        per = (c.voxel_num * c.max_particles_per_voxel + 100_000) // (
            360 * 180 // c.angle_resolution_deg ** 2) * 2
        c.pyr_slots = _round_up(max(per, 8), 8)
    dense = 64 if c.angle_resolution_deg >= 2 else 32
    c.dense_slots = min(c.pyr_slots, dense if c.pyramid_dense_slots is None
                        else c.pyramid_dense_slots)
    odense = 32 if c.angle_resolution_deg >= 2 else 16
    c.obs_dense = min(c.max_obs_points_per_pyramid,
                      odense if c.obs_dense_points is None
                      else c.obs_dense_points)
    c.fov_cap = (c.fov_capacity if c.fov_capacity is not None
                 else min(c.n_pyr * c.pyr_slots, 1 << 15))
    c.n_b = c.newborn_particles_per_point
    c.min_static = int(c.n_b * c.min_static_newborn_fraction)
    c.n_model = int(c.n_b * c.model_newborn_fraction)
    c.cluster_tol = 2.0 * c.voxel_filter_resolution
    return c


# ---------------------------------------------------------------- geometry

def window_origin(pos, c):
    half = np.asarray(c.half_extent, F32)
    return np.floor((np.asarray(pos, F32) - half) / F32(c.voxel_resolution)
                    + F32(0.5)).astype(np.int32)


def quat_rotate(q, v):
    """``q * v * q^-1`` for a unit quaternion ``q`` (wxyz), vectors
    ``v [..., 3]``."""
    w, u = q[0], q[1:]
    t = F32(2.0) * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def conj_matrix(q):
    """The rotation matrix of the conjugate of ``q`` (world to sensor)."""
    w, x, y, z = (F32(q[0]), F32(-q[1]), F32(-q[2]), F32(-q[3]))
    one, two = F32(1), F32(2)
    return np.array([
        [one - two * (y * y + z * z), two * (x * y - w * z),
         two * (x * z + w * y)],
        [two * (x * y + w * z), one - two * (x * x + z * z),
         two * (y * z - w * x)],
        [two * (x * z - w * y), two * (y * z + w * x),
         one - two * (x * x + y * y)]], F32)


def to_sensor(R, px, py, pz, pos):
    ex, ey, ez = px - F32(pos[0]), py - F32(pos[1]), pz - F32(pos[2])
    return (R[0, 0] * ex + R[0, 1] * ey + R[0, 2] * ez,
            R[1, 0] * ex + R[1, 1] * ey + R[1, 2] * ez,
            R[2, 0] * ex + R[2, 1] * ey + R[2, 2] * ez)


def pyramid(sx, sy, sz, c):
    """``(pyramid cell, in FOV)`` of sensor-frame coordinates: azimuth
    ``atan2(y, x)`` and ``atan2(z, x)`` cut at the angle resolution
    (dsp_dynamic.h:1329-1367); cell ``h * n_v + v``, ``v`` downward."""
    az = np.arctan2(sy, sx)
    el = np.arctan2(sz, sx)
    in_fov = ((np.abs(az) <= F32(c.half_h)) & (np.abs(el) <= F32(c.half_v))
              & (sx > F32(0)))
    h = np.clip(np.floor((az + F32(c.half_h)) / F32(c.res_rad))
                .astype(np.int32), 0, c.n_h - 1)
    v = np.clip(np.floor((F32(c.half_v) - el) / F32(c.res_rad))
                .astype(np.int32), 0, c.n_v - 1)
    return h * c.n_v + v, in_fov


def voxel_of_mul(px, py, pz, c):
    """World voxel as the prediction, rebin and future passes take it:
    coordinates times ``1 / resolution``."""
    inv = F32(1.0 / c.voxel_resolution)
    return (np.floor(px * inv).astype(np.int32),
            np.floor(py * inv).astype(np.int32),
            np.floor(pz * inv).astype(np.int32))


def voxel_of_div(pos, c):
    """World voxel as birth takes it: coordinates over the resolution."""
    return np.floor(pos / F32(c.voxel_resolution)).astype(np.int32)


def inside(wx, wy, wz, origin, c):
    rx, ry, rz = wx - origin[0], wy - origin[1], wz - origin[2]
    return ((rx >= 0) & (rx < c.nx) & (ry >= 0) & (ry < c.ny)
            & (rz >= 0) & (rz < c.nz))


def cell_of(wx, wy, wz, c):
    """Toroidal storage cell, z-major, x fastest (dsp_dynamic.h:1067)."""
    return ((np.mod(wz, c.nz) * c.ny + np.mod(wy, c.ny)) * c.nx
            + np.mod(wx, c.nx)).astype(np.int64)


# ------------------------------------------------------------- ordering

def ranks_by_key(key):
    """Each entry's rank among the entries of equal key, in index order."""
    order = np.argsort(key, kind="stable")
    sk = key[order]
    n = len(key)
    start = np.ones(n, bool)
    start[1:] = sk[1:] != sk[:-1]
    run = np.maximum.accumulate(np.where(start, np.arange(n), 0))
    out = np.empty(n, np.int64)
    out[order] = np.arange(n) - run
    return out


def first(mask, n):
    """Indices of the first ``n`` true entries."""
    return np.flatnonzero(mask)[:n]


def allocate(flags, cell, ok):
    """Each candidate's slot, in arrival order: the candidate ranked ``r``
    among those bound for its voxel takes the voxel's ``r``-th empty slot
    (dsp_dynamic.h:1183-1201); ``-1`` where the voxel is full or the
    candidate not ``ok``.  Returns flat ``s * V + v`` positions."""
    S, V = flags.shape
    out = np.full(len(cell), -1, np.int64)
    idx = np.flatnonzero(ok)
    if not len(idx):
        return out
    r = ranks_by_key(cell[idx])
    empty = flags[:, cell[idx]] == DEAD  # [S, M]
    cum = np.cumsum(empty, axis=0)
    has = r < cum[-1]
    slot = np.argmax(cum > r[None, :], axis=0)
    out[idx[has]] = slot[has] * V + cell[idx][has]
    return out


# ------------------------------------------------------------- ingest

def project(points, n, pos, quat, c):
    """The frame's points binned into pyramids (dsp_dynamic.h:234-293):
    per point its world position, pyramid and whether the update reads it,
    and per pyramid the largest range."""
    P = points.shape[0]
    pyr, in_fov = pyramid(points[:, 0], points[:, 1], points[:, 2], c)
    valid = (np.arange(P) < n) & in_fov
    world = np.asarray(pos, F32) + quat_rotate(np.asarray(quat, F32), points)
    rng = np.sqrt((points * points).sum(-1, dtype=F32))
    max_range = np.full(c.n_pyr, -1.0, F32)
    np.maximum.at(max_range, pyr[valid], rng[valid])
    counts = np.bincount(pyr[valid], minlength=c.n_pyr)
    rank = np.full(P, c.max_obs_points_per_pyramid, np.int64)
    rank[valid] = ranks_by_key(pyr[valid])
    spill_cells = first(counts > c.obs_dense, c.obs_spill_capacity)
    has_spill = np.zeros(c.n_pyr, bool)
    has_spill[spill_cells] = True
    dense = valid & (rank < c.obs_dense)
    spill = (valid & (rank >= c.obs_dense)
             & (rank < c.max_obs_points_per_pyramid) & has_spill[pyr])
    return types.SimpleNamespace(world=world, valid=valid, pyr=pyr,
                                 used=dense | spill, max_range=max_range,
                                 n_valid=int(valid.sum()))


# ------------------------------------------------------------- estimator

def cluster(points, valid, tol, iters, tf32=False):
    """Connected components of the points within ``tol`` of each other:
    each point's label is the least index of its component as ``iters``
    sweeps of min-label propagation with pointer jumping find it (stopping
    once a sweep changes nothing); ``len(points)`` for invalid points."""
    P = points.shape[0]
    idx = np.flatnonzero(valid)
    n = len(idx)
    labels = np.full(P, P, np.int64)
    if not n:
        return labels
    p = points[idx]
    q = to_tf32(p) if tf32 else p
    sq = (p * p).sum(-1, dtype=F32)
    d2 = sq[:, None] + sq[None, :] - F32(2.0) * (q @ q.T)
    adj = d2 <= F32(tol * tol)
    lab = np.arange(n, dtype=np.int32)
    sentinel = np.int32(n)
    for _ in range(iters):
        new = np.where(adj, lab[None, :], sentinel).min(1)
        new = np.minimum(lab, new)
        ext = np.append(new, sentinel)
        new = np.minimum(new, ext[np.minimum(new, sentinel)])
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            break
    labels[idx] = idx[lab]
    return labels


def assignment(cost, row_ok, col_ok):
    """Least-cost one-to-one assignment of rows to columns (-1: none), the
    instance squared up with a dummy cost above every real pair: all rows
    and columns within the first 8 by enumeration of permutations, others
    by shortest augmenting paths (Jonker-Volgenant)."""
    R, C = cost.shape
    N = max(R, C, 8)
    pair = row_ok[:, None] & col_ok[None, :]
    spread = max(F32(np.where(pair, cost, F32(0)).max()), F32(1))
    dummy = F32(spread * F32(2) + F32(1))
    a = np.full((N, N), dummy, F32)
    a[:R, :C] = np.where(pair, cost, dummy)
    if not (row_ok[8:].any() or col_ok[8:].any()):
        best, res = None, None
        for perm in itertools.permutations(range(8)):
            tot = F32(0)
            for i in range(8):
                tot = F32(tot + a[i, perm[i]])
            if best is None or tot < best:
                best, res = tot, perm
        r = np.full(N, -1, np.int64)
        r[:8] = res
        r = r[:R]
        r = np.where(r < C, r, -1)
    else:
        INF = F32(1e12)
        u = np.zeros(N + 1, F32)
        v = np.zeros(N + 1, F32)
        p = np.zeros(N + 1, np.int64)
        n_rows = max([i + 1 for i in range(R) if row_ok[i]], default=0)
        for i in range(1, n_rows + 1):
            p[0] = i
            m = np.full(N, INF, F32)
            way = np.zeros(N, np.int64)
            used = np.zeros(N + 1, bool)
            d_use = np.zeros(N + 1, F32)
            j0, d_now = 0, F32(0)
            while True:
                used[j0] = True
                d_use[j0] = d_now
                i0 = p[j0]
                cand = a[i0 - 1, :] - u[i0] - v[1:] + d_now
                better = ~used[1:] & (cand < m)
                m = np.where(better, cand, m)
                way = np.where(better, j0, way)
                masked = np.where(used[1:], INF, m)
                j1 = int(np.argmin(masked)) + 1
                d_now = masked[j1 - 1]
                j0 = j1
                if p[j1] == 0:
                    break
            amt = np.where(used, d_now - d_use, F32(0)).astype(F32)
            np.add.at(u, p, amt)
            v = (v - amt).astype(F32)
            wayf = np.concatenate([[0], way])
            while j0 != 0:
                j1 = wayf[j0]
                p[j0] = p[j1]
                j0 = j1
        col_of_row = np.full(N + 1, -1, np.int64)
        col_of_row[p[1:]] = np.arange(1, N + 1)
        r = col_of_row[1:R + 1] - 1
        r = np.where((r >= 0) & (r < C), r, -1)
    real = row_ok & (r >= 0) & pair[np.arange(R), np.maximum(r, 0)]
    return np.where(real, r, -1)


def estimate(world, valid, est, dt, fresh, c, tf32=False):
    """Ground split, clustering, dynamic-cluster association with the last
    frame's and per-point velocities (dsp_dynamic.h:1377-1544).  Returns
    ``(per-point velocity, dynamic, valid)`` and the new estimator
    state."""
    P, C = world.shape[0], c.max_clusters
    ground = world[:, 2] <= F32(c.voxel_filter_resolution)
    nonground = valid & ~ground
    labels = cluster(world, nonground, c.cluster_tol,
                     c.cluster_propagation_iters, tf32)
    lab = np.minimum(labels, P)
    ng = np.flatnonzero(nonground)
    size = np.zeros(P + 1, F32)
    np.add.at(size, labels[ng], F32(1))
    csum = np.zeros((P + 1, 3), F32)
    np.add.at(csum, labels[ng], world[ng])
    centroid = csum / np.maximum(size, F32(1))[:, None]
    my_size, my_c = size[lab], centroid[lab]
    big = my_size >= c.cluster_min_points
    static = ((my_size > c.dynamic_cluster_max_points)
              | (my_c[:, 2] > F32(c.dynamic_cluster_max_height)))
    dyn = nonground & big & ~static
    stat = (valid & ground) | (nonground & big & static)
    root = (labels == np.arange(P)) & dyn
    roots = first(root, C)
    k = len(roots)
    slot_ok = np.arange(C) < k
    c_centers = np.zeros((C, 3), F32)
    c_centers[:k] = centroid[roots]
    c_sizes = np.zeros(C, np.int32)
    c_sizes[:k] = size[roots].astype(np.int32)
    slot_of = np.full(P + 1, C, np.int64)
    slot_of[roots] = np.arange(k)
    point_slot = slot_of[lab]

    prev_c = np.asarray(est.prev_centers, F32)
    prev_n = np.asarray(est.prev_point_num, np.int32)
    prev_ok = np.asarray(est.prev_valid, bool)
    diff = c_centers[:, None, :] - prev_c[None, :, :]
    dist = np.sqrt((diff * diff).sum(-1, dtype=F32))
    gate = ((dist < F32(c.assoc_distance_gate))
            & (np.abs(c_sizes[:, None] - prev_n[None, :])
               <= c.assoc_point_num_gate))
    cost = np.where(gate, dist / F32(c.assoc_distance_gate) * F32(1000),
                    F32(c.assoc_distance_gate * 5000.0)).astype(F32)
    if (F32(1e-5) < dt < F32(10)) and k > 0 and prev_ok.any():
        col = assignment(cost, slot_ok, prev_ok)
    else:
        col = np.full(C, -1, np.int64)
    safe = np.maximum(col, 0)
    matched = (col >= 0) & gate[np.arange(C), safe]
    vel = np.where(matched[:, None],
                   (c_centers - prev_c[safe]) / max(dt, F32(1e-6)),
                   F32(-10000)).astype(F32)
    sp = np.where(matched[:, None], vel, F32(0))
    speed = np.sqrt((sp * sp).sum(-1, dtype=F32))
    vel = np.where(((speed > F32(c.max_cluster_velocity)) & matched)[:, None],
                   F32(0), vel).astype(F32)
    intensity = np.where(matched,
                         np.asarray(est.prev_intensity, F32)[safe],
                         np.asarray(fresh, F32)).astype(F32)
    ext = np.concatenate([vel, np.zeros((1, 3), F32)])
    point_vel = np.where(dyn[:, None], ext[np.minimum(point_slot, C)],
                         F32(0)).astype(F32)
    new = types.SimpleNamespace(prev_centers=c_centers, prev_point_num=c_sizes,
                                prev_intensity=intensity, prev_valid=slot_ok)
    return (point_vel, dyn, stat | dyn), new


# ----------------------------------------------------- measurement update

def neighbours(pyr, c):
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


def pairs(part_pyr, obs_pyr, c):
    """Every (particle, point) pair whose pyramids are neighbours."""
    order = np.argsort(obs_pyr, kind="stable")
    counts = np.bincount(obs_pyr, minlength=c.n_pyr)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    nb = neighbours(part_pyr, c)
    pi, zi = [], []
    for k in range(nb.shape[1]):
        q = nb[:, k]
        cnt = np.where(q >= 0, counts[np.maximum(q, 0)], 0)
        tot = int(cnt.sum())
        if not tot:
            continue
        rows = np.repeat(np.arange(len(q)), cnt)
        off = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        pi.append(rows)
        zi.append(order[starts[q[rows]] + off])
    if not pi:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(pi), np.concatenate(zi)


def likelihood(x, z, sigma):
    """``g(z | x)``: the reference's standard-normal product without the
    ``1/sigma`` factor and with ``1/sqrt(pi)`` a factor
    (dsp_dynamic.h:1282-1301), over ``|x - z|^2`` in the Gram form on
    coordinates over sigma, as the configuration's float32 computes it."""
    a = x / sigma
    b = z / sigma
    d2 = ((a * a).sum(-1, dtype=F32) + (b * b).sum(-1, dtype=F32)
          - F32(2.0) * (a * b).sum(-1, dtype=F32))
    return PDF3 * np.exp(F32(-0.5) * np.maximum(d2, F32(0)))


def update(weight_flat, upd, obs, expected_newborn, c):
    """The SMC-PHD update (dsp_dynamic.h:704-793) of the registered
    particles ``upd`` (flat slot, position, weight, range, pyramid) by the
    frame's points; returns the new weight plane and ``sum_z 1/C(z)``."""
    sigma = F32(c.sigma_ob)
    p_d = F32(c.p_detection)
    e_birth = F32(expected_newborn + F32(c.kappa))
    zi_all = np.flatnonzero(obs.used)
    z_pos, z_pyr = obs.world[zi_all], obs.pyr[zi_all]
    pi, zi = pairs(upd.pyr, z_pyr, c)
    g = likelihood(upd.pos[pi], z_pos[zi], sigma)
    c_sum = np.bincount(zi, weights=(g * upd.w[pi]).astype(np.float64),
                        minlength=len(zi_all)).astype(F32)
    cz = (c_sum * p_d + e_birth).astype(F32)
    cinv = (F32(1) / cz).astype(F32)
    norm = F32(cinv.astype(np.float64).sum())
    s2 = np.bincount(pi, weights=(g * cinv[zi]).astype(np.float64),
                     minlength=len(upd.slot)).astype(F32)
    factor = (F32(1) - p_d) + p_d * s2
    mr = obs.max_range[upd.pyr]
    occluded = (mr > F32(0)) & (upd.rng > mr + F32(c.occlusion_slack))
    out = weight_flat.copy()
    live = ~occluded
    out[upd.slot[live]] = (upd.w[live] * factor[live]).astype(F32)
    return out, norm


def registered(flat, pos, w, pyr, rank, sel, sensor, c):
    """The particles the update reads from a registration: FOV-selected,
    ranked under the pyramid capacity, and either in the dense tier or
    among the first ``particle_spill_capacity`` of the spill tier in
    ``flat``'s order."""
    dense = sel & (rank < c.dense_slots)
    spill = first(sel & (rank >= c.dense_slots) & (rank < c.pyr_slots),
                  c.particle_spill_capacity)
    take = np.zeros(len(flat), bool)
    take[dense] = True
    take[spill] = True
    p = pos[take]
    d = p - np.asarray(sensor, F32)[None, :]
    return types.SimpleNamespace(
        slot=flat[take], pos=p, w=w[take], pyr=pyr[take],
        rng=np.sqrt((d * d).sum(-1, dtype=F32)))


# ------------------------------------------------------------- birth

def birth(P_, obs_world, est, norm, origin, draws, c):
    """Newborns around the frame's points with Dempster-Shafer arbitration
    against the voxel's particles (dsp_dynamic.h:796-921), inserted into
    the first empty slots of their voxels with the newborn flag."""
    w_new = F32(F32(c.newborn_particle_weight) * norm)
    ok, cell = birth_cells(obs_world, est[2], origin, c)
    fl = P_["flags"]
    considered = (fl != DEAD) & (fl != NEWBORN)
    l1 = F32(0) + np.abs(P_["vx"]) + np.abs(P_["vy"])
    wc = np.where(considered, P_["weight"], F32(0)).astype(F32)
    ws_v = np.where(l1 < F32(0.1), wc, F32(0)).sum(0, dtype=F32)
    wm_v = np.where((l1 >= F32(0.1)) & (l1 < F32(0.5)), wc,
                    F32(0)).sum(0, dtype=F32)
    wd_v = np.where(l1 >= F32(0.5), wc, F32(0)).sum(0, dtype=F32)
    ws = np.where(ok, ws_v[cell], F32(0))
    wm = np.where(ok, wm_v[cell], F32(0))
    wd = np.where(ok, wd_v[cell], F32(0))
    pos, vel, cand_ok, dest = newborns(obs_world, est, ok, ws, wm, wd, draws,
                                       origin, c)
    flat = allocate(fl, dest, cand_ok)
    put = flat >= 0
    write(P_, flat[put], pos[put], vel[put],
          np.full(int(put.sum()), w_new, F32), NEWBORN)


def birth_cells(obs_world, valid_e, origin, c):
    """``(ok, cell)`` of the frame's points as birth takes them: the points
    the estimator kept whose voxel (coordinates over the resolution) lies
    in the window, and that voxel's storage cell (0 where not ok)."""
    wv = voxel_of_div(obs_world, c)
    ok = valid_e & inside(wv[:, 0], wv[:, 1], wv[:, 2], origin, c)
    cell = np.where(ok, cell_of(wv[:, 0], wv[:, 1], wv[:, 2], c), 0)
    return ok, cell


def newborns(obs_world, est, ok, ws, wm, wd, draws, origin, c):
    """The newborn table (dsp_dynamic.h:850-907): per point the
    Dempster-Shafer split of its ``n_b`` newborns into static, model and
    random ones from the classes' weights ``ws, wm, wd`` of its voxel.
    Returns the candidates point-major, ``(pos [M, 3], vel [M, 3], ok [M],
    storage cell [M])``, ok where the point is and the newborn's own voxel
    lies in the window."""
    vel_e, dyn, _ = est
    fresh, noise_p, noise_v, noise_u = draws
    n_b = c.n_b
    total = ws + wm + wd
    p_s = (F32(2) * ws + wm) * F32(0.5)
    p_d = (F32(2) * wd + wm) * F32(0.5)
    with np.errstate(invalid="ignore", divide="ignore"):
        p_norm = np.where(total > F32(0), p_s / (p_s + p_d), F32(0))
    n_static = np.maximum(c.min_static,
                          np.floor(F32(c.n_model) * p_norm).astype(np.int32))
    b = np.arange(n_b)[None, :]
    pos = obs_world[:, None, :] + noise_p * F32(c.position_noise_std)
    gain = F32(F32(c.estimator_newborn_noise_gain)
               * F32(c.velocity_noise_std))
    v_model = np.where(dyn[:, None, None],
                       vel_e[:, None, :] + gain * noise_v, F32(0))
    span = np.array([c.random_newborn_vxy, c.random_newborn_vxy,
                     c.random_newborn_vz], F32)
    v_rand = np.where(dyn[:, None, None], noise_u * span, F32(0))
    known = vel_e[:, 0] > F32(-100)
    is_static = b < n_static[:, None]
    is_model = ~is_static & known[:, None] & (b < c.n_model)
    vel = np.where(is_static[:, :, None], F32(0),
                   np.where(is_model[:, :, None], v_model, v_rand))
    vel = vel.astype(F32)
    vel[:, :, 2] = 0
    pos = pos.reshape(-1, 3).astype(F32)
    vel = vel.reshape(-1, 3)
    cand_ok = np.repeat(ok, n_b)
    wv = voxel_of_div(pos, c)
    cand_ok &= inside(wv[:, 0], wv[:, 1], wv[:, 2], origin, c)
    dest = cell_of(wv[:, 0], wv[:, 1], wv[:, 2], c)
    return pos, vel, cand_ok, dest


def write(P_, flat, pos, vel, w, flag):
    for k, name in enumerate(("px", "py", "pz")):
        P_[name].reshape(-1)[flat] = pos[:, k]
    for k, name in enumerate(("vx", "vy", "vz")):
        P_[name].reshape(-1)[flat] = vel[:, k]
    P_["weight"].reshape(-1)[flat] = w
    P_["flags"].reshape(-1)[flat] = flag


# --------------------------------------------- occupancy and resample

def occupancy(P_, c):
    """Cull, per-voxel aggregates and the systematic resample
    (dsp_dynamic.h:924-1057), over the slot axis in slot order.  Returns
    the new planes, ``weight_sum``, ``vel_avg``, the static particles'
    weight a voxel and the moving old particles' mask."""
    fl, w = P_["flags"], P_["weight"]
    S = fl.shape[0]
    fl = np.where((fl != DEAD) & (w < F32(c.weight_cull_threshold)), DEAD,
                  fl).astype(np.int32)
    valid = fl != DEAD
    old = valid & (fl != NEWBORN)
    wv = np.where(valid, w, F32(0)).astype(F32)
    weight_sum = np.zeros(w.shape[1], F32)
    hi = np.empty_like(wv)
    for s in range(S):  # the slot walk (dsp_dynamic.h:968-974)
        weight_sum = (weight_sum + wv[s]).astype(F32)
        hi[s] = weight_sum
    lo = (hi - wv).astype(F32)
    n_old = old.sum(0).astype(F32)
    vel_sums = [np.where(old, P_[f], F32(0)).sum(0, dtype=F32)
                for f in ("vx", "vy", "vz")]
    moving = old & ((P_["vx"] != 0) | (P_["vy"] != 0) | (P_["vz"] != 0))
    static_w = np.where(old & ~moving, w, F32(0)).sum(0, dtype=F32)
    count = valid.sum(0)
    do_rs = count >= c.resample_min_count
    n_target = np.minimum(count, c.max_particles_per_voxel)
    wa = np.where(do_rs, weight_sum / np.maximum(n_target, 1).astype(F32),
                  F32(1)).astype(F32)

    def n_grid(x):  # comb points wa * (k + 1/2) strictly below x
        return np.maximum(np.ceil(x / wa - F32(0.5)), F32(0)).astype(np.int64)

    copies = np.where(valid & do_rs, n_grid(hi) - n_grid(lo), 0)
    kept = valid & do_rs & (copies >= 1)
    dropped = valid & do_rs & (copies == 0)
    extra = np.maximum(copies - 1, 0)
    free = ~valid | dropped
    free_rank = np.cumsum(free, 0) - free
    total_free = free.sum(0)
    demand_end = np.cumsum(extra, 0)
    total_extra = demand_end[-1]
    src = (demand_end[None, :, :] <= free_rank[:, None, :]).sum(1)
    filled = free & (free_rank < np.minimum(total_extra, total_free)) & do_rs
    placed = np.clip(total_free[None, :] - (demand_end - extra), 0, extra)
    unplaced = (extra - placed).astype(F32)
    new_w = np.where(kept, wa * (F32(1) + unplaced), w)
    new_w = np.where(filled, wa, new_w).astype(F32)
    new_fl = np.where(valid, VALID, fl)
    new_fl = np.where(dropped, DEAD, new_fl)
    new_fl = np.where(filled, VALID, new_fl).astype(np.int32)
    cols = np.arange(fl.shape[1])[None, :]
    out = {"flags": new_fl, "weight": new_w, "t": P_["t"]}
    for f in ("px", "py", "pz", "vx", "vy", "vz"):
        out[f] = np.where(filled, P_[f][np.minimum(src, S - 1), cols],
                          P_[f]).astype(F32)
    denom = np.maximum(n_old, F32(1))
    vel_avg = (np.stack([s / denom for s in vel_sums], -1)
               * (n_old > 0)[:, None]).astype(F32)
    return out, weight_sum, vel_avg, static_w, moving


def future(fut_in, static_w, P_, flat, ok, origin, c):
    """Each old particle's weight at each horizon in the voxel of ``p + v
    tau`` (dsp_dynamic.h:950-964): the static ones in their own voxel, the
    moving ones (``flat``, ``ok``) scattered."""
    out = (np.asarray(fut_in, F32) + static_w[None, :]).astype(F32)
    take = lambda f: P_[f].reshape(-1)[flat]  # noqa: E731
    px, py, pz, vx, vy, vz = (take(f) for f in
                              ("px", "py", "pz", "vx", "vy", "vz"))
    w = np.where(ok, take("weight"), F32(0)).astype(F32)
    taus = np.asarray(c.prediction_horizons, F32)[:, None]
    fx, fy, fz = px + vx * taus, py + vy * taus, pz + vz * taus
    wx, wy, wz = voxel_of_mul(fx, fy, fz, c)
    good = ok[None, :] & inside(wx, wy, wz, origin, c)
    cell = cell_of(wx, wy, wz, c) + c.V * np.arange(c.T)[:, None]
    acc = out.reshape(-1).astype(np.float64)
    np.add.at(acc, cell[good], np.broadcast_to(w, cell.shape)[good])
    return acc.astype(F32).reshape(out.shape)


# ------------------------------------------------------------- the frame

def _camera(points, n, pos, quat, est, dt, fresh, c, tf32):
    obs = project(points, n, pos, quat, c)
    expected = F32(F32(c.newborn_particle_weight) * F32(obs.n_valid)
                   * F32(c.n_b))
    est_out, est_new = estimate(obs.world, obs.valid, est, dt, fresh, c,
                                tf32)
    return obs, expected, est_out, est_new


def _fused_register(P_, c, dt, origin, pos, quat):
    """Prediction, relocation and FOV registration of the one-camera path:
    one candidate buffer (movers, FOV particles and moving particles in
    flat order, ``fov_cap`` of them), movers relocated into their new
    voxels' empty slots, FOV ranks in the buffer's (pre-relocation) order,
    particles ranked at or over the pyramid capacity killed.  Returns the
    update's particles and the future's moving particles."""
    S, V = P_["flags"].shape
    SV = S * V
    fl = P_["flags"]
    valid = fl != DEAD
    P_["vz"] = np.zeros_like(P_["vz"])
    for a in ("x", "y", "z"):
        P_["p" + a] = np.where(valid, P_["p" + a] + P_["v" + a] * dt,
                               P_["p" + a]).astype(F32)
    wx, wy, wz = voxel_of_mul(P_["px"], P_["py"], P_["pz"], c)
    ins = inside(wx, wy, wz, origin, c)
    fl = np.where(valid & ~ins, DEAD, fl).astype(np.int32)
    new_cell = cell_of(wx, wy, wz, c)
    mover = valid & ins & (new_cell != np.arange(V)[None, :])
    R = conj_matrix(quat)
    pyr, in_fov = pyramid(*to_sensor(R, P_["px"], P_["py"], P_["pz"], pos),
                          c)
    fov = valid & ins & in_fov
    moving = valid & ins & ((P_["vx"] != 0) | (P_["vy"] != 0))
    cand = first((mover | fov | moving).reshape(-1), c.fov_cap)
    rav = lambda x: x.reshape(-1)[cand]  # noqa: E731
    is_mover, is_fov, is_moving = rav(mover), rav(fov), rav(moving)
    c_pyr = rav(pyr)
    c_pos = np.stack([rav(P_["px"]), rav(P_["py"]), rav(P_["pz"])], 1)
    c_w = rav(P_["weight"])
    c_vel = np.stack([rav(P_["vx"]), rav(P_["vy"]), rav(P_["vz"])], 1)
    fl = np.where(mover, DEAD, fl).astype(np.int32)  # vacated
    mov = first(is_mover, c.mover_capacity)
    new_flat = allocate(fl, rav(new_cell)[mov], np.ones(len(mov), bool))
    flat = cand.copy()
    flat[mov] = np.where(new_flat >= 0, new_flat, SV)
    sel = is_fov & (flat < SV)
    rank = ranks_by_key(np.where(sel, c_pyr, c.n_pyr))
    kill = sel & (rank >= c.pyr_slots)
    P_["flags"] = fl
    ins_m = new_flat >= 0
    mflag = np.where(kill[mov], DEAD, VALID)[ins_m]
    dst = new_flat[ins_m]
    write(P_, dst, c_pos[mov][ins_m], c_vel[mov][ins_m], c_w[mov][ins_m], 0)
    P_["flags"].reshape(-1)[dst] = mflag
    P_["flags"].reshape(-1)[flat[kill & ~is_mover]] = DEAD
    upd = registered(flat, c_pos, c_w, c_pyr, rank, sel, pos, c)
    fm = first(is_moving & (flat < SV), c.mover_capacity)
    return upd, flat[fm]


def _separate_predict(P_, c, dt, origin):
    """Prediction and relocation once a frame (the multi-camera path):
    movers, the first ``mover_capacity`` in flat order, into the first
    empty slots of their new voxels, ranked in flat order."""
    S, V = P_["flags"].shape
    fl = P_["flags"]
    valid = fl != DEAD
    P_["vz"] = np.where(valid, F32(0), P_["vz"]).astype(F32)
    for a in ("x", "y", "z"):
        P_["p" + a] = np.where(valid, P_["p" + a] + P_["v" + a] * dt,
                               P_["p" + a]).astype(F32)
    wx, wy, wz = voxel_of_mul(P_["px"], P_["py"], P_["pz"], c)
    ins = inside(wx, wy, wz, origin, c) & valid
    new_cell = cell_of(wx, wy, wz, c)
    mover = ins & (new_cell != np.arange(V)[None, :])
    mov = first(mover.reshape(-1), c.mover_capacity)
    rav = lambda x: x.reshape(-1)[mov]  # noqa: E731
    pos = np.stack([rav(P_["px"]), rav(P_["py"]), rav(P_["pz"])], 1)
    vel = np.stack([rav(P_["vx"]), rav(P_["vy"]), rav(P_["vz"])], 1)
    w = rav(P_["weight"])
    P_["flags"] = np.where(mover | (valid & ~ins), DEAD, fl).astype(np.int32)
    # arrival order: grouped by destination, flat order within a voxel
    cells = rav(new_cell)
    order = np.argsort(cells, kind="stable")
    dst = allocate(P_["flags"], cells[order], np.ones(len(mov), bool))
    put = dst >= 0
    write(P_, dst[put], pos[order][put], vel[order][put], w[order][put],
          VALID)


def _register(P_, c, pos, quat):
    """FOV registration of one camera on the multi-camera path: FOV
    particles, the first ``fov_cap`` in flat order, grouped by pyramid in
    that order; those ranked at or over the pyramid capacity are killed."""
    S, V = P_["flags"].shape
    R = conj_matrix(quat)
    pyr, in_fov = pyramid(*to_sensor(R, P_["px"], P_["py"], P_["pz"], pos),
                          c)
    sel = first(((P_["flags"] != DEAD) & in_fov).reshape(-1), c.fov_cap)
    gp = pyr.reshape(-1)[sel]
    order = np.argsort(gp, kind="stable")
    flat, gp = sel[order], gp[order]
    rank = ranks_by_key(gp)
    kill = rank >= c.pyr_slots
    rav = lambda x: x.reshape(-1)[flat]  # noqa: E731
    c_pos = np.stack([rav(P_["px"]), rav(P_["py"]), rav(P_["pz"])], 1)
    upd = registered(flat, c_pos, rav(P_["weight"]), gp, rank,
                     np.ones(len(flat), bool), pos, c)
    P_["flags"].reshape(-1)[flat[kill]] = DEAD
    return upd


def step(tree, frame, draws, c, tf32=False):
    """One frame from the state ``tree`` (a namespace of numpy arrays as
    the program's state reads back) and the frame ``(points [n, P, 3],
    n_points [n], sensor_pos [n, 3], quat [n, 4], timestamp [n])``: the
    state after it, as a tree of the same names."""
    points, n_pts, pos, quat, t = (np.asarray(x) for x in frame)
    cams = points.shape[0]
    f = admit(tree, pos, quat, t, c)
    if f is None:
        return tree
    q_ok, dt, origin = f.q_ok, f.dt, f.origin
    P_ = planes(tree)
    est_in = tree.estimator
    if cams == 1:
        fresh, *rest = draws
        obs, expected, est_out, est_new = _camera(
            points[0].astype(F32), int(n_pts[0]), pos[0], quat[0], est_in,
            dt, fresh, c, tf32)
        upd, fm_flat = _fused_register(P_, c, dt, origin, pos[0], quat[0])
        P_["weight"], norm = update(P_["weight"].reshape(-1), upd, obs,
                                    expected, c)
        P_["weight"] = P_["weight"].reshape(P_["flags"].shape)
        birth(P_, obs.world, est_out, norm, origin, draws, c)
        estimator = est_new
    else:
        _separate_predict(P_, c, dt, origin)
        per = tracks(est_in, cams)
        for i in range(cams):
            if not q_ok[i]:
                continue
            d = draws[1][i]
            obs, expected, est_out, per[i] = _camera(
                points[i].astype(F32), int(n_pts[i]), pos[i], quat[i],
                per[i], dt, d[0], c, tf32)
            upd = _register(P_, c, pos[i], quat[i])
            w, norm = update(P_["weight"].reshape(-1), upd, obs, expected, c)
            P_["weight"] = w.reshape(P_["flags"].shape)
            birth(P_, obs.world, est_out, norm, origin, d, c)
        estimator = stack_tracks(per)
        fm_flat = None
    before = {k: v.copy() for k, v in P_.items()}
    new, weight_sum, vel_avg, static_w, moving = occupancy(P_, c)
    if fm_flat is None:
        fm_flat = first(moving.reshape(-1), c.mover_capacity)
        ok = np.ones(len(fm_flat), bool)
    else:
        fl = before["flags"].reshape(-1)[fm_flat]
        ok = ((fl != DEAD) & (fl != NEWBORN)
              & (before["weight"].reshape(-1)[fm_flat]
                 >= F32(c.weight_cull_threshold)))
    fut = future(tree.future, static_w, before, fm_flat, ok, origin, c)
    return after(tree, f, pos, new, weight_sum, vel_avg, fut, estimator)


TRACK_KEYS = ("prev_centers", "prev_point_num", "prev_intensity",
              "prev_valid")
PLANES = ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")


def admit(tree, pos, quat, t, c):
    """Admission control (dsp_dynamic.h:193-208) and the frame's values:
    ``None`` where the frame is rejected, else ``q_ok`` (a camera's
    quaternion is valid), ``dt``, ``t0``, ``origin`` and ``update_time``.
    One camera needs its quaternion, a rig one camera's; every camera
    takes camera 0's pose jump, time and window."""
    q_ok = (np.abs(quat) <= F32(1.001)).all(1)
    t0 = F32(t[0])
    last_pos = (np.asarray(tree.last_sensor_pos, F32) if tree.initialized
                else pos[0].astype(F32))
    last_t = F32(tree.last_timestamp) if tree.initialized else t0
    dt = F32(t0 - last_t)
    jump_ok = bool((np.abs(pos[0] - last_pos) <= F32(10)).all()
                   and F32(0) <= dt <= F32(10))
    accepted = (q_ok.all() if len(q_ok) == 1 else q_ok.any()) and jump_ok
    if not accepted:
        return None
    return types.SimpleNamespace(
        q_ok=q_ok, dt=dt, t0=t0, origin=window_origin(pos[0], c),
        update_time=F32(F32(tree.update_time) + dt))


def planes(tree) -> dict:
    """The state's particle planes, copied."""
    return {k: np.array(getattr(tree.particles, k)) for k in PLANES}


def tracks(est, cams: int) -> list:
    """A rig's estimator state, one namespace a camera."""
    return [types.SimpleNamespace(**{k: np.array(getattr(est, k)[i])
                                     for k in TRACK_KEYS})
            for i in range(cams)]


def stack_tracks(per: list):
    return types.SimpleNamespace(**{
        k: np.stack([getattr(e, k) for e in per]) for k in TRACK_KEYS})


def after(tree, f, pos, particles: dict, weight_sum, vel_avg, fut,
          estimator):
    """The state after an accepted frame as a tree of the state's names."""
    return types.SimpleNamespace(
        particles=types.SimpleNamespace(**particles), weight_sum=weight_sum,
        vel_avg=vel_avg, future=fut, sensor_pos=pos[0].astype(F32),
        last_sensor_pos=pos[0].astype(F32), origin=f.origin,
        update_time=f.update_time, last_timestamp=f.t0,
        update_counter=int(tree.update_counter) + 1, initialized=True,
        estimator=estimator)


def readout(tree, c, threshold):
    """The occupancy map and future status in the window's own voxel order
    (z-major, x fastest from its low corner; dsp_dynamic.h:405-426)."""
    v = np.arange(c.voxel_num)
    ex, ey, ez = v % c.nx, (v // c.nx) % c.ny, v // (c.nx * c.ny)
    o = np.asarray(tree.origin, np.int64)
    wx, wy, wz = o[0] + ex, o[1] + ey, o[2] + ez
    gather = cell_of(wx, wy, wz, c)
    occupied = np.asarray(tree.weight_sum)[gather] > F32(threshold)
    centers = ((np.stack([wx, wy, wz], -1).astype(F32) + F32(0.5))
               * F32(c.voxel_resolution)).astype(F32)
    fut = np.asarray(tree.future)[:, gather].T
    return {"occupied": occupied, "centers": centers, "future": fut}


def init_tree(c, cameras, sensor_pos, rows=None):
    """A fresh map centred at ``sensor_pos``: no particles, in ``[S, V]``
    planes, or in ``[rows]`` where given (the compact layout)."""
    V = c.V
    shape = (c.S, V) if rows is None else (rows,)
    z = lambda dt=F32: np.zeros(shape, dt)  # noqa: E731
    pos = np.asarray(sensor_pos, F32)
    lead = () if cameras == 1 else (cameras,)
    C = c.max_clusters
    return types.SimpleNamespace(
        particles=types.SimpleNamespace(
            flags=z(np.int32), px=z(), py=z(), pz=z(), vx=z(), vy=z(),
            vz=z(), weight=z(), t=z()),
        weight_sum=np.zeros(V, F32), vel_avg=np.zeros((V, 3), F32),
        future=np.zeros((c.T, V), F32), sensor_pos=pos,
        last_sensor_pos=pos.copy(), origin=window_origin(pos, c),
        update_time=F32(0), last_timestamp=F32(0), update_counter=0,
        initialized=False,
        estimator=types.SimpleNamespace(
            prev_centers=np.zeros(lead + (C, 3), F32),
            prev_point_num=np.zeros(lead + (C,), np.int32),
            prev_intensity=np.zeros(lead + (C,), F32),
            prev_valid=np.zeros(lead + (C,), bool)))


def to_tf32(x):
    """float32 values rounded to TF32's 10 mantissa bits, nearest even."""
    bits = np.ascontiguousarray(x, F32).view(np.int32)
    keep = bits + 0x0FFF + ((bits >> 13) & 1)
    return (keep & ~0x1FFF).view(F32)


def to_bf16(x):
    """float32 values rounded to bfloat16, nearest even."""
    bits = np.ascontiguousarray(x, F32).view(np.int32)
    keep = bits + 0x7FFF + ((bits >> 16) & 1)
    return (keep & ~0xFFFF).view(F32)
