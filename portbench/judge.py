"""The comparison that decides ``correct``: the numbers that hold one
frame's result on the program's side against the reference's.

A result is the state after the frame (a tree of numpy arrays, as
``program.to_tree`` and ``reference.step.run`` give it) and the occupancy
readout that follows it.  The particles are compared by the world voxel
they lie in, so the comparison reads the pool layout's slots and the
compact layout's rows alike: two sides that place the same particles in the
same voxels with the same weights, positions and velocities agree, in
whatever slot or row each sits.  Each number is a share, 0 where the two
sides agree to the tolerances below:

* ``alive_rel``: the alive counts' difference over the reference's;
* ``cell_count_off``: the summed per-voxel differences of the alive counts
  over the reference's alive count;
* ``cell_payload_off``: the share of voxels holding particles on either
  side whose count, weight sum (rtol 1e-3), weighted mean position (1e-4 m)
  or weighted mean velocity (1e-4 m/s) differs;
* ``voxel_state_off``: the share of voxels whose ``weight_sum`` (rtol
  1e-3, atol 1e-6) or ``vel_avg`` (atol 1e-4 m/s) differs;
* ``future_off``: the share of the future grid's entries (rtol 1e-3, atol
  1e-5) that differ;
* ``readout_off``: the share of the readout's voxels whose occupied flag,
  centre (1e-4 m) or future row (rtol 1e-3, atol 1e-5) differs;
* ``estimator_off``: the share of the velocity-estimator tracks valid on
  either side that differ in validity, centre (1e-4 m), point count or
  intensity (rtol 1e-4), pooled over a run's compared frames (a run's
  reading of the others is their worst frame): a point at the clustering
  tolerance's edge flips one track now and then, the card's Gram product
  summing in another order than the CPU's.

The relative tolerances of 1e-3 leave room for the last bits in which the
card's sums and products part from the CPU's: the likelihood of a particle
is a function of its distance to the points, taken in world coordinates, so
one rounding of a coordinate tens of metres from the origin moves a weight
by some 1e-4.

On the start frame (a fresh map, every voxel's particles newborns of one
weight) the first three are not taken: how many copies of such a voxel
survive the resample turns on the last bit of the newborn weight, so they
read 0 or a few percent as that bit falls, on the card as against the CPU
alike; the voxels' weights, the future and the estimator hold the start.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("alive_rel", "cell_count_off", "cell_payload_off",
           "voxel_state_off", "future_off", "readout_off", "estimator_off")
#: a frame's differing and valid estimator tracks, which a run pools
TRACKS = "_tracks"
#: the numbers not taken on the start frame
PARTICLE_COUNTS = ("alive_rel", "cell_count_off", "cell_payload_off")


def _close(a, b, rtol, atol):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) <= (
        atol + rtol * np.abs(np.asarray(b, np.float64)))


def _cells(particles, resolution: float):
    """Per world voxel of the alive particles: ``(keys, count, weight sum,
    weighted position sums [n, 3], weighted velocity sums [n, 3])``."""
    alive = np.asarray(particles.flags).reshape(-1) != 0
    get = lambda n: np.asarray(getattr(particles, n),  # noqa: E731
                               np.float64).reshape(-1)[alive]
    pos = np.stack([get(n) for n in ("px", "py", "pz")], 1)
    vel = np.stack([get(n) for n in ("vx", "vy", "vz")], 1)
    w = get("weight")
    vox = np.floor(pos * np.float32(1.0 / resolution)).astype(np.int64)
    vox = (vox + (1 << 20)) & ((1 << 21) - 1)
    keys, inv = np.unique((vox[:, 0] << 42) | (vox[:, 1] << 21) | vox[:, 2],
                          return_inverse=True)
    inv = inv.reshape(-1)
    n = len(keys)
    count = np.bincount(inv, minlength=n)
    wsum = np.bincount(inv, w, minlength=n)
    wpos = np.stack([np.bincount(inv, w * pos[:, k], minlength=n)
                     for k in range(3)], 1)
    wvel = np.stack([np.bincount(inv, w * vel[:, k], minlength=n)
                     for k in range(3)], 1)
    return keys, count, wsum, wpos, wvel


def _on_union(a, b):
    """Both sides' per-voxel arrays on the union of their voxels."""
    keys = np.union1d(a[0], b[0])

    def spread(side):
        idx = np.searchsorted(keys, side[0])
        out = []
        for arr in side[1:]:
            full = np.zeros((len(keys),) + arr.shape[1:], arr.dtype)
            full[idx] = arr
            out.append(full)
        return out

    return spread(a), spread(b)


def _mean(sums, wsum):
    return sums / np.where(wsum > 0, wsum, 1.0)[:, None]


def compare(prog, ref, resolution: float, start: bool = False) -> dict:
    """The numbers of one frame: ``prog`` and ``ref`` are ``(state tree,
    readout)`` pairs; ``start`` leaves out :data:`PARTICLE_COUNTS`."""
    (ps, pr), (rs, rr) = prog, ref
    pa, ra = _cells(ps.particles, resolution), _cells(rs.particles,
                                                       resolution)
    alive_p, alive_r = int(pa[1].sum()), int(ra[1].sum())
    (pc, pw, pp, pv), (rc, rw, rp, rv) = _on_union(pa, ra)
    payload = ((pc != rc) | ~_close(pw, rw, 1e-3, 1e-12)
               | ~_close(_mean(pp, pw), _mean(rp, rw), 0.0, 1e-4).all(1)
               | ~_close(_mean(pv, pw), _mean(rv, rw), 0.0, 1e-4).all(1))
    voxel = (~_close(ps.weight_sum, rs.weight_sum, 1e-3, 1e-6)
             | ~_close(ps.vel_avg, rs.vel_avg, 0.0, 1e-4).all(-1))
    future = ~_close(ps.future, rs.future, 1e-3, 1e-5)
    readout = ((pr["occupied"] != rr["occupied"])
               | ~_close(pr["centers"], rr["centers"], 0.0, 1e-4).all(-1)
               | ~_close(pr["future"], rr["future"], 1e-3, 1e-5).all(-1))
    pe, re = ps.estimator, rs.estimator
    valid_p = np.asarray(pe.prev_valid).reshape(-1)
    valid_r = np.asarray(re.prev_valid).reshape(-1)
    both = valid_p & valid_r
    tracks = ((valid_p != valid_r)
              | both & ~_close(np.asarray(pe.prev_centers).reshape(-1, 3),
                               np.asarray(re.prev_centers).reshape(-1, 3),
                               0.0, 1e-4).all(-1)
              | both & (np.asarray(pe.prev_point_num).reshape(-1)
                        != np.asarray(re.prev_point_num).reshape(-1))
              | both & ~_close(np.asarray(pe.prev_intensity).reshape(-1),
                               np.asarray(re.prev_intensity).reshape(-1),
                               1e-4, 1e-6))
    out = {
        "alive_rel": abs(alive_p - alive_r) / max(alive_r, 1),
        "cell_count_off": float(np.abs(pc - rc).sum()) / max(alive_r, 1),
        "cell_payload_off": float(payload.mean()) if len(payload) else 0.0,
        "voxel_state_off": float(voxel.mean()),
        "future_off": float(future.mean()),
        "readout_off": float(readout.mean()),
        "estimator_off": (float(tracks.sum())
                          / max(int((valid_p | valid_r).sum()), 1)),
        TRACKS: (int(tracks.sum()), int((valid_p | valid_r).sum())),
    }
    if start:
        for k in PARTICLE_COUNTS:
            del out[k]
    return out


def worst(readings: list) -> dict:
    """A run's reading of each number from its compared frames: the
    largest, and ``estimator_off`` pooled over the frames."""
    out = {k: max(r[k] for r in readings if k in r) for k in NUMBERS
           if any(k in r for r in readings)}
    pooled = [r[TRACKS] for r in readings if TRACKS in r]
    if pooled:
        out["estimator_off"] = (sum(d for d, _ in pooled)
                                / max(sum(v for _, v in pooled), 1))
    return out


def verdict(numbers: dict, limits: dict):
    """``(correct, lines)``: every number of ``limits`` taken and at or
    under its limit (a number no compared frame gave fails), and one
    ``name value limit`` line each."""
    ok = all(numbers.get(k) is not None and numbers[k] <= lim
             for k, lim in limits.items())
    lines = [f"{k} {numbers.get(k)!r} limit {lim!r}"
             for k, lim in limits.items()]
    return ok, lines
