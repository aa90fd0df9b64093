"""The port's geometry, ``ops/common`` primitives, ingest, rebin + FOV
registration, clustering and assignment against the JAX package's
functions on the same numpy-seeded inputs (CPU).  Integer outputs must be
equal; float outputs agree to the tolerance stated at each assert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu import geometry as jg
from dspmap_tpu.ops import common as jc
from dspmap_tpu.ops.assignment import solve_assignment as jax_solve
from dspmap_tpu.ops.cluster import euclidean_cluster as jax_cluster
from dspmap_tpu.ops.fov import rebin_and_register as jax_rebin
from dspmap_tpu.ops.project import project_points as jax_project
from dspmap_tpu.ops.sweep import sweep_reference as jax_sweep
from dspmap_tpu.state import flatten_pool
from dspmap_tpu.utils import sim
from dspmap_tpu_torch import geometry as tg
from dspmap_tpu_torch.ops import common as tc
from dspmap_tpu_torch.ops.assignment import solve_assignment
from dspmap_tpu_torch.ops.cluster import euclidean_cluster
from dspmap_tpu_torch.ops.fov import rebin_and_register
from dspmap_tpu_torch.ops.project import project_points
from dspmap_tpu_torch.ops.sweep import sweep_reference

torch.set_num_threads(2)

KW = dict(nx=16, ny=16, nz=8, max_input_points=512, mover_capacity=1024,
          pyramid_slot_capacity=24, pyramid_dense_slots=8, max_clusters=12,
          obs_dense_points=4, fov_capacity=4096)


def _cfgs(**kw):
    kw = {**KW, **kw}
    return (J.example_node_settings(J.dsp_dynamic(**kw)),
            T.example_node_settings(T.dsp_dynamic(**kw)))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------- geometry

def test_window_origin_and_storage_index_with_negative_origins():
    """Window origin, toroidal cells and the ego gather agree exactly,
    including the negative origins of a sensor that moved to -x/-y/-z
    (``torch.remainder`` is a floor mod; ``fmod`` would truncate)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    for sensor in rng.uniform(-40, 40, (6, 3)).astype(np.float32):
        o = tg.window_origin_np(sensor, tcfg)
        np.testing.assert_array_equal(
            o, np.asarray(jg.window_origin(jnp.asarray(sensor), jcfg)))
        np.testing.assert_array_equal(
            _n(tg.ego_grid_gather_indices(o, tcfg, "cpu")),
            np.asarray(jg.ego_grid_gather_indices(jnp.asarray(o), jcfg)))
        np.testing.assert_array_equal(
            _n(tg.storage_to_world_voxel(o, tcfg, "cpu")),
            np.asarray(jg.storage_to_world_voxel(jnp.asarray(o), jcfg)))
    wv = rng.integers(-200, 200, (4000, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        _n(tg.storage_index(torch.from_numpy(wv), tcfg)),
        np.asarray(jg.storage_index(jnp.asarray(wv), jcfg)))
    o = np.asarray([-37, -5, -9], np.int32)
    rel = rng.integers(0, 8, (3, 500)).astype(np.int32)
    np.testing.assert_array_equal(
        _n(tg.storage_index_from_rel(*map(torch.from_numpy, rel), o, tcfg)),
        np.asarray(jg.storage_index_from_rel(*map(jnp.asarray, rel),
                                             jnp.asarray(o), jcfg)))


def test_pyramid_index_and_rotation():
    """Quaternion rotation to 1e-6 (same cross-product form); pyramid cells
    and the FOV mask equal on >= 99.9% of points (atan2 implementations
    may differ by an ulp exactly at a cell boundary)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    v = rng.normal(0, 3, (5000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _n(tg.quaternion_rotate(torch.from_numpy(q), torch.from_numpy(v))),
        np.asarray(jg.quaternion_rotate(jnp.asarray(q), jnp.asarray(v))),
        atol=1e-5)
    np.testing.assert_allclose(
        tg.rotation_matrix_np(q), np.asarray(jg.rotation_matrix(jnp.asarray(q))),
        atol=1e-7)
    c, m = tg.pyramid_index(torch.from_numpy(v), tcfg)
    jc_, jm = jg.pyramid_index(jnp.asarray(v), jcfg)
    assert np.mean(_n(c) == np.asarray(jc_)) >= 0.999
    assert np.mean(_n(m) == np.asarray(jm)) >= 0.999
    assert _n(m).sum() > 100


# --------------------------------------------------------- common primitives

@pytest.mark.parametrize("capacity", [64, 700, 5000])
def test_compact_mask(capacity):
    """Exact: first-to-last order, capacity cut, overflow count."""
    mask = np.random.default_rng(capacity).random(3000) < 0.2
    got = tc.compact_mask(torch.from_numpy(mask), capacity)
    want = jc.compact_mask(jnp.asarray(mask), capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_n(g), np.asarray(w))


def test_sort_group_and_segment_primitives():
    """Exact: stable sort by destination, run ranks, grouping, counts,
    row selection and the drop-mode pool scatter/gather."""
    rng = np.random.default_rng(2)
    dest = rng.integers(0, 50, 800).astype(np.int32)
    valid = rng.random(800) < 0.7
    got = tc.sort_by_destination(torch.from_numpy(dest), torch.from_numpy(valid))
    want = jc.sort_by_destination(jnp.asarray(dest), jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_n(g), np.asarray(w))
    np.testing.assert_array_equal(
        _n(tc.segment_counts(torch.from_numpy(dest), torch.from_numpy(valid), 50)),
        np.asarray(jc.segment_counts(jnp.asarray(dest), jnp.asarray(valid), 50)))
    mask = rng.random((6, 40)) < 0.3
    group = rng.integers(0, 9, (6, 40)).astype(np.int32)
    got = tc.compact_and_group(torch.from_numpy(mask), torch.from_numpy(group),
                               100, 9)
    want = jc.compact_and_group(jnp.asarray(mask.ravel()),
                                jnp.asarray(group.ravel()), 100, 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_n(g), np.asarray(w))
    table = rng.normal(size=(5, 30)).astype(np.float32)
    rows = rng.integers(0, 5, (4, 30)).astype(np.int32)
    np.testing.assert_array_equal(
        _n(tc.select_rows(torch.from_numpy(table), torch.from_numpy(rows), 5)),
        np.asarray(jc.select_rows(jnp.asarray(table), jnp.asarray(rows), 5)))
    plane = rng.normal(size=(4, 25)).astype(np.float32)
    flat = np.asarray([3, 99, 100, 250, -1, 7], np.int32)  # 100+ dropped
    vals = np.arange(6, dtype=np.float32)
    put = tc.pool_put(torch.from_numpy(plane.copy()), torch.from_numpy(flat),
                      torch.from_numpy(vals))
    want = plane.ravel().copy()
    want[[3, 99, 7]] = vals[[0, 1, 5]]
    np.testing.assert_array_equal(_n(put).ravel(), want)
    np.testing.assert_array_equal(
        _n(tc.pool_take(torch.from_numpy(plane), torch.from_numpy(flat[:4]))),
        plane.ravel()[[3, 99, 99, 99]])


# -------------------------------------------------------------------- ingest

def _frames(cfg, n, seed=3):
    return list(sim.generate_sequence(n, cfg, seed=seed))


def test_project_points_matches_jax():
    """Dense and spill tiers, masks, counts and max range: integer fields
    exact, positions to 1e-5 m (same rotation arithmetic), max range to
    1e-6 relative.  The small dense tier (4) forces the spill path."""
    jcfg, tcfg = _cfgs()
    pts, n, pos, quat, _ = _frames(jcfg, 3)[2]
    valid = np.arange(pts.shape[0]) < n
    want = jax_project(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pos),
                       jnp.asarray(quat), jcfg)
    got = project_points(torch.from_numpy(pts), torch.from_numpy(valid), pos,
                         quat, tcfg)
    assert _n(got.spill_cell_mask).sum() > 0
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), _n(getattr(got, name))
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


# ------------------------------------------------------- rebin + FOV binning

def _moving_pool(jcfg, seed):
    state = J.init_state(jcfg, jax.random.key(seed), sensor_pos=(0.4, -0.3, 1.0),
                         init_particle_num=30000, init_weight=0.05)
    p = state.particles
    rng = np.random.default_rng(seed)
    S, V = p.flags.shape
    vx = np.where(rng.random((S, V)) < 0.3, rng.normal(0, 2.0, (S, V)), 0)
    vy = np.where(rng.random((S, V)) < 0.3, rng.normal(0, 2.0, (S, V)), 0)
    flags = np.asarray(p.flags) * np.where(rng.random((S, V)) < 0.2, 3, 1)
    p = dataclasses.replace(
        p, vx=jnp.asarray(vx, jnp.float32), vy=jnp.asarray(vy, jnp.float32),
        vz=jnp.zeros((S, V), jnp.float32),
        flags=jnp.asarray(np.minimum(flags, 3), jnp.int32))
    return state, p


@pytest.mark.parametrize("seed", [0, 1])
def test_rebin_and_register_matches_jax(seed):
    """Mover relocation with drop-on-full ranks, the pyramid-capacity kill,
    dense/spill binning and the future-mover set: every integer field and
    counter exact, float fields to 1e-6 (gathers of the same values; the
    range is the same sqrt)."""
    jcfg, tcfg = _cfgs(pyramid_slot_capacity=12, fov_capacity=16384)
    state, jp = _moving_pool(jcfg, seed)
    sensor = np.asarray([0.6, -0.2, 1.0], np.float32)
    quat = np.asarray([np.cos(0.15), 0, 0, np.sin(0.15)], np.float32)
    dt = np.float32(0.1)
    origin = tg.window_origin_np(sensor, tcfg)
    sw = jax_sweep(jp, jcfg, jnp.float32(dt), jnp.asarray(origin),
                   jnp.asarray(sensor), jnp.asarray(quat))
    jp2 = dataclasses.replace(jp, px=sw.px, py=sw.py, pz=sw.pz, flags=sw.flags)
    flat = flatten_pool(jp2, skip=("t",))
    sw_flat = sw._replace(tags=sw.tags.reshape(-1), new_cell=sw.new_cell.reshape(-1))
    j_out, j_bin, j_fm, j_stats, _ = jax_rebin(
        flat, jcfg, sw_flat, jnp.asarray(sensor), jnp.float32(1.0))

    tp = T.Particles(**{k: torch.from_numpy(np.array(getattr(jp, k)))
                        for k in ("flags", "px", "py", "pz", "vx", "vy", "vz",
                                  "weight", "t")})
    tsw = sweep_reference(tp, tcfg, dt, origin, sensor, quat)
    assert torch.equal(tsw.tags, torch.from_numpy(np.array(sw.tags)))
    tp2 = dataclasses.replace(tp, px=tsw.px, py=tsw.py, pz=tsw.pz, flags=tsw.flags)
    t_out, t_bin, t_fm, t_stats = rebin_and_register(tp2, tcfg, tsw, sensor, 1.0)

    assert int(t_stats["movers"]) > 50 and int(t_stats["pyramid_full_killed"]) > 0
    assert int(_n(t_bin.sp_mask).sum()) > 0
    for k in ("flags", "px", "py", "pz", "vx", "vy", "weight"):
        np.testing.assert_allclose(_n(getattr(t_out, k)).ravel(),
                                   np.asarray(getattr(j_out, k)), rtol=1e-6,
                                   err_msg=k)
    for name in j_bin._fields:
        a, b = np.asarray(getattr(j_bin, name)), _n(getattr(t_bin, name))
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    for a, b in zip(j_fm, t_fm):
        np.testing.assert_array_equal(_n(b), np.asarray(a))
    assert set(t_stats) == set(j_stats)
    for k in j_stats:
        assert int(t_stats[k]) == int(j_stats[k]), k


# ------------------------------------------------------------ the estimator

def test_euclidean_cluster_matches_jax():
    """Labels equal: blobs of points with gaps well above the tolerance,
    plus scattered singletons and invalid points."""
    rng = np.random.default_rng(4)
    centers = rng.uniform(-5, 5, (12, 3))
    pts = np.concatenate([c + rng.normal(0, 0.08, (40, 3)) for c in centers]
                         + [rng.uniform(-8, 8, (300, 3))]).astype(np.float32)
    valid = rng.random(pts.shape[0]) < 0.9
    want = np.asarray(jax_cluster(jnp.asarray(pts), jnp.asarray(valid), 0.2, 12))
    got = _n(euclidean_cluster(torch.from_numpy(pts), torch.from_numpy(valid),
                               0.2, 12))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want[valid])) > 12


#: the estimator's cost of an ungated pair (``assoc_distance_gate * 5000``
#: at the default gate of 1.5 m): every such pair costs the same
GATED_OUT = np.float32(1.5 * 5000.0)


def _assignment_costs(kind, rng, R, C):
    """``uniform``: distinct floats; ``ties``: integers in {0, 1, 2, 3} on
    a third of the pairs and the gate's constant on the rest, so equal
    minima meet on almost every path step; ``equal``: the gate's constant
    on every pair (row i's path visits every matched column: the longest
    chain of path steps); ``negative_zero``: ties with -0.0 on about a
    third of the pairs."""
    if kind == "uniform":
        return rng.uniform(0, 2000, (R, C)).astype(np.float32)
    if kind == "equal":
        return np.full((R, C), GATED_OUT, np.float32)
    small = rng.integers(0, 4, (R, C)).astype(np.float32)
    cost = np.where(rng.random((R, C)) < 1 / 3, small, GATED_OUT)
    if kind == "negative_zero":
        cost[rng.random((R, C)) < 0.3] = -0.0
    return cost


def _valid(rng, n, size, first):
    """``n`` valid entries of ``size``: the first ``n`` (``first``), else
    drawn from the leading 8 when ``n <= 8`` (the exhaustive 8x8 arm) and
    from all ``size`` otherwise."""
    v = np.zeros(size, bool)
    if first:
        v[:n] = True
    else:
        v[rng.choice(size if n > 8 else 8, n, replace=False)] = True
    return v


@pytest.mark.parametrize("n_rows,n_cols,size,kind,first", [
    pytest.param(3, 5, 16, "uniform", False, id="3-5"),
    pytest.param(7, 7, 16, "uniform", False, id="7-7"),
    pytest.param(12, 9, 16, "uniform", False, id="12-9"),
    pytest.param(16, 16, 16, "uniform", False, id="16-16"),
    pytest.param(12, 16, 16, "ties", False, id="ties-12-16"),
    pytest.param(16, 16, 16, "ties", False, id="ties-16-16"),
    pytest.param(33, 33, 33, "ties", False, id="ties-33-33"),
    pytest.param(64, 64, 64, "ties", False, id="ties-64-64"),
    pytest.param(40, 29, 64, "uniform", False, id="64-scattered"),
    pytest.param(20, 33, 33, "ties", True, id="ties-33-n_rows-20"),
    pytest.param(11, 30, 33, "uniform", True, id="33-n_rows-11"),
    pytest.param(0, 16, 16, "ties", False, id="no-rows"),
    pytest.param(16, 0, 16, "ties", False, id="no-columns"),
    pytest.param(0, 0, 33, "uniform", False, id="33-empty"),
    pytest.param(16, 16, 16, "equal", False, id="equal-16-16"),
    pytest.param(31, 31, 31, "ties", False, id="ties-31-31"),
    pytest.param(32, 32, 32, "ties", False, id="ties-32-32"),
    pytest.param(16, 16, 16, "negative_zero", False, id="negative-zero-16"),
    pytest.param(25, 31, 31, "negative_zero", True,
                 id="negative-zero-31-n_rows-25"),
])
def test_solve_assignment_matches_jax(n_rows, n_cols, size, kind, first):
    """The assignment equals the JAX solve: the exhaustive 8x8 path when
    every valid row and column lies in the leading 8, the JV otherwise
    (the plain version on the CPU, whose bits the card's kernel is held
    to).  Tie-heavy costs pin its choice among equal minima to JAX's;
    ``first`` makes the valid rows a prefix, so the JV augments
    ``n_rows < R`` rows."""
    rng = np.random.default_rng(n_rows * 100 + n_cols + size * 10000
                                * (kind == "ties" or size != 16))
    R = C = size
    for trial in range(4 if size <= 33 else 2):
        cost = _assignment_costs(kind, rng, R, C)
        rv = _valid(rng, n_rows, R, first)
        cv = _valid(rng, n_cols, C, False)
        want = np.asarray(jax_solve(jnp.asarray(cost), jnp.asarray(rv),
                                    jnp.asarray(cv)))
        got = _n(solve_assignment(torch.from_numpy(cost), torch.from_numpy(rv),
                                  torch.from_numpy(cv)))
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).sum() == min(n_rows, n_cols)
