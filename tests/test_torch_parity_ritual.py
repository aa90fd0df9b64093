"""The port's parity ritual (``tools/parity_torch.py``) and the scatter
helper that lets the card repeat its bits.

The tool's frames are ``run_oracle.make_frames``' arrays, its readings on
canned records are the old tools' inline formulas (``parity_report.py``,
``parity_roc.py``), its ``jax`` mode runs on a small map against the JAX
step, its ``card`` mode runs CPU against CPU in a directory where jax is
blocked, and ``ops/common.py::add_at`` on the CPU is ``index_add_`` bit for
bit."""

import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dspmap_tpu_torch.ops import common, compact

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pt = _load(REPO / "tools" / "parity_torch.py")

#: a small map whose CPU step is quick (the cut of tests/test_torch_imports.py)
SMALL = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=1024,
             mover_capacity=1024, max_clusters=4, pyramid_slot_capacity=16)


# ---- frames ---------------------------------------------------------------------

@pytest.mark.parametrize("dense", [False, True])
def test_make_frames_equal_run_oracles(dense):
    """The tool's copy of ``run_oracle.make_frames`` on the port's scene
    generator gives the same arrays, at the flagship's field of view."""
    oracle = _load(REPO / "tools" / "oracle" / "run_oracle.py")
    got = pt.make_frames(6, 3000, seed=3, dense=dense)
    want = oracle.make_frames(6, 3000, seed=3, dense=dense)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_make_frames_take_the_configurations_field_of_view():
    """A narrower field of view gives other frames, with fewer points."""
    import dataclasses

    import dspmap_tpu_torch as dm

    flag = pt.preset_config(dm, "dynamic")
    narrow = dataclasses.replace(flag, half_fov_h_deg=21)
    assert narrow.half_fov_h_deg < flag.half_fov_h_deg
    a = pt.make_frames(3, 3000, seed=3, dense=False, cfg=narrow)
    b = pt.make_frames(3, 3000, seed=3, dense=False)
    assert all(x[1] < y[1] for x, y in zip(a, b))


# ---- readings on canned records ------------------------------------------------------

def _canned(seed, n_frames=30, n_vox=400, T=6):
    """Frames of ``read_occupancy``-shaped records: voxel centres on a 0.15 m
    lattice, weights, future weights."""
    rng = np.random.default_rng(seed)
    lattice = rng.integers(0, 30, (n_vox, 3)).astype(np.float32) * 0.15
    recs = []
    for _ in range(n_frames):
        w = np.where(rng.random(n_vox) < 0.4, rng.exponential(0.6, n_vox), 0)
        fut = np.where(rng.random((n_vox, T)) < 0.2,
                       rng.exponential(0.9, (n_vox, T)), 0)
        recs.append({"weight": w.astype(np.float32), "centers": lattice,
                     "future": fut.astype(np.float32)})
    return recs


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 5), (5, 0), (1, 1), (37, 300),
                                   (2500, 40)])
def test_chamfer_equals_parity_roc(na, nb):
    """A frame of ``agreement_curve`` is parity_roc.py's chamfer fractions
    of the two occupied sets and their sizes."""
    roc = _load(REPO / "tools" / "parity_roc.py")
    rng = np.random.default_rng(na * 7 + nb)
    a = rng.integers(0, 40, (na, 3)).astype(np.float32) * 0.15
    b = rng.integers(0, 40, (nb, 3)).astype(np.float32) * 0.15

    def rec(centers):  # every voxel occupied, and some below the threshold
        n = len(centers)
        return {"centers": np.concatenate([centers, centers + 0.07]),
                "weight": np.r_[np.ones(n), np.full(n, 0.1)].astype(
                    np.float32), "future": np.zeros((2 * n, 6), np.float32)}

    got = pt.agreement_curve([rec(a)], [rec(b)], 0.24)
    assert got.tolist() == [list(roc.chamfer(a, b, 0.24)) + [na, nb]]


def test_windows_and_gate_equal_parity_report():
    """parity_report.py's table windows and its final-third gate reading,
    as its inline code computes them."""
    rng = np.random.default_rng(5)
    for frames in (60, 100, 300):
        pf = rng.random((frames, 4))
        third = frames // 3
        want = [(pf[sl, 0].mean(), pf[sl, 1].mean()) for sl in (
            slice(10, 30), slice(third, 2 * third), slice(-third, None),
            slice(-20, None))]
        got = pt.windows(pf)
        assert [tuple(v) for v in got.values()] == want
        assert pt.final_third(pf) == pf[-(frames // 3):, :2].mean()


def test_operating_curve_equals_parity_rocs_sweep():
    recs, ref = _canned(1), _canned(2)
    tol, steady = 0.15 * 1.6, 5
    got = pt.operating_curve(recs, ref, tol, steady)
    for th in pt.THRESHOLDS:
        ms = []
        for i in range(steady, len(recs)):
            ours = recs[i]["centers"][recs[i]["weight"] > th]
            ref_w = ref[i]["centers"][ref[i]["weight"] > th]
            ms.append(pt.chamfer(ours, ref_w, tol))
        assert got[th] == np.mean(ms, axis=0).tolist()


def _parity_roc_calibration(recs, taus, steady, tol, frame_dt=0.1):
    """parity_roc.py's inline calibration loop for one seed."""
    from scipy.spatial import cKDTree

    bins = np.array([0.0, 0.5, 1.0, 2.0, np.inf])
    calib_hits = {tau: np.zeros(4) for tau in taus}
    calib_tot = {tau: np.zeros(4) for tau in taus}
    for k, tau in enumerate(taus):
        lead = int(round(tau / frame_dt))
        for i in range(steady, len(recs) - lead):
            pred = recs[i]["future"][:, k]
            pc = recs[i]["centers"]
            realized = recs[i + lead]["centers"][
                recs[i + lead]["weight"] > 0.2
            ]
            if len(realized) == 0:
                continue
            b = np.digitize(pred, bins) - 1
            sel_any = pred > 0
            pts = pc[sel_any]
            d, _ = cKDTree(realized).query(pts)
            hit = d <= tol
            bsel = b[sel_any]
            for bi in range(4):
                m = bsel == bi
                calib_tot[tau][bi] += m.sum()
                calib_hits[tau][bi] += (m & hit).sum()
    return (np.asarray([calib_hits[t] for t in taus]),
            np.asarray([calib_tot[t] for t in taus]))


def test_calibration_equals_parity_rocs_on_whole_and_cut_records():
    """The calibration of full records equals parity_roc.py's loop, and
    the records cut by ``reduce_record`` give the same counts."""
    recs = _canned(3)
    taus = [0.05, 0.2, 0.5, 1.0, 1.5, 2.0]
    want = _parity_roc_calibration(recs, taus, 4, 0.24)
    got = pt.calibration(recs, taus, 4, 0.24)
    cut = pt.calibration([pt.reduce_record(r["weight"], r["centers"],
                                           r["future"]) for r in recs],
                         taus, 4, 0.24)
    assert want[1].sum() > 0 and want[1][-1].sum() > 0
    for a, b, c in zip(want, got, cut):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_calibration_gate_reads_bins_of_enough_predictions():
    """Bins where the port or JAX a holds fewer than 500 predictions are
    not read; the others must lie within |JAX a - JAX b| + 0.05."""
    tot = np.full((2, 4), 1000.0)
    tot[1, 3] = 10
    ra = np.array([[0.5, 0.9, 1.0, 1.0]] * 2)
    rb = ra + [0.02, 0, 0, 0]
    near, far = ra + [0.06, 0, 0, 0], ra + [0.08, 0, 0, 0]
    near[1, 3] = far[1, 3] = 0.0  # the bin of 10 predictions
    jax_a, jax_b = (ra * tot, tot), (rb * tot, tot)
    ok, failed, checked = pt.calibration_gate((near * tot, tot), jax_a, jax_b)
    assert ok and not failed and checked == 7
    ok, failed, _ = pt.calibration_gate((far * tot, tot), jax_a, jax_b)
    assert not ok and [(k, b) for k, b, *_ in failed] == [(0, 0), (1, 0)]


# ---- the two modes --------------------------------------------------------------------

def test_jax_mode_on_a_small_map(tmp_path):
    """Twenty frames of a small dynamic map: the port with seed 3, JAX
    with key 3 and key 1003; every reading present and the report
    written, with its drift gate passed."""
    rec = pt.jax_job("dynamic", 3, tmp_path, n_frames=20, cfg_overrides=SMALL,
                     steady=4)
    assert (tmp_path / "jax_dynamic_s3.json").exists()
    ours, null = (np.asarray(rec[k]) for k in ("port_vs_jax", "jax_vs_jax"))
    assert ours.shape == null.shape == (20, 4)
    assert ours[4:, 2].min() > 0 and ours[4:, 3].min() > 0
    assert pt.final_third(ours) >= pt.final_third(null) - pt.DRIFT_MARGIN
    assert set(rec["roc_port_vs_jax"]) == set(pt.THRESHOLDS)
    hits, tot = (np.asarray(x) for x in rec["calibration"]["port"])
    assert tot.shape == (6, 4) and tot[0].sum() > 0
    assert (hits <= tot).all()
    doc = tmp_path / "PARITY_TORCH.md"
    pt.render(tmp_path, doc)
    text = doc.read_text()
    assert "### dynamic: 20 frames of 1024 points, seeds 3" in text
    assert "Drift gate" in text and "Calibration gate" in text


_CARD_ALONE = """
import sys
sys.modules["jax"] = None  # any import of jax raises ImportError
import json, pathlib
import numpy as np
import torch
torch.set_num_threads(2)
sys.path.insert(0, "tools")
import parity_torch as pt
import dspmap_tpu_torch as dm
assert not (pathlib.Path.cwd() / "dspmap_tpu").exists()
small = json.loads(sys.argv[1])
out = pathlib.Path("out")
for layout, n_sensors in (("pool", None), ("compact", 2)):
    cfg = dm.example_node_settings(dm.dsp_dynamic(layout=layout, **small))
    rec = pt.card_job(f"cpu_{layout}", out, device="cpu", cfg=cfg,
                      n_sensors=n_sensors, warm=2, n_frames=3)
    assert rec["teacher_forced_met"] == 3, rec["teacher_forced"]
    assert all(m["flags_equal"] == 1.0 and m["future_bit_equal"] == 1.0
               for m in rec["teacher_forced"])
    assert not rec["repeat_leaves_differing"] and rec["repeat_readouts_equal"]
    assert rec["card_vs_cpu"] == [[1.0, 1.0] + r[2:] for r in rec["card_vs_cpu"]]
    assert rec["alive_card"] == rec["alive_cpu"] and min(rec["alive_cpu"]) > 0
    if layout == "compact":
        for m in rec["teacher_forced"]:
            assert m["placed_alike"] == 1.0
            assert list(m["rows_parted"]) == [
                "into " + s for s in pt.COMPACT_STAGES] + ["result"]
            for w in m["rows_parted"].values():
                assert w["first_differing_row"] is None and not any(
                    w[k] for k in ("rows_differing", "card_only", "cpu_only",
                                   "cell_differing", "payload_differing",
                                   "n_cells_off", "cull_differing")), w
assert pt.render(out, pathlib.Path("PARITY_TORCH.md"))
assert "| cpu_compact | 3 of 3 PASS |" in open("PARITY_TORCH.md").read()
assert not [m for m, v in sys.modules.items()
            if v is not None and m.split(".")[0] in ("jax", "dspmap_tpu")]
print("OK")
"""


def test_card_mode_cpu_against_cpu_without_jax(tmp_path):
    """In a directory holding only the port and the tool, with jax
    blocked: the tool imports, and its card mode run with the CPU in the
    card's place (pool, and compact with two cameras) meets every bar,
    agrees with itself bit for bit and writes its report."""
    shutil.copytree(REPO / "dspmap_tpu_torch", tmp_path / "dspmap_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    (tmp_path / "tools").mkdir()
    for tool in ("parity_torch.py", "parity_roc.py"):
        shutil.copy(REPO / "tools" / tool, tmp_path / "tools")
    import json

    small = dict(SMALL, particle_capacity=4096)
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", _CARD_ALONE,
                          json.dumps(small)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")


# ---- the scatter helper ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("dim", [0, 1])
def test_add_at_on_the_cpu_is_index_add(dim, dtype):
    """``add_at`` on CPU tensors is ``index_add_`` bit for bit, duplicate
    indices included, so the CPU's bits (held against JAX) do not move."""
    g = torch.Generator().manual_seed(dim)
    shape = (300, 4) if dim == 0 else (4, 300)
    n = 5000
    idx = torch.randint(0, 300, (n,), generator=g)
    vals = torch.randn((n, 4) if dim == 0 else (4, n), generator=g) * 100
    out = (torch.randn(shape, generator=g) * 100).to(dtype)
    vals = vals.to(dtype)
    want = out.clone().index_add_(dim, idx, vals)
    got = common.add_at(out.clone(), idx, vals, dim=dim)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_scatter_add_and_table_keep_the_cpus_bits():
    """``scatter_add`` and the compact layout's per-cell table, whose dropped
    rows now spread over sentinel rows, give the bits of a single
    sentinel row and ``index_add_``."""
    g = torch.Generator().manual_seed(0)
    n = 50
    tgt = torch.randn(n, generator=g)
    idx = torch.randint(-5, n + 5, (3000,), generator=g)
    vals = torch.randn(3000, generator=g)
    old = torch.zeros(n + 1)
    old[:n] = tgt
    old.index_add_(0, torch.where((idx >= 0) & (idx < n), idx, n), vals)
    got = common.scatter_add(tgt, idx, vals)
    assert torch.equal(got.view(torch.int32), old[:n].view(torch.int32))

    cell = torch.randint(0, n, (3000,), generator=g, dtype=torch.int32)
    valid = torch.rand(3000, generator=g) < 0.6
    upd = torch.randn(4, 3000, generator=g)
    old = torch.zeros(4, n + 1)
    old.index_add_(1, torch.where(valid, cell.long(), n), upd)
    got = compact._table(cell, valid, upd, n)
    assert torch.equal(got.contiguous().view(torch.int32),
                       old[:, :n].contiguous().view(torch.int32))


def test_drop_rows_spread_out_of_range_entries():
    idx = torch.tensor([[0, -1, 7, 3], [9, 8, 2, 100]])
    got = common.drop_rows(idx, 8)
    assert got.dtype == torch.int64
    assert got.tolist() == [[0, 9, 7, 3], [12, 13, 2, 15]]
    many = common.drop_rows(torch.full((3000,), -1), 4)
    assert int(many.min()) == 4 and int(many.max()) == 4 + common.DROP_ROWS - 1


# ---- the bars and the row-shift witness --------------------------------------------

def _measures(**kw):
    m = dict(flags_equal=1.0, weight_sum_close=1.0, future_close=1.0,
             alive_rel=0.0)
    m.update(kw)
    return m


@pytest.mark.parametrize("name", ["flags_equal", "weight_sum_close",
                                  "future_close", "alive_rel"])
def test_missed_bars_reads_each_bar(name):
    """A measure at its bar meets it; one just past it misses that bar
    alone, for the pinned bars and for the free ones of both layouts."""
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.utils import parity

    assert parity.PINNED_BARS == dict(flags_equal=0.999,
                                      weight_sum_close=0.999,
                                      future_close=0.999, alive_rel=0.005)
    pool = dm.example_node_settings(dm.dsp_dynamic(**SMALL))
    small_compact = dm.example_node_settings(dm.dsp_dynamic(
        layout="compact", **dict(SMALL, particle_capacity=4096)))
    for bars in (parity.PINNED_BARS, parity.free_bars(pool),
                 parity.free_bars(small_compact)):
        bar = bars[name]
        assert parity.missed_bars(_measures(**{name: bar}), bars) == []
        past = bar + 1e-6 if name == "alive_rel" else bar - 1e-6
        assert parity.missed_bars(_measures(**{name: past}), bars) == [name]
    assert parity.free_bars(pool)["flags_equal"] == 0.999
    assert parity.free_bars(small_compact)["flags_equal"] == 0.995
    assert parity.free_bars(pool)["alive_rel"] == 0.02


def _compact_state(n_frames=3, **size):
    import dspmap_tpu_torch as dm

    cfg = dm.example_node_settings(dm.dsp_dynamic(
        layout="compact", **{**SMALL, "particle_capacity": 4096, **size}))
    state = dm.init_state(cfg, seed=1, device="cpu")
    step = dm.make_step(cfg)
    for f in pt.make_frames(n_frames, cfg.max_input_points, seed=3,
                            dense=False, cfg=cfg):
        state, _ = step(state, dm.Frame(*f[:4], np.float32(f[4])))
    return cfg, state


def test_rows_parted_finds_the_cell_off_by_one():
    """One alive row taken out of a compact population, the rows after it
    moved up one, reads as one cell whose count is off by one, the rows
    after it shifted, and nothing before it parted; one weight one ulp off
    reads as one row of other bits."""
    import dataclasses

    from dspmap_tpu_torch import geometry
    from dspmap_tpu_torch.state import _PLANES
    from dspmap_tpu_torch.utils import parity

    cfg, state = _compact_state()
    p = state.particles
    alive = torch.nonzero(p.flags != 0).flatten()
    assert len(alive) > 100
    k = int(alive[len(alive) // 2])
    keep = torch.cat([torch.arange(k), torch.arange(k + 1, len(p.flags)),
                      torch.tensor([k])])
    short = dataclasses.replace(p, **{n: getattr(p, n)[keep].clone()
                                      for n in _PLANES})
    short.flags[-1] = 0

    same = parity.rows_parted(p, p.clone(), cfg)
    assert same["first_differing_row"] is None and same["cells_off"] == []
    assert not any(same[k] for k in ("rows_differing", "card_only",
                                     "cpu_only", "cell_differing",
                                     "payload_differing", "n_cells_off",
                                     "cull_differing", "cull_rows"))

    w = parity.rows_parted(short, p, cfg)
    cell = int(geometry.storage_index_planar(*geometry.world_voxel_planar(
        p.px[k:k + 1], p.py[k:k + 1], p.pz[k:k + 1], cfg), cfg)[0])
    assert w["n_cells_off"] == 1
    c, a, b, first_short, first_p = w["cells_off"][0]
    assert (c, b - a) == (cell, 1) and first_p <= k
    assert first_short in (first_p, -1)
    n_alive = len(alive)
    last = int(alive[-1])
    # the rows from k on hold the next row's particle: some in another cell
    assert w["cell_differing"] + w["payload_differing"] + w["card_only"] \
        + w["cpu_only"] >= 1
    assert w["cell_differing"] + w["payload_differing"] <= last - k
    assert w["first_differing_row"] is None or w["first_differing_row"] >= k
    assert n_alive - int((short.flags != 0).sum()) == 1

    nudged = p.clone()
    nudged.weight[k] = torch.nextafter(nudged.weight[k],
                                       torch.tensor(float("inf")))
    w = parity.rows_parted(nudged, p, cfg)
    assert w["payload_differing"] == 1 and w["rows_differing"] == 0
    assert w["n_cells_off"] == 0 and w["cell_differing"] == 0
    assert w["cull_differing"] == 0


def test_a_resample_flip_moves_a_few_rows():
    """One weight one part in 10^6 up flips a resample decision of its
    cell: the two results of ``occupancy_compact`` differ in that cell's
    count and in a few rows' flags, and no particle changes its cell."""
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.ops.compact import occupancy_compact
    from dspmap_tpu_torch.utils import parity

    cfg, state = _compact_state(7, nx=32, ny=32, max_input_points=2048,
                                mover_capacity=2048, particle_capacity=16384)
    f = pt.make_frames(8, cfg.max_input_points, seed=3, dense=False,
                       cfg=cfg)[7]
    into = {}  # the particles the next frame's occupancy takes in
    with parity.particles_recorded(("occupancy_compact",), into):
        new, _ = dm.make_step(cfg)(state, dm.Frame(*f[:4], np.float32(f[4])))
    p = into["occupancy_compact"][0]
    args = (cfg, new.origin, state.future)
    base = occupancy_compact(p, *args)[0]
    for i in torch.nonzero(p.flags != 0).flatten()[::7].tolist():
        q = p.clone()
        q.weight[i] = q.weight[i] * (1 + 1e-6)
        w = parity.rows_parted(occupancy_compact(q, *args)[0], base, cfg)
        if w["n_cells_off"]:
            break
    else:
        raise AssertionError("no resample flip found")
    assert w["n_cells_off"] == 1 and w["cell_differing"] == 0
    assert 0 < w["rows_differing"] <= 10, w


def test_a_cull_flip_moves_the_rows_after_it():
    """One particle whose weight sits one ulp above the cull threshold on
    one side and one ulp below on the other: ``rows_parted`` of the two
    inputs names that row, and in the two results of ``occupancy_compact``
    the culled row sorts to the tail on one side only, so the particles
    after it sit a row apart (their flags differ too where the resample
    has left holes, thousands of rows on large_urban)."""
    from dspmap_tpu_torch.ops.compact import occupancy_compact
    from dspmap_tpu_torch.utils import parity

    cfg, state = _compact_state()
    p = state.particles
    alive = torch.nonzero(p.flags != 0).flatten()
    i = int(alive[len(alive) // 3])
    thr = torch.tensor(cfg.weight_cull_threshold, dtype=torch.float32)
    above, below = p.clone(), p.clone()
    above.weight[i] = torch.nextafter(thr, torch.tensor(1.0))
    below.weight[i] = torch.nextafter(thr, torch.tensor(0.0))
    w_in = parity.rows_parted(above, below, cfg)
    assert w_in["cull_differing"] == 1 and w_in["payload_differing"] == 1
    r, _, a, b = w_in["cull_rows"][0]
    assert r == i and b < cfg.weight_cull_threshold <= a
    out = [occupancy_compact(q, cfg, state.origin, state.future)[0]
           for q in (above, below)]
    w = parity.rows_parted(*out, cfg)
    assert w["n_cells_off"] == 1 and w["card_only"] - w["cpu_only"] == 1
    assert w["cell_differing"] + w["payload_differing"] > 20


# ---- the update pinned -------------------------------------------------------------

def _frame_and_draws(cfg, n_sensors=None, frame_at=3):
    import dspmap_tpu_torch as dm

    f = pt.make_frames(frame_at + 1, cfg.max_input_points, seed=3,
                       dense=False, cfg=cfg)[frame_at]
    frame = dm.Frame(*f[:4], np.float32(f[4]))
    gen = torch.Generator()
    gen.manual_seed(5)
    if n_sensors is None:
        return frame, dm.make_draws(cfg, gen, "cpu")
    return (dm.stack_frames([frame] * n_sensors),
            dm.make_multisensor_draws(cfg, n_sensors, gen, "cpu"))


@pytest.mark.parametrize("case", ["pool_working_buffers", "compact",
                                  "two_cameras"])
def test_updates_pinned_to_their_own_results_change_no_bit(case,
                                                           monkeypatch):
    """``updates_recorded`` keeps each ``measurement_update``'s particles
    and ``norm_coeff`` (one a camera), and ``updates_pinned`` hands them
    back in order: the step gives the same state bit for bit, also where
    the update returns working buffers that birth writes in place
    (``state._DMA_RELAYOUT_BYTES`` patched to 0)."""
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch import state as state_mod
    from dspmap_tpu_torch.utils import parity

    n_sensors = 2 if case == "two_cameras" else None
    if case == "compact":
        cfg, state = _compact_state()
    else:
        if case == "pool_working_buffers":
            monkeypatch.setattr(state_mod, "_DMA_RELAYOUT_BYTES", 0)
        cfg = dm.example_node_settings(dm.dsp_dynamic(**SMALL))
        state = (dm.init_state(cfg, seed=1, device="cpu",
                               init_particle_num=2000) if n_sensors is None
                 else dm.init_multisensor_state(cfg, n_sensors, seed=1,
                                                device="cpu"))
    step = (dm.make_step(cfg) if n_sensors is None
            else dm.make_multisensor_step(cfg, n_sensors))
    first = 3 if case == "compact" else 0  # the frames after the state's
    frame, draws = _frame_and_draws(cfg, n_sensors, frame_at=first)
    state, _ = step(state, frame, draws)
    frame, draws = _frame_and_draws(cfg, n_sensors, frame_at=first + 1)
    seen = []
    with parity.updates_recorded(seen):
        plain, _ = step(state, frame, draws)
    assert len(seen) == (n_sensors or 1)
    if case == "pool_working_buffers":
        assert seen[0][0].flags.dim() == 1  # the flat working phase
    pending = list(seen)
    with parity.updates_pinned(pending):
        again, _ = step(state, frame, draws)
    assert not pending
    assert not parity.differing_leaves(again, plain)


def test_a_pinned_weight_across_the_cull_threshold_moves_the_rows():
    """One recorded weight of the update set one ulp under
    ``weight_cull_threshold`` and pinned: the particles the step's
    occupancy takes in carry that weight, the cull takes that row on this
    side only (``rows_parted``'s ``cull_differing``), and the result's rows
    follow it -- as a CPU step pinned to the card's update follows the
    card's weights."""
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.utils import parity

    cfg, state = _compact_state()
    frame, draws = _frame_and_draws(cfg)
    step = dm.make_step(cfg)
    seen, into = [], {}
    with parity.updates_recorded(seen), parity.particles_recorded(
            ("occupancy_compact",), into):
        plain, _ = step(state, frame, draws)
    (p, norm_coeff), = seen
    thr = torch.tensor(cfg.weight_cull_threshold, dtype=torch.float32)
    alive = torch.nonzero((p.flags != 0) & (p.weight > 2 * thr)).flatten()
    i = int(alive[len(alive) // 3])
    nudged = p.clone()
    nudged.weight[i] = torch.nextafter(thr, torch.tensor(0.0))
    into_pinned = {}
    with parity.updates_pinned([(nudged, norm_coeff)]), \
            parity.particles_recorded(("occupancy_compact",), into_pinned):
        new, _ = step(state, frame, draws)
    q, q_plain = into_pinned["occupancy_compact"][0], into["occupancy_compact"][0]
    assert torch.equal(q.weight[i].view(torch.int32),
                       nudged.weight[i].view(torch.int32))
    w_in = parity.rows_parted(q, q_plain, cfg)
    assert w_in["cull_differing"] == 1 and w_in["cull_rows"][0][0] == i
    assert w_in["cell_differing"] == 0 and w_in["n_cells_off"] == 0
    w = parity.rows_parted(new.particles, plain.particles, cfg)
    assert w["n_cells_off"] >= 1 and w["cpu_only"] - w["card_only"] >= 1
    assert w["cell_differing"] + w["payload_differing"] > 0


# ---- the repeat probe ---------------------------------------------------------------

@pytest.mark.parametrize("layout,n_sensors", [("pool", None),
                                              ("compact", 2)])
def test_repeat_probe_on_the_cpu(layout, n_sensors):
    """``utils/repeat_probe.py``'s probe at a small size on the CPU: the
    step with deterministic mode on gives the plain step's bits, and two
    runs from one state with the same draws are bit-equal."""
    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.utils import repeat_probe

    cfg = dm.example_node_settings(dm.dsp_dynamic(
        layout=layout, **dict(SMALL, particle_capacity=4096)))
    got = repeat_probe.probe(cfg, n_sensors, device="cpu", warm=2,
                             watched=1, repeated=2)
    assert got["det_mode_vs_plain_differing"] == []
    assert got["repeat_leaves_differing"] == []
    assert got["repeat_outputs_differing"] == []
    assert len(got["repeat_digest"]) == 64
    assert not torch.are_deterministic_algorithms_enabled()
    assert set(repeat_probe.configs()) == {
        "flagship", "large_urban", "static", "multi", "noisy",
        "noisy_compact", "multisensor_2cam", "multisensor_compact"}
