"""The update's spill tier (``ops/update.py::spill_pass1_plain`` /
``spill_pass2_plain``, the plain versions of the spill kernels) against a
float64 loop over each spill particle and each spill cell, written from
the sums the blocks stand for:

* ``c_pyr[p, m] = sum_{valid i, pyr_i = p} w_i g(x_i, z[p, m])``
* ``c_cell[y, k] = sum_{valid i, y open, pyr_i within the radius of y}
  w_i g(x_i, s[y, k])``
* ``sum_sp[i] = sum_m g(x_i, z[p_i, m]) cinv[p_i, m]
  + sum_{open y within the radius of p_i} sum_k g(x_i, s[y, k]) ccinv[y, k]``

with ``g(x, z) = pi^-3/2 exp(-|x - z|^2 / (2 sigma^2))``.  Radius 1 and 2
(9 and 25 neighbour cells), an empty spill tier and one filled to
capacity, spill cells on the grid's edges beside pyramids that a flat
index would wrap onto, closed spill cells that name a real pyramid, and
masked spill points (a zero ``ccinv``).  The card test of the kernels
(``tests/test_torch_cuda.py``) holds them to these plain versions."""

import math

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch.ops import update
from dspmap_tpu_torch.utils.kernel_times import spill_operands

torch.set_num_threads(2)

SIGMA = 0.1


def _cfg(radius, **kw):
    """112 pyramids (14 x 8 at 6 degrees), 6 dense and 10 spill points a
    pyramid, 8 spill cells, 96 spill rows, 24 spill slots a pyramid."""
    return T.dsp_dynamic(
        angle_resolution_deg=6, pyramid_neighbor_radius=radius,
        max_obs_points_per_pyramid=16, obs_dense_points=6,
        obs_spill_capacity=8, particle_spill_capacity=96,
        pyramid_slot_capacity=32, pyramid_dense_slots=8, **kw)


def _by_loop(o, cfg):
    """``(c_pyr, c_cell, sum_sp)`` in float64, a particle and a cell at a
    time."""
    n = {k: v.double().numpy() if v.is_floating_point() else v.numpy()
         for k, v in o.items()}
    W, r = cfg.n_pyramids_v, cfg.pyramid_neighbor_radius
    c3 = math.pi ** -1.5

    def g(x, z):
        return c3 * np.exp(-((z - x) ** 2).sum(-1) / (2 * SIGMA ** 2))

    c_pyr = np.zeros(n["nbr_cinv"].shape)
    c_cell = np.zeros(n["cell_cinv"].shape)
    sum_sp = np.zeros(len(n["sp_w"]))
    for i in np.flatnonzero(n["sp_mask"]):
        p, x, w = int(n["sp_pyr"][i]), n["sp_pos"][i], n["sp_w"][i]
        gz = g(x, n["nbr_pts"][p])
        c_pyr[p] += w * gz
        sum_sp[i] = (gz * n["nbr_cinv"][p]).sum()
        for y in np.flatnonzero(n["cell_mask"]):
            cell = int(n["cells"][y])
            if abs(p // W - cell // W) > r or abs(p % W - cell % W) > r:
                continue
            gs = g(x, n["cell_pts"][y])
            c_cell[y] += w * gs
            sum_sp[i] += (gs * n["cell_cinv"][y]).sum()
    return c_pyr, c_cell, sum_sp


def _plain(o, cfg, dtype):
    t = {k: v.to(dtype) if v.is_floating_point() else v for k, v in o.items()}
    c_pyr, c_cell, pairs = update.spill_pass1_plain(
        t["sp_pos"], t["sp_w"], t["sp_pyr"], t["sp_mask"], t["nbr_pts"],
        t["cell_pts"], t["cells"], t["cell_mask"], cfg, SIGMA)
    sum_sp = update.spill_pass2_plain(pairs, t["nbr_cinv"], t["cell_cinv"])
    return c_pyr, c_cell, sum_sp


def _edges(cfg, rng):
    """Open spill cells at the grid's four corners and on its edges; spill
    particles in every pyramid within the radius of one, and in the
    pyramids one flat index past a row's last column (the next row's
    first, never adjacent)."""
    H, W, r = cfg.n_pyramids_h, cfg.n_pyramids_v, cfg.pyramid_neighbor_radius
    o = spill_operands(cfg, 0, rng, "cpu")
    open_cells = [0, W - 1, (H - 1) * W, H * W - 1, (H // 2) * W + W - 1,
                  W // 2]
    near = {h * W + v for c in open_cells for h in range(H) for v in range(W)
            if abs(h - c // W) <= r and abs(v - c % W) <= r}
    wrap = [c + 1 for c in open_cells if c % W == W - 1 and c + 1 < H * W]
    # the cells' own pyramids and the wrapped ones twice, then the rest
    first = np.tile(np.asarray(open_cells + wrap), 2)
    rest = rng.permutation(sorted(near - set(open_cells) - set(wrap)))
    pyr = np.concatenate([first, rest])[:len(o["sp_w"])]
    n = len(pyr)
    pyr = rng.permutation(pyr).astype(np.int32)
    o["sp_pyr"][:n] = torch.from_numpy(pyr)
    o["sp_mask"][:n] = True
    o["sp_w"][:n] = torch.from_numpy(rng.uniform(0.1, 1, n).astype(np.float32))
    # each particle near a point of its own pyramid and of the cells
    o["sp_pos"][:n] = o["nbr_pts"][torch.from_numpy(pyr).long(), 0] + 0.05
    o["cells"][:len(open_cells)] = torch.tensor(open_cells, dtype=torch.int32)
    o["cell_mask"][:] = False
    o["cell_mask"][:len(open_cells)] = True
    for y, c in enumerate(open_cells):
        o["cell_pts"][y] = o["nbr_pts"][c, :o["cell_pts"].shape[1]] + 0.02
    return o


def _masked(cfg, rng):
    """Closed spill cells between open ones, each naming a busy pyramid
    (the cell mask alone closes it), and a third of the spill points
    masked: their ``ccinv`` 0, as the update gives them."""
    o = spill_operands(cfg, 60, rng, "cpu", n_open=8)
    yc = o["cells"].shape[0]
    o["cell_mask"][:] = torch.from_numpy(np.arange(yc) % 2 == 0)
    pts_mask = torch.from_numpy(rng.random(o["cell_cinv"].shape) > 1 / 3)
    o["cell_cinv"] = torch.where(pts_mask, o["cell_cinv"] + 0.5, 0.0)
    return o


CASES = {
    "radius1": (1, lambda cfg, rng: spill_operands(cfg, 60, rng, "cpu")),
    "radius2": (2, lambda cfg, rng: spill_operands(cfg, 60, rng, "cpu")),
    "radius1_empty": (1, lambda cfg, rng: spill_operands(cfg, 0, rng, "cpu")),
    "radius2_empty": (2, lambda cfg, rng: spill_operands(cfg, 0, rng, "cpu")),
    "radius1_full": (1, lambda cfg, rng: spill_operands(
        cfg, cfg.particle_spill_capacity, rng, "cpu")),
    "radius2_full": (2, lambda cfg, rng: spill_operands(
        cfg, cfg.particle_spill_capacity, rng, "cpu")),
    "radius1_edges": (1, _edges),
    "radius2_edges": (2, _edges),
    "radius1_masked": (1, _masked),
    "radius2_masked": (2, _masked),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_spill_blocks_match_a_float64_loop(case):
    radius, make = CASES[case]
    cfg = _cfg(radius)
    o = make(cfg, np.random.default_rng(sorted(CASES).index(case)))
    want = _by_loop(o, cfg)
    valid = o["sp_mask"].numpy()
    for dtype, rtol, atol in ((torch.float64, 1e-9, 1e-12),
                              (torch.float32, 2e-3, 1e-6)):
        c_pyr, c_cell, sum_sp = (x.double().numpy()
                                 for x in _plain(o, cfg, dtype))
        np.testing.assert_allclose(c_pyr, want[0], rtol=rtol, atol=atol)
        np.testing.assert_allclose(c_cell, want[1], rtol=rtol, atol=atol)
        np.testing.assert_allclose(sum_sp[valid], want[2][valid], rtol=rtol,
                                   atol=atol)
    if valid.any():
        assert want[0].max() > 1e-2 and want[2].max() > 1e-2
    if "empty" in case:
        assert not want[0].any() and not want[1].any()
    if "edges" in case or "masked" in case:
        assert want[1].max() > 1e-2


@pytest.mark.parametrize("radius", [1, 2])
def test_edge_cells_pair_only_within_the_radius(radius):
    """On the edges case, a particle one flat index past a row's last
    column adds nothing to that row's edge cell, and every open cell has
    particles within its radius that add to it."""
    cfg = _cfg(radius)
    o = _edges(cfg, np.random.default_rng(11))
    W = cfg.n_pyramids_v
    _, c_cell, _ = _plain(o, cfg, torch.float64)
    n_open = int(o["cell_mask"].sum())
    assert (c_cell[:n_open].sum(-1) > 0).all()
    # the wrapped pyramid alone: its particles add to no edge cell
    edge = [y for y in range(n_open) if int(o["cells"][y]) % W == W - 1
            and int(o["cells"][y]) + 1 < cfg.n_pyramids]
    assert len(edge) == 2
    for y in edge:
        cell = int(o["cells"][y])
        only = {k: v.clone() for k, v in o.items()}
        wrapped = only["sp_pyr"] == cell + 1
        assert int(wrapped.sum()) == 2
        only["sp_mask"] &= wrapped
        only["sp_w"] = torch.where(only["sp_mask"], only["sp_w"], 0.0)
        want = _by_loop(only, cfg)
        c_pyr, c_only, _ = _plain(only, cfg, torch.float64)
        assert float(c_only[y].abs().max()) == 0.0 == want[1][y].max()
        assert float(c_pyr[cell + 1].max()) > 1e-2  # their own pyramid


def test_spill_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors ``spill_pass1`` / ``spill_pass2`` return the plain
    versions' results bit for bit and launch nothing."""
    from dspmap_tpu_torch import kernels
    cfg = _cfg(1)
    o = spill_operands(cfg, 60, np.random.default_rng(5), "cpu")
    args = (o["sp_pos"], o["sp_w"], o["sp_pyr"], o["sp_mask"], o["nbr_pts"],
            o["cell_pts"], o["cells"], o["cell_mask"], cfg, SIGMA)
    before = dict(kernels.LAUNCHES)
    c_pyr, c_cell, carry = update.spill_pass1(*args)
    sum_sp = update.spill_pass2(carry, o["nbr_cinv"], o["cell_cinv"])
    assert kernels.LAUNCHES == before
    want = _plain(o, cfg, torch.float32)
    for got, w in zip((c_pyr, c_cell, sum_sp), want):
        assert torch.equal(got, w)
