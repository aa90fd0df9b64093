"""The port's CUDA kernels against their plain versions on a card.

Marked ``cuda``: each test skips unless a compute-capability-9.x card is
present.  On a machine with an H100 (and without jax, which
``tests/conftest.py`` imports) run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``;
``chip_smoke.py`` runs the same checks at the full-width shapes of every
path."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch import kernels
from dspmap_tpu_torch.ops import (assignment, cluster, compact, occupancy,
                                  relayout, sweep, update)
from dspmap_tpu_torch.ops.common import padded_buffer
from dspmap_tpu_torch.utils import sim
from dspmap_tpu_torch.utils.kernel_times import (CLUSTER_KINDS,
                                                 CLUSTER_TOLERANCE,
                                                 cluster_case, jv_case,
                                                 jv_numpy, jv_worst_chain,
                                                 SPILL_CASES, pair_operands,
                                                 segscan_case, spill_config,
                                                 spill_operands)

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


#: the configurations' arms the kernels take: limit-xy (two velocity
#: planes; the flagship), full 3-D velocity, the static motion model (no
#: velocity planes, no advance) and the recorded particle time plane
ARMS = {
    "limit_xy": {},
    "velocity_3d": dict(limit_motion_to_xy_plane=False),
    "static_motion": dict(motion_model="static"),
    "particle_time": dict(record_particle_time=True),
}


def _cfg(**kw):
    return T.example_node_settings(T.dsp_dynamic(
        nx=24, ny=24, nz=12, voxel_resolution=0.25, max_input_points=1024,
        pyramid_slot_capacity=96, **kw))


def _pool(cfg, device, seed=0, V=None, fill=0.5, live_slots=None):
    """Random pool whose velocities obey the configuration's clamp: ``V``
    columns (default: the configuration's), a share ``fill`` of the first
    ``live_slots`` slots (default: all) of each holding a particle."""
    rng = np.random.default_rng(seed)
    S, V = cfg.slots_per_voxel, V or cfg.storage_voxels
    flags = np.where(rng.random((S, V)) < fill,
                     rng.choice([1, 1, 3], size=(S, V)), 0).astype(np.int32)
    if live_slots is not None:
        flags[live_slots:] = 0
    half = np.asarray(cfg.half_extent, np.float32)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)  # noqa: E731
    mv = rng.random((S, V)) < 0.3
    vel = [np.where(mv, rng.normal(0, 1, (S, V)), 0) for _ in range(3)]
    if cfg.motion_model == "static":
        vel = [np.zeros((S, V))] * 3
    elif cfg.limit_motion_to_xy_plane:
        vel[2] = np.zeros((S, V))
    return T.Particles(
        flags=torch.from_numpy(flags).to(device),
        px=f(rng.uniform(-half[0], half[0], (S, V))),
        py=f(rng.uniform(-half[1], half[1], (S, V))),
        pz=f(rng.uniform(0, 2 * half[2], (S, V))),
        vx=f(vel[0]), vy=f(vel[1]), vz=f(vel[2]),
        weight=f(np.where(flags != 0, rng.uniform(0.0005, 1, (S, V)), 0)),
        t=f(rng.uniform(0, 5, (S, V))))


@pytest.mark.parametrize("with_moving", [True, False])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_occupancy_kernel_matches_plain(device, arm, with_moving):
    """Flags, the moving mask and every payload plane equal, weights and
    weight_sum to rtol 1e-6, counter sums exact."""
    cfg = _cfg(**ARMS[arm])
    p = _pool(cfg, device)
    n0 = kernels.LAUNCHES["occupancy_pool_pass"]
    got = occupancy.occupancy_pool_pass(p, cfg, with_moving=with_moving)
    want = occupancy.pool_pass_plain(p, cfg, with_moving=with_moving)
    assert kernels.LAUNCHES["occupancy_pool_pass"] == n0 + 1
    assert torch.equal(got[0]["flags"], want[0]["flags"])
    if with_moving:
        assert torch.equal(got[5], want[5])
    else:
        assert got[5] is None and want[5] is None
    for name in ("px", "py", "pz", "vx", "vy", "vz", "t"):
        assert torch.equal(got[0][name], want[0][name]), name
    torch.testing.assert_close(got[0]["weight"], want[0]["weight"], rtol=1e-6,
                               atol=1e-9)
    for a, b in zip((got[1], got[2], got[4]) + got[3],
                    (want[1], want[2], want[4]) + want[3]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    for a, b in zip(got[6], want[6]):
        assert float(a.sum()) == float(b.sum())
    assert float(want[6][4].sum()) > 0  # the resample filled slots


@pytest.mark.parametrize("arm", ["limit_xy", "static_motion"])
def test_sweep_kernel_matches_plain(device, arm):
    cfg = _cfg(**ARMS[arm])
    p = _pool(cfg, device, seed=1)
    sensor = np.asarray([-2.3, 0.4, 1.0], np.float32)
    quat = np.asarray([np.cos(0.4), 0, 0, np.sin(0.4)], np.float32)
    origin = T.geometry.window_origin_np(sensor, cfg)
    got = sweep.sweep(p, cfg, np.float32(0.1), origin, sensor, quat)
    want = sweep.sweep_reference(p, cfg, np.float32(0.1), origin, sensor, quat)
    torch.testing.assert_close(got.px, want.px, atol=1e-5, rtol=0)
    for name in ("flags", "new_cell", "tags"):
        assert (getattr(got, name) != getattr(want, name)).float().mean() < 1e-3
    assert bool(got.fov.any()) and bool(got.moved_out.any())


@pytest.mark.parametrize("half", [0, 1], ids=["cell_base_0", "cell_base_V/2"])
def test_sweep_kernel_on_a_slab_matches_plain(device, half):
    """K2 on the upper half of a pool (``cell_base = V/2``, as on a slab of
    the sharded step) and on the whole pool (``cell_base = 0``): the bars
    of the whole-pool test against the plain version at the same
    ``cell_base``, and the slab's outputs bit-equal to the whole pool's in
    the same columns (the mover test reads the global column)."""
    cfg = _cfg()
    p = _pool(cfg, device, seed=2)
    V = cfg.storage_voxels
    base = half * V // 2
    slab = T.Particles(**{k: getattr(p, k)[:, base:].contiguous()
                          for k in ("flags", "px", "py", "pz", "vx", "vy",
                                    "vz", "weight", "t")})
    sensor = np.asarray([-2.3, 0.4, 1.0], np.float32)
    quat = np.asarray([np.cos(0.4), 0, 0, np.sin(0.4)], np.float32)
    origin = T.geometry.window_origin_np(sensor, cfg)
    args = (cfg, np.float32(0.1), origin, sensor, quat)
    n0 = kernels.LAUNCHES["sweep"]
    got = sweep.sweep(slab, *args, cell_base=base)
    assert kernels.LAUNCHES["sweep"] == n0 + 1
    want = sweep.sweep_reference(slab, *args, cell_base=base)
    torch.testing.assert_close(got.px, want.px, atol=1e-5, rtol=0)
    for name in ("flags", "new_cell", "tags"):
        assert (getattr(got, name) != getattr(want, name)).float().mean() < 1e-3
    assert bool(got.mover.any()) and bool(got.fov.any())
    whole = sweep.sweep(p, *args)
    for name in ("px", "py", "flags", "new_cell", "tags"):
        assert torch.equal(getattr(got, name), getattr(whole, name)[:, base:])


def test_wrappers_refuse_operands_the_kernels_do_not_take(device):
    """A slot depth without an instantiation, a plane of another dtype, a
    non-contiguous or misshapen plane, or a CPU tensor raises; nothing
    falls back to the plain version."""
    cfg = _cfg()
    p = _pool(cfg, device)
    S, V = p.flags.shape
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        occupancy.pool_pass_cuda(T.Particles(**{
            k: getattr(p, k)[:10].contiguous() for k in ("flags", "px", "py",
                                                        "pz", "vx", "vy", "vz",
                                                        "weight", "t")}), cfg)
    with pytest.raises(TypeError):
        occupancy.pool_pass_cuda(T.Particles(**{
            **{k: getattr(p, k) for k in ("flags", "px", "py", "pz", "vx",
                                          "vy", "vz", "t")},
            "weight": p.weight.double()}), cfg)
    with pytest.raises(ValueError):
        sweep.sweep_cuda(T.Particles(**{
            **{k: getattr(p, k) for k in ("flags", "px", "pz", "vx", "vy",
                                          "vz", "weight", "t")},
            "py": p.py.t().contiguous().t()}), cfg, 0.1, np.zeros(3, np.int32),
            np.zeros(3, np.float32), np.asarray([1, 0, 0, 0], np.float32))
    with pytest.raises(ValueError):
        sweep.sweep_cuda(T.Particles(**{
            **{k: getattr(p, k) for k in ("flags", "px", "py", "pz", "vy",
                                          "vz", "weight", "t")},
            "vx": p.vx[:, : V // 2].contiguous()}), cfg, 0.1,
            np.zeros(3, np.int32), np.zeros(3, np.float32),
            np.asarray([1, 0, 0, 0], np.float32))
    pos = torch.zeros((4, 8, 3), device=device)
    with pytest.raises(ValueError):
        update.update_pass1(pos, torch.zeros((4, 8), device=device),
                            torch.zeros((4, 16, 3)), 0.1)
    assert kernels.LAUNCHES == n0


#: (rows, S_t, CK) of the pair passes: the flagship's and large_urban's
#: tile, the static preset's and the multi-neighbor preset's, a ragged one
#: (no multiple of pass 2's lane groups, particles a lane or rows a block),
#: and rows of few points (obs_dense_points = 1 gives CK = 9; pyramid
#: neighbor radius 0 down to one point), where 256 of pass 1's threads
#: reach more rows than shared memory stages and a block takes whole rows
PAIR_SHAPES = [(448, 64, 288), (504, 32, 288), (4536, 16, 400), (37, 13, 101),
               (300, 64, 8), (300, 64, 9), (1000, 16, 1)]


def _pair_operands(rows, s_t, ck, device, seed=2):
    return pair_operands(rows, s_t, ck, 0.1, np.random.default_rng(seed),
                         device)


@pytest.mark.parametrize("rows,s_t,ck", PAIR_SHAPES)
def test_pair_kernels_match_float64(device, rows, s_t, ck):
    pos, pts, w, cinv = _pair_operands(rows, s_t, ck, device)
    scaled = update.prescale_pairs(pos, pts, 0.1)
    for kern, plain, vec in ((update.update_pass1, update.update_pass1_plain, w),
                             (update.update_pass2, update.update_pass2_plain, cinv)):
        ref = plain(pos.double(), vec.double(), pts.double(), 0.1)
        assert float(ref.abs().max()) > 1e-3
        got = kern(pos, vec, pts, 0.1)
        torch.testing.assert_close(got.double(), ref, rtol=2e-5, atol=1e-6)
        # operands scaled once and shared by both passes: the same bits
        assert torch.equal(kern(pos, vec, pts, 0.1, scaled), got)


@pytest.mark.parametrize("rows,s_t,ck", PAIR_SHAPES)
def test_pass2_gives_the_same_bits_every_call(device, rows, s_t, ck):
    """Pass 2 sums each particle's points across lanes in a fixed order and
    a fixed shuffle tree: no atomics, so two calls on the same operands
    agree bit for bit (the newborn weight's last bit decides resample flags
    downstream), also when other work ran in between."""
    pos, pts, _, cinv = _pair_operands(rows, s_t, ck, device, seed=7)
    n0 = kernels.LAUNCHES["update_pass2"]
    first = update.update_pass2(pos, cinv, pts, 0.1)
    update.update_pass2(pos.flip(0).contiguous(), cinv, pts, 0.1)
    second = update.update_pass2(pos, cinv, pts, 0.1)
    assert kernels.LAUNCHES["update_pass2"] == n0 + 3
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert bool(torch.isfinite(first).all()) and float(first.max()) > 0


@pytest.mark.parametrize("rows,s_t,ck", PAIR_SHAPES)
def test_pass1_gives_the_same_bits_every_call(device, rows, s_t, ck):
    """Pass 1 sums each point's particles in order in one thread: no
    atomics, so two calls on the same operands agree bit for bit (its sums
    make the newborn weight), also when other work ran in between."""
    pos, pts, w, _ = _pair_operands(rows, s_t, ck, device, seed=7)
    n0 = kernels.LAUNCHES["update_pass1"]
    first = update.update_pass1(pos, w, pts, 0.1)
    update.update_pass1(pos.flip(0).contiguous(), w, pts, 0.1)
    second = update.update_pass1(pos, w, pts, 0.1)
    assert kernels.LAUNCHES["update_pass1"] == n0 + 3
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert bool(torch.isfinite(first).all()) and float(first.max()) > 0


#: SHA-256 of pass 2's output bytes at the first four PAIR_SHAPES
#: (operands of seed 7, sigma 0.1) as the kernel gave them before pass 1
#: moved to the shared pair term, on an NVIDIA H100 80GB HBM3 (the nvcc,
#: PyTorch and driver versions that produced them are in PERF.md, section
#: 6).  The digests hold for that toolchain: a CUDA release that schedules
#: ex2.approx or the FMAs otherwise may change the last bits with no fault
#: in the port, and then they are taken again from a build of the same
#: commit with the old and the new toolchain side by side.
PASS2_BITS = {
    (448, 64, 288):
        "bb2d326f9f95577b37f518c38053a2e8d0a5be9fa5c7856d27f6992deadd1fee",
    (504, 32, 288):
        "17bdd1e826cdfb3c06e729e1f1fc01fabcd9bdc7a1cbf8c0dba3f2c02811d492",
    (4536, 16, 400):
        "66e0f875392880601745a19bcd00428b1e2bc72d5c8cca43cd13caab3c2f08a0",
    (37, 13, 101):
        "7a910ce53b36e6263ad3d0c673b4cfad56f7832b877cc95fd5162d4848e53895",
}


@pytest.mark.parametrize("rows,s_t,ck", list(PASS2_BITS))
def test_pass2_bits_are_those_it_gave_before(device, rows, s_t, ck):
    """Pass 2 shares its term with pass 1 and keeps its bits: the output
    hashes as it did before the two passes shared the term."""
    pos, pts, _, cinv = _pair_operands(rows, s_t, ck, device, seed=7)
    got = update.update_pass2(pos, cinv, pts, 0.1).cpu().numpy()
    assert hashlib.sha256(got.tobytes()).hexdigest() == PASS2_BITS[
        (rows, s_t, ck)]


def test_pass2_takes_unaligned_operands(device):
    """The result does not depend on where the operands' storage starts:
    points 4 bytes off a 16-byte boundary give the bits of the aligned
    call (pass 2 stages a point with scalar loads)."""
    rows, s_t, ck = 64, 16, 400
    pos, pts, _, cinv = _pair_operands(rows, s_t, ck, device, seed=3)
    pos_s, pts_s = update.prescale_pairs(pos, pts, 0.1)
    want = update.update_pass2(pos, cinv, pts, 0.1, (pos_s, pts_s))
    shifted = torch.empty(pts_s.numel() + 1, device=device)[1:].view(
        pts_s.shape).copy_(pts_s)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    got = update.update_pass2(pos, cinv, pts, 0.1, (pos_s, shifted))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _spill_case(name):
    """``(configuration, a street frame's spill particles)`` of
    ``kernel_times.SPILL_CASES``' case ``name``: a configuration whose
    update runs the spill kernels, at the capacity its cell runs."""
    return spill_config(name), SPILL_CASES[name][2]


def _spill_call(o, cfg, plain=False, dtype=torch.float32):
    """``(c_pyr, c_cell, sum_sp)`` of the two spill passes on ``o``
    (:func:`spill_operands`): the kernels, or the plain versions in
    ``dtype``."""
    t = {k: v.to(dtype) if v.is_floating_point() else v for k, v in o.items()}
    sigma = float(np.float32(cfg.sigma_ob))
    args = (t["sp_pos"], t["sp_w"], t["sp_pyr"], t["sp_mask"], t["nbr_pts"],
            t["cell_pts"], t["cells"], t["cell_mask"], cfg, sigma)
    if plain:
        c_pyr, c_cell, carry = update.spill_pass1_plain(*args)
        return c_pyr, c_cell, update.spill_pass2_plain(
            carry, t["nbr_cinv"], t["cell_cinv"])
    c_pyr, c_cell, carry = update.spill_pass1(*args)
    return c_pyr, c_cell, update.spill_pass2(carry, t["nbr_cinv"],
                                             t["cell_cinv"])


@pytest.mark.parametrize("fill", ["empty", "street", "full"])
@pytest.mark.parametrize("preset", sorted(SPILL_CASES))
def test_spill_kernels_match_float64(device, preset, fill):
    """Both spill kernels within K3's bar (rtol 2e-5, atol 1e-6) of the
    plain spill blocks evaluated in float64, on an empty spill tier, a
    street frame's and one filled to capacity; pass 2 gives 0 on the rows
    past the valid ones."""
    cfg, street = _spill_case(preset)
    n = {"empty": 0, "street": street,
         "full": cfg.particle_spill_capacity}[fill]
    o = spill_operands(cfg, n, np.random.default_rng(3), device)
    got = _spill_call(o, cfg)
    want = _spill_call(o, cfg, plain=True, dtype=torch.float64)
    valid = o["sp_mask"]
    for name, g, w in zip(("c_pyr", "c_cell", "sum_sp"), got, want):
        if name == "sum_sp":
            assert not bool(g[~valid].any())
            g, w = g[valid], w[valid]
        torch.testing.assert_close(g.double(), w, rtol=2e-5, atol=1e-6,
                                   msg=name)
        if n:
            assert float(w.max()) > 1e-2, name


@pytest.mark.parametrize("preset", sorted(SPILL_CASES))
def test_spill_kernels_give_the_same_bits_every_call(device, preset):
    """Both passes sum in a fixed order without atomics: two calls on the
    same operands agree bit for bit, also with another call between, and
    each call counts one launch of each kernel."""
    cfg, street = _spill_case(preset)
    o = spill_operands(cfg, street, np.random.default_rng(7), device)
    other = spill_operands(cfg, street // 2, np.random.default_rng(8), device)
    n0 = dict(kernels.LAUNCHES)
    first = _spill_call(o, cfg)
    _spill_call(other, cfg)
    second = _spill_call(o, cfg)
    for name in ("spill_pass1", "spill_pass2"):
        assert kernels.LAUNCHES[name] == n0[name] + 3
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_spill_wrappers_refuse_what_the_kernels_do_not_take(device):
    """Float64 operands, or a neighbourhood of another pyramid count,
    raise on CUDA tensors; nothing falls back to the plain version."""
    cfg, street = _spill_case("flagship")
    o = spill_operands(cfg, street, np.random.default_rng(1), device)
    args = lambda **kw: tuple({**o, **kw}[k] for k in (  # noqa: E731
        "sp_pos", "sp_w", "sp_pyr", "sp_mask", "nbr_pts", "cell_pts",
        "cells", "cell_mask")) + (cfg, 0.1)
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError):
        update.spill_pass1(*args(sp_pos=o["sp_pos"].double()))
    with pytest.raises(ValueError):
        update.spill_pass1(*args(nbr_pts=o["nbr_pts"][:-1].contiguous()))
    assert kernels.LAUNCHES == n0


def test_spill_kernels_sync_nothing_and_graph(device):
    """Both passes read the count of valid rows on the card: no host sync
    (sync-debug mode raises on one), and a captured graph replayed on new
    operands of another count gives the eager call's bits."""
    cfg, street = _spill_case("flagship")
    o = spill_operands(cfg, street, np.random.default_rng(1), device)
    _spill_call(o, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _spill_call(o, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    static = {k: v.clone() for k, v in o.items()}
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _spill_call(static, cfg)
        with torch.cuda.graph(graph):
            out = _spill_call(static, cfg)
    torch.cuda.current_stream().wait_stream(stream)
    new = spill_operands(cfg, street // 3, np.random.default_rng(2), device)
    for k, v in new.items():
        static[k].copy_(v)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, _spill_call(new, cfg)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_the_update_allocates_no_padded_spill_block(device):
    """One ``measurement_update`` at large_urban's shapes (65,536 spill
    rows, 45,000 of them valid, 64 spill cells of 68 points) allocates
    well under the 1.14 GB of the padded [Psp, Yc * Ks] block the plain
    version builds: the card path holds no [Psp, Yc * Ks], [Psp, CK] or
    [n_pyr, Psp] tensor."""
    from dspmap_tpu_torch.ops.fov import FovBinning
    from dspmap_tpu_torch.ops.project import Observation
    cfg, street = _spill_case("large_urban")
    rng = np.random.default_rng(5)
    o = spill_operands(cfg, street, rng, device)
    n_pyr, S_t, Ko = cfg.n_pyramids, cfg.dense_slots, cfg.obs_dense
    yc, ks = o["cell_pts"].shape[:2]
    total = cfg.compact_capacity
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)  # noqa: E731
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(device)  # noqa: E731
    b = lambda x: torch.from_numpy(np.asarray(x, bool)).to(device)  # noqa: E731
    psp = cfg.particle_spill_capacity
    fovbin = FovBinning(
        pos=o["nbr_pts"][:, :S_t].contiguous(),
        weight=f(rng.random((n_pyr, S_t))), rng=f(rng.uniform(1, 8, (n_pyr, S_t))),
        mask=b(rng.random((n_pyr, S_t)) < 0.7),
        slot=i32(rng.integers(0, total, (n_pyr, S_t))),
        sp_pos=o["sp_pos"], sp_weight=o["sp_w"],
        sp_rng=f(rng.uniform(1, 8, psp)), sp_pyr=o["sp_pyr"],
        sp_mask=o["sp_mask"], sp_slot=i32(rng.integers(0, total, psp)),
        sp_overflow=i32(0))
    obs = Observation(
        points=o["nbr_pts"][:, :Ko].contiguous(),
        mask=b(rng.random((n_pyr, Ko)) < 0.8),
        counts=i32(np.full(n_pyr, Ko)), max_range=f(np.full(n_pyr, 9.0)),
        n_valid_points=i32(5000), cloud_world=f(np.zeros((5000, 3))),
        cloud_valid=b(np.ones(5000)), spill_cells=o["cells"],
        spill_cell_mask=o["cell_mask"], spill_pts=o["cell_pts"],
        spill_pts_mask=b(rng.random((yc, ks)) < 0.8),
        spill_overflow=i32(0))
    zeros = torch.zeros(total, dtype=torch.float32, device=device)
    particles = T.Particles(
        flags=torch.ones(total, dtype=torch.int32, device=device),
        px=zeros, py=zeros, pz=zeros, vx=zeros, vy=zeros, vz=zeros,
        weight=f(rng.random(total)), t=zeros)
    rt = T.RuntimeParams.from_config(cfg)
    args = (particles, fovbin, obs, cfg, f(1e-3), 0.0, rt)
    update.measurement_update(*args)  # build and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n0 = dict(kernels.LAUNCHES)
    new, norm, stats = update.measurement_update(*args)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    assert grew < 200 * 2**20, grew
    assert kernels.LAUNCHES["spill_pass1"] == n0["spill_pass1"] + 1
    assert kernels.LAUNCHES["spill_pass2"] == n0["spill_pass2"] + 1
    assert 0 < int(stats["update_spilled"]) <= street
    assert bool(torch.isfinite(norm)) and float(norm) > 0


#: the compact step's seg_scans calls at large_urban (S = 10): (columns,
#: n_tot, max_run) of occupancy_compact's two calls and of segment_table's
#: calls in birth and rebin (reach 32, 32, 16, 16: the warp form); then the
#: tile form at reach 64 and 512 and at reach 1, 2, 4 and 8
SEGSCAN_CASES = [(7, 2, 20), (2, 2, 20), (4, 0, 10), (1, 0, 10),
                 (3, 2, 50), (2, 1, 400),
                 (2, 1, 1), (3, 2, 2), (2, 2, 3), (3, 1, 7)]


def _segscan_inputs(P, C, max_run, device, typed=False):
    """Runs of 1..max_run rows, fragments of one run further on, a dead
    tail and some -0.0 values; with ``typed`` the first column is bool and
    the last i32, as the compact step passes them."""
    types = ["f32"] * C
    if typed:
        types[0], types[-1] = "bool", "i32"
    cols, st, en, live = segscan_case(P, types, max_run, device)
    return live, st, en, cols


def _assert_segscan_equal(got, want, live):
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g[live].view(torch.int32), w[live].view(torch.int32))


@pytest.mark.parametrize("C,n_tot,max_run", SEGSCAN_CASES)
def test_segscan_kernel_bit_equal_to_plain(device, C, n_tot, max_run):
    """K4 at P = 131072 (large_urban's row count): runs of 1..max_run rows,
    fragments of one run further on, a dead tail and some -0.0 values;
    ``hi`` equal on every row, ``tot`` on every live row."""
    P = 131072
    live, st, en, cols = _segscan_inputs(P, C, max_run, device)
    n0 = kernels.LAUNCHES["seg_scans"]
    got = compact.seg_scans(cols, st, en, max_run, n_tot)
    want = compact.seg_scans_plain(cols, st, en, max_run, n_tot)
    assert kernels.LAUNCHES["seg_scans"] == n0 + 1
    assert len(got[0]) == C and len(got[1]) == n_tot
    _assert_segscan_equal(got, want, live)


@pytest.mark.parametrize("P", [131072 - 1000 + 7, 33 * 1024 + 1, 20011, 6001])
@pytest.mark.parametrize("C,n_tot,max_run", [(7, 2, 20), (2, 1, 10),
                                             (2, 2, 50), (2, 1, 400),
                                             (2, 2, 1), (3, 1, 3), (2, 2, 7)])
def test_segscan_kernel_ragged_rows_and_typed_columns(device, P, C, n_tot,
                                                      max_run):
    """K4 at row counts that are no multiple of a window (32), a strip or a
    tile (1024), in both forms, with a bool and an i32 column read where
    they lie: ``hi`` and ``tot`` equal to the plain version on every row
    (the dead tail included)."""
    live, st, en, cols = _segscan_inputs(P, C, max_run, device, typed=True)
    got = compact.seg_scans(cols, st, en, max_run, n_tot)
    want = compact.seg_scans_plain(cols, st, en, max_run, n_tot)
    _assert_segscan_equal(got, want, torch.ones_like(live))
    assert all(h.dtype == torch.float32 and h.shape == (P,) for h in got[0])


# ------------------------------------------- the static and multi presets

#: preset -> (constructor, slots per voxel, velocity planes of the pool pass)
PRESETS = {"static": ("dsp_static", 50, 0),
           "multi": ("dsp_dynamic_multi_neighbors", 60, 2)}


def _preset(name, **kw):
    fn, slots, n_vel = PRESETS[name]
    cfg = T.example_node_settings(getattr(T, fn)(**kw))
    assert cfg.slots_per_voxel == slots and occupancy._n_vel(cfg) == n_vel
    return cfg


def _tie_pool(cfg, device, seed=11, n_voxels=1500):
    """Voxels of ``resample_min_count..S`` newborns of one weight each: the
    resample's ``ceil(x/wa - 1/2)`` thresholds fall exactly on the grid."""
    rng = np.random.default_rng(seed)
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    cols = rng.choice(cfg.voxel_num, size=n_voxels, replace=False)
    k = rng.integers(cfg.resample_min_count, S + 1, size=n_voxels)
    occ = np.arange(S)[:, None] < k[None, :]
    flags = np.zeros((S, V), np.int32)
    weight = np.zeros((S, V), np.float32)
    flags[:, cols] = np.where(occ, 3, 0)
    weight[:, cols] = np.where(occ, rng.uniform(0.002, 0.2, n_voxels)[None, :], 0)
    z = lambda: torch.zeros((S, V), device=device)  # noqa: E731
    return T.Particles(flags=torch.from_numpy(flags).to(device), px=z(),
                       py=z(), pz=z(), vx=z(), vy=z(), vz=z(),
                       weight=torch.from_numpy(weight).to(device), t=z())


@pytest.mark.parametrize("pool", ["random", "ties"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_occupancy_kernel_matches_plain_at_deep_slots(device, preset, pool):
    """K1 at S = 50 (no velocity planes) and S = 60 (two): flags, weights,
    payload and per-voxel sums equal to the plain version bit for bit, on a
    random pool and on voxels of equal-weight newborns."""
    cfg = _preset(preset, nx=24, ny=24, nz=12, voxel_resolution=0.25,
                  max_input_points=1024)
    p = _pool(cfg, device) if pool == "random" else _tie_pool(cfg, device)
    n0 = kernels.LAUNCHES["occupancy_pool_pass"]
    got = occupancy.occupancy_pool_pass(p, cfg, with_moving=True)
    want = occupancy.pool_pass_plain(p, cfg, with_moving=True)
    assert kernels.LAUNCHES["occupancy_pool_pass"] == n0 + 1
    _assert_pool_pass_equal(got, want)
    # the resample dropped slots and, on the random pool, filled free ones
    # (voxels of equal weights place at most one copy a particle)
    assert float(want[6][3].sum()) > 0
    assert pool == "ties" or float(want[6][4].sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_relayout_kernels_bit_equal(device, dtype):
    """K5a and K5b at the multi-neighbor preset's plane (60, 75776): exact
    copies, the source untouched, the flat plane a working plane whose
    sentinel word is not part of it, the restored plane fresh and of the
    exact size; a misaligned or ragged plane raises."""
    S, V = 60, 75776
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (S, V)).astype(
        np.int32)).to(device).view(dtype)
    keep = src.clone()
    n0 = dict(kernels.LAUNCHES)
    flat = relayout.to_flat(src)
    back = relayout.from_flat(flat, S, V)
    assert kernels.LAUNCHES["to_flat"] == n0["to_flat"] + 1
    assert kernels.LAUNCHES["from_flat"] == n0["from_flat"] + 1
    bits = lambda x: x.view(torch.int32)  # noqa: E731
    assert flat.shape == (S * V,) and flat.dtype == dtype
    assert torch.equal(bits(flat), bits(keep).reshape(-1))
    assert torch.equal(bits(src), bits(keep))
    assert padded_buffer(flat).shape == (S * V + 1,)
    assert back.shape == (S, V) and torch.equal(bits(back), bits(keep))
    assert back.untyped_storage().nbytes() == S * V * 4
    assert padded_buffer(back) is None
    with pytest.raises(ValueError):
        relayout.to_flat_cuda(src[:, :1000].contiguous())
    with pytest.raises(ValueError):
        relayout.from_flat_cuda(padded_buffer(flat)[1:], S, V)  # 4-byte offset
    assert kernels.LAUNCHES["to_flat"] == n0["to_flat"] + 1


def _assert_pool_pass_equal(got, want):
    """Every output of the pool pass bit for bit."""
    for name in ("flags", "weight", "px", "py", "pz", "vx", "vy", "vz", "t"):
        assert torch.equal(got[0][name], want[0][name]), name
    assert torch.equal(got[5], want[5])
    for a, b in zip((got[1], got[2], got[4]) + got[3] + got[6],
                    (want[1], want[2], want[4]) + want[3] + want[6]):
        assert torch.equal(a, b)


def _slots_cfg(slots, **kw):
    """The small configuration of a kernel slot depth: 18 (flagship), 50
    (static preset), 60 (multi-neighbor preset)."""
    small = dict(nx=24, ny=24, nz=12, voxel_resolution=0.25,
                 max_input_points=1024)
    if slots == 18:
        return _cfg(**kw)
    return _preset({50: "static", 60: "multi"}[slots], **small, **kw)


@pytest.mark.parametrize("V", [1000, 8 * 128 + 4, 1001, 37],
                         ids=lambda v: f"V{v}")
@pytest.mark.parametrize("slots", occupancy.KERNEL_SLOTS)
def test_occupancy_kernel_ragged_widths(device, slots, V):
    """K1 at widths that no configuration has: a multiple of 4 that ends in
    a part tile, and widths that are no multiple of 4 (4-byte copies), one
    of them narrower than a tile.  Equal to the plain version bit for bit,
    recorded particle time included."""
    cfg = _slots_cfg(slots, record_particle_time=True)
    p = _pool(cfg, device, seed=V, V=V)
    got = occupancy.occupancy_pool_pass(p, cfg, with_moving=True)
    want = occupancy.pool_pass_plain(p, cfg, with_moving=True)
    _assert_pool_pass_equal(got, want)
    assert float(want[6][2].sum()) > 0  # some voxel resampled


@pytest.mark.parametrize("arm", ["none_resamples", "all_resample"])
@pytest.mark.parametrize("slots", occupancy.KERNEL_SLOTS)
def test_occupancy_kernel_both_arms_of_the_resample_vote(device, slots, arm):
    """A pool in which no voxel reaches ``resample_min_count`` (every warp
    skips the resample) and one in which every voxel does."""
    cfg = _slots_cfg(slots)
    few = cfg.resample_min_count - 1
    p = (_pool(cfg, device, seed=5, fill=1.0, live_slots=few)
         if arm == "none_resamples" else _pool(cfg, device, seed=6, fill=0.9))
    got = occupancy.occupancy_pool_pass(p, cfg, with_moving=True)
    want = occupancy.pool_pass_plain(p, cfg, with_moving=True)
    _assert_pool_pass_equal(got, want)
    resampled = want[6][2]
    if arm == "none_resamples":
        assert not resampled.any() and float(want[6][0].sum()) > 0
    else:
        assert bool(resampled.all())


def test_occupancy_kernel_reads_flat_working_planes(device):
    """Fed ``[S, V]`` views of flat working buffers (as the step feeds it),
    K1 returns what it returns for restored planes, leaves the buffers as
    they were and returns planes of the exact size."""
    cfg = _slots_cfg(60)
    p = _pool(cfg, device, seed=8)
    S, V = p.flags.shape
    names = occupancy.rewritten_planes(cfg)
    flats = relayout.to_flat_many([getattr(p, n) for n in names])
    keep = [padded_buffer(f).clone() for f in flats]
    views = T.Particles(**{**{n: getattr(p, n) for n in ("vz", "t")},
                           **{n: f.view(S, V) for n, f in zip(names, flats)}})
    got = occupancy.occupancy_pool_pass(views, cfg, with_moving=True)
    want = occupancy.occupancy_pool_pass(p, cfg, with_moving=True)
    _assert_pool_pass_equal(got, want)
    for f, k in zip(flats, keep):
        assert torch.equal(padded_buffer(f)[:-1].view(torch.int32),
                           k[:-1].view(torch.int32))
    for n in names:
        assert got[0][n].untyped_storage().nbytes() == S * V * 4, n


@pytest.mark.parametrize("n", [1, 7, 9])
def test_relayout_batched_bit_equal(device, n):
    """K5 on n planes of mixed dtype in one launch:
    exact copies both ways, sources untouched, each buffer ``[S*V + 1]``,
    16-byte aligned and apart from the others, restored planes of the exact
    size; a tenth plane raises."""
    S, V = 60, 75776
    rng = np.random.default_rng(n)
    planes = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (S, V)).astype(
        np.int32)).to(device).view(torch.float32 if i % 3 else torch.int32)
        for i in range(n)]
    keep = [x.clone() for x in planes]
    bits = lambda x: x.view(torch.int32)  # noqa: E731
    n0 = dict(kernels.LAUNCHES)
    flats = relayout.to_flat_many_cuda(planes)
    backs = relayout.from_flat_many_cuda(flats, S, V)
    assert kernels.LAUNCHES["to_flat"] == n0["to_flat"] + 1
    assert kernels.LAUNCHES["from_flat"] == n0["from_flat"] + 1
    want = relayout.to_flat_many_plain(planes)
    starts = []
    for src, k, flat, w, back in zip(planes, keep, flats, want, backs):
        assert flat.dtype == src.dtype and flat.shape == (S * V,)
        assert torch.equal(bits(flat), bits(w))
        assert torch.equal(bits(src), bits(k))
        buf = padded_buffer(flat)
        assert buf.shape == (S * V + 1,) and buf.data_ptr() % 16 == 0
        starts.append(buf.data_ptr())
        assert back.shape == (S, V) and back.dtype == src.dtype
        assert torch.equal(bits(back), bits(k))
        assert back.untyped_storage().nbytes() == S * V * 4
    starts.sort()
    assert all(b - a >= 4 * (S * V + 1) for a, b in zip(starts, starts[1:]))
    with pytest.raises(ValueError):
        relayout.to_flat_many_cuda(planes + [planes[0]] * (10 - n))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_frames_on_the_card(device, preset):
    """Three frames of the full-width preset through ``make_step`` on the
    card: one launch of K1, K2, K3a, K3b and the two spill kernels a
    frame, the relayout kernels
    only where the planes reach 16 MiB (multi: one launch in, one out a
    frame), the JV solve and the clustering once a frame where the
    estimator runs (not on static), a finite map with live particles, the input state left as it
    was."""
    cfg = _preset(preset)
    state = T.init_state(cfg, seed=0)
    assert state.device.type == "cuda"
    step = T.make_step(cfg)
    kernels.reset_launch_counts()
    for pts, n, pos, quat, t in sim.generate_sequence(3, cfg, seed=0):
        before = state.particles.clone()
        new, out = step(state, T.Frame(pts, n, pos, quat, t))
        for name in ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight"):
            assert torch.equal(getattr(state.particles, name),
                               getattr(before, name)), name
        state = new
        assert out.accepted
    big = preset == "multi"
    assert kernels.LAUNCHES == {
        "occupancy_pool_pass": 3, "sweep": 3, "update_pass1": 3,
        "update_pass2": 3, "spill_pass1": 3, "spill_pass2": 3,
        "seg_scans": 0,
        "to_flat": 3 if big else 0, "from_flat": 3 if big else 0,
        "jv_solve": 0 if preset == "static" else 3,
        "euclidean_cluster": 0 if preset == "static" else 3}
    assert int(out.metrics["alive"]) > 0 and int(out.metrics["born"]) > 0
    assert state.particles.flags.shape == (cfg.slots_per_voxel,
                                           cfg.storage_voxels)
    for name in ("weight_sum", "vel_avg", "future"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name
    if preset == "static":
        assert not state.particles.vx.any() and not state.particles.vy.any()


def test_occupancy_kernel_moving_mask_at_full_width(device):
    """K1's ``with_moving`` arm as the noisy flagship path takes it: S = 18,
    V = 175,104, three velocity planes; every output, the moving mask
    included, bit-equal to the plain version's."""
    from dspmap_tpu_torch.utils.kernel_times import populated_pool

    cfg = T.example_node_settings(T.dsp_dynamic(limit_motion_to_xy_plane=False))
    assert (cfg.slots_per_voxel, cfg.storage_voxels) == (18, 175104)
    assert occupancy._n_vel(cfg) == 3
    rng = np.random.default_rng(3)
    p = populated_pool(cfg, rng, device)
    p.vz = torch.where(p.vx != 0, torch.from_numpy(rng.normal(
        0, 0.5, p.vx.shape).astype(np.float32)).to(device), 0.0)
    got = occupancy.pool_pass_cuda(p, cfg, with_moving=True)
    want = occupancy.pool_pass_plain(p, cfg, with_moving=True)
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    for name in ("flags", "weight", "px", "py", "pz", "vx", "vy", "vz", "t"):
        assert torch.equal(bits(got[0][name]), bits(want[0][name])), name
    for a, b in zip((got[1], got[2], got[4]) + got[3] + got[6],
                    (want[1], want[2], want[4]) + want[3] + want[6]):
        assert torch.equal(bits(a), bits(b))
    assert torch.equal(got[5], want[5]) and int(want[5].sum()) > 0
    assert float(want[6][4].sum()) > 0


def test_occupancy_kernel_moving_mask_on_a_slab(device):
    """K1's ``with_moving`` arm as a rank of the sharded two-camera step
    takes it on two ranks: the upper half of the flagship pool, S = 18,
    V = 87,552, two velocity planes; every output, the moving mask
    included, bit-equal to the plain version's."""
    from dspmap_tpu_torch.utils.kernel_times import populated_pool

    cfg = T.example_node_settings(T.dsp_dynamic())
    assert occupancy._n_vel(cfg) == 2
    whole = populated_pool(cfg, np.random.default_rng(3), device)
    V = cfg.storage_voxels // 2
    p = T.Particles(**{k: getattr(whole, k)[:, V:].contiguous()
                       for k in ("flags", "px", "py", "pz", "vx", "vy", "vz",
                                 "weight", "t")})
    assert tuple(p.flags.shape) == (18, 87552)
    got = occupancy.pool_pass_cuda(p, cfg, with_moving=True)
    want = occupancy.pool_pass_plain(p, cfg, with_moving=True)
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    for name in ("flags", "weight", "px", "py", "pz", "vx", "vy", "vz", "t"):
        assert torch.equal(bits(got[0][name]), bits(want[0][name])), name
    for a, b in zip((got[1], got[2], got[4]) + got[3] + got[6],
                    (want[1], want[2], want[4]) + want[3] + want[6]):
        assert torch.equal(bits(a), bits(b))
    assert torch.equal(got[5], want[5]) and int(want[5].sum()) > 0
    assert float(want[6][4].sum()) > 0


#: the noisy single-sensor step and the two-camera step, on both layouts
STEP_CASES = {
    "noisy_pool": (dict(limit_motion_to_xy_plane=False), None),
    "noisy_compact": (dict(limit_motion_to_xy_plane=False, layout="compact"),
                      None),
    "multisensor_pool": ({}, 2),
    "multisensor_compact": (dict(layout="compact"), 2),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_new_steps_on_the_card_match_the_cpu(device, case, monkeypatch):
    """Three frames on the card at a small map, then one frame from the
    same state with the same draws on the card and on the CPU, each birth
    given the card's ``norm_coeff`` (the bars of ``chip_smoke.py``'s card
    against CPU: flags >= 99.9%, alive within 0.5%, weight_sum within rtol
    1e-4 on >= 99.9%)."""
    from dspmap_tpu_torch.models import pipeline

    kw, n_sensors = STEP_CASES[case]
    cfg = _cfg(**kw)
    frames = [T.Frame(*f) for f in sim.generate_sequence(4, cfg, seed=0)]
    if n_sensors:
        step = T.make_multisensor_step(cfg, n_sensors)
        state = T.init_multisensor_state(cfg, n_sensors)
        frames = [T.stack_frames([f] * n_sensors) for f in frames]
    else:
        step = T.make_step(cfg)
        state = T.init_state(cfg)
    assert state.device.type == "cuda"
    for f in frames[:3]:
        state, out = step(state, f)
        assert out.accepted
    if n_sensors:
        prop, sensors = T.make_multisensor_draws(cfg, n_sensors, state.gen,
                                                 device)
        draws = (prop, sensors)
        cpu_draws = (None if prop is None else prop.cpu(),
                     tuple(tuple(d.cpu() for d in s) for s in sensors))
    else:
        draws = T.make_draws(cfg, state.gen, device)
        cpu_draws = tuple(d.cpu() for d in draws)
    name = ("particle_birth_compact" if cfg.layout == "compact"
            else "particle_birth")
    birth = getattr(pipeline, name)
    seen = []

    def card_birth(*a, **kw):
        seen.append(kw["norm_coeff"])
        return birth(*a, **kw)

    def cpu_birth(*a, **kw):
        kw["norm_coeff"] = seen.pop(0).cpu()
        return birth(*a, **kw)

    cpu_state = state.to("cpu")
    monkeypatch.setattr(pipeline, name, card_birth)
    card, card_out = step(state, frames[3], draws)
    assert len(seen) == (n_sensors or 1)
    monkeypatch.setattr(pipeline, name, cpu_birth)
    cpu, cpu_out = step(cpu_state, frames[3], cpu_draws)
    assert not seen
    flags = (card.particles.flags.cpu() == cpu.particles.flags).float().mean()
    assert float(flags) >= 0.999
    a_g, a_c = int(card_out.metrics["alive"]), int(cpu_out.metrics["alive"])
    assert a_c > 0 and abs(a_g - a_c) <= 0.005 * a_c
    close = torch.isclose(card.weight_sum.cpu(), cpu.weight_sum, rtol=1e-4,
                          atol=1e-7).float().mean()
    assert float(close) >= 0.999


def _bit_equal_states(a, b):
    """Every leaf of two states' ``state_to_numpy`` trees bit for bit."""
    def leaves(state):
        tree = T.state_to_numpy(state)
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out.update({f"{key}.{k}": v for k, v in value.items()})
            else:
                out[key] = value
        return out

    x, y = leaves(a), leaves(b)
    assert x.keys() == y.keys()
    for k in x:
        u, v = np.asarray(x[k]), np.asarray(y[k])
        assert u.dtype == v.dtype and u.shape == v.shape, k
        assert u.tobytes() == v.tobytes(), k


@pytest.mark.parametrize("layout", ["pool", "compact"])
def test_checkpoint_round_trip_on_the_card(device, layout, tmp_path):
    """A card state saved after three frames and loaded into a card
    template of another seed: every leaf and the generator bit-equal;
    both stepped two more frames with their generators' own draws agree
    within the card-against-CPU bars of ``chip_smoke.py`` (flags >= 99.9%,
    alive within 0.5%, weight_sum within rtol 1e-4 on >= 99.9%); loaded into
    a CPU template, every leaf bit-equal."""
    from dspmap_tpu_torch.io import load_state, save_state

    cfg = _cfg(layout=layout)
    frames = [T.Frame(*f) for f in sim.generate_sequence(5, cfg, seed=0)]
    step = T.make_step(cfg)
    state = T.init_state(cfg, seed=0)
    for f in frames[:3]:
        state, _ = step(state, f)
    path = tmp_path / "card.npz"
    save_state(state, path)
    restored = load_state(T.init_state(cfg, seed=1), path)
    assert restored.device.type == "cuda"
    _bit_equal_states(restored, state)
    assert torch.equal(restored.gen.get_state(), state.gen.get_state())
    _bit_equal_states(load_state(T.init_state(cfg, seed=1, device="cpu"),
                                 path), state)
    for f in frames[3:]:
        state, out_a = step(state, f)
        restored, out_b = step(restored, f)
    flags = float((state.particles.flags == restored.particles.flags)
                  .float().mean())
    ws = float(torch.isclose(state.weight_sum, restored.weight_sum, rtol=1e-4,
                             atol=1e-7).float().mean())
    a, b = int(out_a.metrics["alive"]), int(out_b.metrics["alive"])
    assert flags >= 0.999 and ws >= 0.999 and a > 0
    assert abs(a - b) <= 0.005 * a


@pytest.mark.parametrize("layout", ["pool", "compact"])
def test_particle_csv_from_the_card_equals_the_cpus(device, layout, tmp_path):
    """``export_particles_csv`` of a card state and of the same state moved
    to the CPU: the same bytes."""
    from dspmap_tpu_torch.io import export_particles_csv

    cfg = _cfg(layout=layout)
    step = T.make_step(cfg)
    state = T.init_state(cfg, seed=0, init_particle_num=2000)
    for f in sim.generate_sequence(3, cfg, seed=0):
        state, _ = step(state, T.Frame(*f))
    n = export_particles_csv(state, cfg, tmp_path / "card.csv")
    assert n == export_particles_csv(state.to("cpu"), cfg,
                                     tmp_path / "cpu.csv") > 0
    assert ((tmp_path / "card.csv").read_bytes()
            == (tmp_path / "cpu.csv").read_bytes())


def test_estimator_repeats_its_bits_on_the_card(device):
    """The velocity estimator, which every rank of the sharded step runs on
    the same frames, gives the same bits twice over eight flagship frames
    (two tracks fed alike), and ``segment_sum`` with duplicate indices the
    same bits on every call; ``index_add``'s float atomics would not."""
    from dspmap_tpu_torch.estimator import estimate_velocities
    from dspmap_tpu_torch.models import pipeline
    from dspmap_tpu_torch.ops.common import segment_sum

    g = torch.Generator(device=device)
    g.manual_seed(0)
    seg = torch.randint(0, 40, (5000,), device=device, generator=g)
    vals = torch.randn(5000, 3, device=device, generator=g)
    sums = [segment_sum(vals, seg, 41) for _ in range(10)]
    assert all(torch.equal(sums[0].view(torch.int32), s.view(torch.int32))
               for s in sums[1:])
    torch.testing.assert_close(sums[0].cpu(), segment_sum(
        vals.cpu(), seg.cpu(), 41), rtol=1e-5, atol=1e-4)

    cfg = T.example_node_settings(T.dsp_dynamic())
    state = T.init_state(cfg, seed=0, device=device)
    est_a = est_b = state.estimator
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    n_dynamic = 0
    for pts, n, pos, quat, _ in sim.generate_sequence(8, cfg, seed=0):
        obs, _ = pipeline._observe(pts, n, pos, quat, cfg, state.params,
                                   device)
        fresh = torch.rand(cfg.max_clusters, device=device, generator=g)
        out_a, est_a = estimate_velocities(obs.cloud_world, obs.cloud_valid,
                                           est_a, cfg, 0.1, fresh)
        out_b, est_b = estimate_velocities(obs.cloud_world, obs.cloud_valid,
                                           est_b, cfg, 0.1, fresh)
        for a, b in zip(tuple(out_a) + tuple(vars(est_a).values()),
                        tuple(out_b) + tuple(vars(est_b).values())):
            assert torch.equal(bits(a), bits(b))
        n_dynamic += int(out_a.dynamic.sum())
    assert n_dynamic > 0


#: the step's arms whose float sums meet duplicate indices on the card: the
#: future scatter (pool), the per-voxel tables (compact), the noisy arm and
#: the two-camera step
REPEAT_CASES = {
    "pool": ({}, None),
    "compact": (dict(layout="compact"), None),
    "noisy": (dict(limit_motion_to_xy_plane=False), None),
    "two_camera": ({}, 2),
}


def _outputs_bit_equal(a, b):
    """Two ``StepOutput``s: the same acceptance, and every tensor in them
    bit for bit."""
    assert a.accepted == b.accepted and a.metrics.keys() == b.metrics.keys()
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    pairs = ([(a.weight_sum, b.weight_sum)]
             + [(a.metrics[k], b.metrics[k]) for k in a.metrics]
             + list(zip(a.estimator_cloud, b.estimator_cloud)))
    for x, y in pairs:
        assert torch.equal(bits(x), bits(y))


@pytest.mark.parametrize("case", sorted(REPEAT_CASES))
def test_step_repeats_its_bits_on_the_card(device, case):
    """Three frames on the card at a small map, then four more from that
    state with the same draws twice over: every leaf of the two states and
    every output bit for bit.  ``add_at`` with duplicate indices, along
    either dimension, gives the same bits on every call."""
    from dspmap_tpu_torch.ops.common import add_at

    g = torch.Generator(device=device)
    g.manual_seed(0)
    idx = torch.randint(0, 40, (5000,), device=device, generator=g)
    vals = torch.randn(3, 5000, device=device, generator=g)
    sums = [add_at(torch.zeros(3, 41, device=device), idx, vals, dim=1)
            for _ in range(10)]
    assert all(torch.equal(sums[0].view(torch.int32), s.view(torch.int32))
               for s in sums[1:])

    kw, n_sensors = REPEAT_CASES[case]
    cfg = _cfg(**kw)
    frames = [T.Frame(*f) for f in sim.generate_sequence(7, cfg, seed=0)]
    if n_sensors:
        step = T.make_multisensor_step(cfg, n_sensors)
        state = T.init_multisensor_state(cfg, n_sensors)
        frames = [T.stack_frames([f] * n_sensors) for f in frames]
        draws = [T.make_multisensor_draws(cfg, n_sensors, g, device)
                 for _ in frames[3:]]
    else:
        step = T.make_step(cfg)
        state = T.init_state(cfg)
        draws = [T.make_draws(cfg, g, device) for _ in frames[3:]]
    for f in frames[:3]:
        state, out = step(state, f)
        assert out.accepted
    runs = []
    for _ in range(2):
        s, outs = state, []
        for f, d in zip(frames[3:], draws):
            s, out = step(s, f, d)
            outs.append(out)
        runs.append((s, outs))
    (a, outs_a), (b, outs_b) = runs
    _bit_equal_states(a, b)
    for x, y in zip(outs_a, outs_b):
        _outputs_bit_equal(x, y)
    assert int(outs_a[-1].metrics["alive"]) > 0


#: (N, costs, kinds) of the JV instances, each cost solved at every n_rows
#: from 0 to N: the kernel's warp arm up to WARP_MAX_N = 31, its block arm
#: from 32; kinds: ``ties`` (``kernel_times.jv_case``), ``worst_chain``
#: (``jv_worst_chain``: one cost, N (N + 1) / 2 path steps), ``negative_zero``
#: and ``nan`` (tie-heavy costs holding -0.0 or NaN on a fifth of the pairs)
JV_CASES = [(1, 20, "ties"), (2, 20, "ties"), (8, 100, "ties"),
            (16, 50, "ties"), (31, 6, "ties"), (32, 6, "ties"),
            (33, 6, "ties"), (40, 3, "ties"), (64, 1, "ties")] + [
    (N, n, kind) for kind, n in (("worst_chain", 1), ("negative_zero", 4),
                                 ("nan", 4))
    for N in (1, 2, 8, 16, 31, 32, 40)]


def _jv_cost(kind, N, rng):
    if kind == "worst_chain":
        return jv_worst_chain(N)
    a = jv_case(N, rng)
    if kind != "ties":
        a[rng.random((N, N)) < 0.2] = (-0.0 if kind == "negative_zero"
                                       else np.nan)
    return a


@pytest.mark.parametrize("N,n_costs,kind", JV_CASES,
                         ids=[f"{k}-{N}" for N, _, k in JV_CASES])
def test_jv_kernel_bit_equal_to_plain_on_tie_heavy_costs(device, N, n_costs,
                                                         kind):
    """``jv_solve`` gives ``_jv_plain``'s bits (every entry of ``p``) on
    both arms, the warp's (N <= 31) and the block's, with every ``n_rows``
    from 0 to R = N: one launch a solve, ``n_rows`` read on the card.  The
    plain version runs on the CPU (its adds, subtracts, compares and argmin
    give the same bits on either device; the first cost of a case is also
    solved by it on the card), and the numpy form of
    ``kernel_times.jv_numpy`` agrees."""
    rng = np.random.default_rng(20 + N)
    for k in range(n_costs):
        a_np = _jv_cost(kind, N, rng)
        a, a_cpu = torch.from_numpy(a_np).to(device), torch.from_numpy(a_np)
        for n_rows in range(N + 1):
            nr = torch.tensor(n_rows, dtype=torch.int64, device=device)
            n0 = kernels.LAUNCHES["jv_solve"]
            got = assignment.jv_solve_cuda(a, nr, N)
            assert kernels.LAUNCHES["jv_solve"] == n0 + 1
            want = assignment._jv_plain(a_cpu, nr.cpu(), N)
            assert torch.equal(got.cpu(), want), (N, k, n_rows)
            if k == 0 and n_rows in (N // 2, N):
                assert torch.equal(assignment._jv_plain(a, nr, N), got)
                assert np.array_equal(jv_numpy(a_np, n_rows, N)[0],
                                      want.numpy())


def test_jv_kernel_bit_equal_to_plain_on_flagship_costs(device, monkeypatch):
    """The cost matrices of 30 flagship frames, recorded by wrapping the
    estimator's ``solve_assignment`` on the card: each solve launches
    ``jv_solve`` once and never ``_jv_plain`` (made to raise), its ``p``
    bit-equal to the plain version's on the same squared-up cost, and the
    assignment equal to the CPU's."""
    from dspmap_tpu_torch import estimator
    from dspmap_tpu_torch.models import pipeline

    recorded, solves = [], []
    solve, jv = estimator.solve_assignment, assignment._jv

    def record(cost, row_valid, col_valid):
        recorded.append((cost.cpu(), row_valid.cpu(), col_valid.cpu()))
        return solve(cost, row_valid, col_valid)

    def record_jv(a, n_rows, R):
        p = jv(a, n_rows, R)
        solves.append((a.cpu(), n_rows.cpu(), R, p.cpu()))
        return p

    def no_plain(*args):
        raise AssertionError("_jv_plain ran on a CUDA tensor")

    plain = assignment._jv_plain
    monkeypatch.setattr(estimator, "solve_assignment", record)
    monkeypatch.setattr(assignment, "_jv", record_jv)
    monkeypatch.setattr(assignment, "_jv_plain", no_plain)
    cfg = T.example_node_settings(T.dsp_dynamic())
    state = T.init_state(cfg, seed=0, device=device)
    est = state.estimator
    g = torch.Generator(device=device)
    g.manual_seed(0)
    n0 = kernels.LAUNCHES["jv_solve"]
    for pts, n, pos, quat, _ in sim.generate_sequence(30, cfg, seed=0):
        obs, _ = pipeline._observe(pts, n, pos, quat, cfg, state.params,
                                   device)
        fresh = torch.rand(cfg.max_clusters, device=device, generator=g)
        _, est = estimator.estimate_velocities(
            obs.cloud_world, obs.cloud_valid, est, cfg, 0.1, fresh)
    assert len(recorded) == len(solves) == 30
    assert kernels.LAUNCHES["jv_solve"] == n0 + 30
    monkeypatch.undo()
    n_matched = 0
    for (cost, rv, cv), (a, n_rows, R, p) in zip(recorded, solves):
        assert torch.equal(plain(a, n_rows, R), p)
        card = assignment.solve_assignment(cost.to(device), rv.to(device),
                                           cv.to(device))
        cpu = assignment.solve_assignment(cost, rv, cv)
        assert torch.equal(card.cpu(), cpu)
        n_matched += int((cpu >= 0).sum())
    assert n_matched > 0


#: (kind, P) of the clustering kernel's cases (``kernel_times.cluster_case``):
#: every kind at P = 5,000 (every preset's), and P not a multiple of 32 --
#: 4,999, 1,001 (the chain), 77 (the pairs about the tolerance), 33 and 1
CLUSTER_KERNEL_CASES = [(kind, 5000) for kind in CLUSTER_KINDS] + [
    ("blobs", 4999), ("chain", 1001), ("tolerance_ulps", 77),
    ("all_valid", 33), ("blobs", 1)]


@pytest.mark.parametrize("kind,P", CLUSTER_KERNEL_CASES,
                         ids=[f"{k}-{P}" for k, P in CLUSTER_KERNEL_CASES])
def test_cluster_kernel_bit_equal_to_plain(device, kind, P):
    """``euclidean_cluster_cuda`` gives the plain version's labels bit for
    bit on the same CUDA tensors at 12 sweeps (the presets'), 0, 1, 3 and
    16: one launch a call; the kernel's counter on the card counts one run
    a call and at most ``iters`` sweeps, every one of them on the chain,
    whose labels the cap decides."""
    pts_np, ok_np = cluster_case(kind, P, np.random.default_rng(P))
    pts = torch.from_numpy(pts_np).to(device)
    ok = torch.from_numpy(ok_np).to(device)
    tol = CLUSTER_TOLERANCE
    for iters in (12, 0, 1, 3, 16):
        n0 = kernels.LAUNCHES["euclidean_cluster"]
        s0, r0 = cluster.sweeps_run(device)
        got = cluster.euclidean_cluster_cuda(pts, ok, tol, iters)
        assert kernels.LAUNCHES["euclidean_cluster"] == n0 + 1
        want = cluster.euclidean_cluster_plain(pts, ok, tol, iters)
        assert got.dtype == torch.int32 and torch.equal(got, want), iters
        s1, r1 = cluster.sweeps_run(device)
        assert r1 == r0 + 1 and 0 <= s1 - s0 <= iters
        if kind == "chain":
            assert s1 - s0 == iters
    labels = want.cpu().numpy()
    assert (labels[~ok_np] == P).all() and (labels[ok_np] < P).all()
    if kind == "chain":
        assert len(np.unique(labels)) > 1
    if kind == "tolerance_ulps":  # sq at 0, +1, -1, +2 ulps of tol2
        sq = (pts_np * pts_np).sum(1, dtype=np.float32)
        joined = ok_np & (sq <= np.float32(tol * tol))
        assert joined.sum() == 3 and (ok_np & ~joined).sum() == 2
        assert (labels[joined] == np.flatnonzero(joined).min()).all()
        assert (labels[ok_np & ~joined] == np.flatnonzero(ok_np & ~joined)).all()


def _no_plain_cluster(*args):
    raise AssertionError("euclidean_cluster_plain ran on a CUDA tensor")


def test_cluster_kernel_bit_equal_to_plain_on_street_clouds(device,
                                                            monkeypatch):
    """The clouds the estimator clusters on eight flagship frames and three
    frames of the four-camera rig (``utils/rig.py``), recorded by wrapping
    its ``euclidean_cluster`` on the card: one launch a camera, never the
    plain version (made to raise), the labels bit-equal to the plain
    version's on the same tensors."""
    from dspmap_tpu_torch import estimator
    from dspmap_tpu_torch.utils.graph_ritual import sequence

    recorded = []
    run = estimator.euclidean_cluster

    def record(points, valid, tolerance, iters):
        labels = run(points, valid, tolerance, iters)
        recorded.append((points.clone(), valid.clone(), tolerance, iters,
                         labels.clone()))
        return labels

    monkeypatch.setattr(estimator, "euclidean_cluster", record)
    monkeypatch.setattr(cluster, "euclidean_cluster_plain", _no_plain_cluster)
    cfg = T.example_node_settings(T.dsp_dynamic())
    n0 = kernels.LAUNCHES["euclidean_cluster"]
    step, state = T.make_step(cfg), T.init_state(cfg, seed=0)
    for f in sequence(8, cfg):
        state, out = step(state, f)
        assert out.accepted
    step = T.make_multisensor_step(cfg, 4)
    state = T.init_multisensor_state(cfg, 4, seed=0)
    for f in sequence(3, cfg, 4, rig=True):
        state, out = step(state, f)
        assert out.accepted
    assert len(recorded) == 8 + 3 * 4
    assert kernels.LAUNCHES["euclidean_cluster"] == n0 + len(recorded)
    monkeypatch.undo()
    n_clusters = 0
    for points, valid, tolerance, iters, labels in recorded:
        assert iters == cfg.cluster_propagation_iters
        want = cluster.euclidean_cluster_plain(points, valid, tolerance, iters)
        assert torch.equal(labels, want)
        n_clusters += int((want == torch.arange(
            want.numel(), dtype=torch.int32, device=device)).sum())
    assert n_clusters > len(recorded)


def test_graphed_steps_launch_the_cluster_kernel_once_a_camera(
        device, monkeypatch):
    """In the flagship's graphed step and the four-camera rig's, the
    clustering kernel runs once a camera on the card in every replayed
    frame (its counter on the card), is launched from the host only in the
    warm-up run and the capture, and the plain version never runs (made to
    raise)."""
    from dspmap_tpu_torch.utils.graph_ritual import sequence

    monkeypatch.setattr(cluster, "euclidean_cluster_plain", _no_plain_cluster)
    cfg = T.example_node_settings(T.dsp_dynamic())
    for cams in (None, 4):
        if cams is None:
            step, state = T.make_graphed_step(cfg), T.init_state(cfg, seed=0)
            frames, per_frame = sequence(5, cfg), 1
        else:
            step = T.make_graphed_multisensor_step(cfg, cams)
            state = T.init_multisensor_state(cfg, cams, seed=0)
            frames, per_frame = sequence(5, cfg, cams, rig=True), cams
        for k, f in enumerate(frames):
            n0 = kernels.LAUNCHES["euclidean_cluster"]
            s0, r0 = cluster.sweeps_run(device)
            state, out = step(state, f)
            torch.cuda.synchronize()
            assert out.accepted
            s1, r1 = cluster.sweeps_run(device)
            launched = kernels.LAUNCHES["euclidean_cluster"] - n0
            assert launched == (2 * per_frame if k == 0 else 0), (cams, k)
            assert r1 - r0 == (2 if k == 0 else 1) * per_frame
            assert 0 < s1 - s0 <= (r1 - r0) * cfg.cluster_propagation_iters
        assert step.captures == 1
        step.release()


@pytest.mark.parametrize("preset", ["flagship", "static", "multi"])
def test_sweep_kernel_reads_the_frame_blocks(device, preset):
    """K2 with its per-frame values read from the frame blocks on the card
    (as the step and a captured graph hand them) against the plain version
    on the same views, at the full-width pool of each path that takes it:
    positions within 1e-5, under 0.1% of the discrete fields flipped; and
    the same bits as K2 handed the host values."""
    from dspmap_tpu_torch import scalars
    from dspmap_tpu_torch.utils.kernel_times import populated_pool

    cfg = (_preset(preset) if preset in PRESETS
           else T.example_node_settings(T.dsp_dynamic()))
    p = populated_pool(cfg, np.random.default_rng(3), device)
    dt, sensor = np.float32(0.1), np.asarray([0.35, -0.2, 1.0], np.float32)
    quat = np.asarray([np.cos(0.15), 0, 0, np.sin(0.15)], np.float32)
    fs = scalars.frame_scalars(cfg, device, dt=dt, sensor_pos=sensor,
                               quat=quat)
    args = (fs.dt, fs.origin, fs.sensor_pos)
    kw = dict(origin_mod=fs.origin_mod, R=fs.R)
    got = sweep.sweep_cuda(p, cfg, *args, **kw)
    want = sweep.sweep_reference(p, cfg, *args, **kw)
    torch.testing.assert_close(got.px, want.px, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.py, want.py, atol=1e-5, rtol=0)
    for name in ("flags", "new_cell", "tags"):
        assert (getattr(got, name) != getattr(want, name)).float().mean() < 1e-3
    assert bool(got.fov.any())
    host = sweep.sweep_cuda(p, cfg, dt, T.geometry.window_origin_np(
        sensor, cfg), sensor, quat)
    for name in ("px", "py", "flags", "new_cell", "tags"):
        assert torch.equal(getattr(got, name), getattr(host, name)), name


GRAPH_CASES = {"pool": {}, "compact": dict(layout="compact")}


def _seeded(seed, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("given_draws", [True, False],
                         ids=["draws_given", "draws_from_gen"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_step_bit_equal_to_eager(device, case, given_draws):
    """``make_graphed_step`` against ``make_step`` on six frames from the
    same state with the same draws -- handed in, or drawn by each step from
    its own of two equal generators (the path of replay and the ROS
    bridges) -- a rejected frame (a pose jump of 12 m) and a live setter
    between frames, every state leaf, the generators and every output bit
    for bit after each frame, one capture, and no kernel launched from the
    host during a replay."""
    cfg = _cfg(**GRAPH_CASES[case])
    frames = [T.Frame(*f) for f in sim.generate_sequence(9, cfg, seed=0)]
    frames[6] = frames[6]._replace(
        sensor_pos=frames[6].sensor_pos + np.float32([12, 0, 0]))
    eager, graphed = T.make_step(cfg), T.make_graphed_step(cfg)
    state = T.init_state(cfg)
    for f in frames[:3]:
        state, _ = eager(state, f)
    g = _seeded(4, device)
    draws = ([T.make_draws(cfg, g, device) for _ in frames[3:]]
             if given_draws else [None] * 6)
    a = dataclasses.replace(state, gen=_seeded(5, device))
    b = dataclasses.replace(state, gen=_seeded(5, device))
    for k, (f, d) in enumerate(zip(frames[3:], draws)):
        if k == 4:
            a = T.set_detection_probability(a, 0.85)
            b = T.set_detection_probability(b, 0.85)
        a, out_a = eager(a, f, d)
        n0 = dict(kernels.LAUNCHES)
        b, out_b = graphed(b, f, d)
        if k > 0:  # after the capture, a frame is one replay
            assert kernels.LAUNCHES == n0
        assert out_a.accepted == (k != 3)
        _bit_equal_states(a, b)
        assert torch.equal(a.gen.get_state(), b.gen.get_state())
        if out_a.accepted:
            _outputs_bit_equal(out_a, out_b)
    assert graphed.captures == 1
    assert int(out_b.metrics["alive"]) > 0
    graphed.release()


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_step_bit_equal_to_eager_on_spilling_frames(device, case):
    """With four dense slots a pyramid most of the update's particles go
    through the spill kernels: the graphed step gives the eager step's bits
    on frames whose ``update_spilled`` is above 0, and a replay launches
    nothing from the host."""
    cfg = _cfg(pyramid_dense_slots=4, **GRAPH_CASES[case])
    frames = [T.Frame(*f) for f in sim.generate_sequence(7, cfg, seed=2)]
    eager, graphed = T.make_step(cfg), T.make_graphed_step(cfg)
    state = T.init_state(cfg)
    for f in frames[:3]:
        state, _ = eager(state, f)
    g = _seeded(6, device)
    a = dataclasses.replace(state, gen=_seeded(7, device))
    b = dataclasses.replace(state, gen=_seeded(7, device))
    spilled = []
    for k, f in enumerate(frames[3:]):
        d = T.make_draws(cfg, g, device)
        n0 = dict(kernels.LAUNCHES)
        a, out_a = eager(a, f, d)
        assert kernels.LAUNCHES["spill_pass1"] == n0["spill_pass1"] + 1
        n0 = dict(kernels.LAUNCHES)
        b, out_b = graphed(b, f, d)
        if k > 0:
            assert kernels.LAUNCHES == n0
        _bit_equal_states(a, b)
        _outputs_bit_equal(out_a, out_b)
        spilled.append(int(out_b.metrics["update_spilled"]))
    assert min(spilled) > 0, spilled
    graphed.release()


def test_graphed_step_refuses_a_cpu_state_and_other_shapes(device):
    cfg = _cfg()
    frame = T.Frame(*next(sim.generate_sequence(1, cfg, seed=0)))
    step = T.make_graphed_step(cfg)
    with pytest.raises(ValueError, match="CUDA card"):
        step(T.init_state(cfg, device="cpu"), frame)
    step(T.init_state(cfg), frame)
    assert step.captures == 1
    small = T.init_state(cfg)
    small = dataclasses.replace(small, future=small.future[:, :-8])
    with pytest.raises(ValueError, match="captured"):
        step(small, frame)
    step.release()


MS_GRAPH_CASES = {"pool": {}, "noisy": dict(limit_motion_to_xy_plane=False),
                  "compact": dict(layout="compact")}


def _two_cameras(frame, admitted=(True, True)):
    """Two cameras from one camera's frame: camera 1 shifted 0.3 m, its
    point count 11 less; a camera not ``admitted`` has a NaN quaternion,
    which admission skips alone."""
    cam1 = frame._replace(n_points=int(frame.n_points) - 11,
                          sensor_pos=frame.sensor_pos
                          + np.float32([0.3, -0.2, 0.0]))
    cams = [c if ok else c._replace(quat=np.full(4, np.nan, np.float32))
            for c, ok in zip((frame, cam1), admitted)]
    return T.stack_frames(cams)


#: the six frames of the graphed multi-sensor test: (admitted pattern,
#: camera 0 jumped 12 m); frame 4 follows a live setter
MS_GRAPH_FRAMES = (((True, True), False), ((True, False), False),
                   ((True, True), True), ((True, True), False),
                   ((False, True), False), ((True, False), False))


@pytest.mark.parametrize("given_draws", [True, False],
                         ids=["draws_given", "draws_from_gen"])
@pytest.mark.parametrize("case", sorted(MS_GRAPH_CASES))
def test_graphed_multisensor_step_bit_equal_to_eager(device, case,
                                                     given_draws):
    """``make_graphed_multisensor_step`` against ``make_multisensor_step``
    on six two-camera frames from the same state with the same draws --
    handed in, or drawn by each step from its own of two equal generators
    -- with every pattern of admitted cameras among them, a rejected frame
    (camera 0 jumped 12 m) and a live setter: every state leaf, the
    generators and every output bit for bit after each frame, one capture
    a pattern seen, and no kernel launched from the host when a frame
    replays a pattern's graph."""
    cfg = _cfg(**MS_GRAPH_CASES[case])
    frames = [T.Frame(*f) for f in sim.generate_sequence(9, cfg, seed=0)]
    eager = T.make_multisensor_step(cfg, 2)
    graphed = T.make_graphed_multisensor_step(cfg, 2)
    state = T.init_multisensor_state(cfg, 2)
    for f in frames[:3]:
        state, _ = eager(state, _two_cameras(f))
    g = _seeded(4, device)
    draws = ([T.make_multisensor_draws(cfg, 2, g, device) for _ in frames[3:]]
             if given_draws else [None] * 6)
    a = dataclasses.replace(state, gen=_seeded(5, device))
    b = dataclasses.replace(state, gen=_seeded(5, device))
    seen = set()
    for k, (f, d, (admitted, jump)) in enumerate(zip(frames[3:], draws,
                                                     MS_GRAPH_FRAMES)):
        if jump:
            f = f._replace(sensor_pos=f.sensor_pos + np.float32([12, 0, 0]))
        f = _two_cameras(f, admitted)
        if k == 4:
            a = T.set_detection_probability(a, 0.85)
            b = T.set_detection_probability(b, 0.85)
        a, out_a = eager(a, f, d)
        n0 = dict(kernels.LAUNCHES)
        b, out_b = graphed(b, f, d)
        assert out_a.accepted == (not jump)
        if out_a.accepted:
            if admitted in seen:  # a pattern's later frame is one replay
                assert kernels.LAUNCHES == n0
            seen.add(admitted)
            _outputs_bit_equal(out_a, out_b)
        _bit_equal_states(a, b)
        assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert len(seen) == 3 and graphed.captures == 3
    assert set(graphed.capture_ms) == set(graphed.pool_bytes) == seen
    assert int(out_b.metrics["alive"]) > 0
    graphed.release()


def test_graphed_multisensor_step_refuses_a_cpu_state_and_other_shapes(
        device):
    cfg = _cfg()
    frame = T.Frame(*next(sim.generate_sequence(1, cfg, seed=0)))
    step = T.make_graphed_multisensor_step(cfg, 2)
    with pytest.raises(ValueError, match="CUDA card"):
        step(T.init_multisensor_state(cfg, 2, device="cpu"),
             _two_cameras(frame))
    with pytest.raises(ValueError, match="sensor frames"):
        step(T.init_multisensor_state(cfg, 2),
             T.stack_frames([frame] * 3))
    with pytest.raises(ValueError, match="leading"):
        step(T.init_state(cfg), _two_cameras(frame))
    assert step.captures == 0
    step(T.init_multisensor_state(cfg, 2), _two_cameras(frame))
    assert step.captures == 1
    small = T.init_multisensor_state(cfg, 2)
    small = dataclasses.replace(small, future=small.future[:, :-8])
    with pytest.raises(ValueError, match="captured"):
        step(small, _two_cameras(frame))
    step.release()


@pytest.fixture
def nccl_mesh(device, tmp_path):
    """A one-rank NCCL group (a ``file://`` rendezvous) and its mesh."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield T.make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_graphed_sharded_step_bit_equal_to_eager_at_one_nccl_rank(
        device, nccl_mesh):
    """``make_graphed_sharded_step`` against ``make_shardmap_step`` in a
    one-rank NCCL group on four frames from the same slab, each step
    drawing from its own of two equal generators: every leaf, the
    generators and every output bit for bit, one capture, no kernel
    launched from the host during a replay."""
    cfg = _cfg()
    frames = [T.Frame(*f) for f in sim.generate_sequence(6, cfg, seed=0)]
    eager = T.make_shardmap_step(cfg, nccl_mesh, device=device)
    graphed = T.make_graphed_sharded_step(cfg, nccl_mesh, device=device)
    state = T.shard_state(T.init_state(cfg), nccl_mesh)
    for f in frames[:2]:
        state, _ = eager(state, f)
    a = dataclasses.replace(state, gen=_seeded(5, device))
    b = dataclasses.replace(state, gen=_seeded(5, device))
    for k, f in enumerate(frames[2:]):
        a, out_a = eager(a, f)
        n0 = dict(kernels.LAUNCHES)
        b, out_b = graphed(b, f)
        if k > 0:  # after the capture, a frame is one replay
            assert kernels.LAUNCHES == n0
        _bit_equal_states(a, b)
        assert torch.equal(a.gen.get_state(), b.gen.get_state())
        _outputs_bit_equal(out_a, out_b)
    assert graphed.captures == 1
    assert int(out_b.metrics["alive"]) > 0
    graphed.release()


def test_graphed_sharded_step_raises_when_its_capture_fails(
        device, nccl_mesh, monkeypatch):
    """A body that reads a device value on the host runs in the warm-up
    and cannot be captured: the step raises, captures nothing and runs no
    eager step in its place.  (Last in the file: a failed capture may
    leave the card's allocator in a state the other tests should not
    meet.)"""
    from dspmap_tpu_torch.models import graphed as graphed_module

    make_body = graphed_module.make_body

    def reading(cfg, with_metrics=True, shard=None):
        body = make_body(cfg, with_metrics, shard)

        def read_then_body(particles, *args):
            float(particles.weight.sum())
            return body(particles, *args)

        return read_then_body

    monkeypatch.setattr(graphed_module, "make_body", reading)
    cfg = _cfg()
    frame = T.Frame(*next(sim.generate_sequence(1, cfg, seed=0)))
    step = T.make_graphed_shardmap_step(cfg, nccl_mesh, device=device)
    state = T.shard_state(T.init_state(cfg), nccl_mesh)
    with pytest.raises(RuntimeError):
        step(state, frame)
    assert step.captures == 0 and not step.capture_ms
