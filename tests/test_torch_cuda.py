"""The port's CUDA kernels against their plain versions on a card.

Marked ``cuda``: each test skips unless a compute-capability-9.x card is
present.  On a machine with an H100 (and without jax, which
``tests/conftest.py`` imports) run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``;
``chip_smoke.py`` runs the same checks at the full-width shapes of every
path."""

import hashlib

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch import kernels
from dspmap_tpu_torch.ops import compact, occupancy, relayout, sweep, update
from dspmap_tpu_torch.ops.common import padded_buffer
from dspmap_tpu_torch.utils import sim
from dspmap_tpu_torch.utils.kernel_times import pair_operands, segscan_case

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
    card: one launch of K1, K2, K3a and K3b a frame, the relayout kernels
    only where the planes reach 16 MiB (multi: one launch in, one out a
    frame), a finite map with live particles, the input state left as it
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
        "update_pass2": 3, "seg_scans": 0,
        "to_flat": 3 if big else 0, "from_flat": 3 if big else 0}
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
