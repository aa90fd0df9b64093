"""The port's kernel modules on the CPU: the plain PyTorch version of each
hand-written CUDA kernel against the JAX package's XLA specification, on the
same numpy-seeded inputs.

* K1 (occupancy pool pass) vs ``ops/occupancy.py::_pool_pass_xla``: flags
  exact, weights and payload rtol 1e-6, counter sums exact (the bar of
  ``tests/test_pallas.py``).
* K2 (fused sweep) vs ``ops/sweep.py::sweep_reference``: floats atol 1e-5,
  under 0.1% of discrete fields may differ.
* K3 (pair passes) vs the XLA dense blocks of ``ops/update.py``.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu.ops.occupancy import _pool_pass_xla
from dspmap_tpu.ops.sweep import sweep_reference as jax_sweep
from dspmap_tpu.ops.update import _pair_g as jax_pair_g
from dspmap_tpu_torch import kernels
from dspmap_tpu_torch.ops import (assignment, compact, occupancy, relayout,
                                  sweep, update)

torch.set_num_threads(2)

SMALL = dict(nx=16, ny=16, nz=8, max_input_points=128, mover_capacity=1024,
             pyramid_slot_capacity=16, max_clusters=4)
PLANES = ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")


def _configs(**kw):
    base = {**SMALL, **kw}
    return J.dsp_dynamic(**base), T.dsp_dynamic(**base)


def _both(arrays):
    """(JAX Particles, port Particles) over the same numpy planes."""
    jp = J.Particles(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tp = T.Particles(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    return jp, tp


def _occupancy_pool(cfg, seed, resample=True):
    """Pool populated like tests/test_pallas.py's occupancy test, with
    velocities conforming to the limit-xy clamp (vz = 0)."""
    rng = np.random.default_rng(seed)
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    a = {k: np.zeros((S, V), np.float32) for k in PLANES}
    a["flags"] = np.zeros((S, V), np.int32)
    for c in rng.choice(cfg.voxel_num, size=300, replace=False):
        k = (rng.integers(1, S + 1) if resample
             else rng.integers(1, cfg.resample_min_count))
        slots = rng.choice(S, size=k, replace=False)
        a["flags"][slots, c] = rng.choice([1, 1, 1, 3], size=k)
        a["weight"][slots, c] = rng.uniform(0.0005, 1.0, size=k)
        a["vx"][slots, c] = np.where(rng.random(k) < 0.3, 1.0, 0.0)
        a["vy"][slots, c] = np.where(rng.random(k) < 0.2, -0.5, 0.0)
    for k in ("px", "py", "pz"):
        a[k] = rng.normal(0, 1, (S, V)).astype(np.float32)
    a["t"] = rng.uniform(0, 5, (S, V)).astype(np.float32)
    return a


@pytest.mark.parametrize("seed,resample", [(0, True), (1, True), (2, True),
                                           (3, False)])
def test_occupancy_plain_matches_xla(seed, resample):
    jcfg, tcfg = _configs()
    a = _occupancy_pool(jcfg, seed, resample)
    jp, tp = _both(a)
    ref, ws_r, n_old_r, vsum_r, static_r, moving_r = _pool_pass_xla(jp, jcfg)
    (fields, ws, n_old, vsum, static_c, moving,
     counters) = occupancy.pool_pass_plain(tp, tcfg, with_moving=True)

    np.testing.assert_array_equal(fields["flags"].numpy(), np.asarray(ref.flags))
    np.testing.assert_allclose(fields["weight"].numpy(), np.asarray(ref.weight),
                               rtol=1e-6, atol=1e-9)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "t"):
        np.testing.assert_allclose(fields[f].numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_r), rtol=1e-6)
    np.testing.assert_allclose(static_c.numpy(), np.asarray(static_r), rtol=1e-6)
    for got, want in zip(vsum, vsum_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(n_old.numpy(), np.asarray(n_old_r))
    np.testing.assert_array_equal(moving.numpy(), np.asarray(moving_r))

    # counters: the set semantics of the JAX package's stats surface
    valid_in = a["flags"] != 0
    survivor = valid_in & (a["weight"] >= jcfg.weight_cull_threshold)
    new_valid = np.asarray(ref.flags) != 0
    n_valid, n_culled, do_rs, n_dropped, n_filled = (c.numpy() for c in counters)
    assert n_valid.sum() == survivor.sum()
    assert n_culled.sum() == (valid_in & ~survivor).sum()
    assert do_rs.sum() == (survivor.sum(0) >= jcfg.resample_min_count).sum()
    assert n_dropped.sum() == (survivor & ~new_valid).sum()
    assert n_filled.sum() == (~survivor & new_valid).sum()
    assert (n_valid - n_dropped + n_filled).sum() == new_valid.sum()
    if resample:
        assert n_dropped.sum() > 0 and n_filled.sum() > 0


def test_occupancy_plain_matches_xla_on_equal_weight_ties():
    """Voxels full of equal-weight newborns put the resample's
    ``ceil(x/wa - 1/2)`` thresholds exactly on the grid, where the last bit
    of the slot-axis cumsum decides which slots are kept.  The plain
    version associates the cumsum as XLA does (blocks of 16 slots), so the
    flags agree exactly across many weight values."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(11)
    S, V = jcfg.slots_per_voxel, jcfg.storage_voxels
    a = {k: np.zeros((S, V), np.float32) for k in PLANES}
    a["flags"] = np.zeros((S, V), np.int32)
    cols = rng.choice(jcfg.voxel_num, size=1500, replace=False)
    k = rng.integers(jcfg.resample_min_count, S + 1, size=cols.size)
    occ = np.arange(S)[:, None] < k[None, :]
    a["flags"][:, cols] = np.where(occ, 3, 0)
    a["weight"][:, cols] = np.where(
        occ, rng.uniform(0.002, 0.2, cols.size)[None, :], 0).astype(np.float32)
    jp, tp = _both(a)
    ref = _pool_pass_xla(jp, jcfg)[0]
    got = occupancy.pool_pass_plain(tp, tcfg)[0]
    np.testing.assert_array_equal(got["flags"].numpy(), np.asarray(ref.flags))
    np.testing.assert_array_equal(got["weight"].numpy(), np.asarray(ref.weight))


def test_occupancy_wrapper_takes_plain_on_cpu():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; the CUDA entry point refuses a CPU tensor."""
    jcfg, tcfg = _configs()
    _, tp = _both(_occupancy_pool(jcfg, 5))
    before = dict(kernels.LAUNCHES)
    got = occupancy.occupancy_pool_pass(tp, tcfg, with_moving=False)
    want = occupancy.pool_pass_plain(tp, tcfg, with_moving=False)
    assert torch.equal(got[0]["flags"], want[0]["flags"])
    assert got[5] is None
    assert kernels.LAUNCHES == before
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        occupancy.pool_pass_cuda(tp, tcfg)


def _sweep_pool(cfg, seed, sensor):
    rng = np.random.default_rng(seed)
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    half = np.asarray(cfg.half_extent, np.float32)
    a = {k: np.zeros((S, V), np.float32) for k in PLANES}
    a["flags"] = np.where(rng.random((S, V)) < 0.4,
                          rng.choice([1, 3], size=(S, V)), 0).astype(np.int32)
    for i, k in enumerate(("px", "py", "pz")):
        a[k] = (sensor[i] + rng.uniform(-1.2, 1.2, (S, V)) * half[i]).astype(
            np.float32)
    a["vx"] = rng.normal(0, 0.5, (S, V)).astype(np.float32)
    a["vy"] = np.where(rng.random((S, V)) < 0.5, rng.normal(0, 0.5, (S, V)),
                       0).astype(np.float32)
    return a


@pytest.mark.parametrize("sensor,yaw", [
    ((0.2, -0.1, 0.4), 0.5),
    ((-7.3, -4.1, -1.2), -0.2),  # negative window origin: floor-mod cells
    ((13.9, 2.6, 1.0), 2.9),
])
def test_sweep_plain_matches_reference(sensor, yaw):
    jcfg, tcfg = _configs()
    sensor = np.asarray(sensor, np.float32)
    quat = np.asarray([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], np.float32)
    origin = T.geometry.window_origin_np(sensor, tcfg)
    np.testing.assert_array_equal(
        origin, np.asarray(J.geometry.window_origin(jnp.asarray(sensor), jcfg)))
    jp, tp = _both(_sweep_pool(jcfg, 1, sensor))
    dt = np.float32(0.3)
    ref = jax_sweep(jp, jcfg, jnp.float32(dt), jnp.asarray(origin),
                    jnp.asarray(sensor), jnp.asarray(quat))
    got = sweep.sweep(tp, tcfg, dt, origin, sensor, quat)
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=name)
        else:
            frac = np.mean(a.astype(np.int64) != b.astype(np.int64))
            assert frac < 1e-3, (name, frac)
    assert got.fov.any() and got.mover.any() and got.moved_out.any()
    if sensor[0] < 0:
        assert (origin < 0).all()


def test_sweep_kernel_contract_under_limit_xy():
    """The CUDA sweep kernel does not read vz: under the limit-xy clamp
    (vz identically zero) the spec's ``pz`` does not advance and its
    ``moving`` bit reduces to ``vx != 0 | vy != 0``, which is what the
    kernel computes."""
    _, tcfg = _configs()
    sensor = np.asarray([0.3, 0.2, 0.5], np.float32)
    _, tp = _both(_sweep_pool(tcfg, 2, sensor))
    quat = np.asarray([1, 0, 0, 0], np.float32)
    origin = T.geometry.window_origin_np(sensor, tcfg)
    out = sweep.sweep_reference(tp, tcfg, 0.25, origin, sensor, quat)
    assert torch.equal(out.pz, tp.pz)
    valid = tp.flags != 0
    inside = valid & ~out.moved_out
    assert torch.equal(out.moving, inside & ((tp.vx != 0) | (tp.vy != 0)))


def _pair_inputs(seed=7):
    rng = np.random.default_rng(seed)
    n_pyr, s_t, ck = 56, 32, 288
    pos = rng.normal(0, 2, (n_pyr, s_t, 3)).astype(np.float32)
    w = (rng.random((n_pyr, s_t)) * (rng.random((n_pyr, s_t)) > 0.3)).astype(np.float32)
    pts = rng.normal(0, 2, (n_pyr, ck, 3)).astype(np.float32)
    pts[:, :s_t] = pos + rng.normal(0, 0.2, pos.shape).astype(np.float32)
    cinv = (rng.random((n_pyr, ck)) * (rng.random((n_pyr, ck)) > 0.5)).astype(np.float32)
    return pos, w, pts, cinv


def test_pair_passes_plain_match_xla():
    """K3's plain version is the XLA dense block: the same identity-form
    pair term and contraction.  The two f32 evaluations differ only by
    matmul summation order: within rtol 1e-4 / atol 1e-6 (the identity
    loses ~|a|^2 2^-24 in d2 at |a| ~ 40, i.e. a few 1e-5 relative in g)."""
    pos, w, pts, cinv = _pair_inputs()
    sigma = 0.1
    g = jax_pair_g(jnp.asarray(pos), jnp.asarray(pts), sigma)
    want1 = np.asarray(jnp.einsum("bsm,bs->bm", g, jnp.asarray(w)))
    want2 = np.asarray(jnp.einsum("bsm,bm->bs", g, jnp.asarray(cinv)))
    tp = [torch.from_numpy(x) for x in (pos, w, pts, cinv)]
    got1 = update.update_pass1(tp[0], tp[1], tp[2], sigma).numpy()
    got2 = update.update_pass2(tp[0], tp[3], tp[2], sigma).numpy()
    np.testing.assert_allclose(got1, want1, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got2, want2, rtol=1e-4, atol=1e-6)
    assert np.abs(want1).max() > 1e-2 and np.abs(want2).max() > 1e-2


def test_pair_passes_plain_in_float64_match_direct_form():
    """Evaluated in float64, the plain version equals the pair sums formed
    from coordinate differences (the kernel's form) to 1e-10: the float64
    plain version is the reference ``chip_smoke.py`` holds the kernel to."""
    pos, w, pts, cinv = (x.astype(np.float64) for x in _pair_inputs(3))
    sigma = 0.1
    c3 = (1.0 / math.sqrt(math.pi)) ** 3
    d2 = ((pos[:, :, None, :] - pts[:, None, :, :]) ** 2).sum(-1) / sigma ** 2
    g = c3 * np.exp(-0.5 * d2)
    tp = [torch.from_numpy(x) for x in (pos, w, pts, cinv)]
    got1 = update.update_pass1_plain(tp[0], tp[1], tp[2], sigma).numpy()
    got2 = update.update_pass2_plain(tp[0], tp[3], tp[2], sigma).numpy()
    np.testing.assert_allclose(got1, np.einsum("psm,ps->pm", g, w),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got2, np.einsum("psm,pm->ps", g, cinv),
                               rtol=1e-10, atol=1e-12)


def test_kernel_build_targets_hopper_only():
    """The library is built for sm_90a alone, every entry point is defined
    in a source, and the wrappers never read the JAX package's
    ``use_pallas_*`` flags."""
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert set(kernels.LAUNCHES) == {"occupancy_pool_pass", "sweep",
                                     "update_pass1", "update_pass2",
                                     "seg_scans", "to_flat", "from_flat",
                                     "jv_solve"}
    text = "".join((kernels.CSRC / name).read_text()
                   for name in kernels.SOURCES)
    for name in kernels.ENTRY_POINTS:
        assert f"DSPMAP_API int {name}(" in text, name
        assert name[len("dspmap_"):] in kernels.LAUNCHES
    import inspect
    for mod in (occupancy, sweep, update, compact, relayout, assignment):
        assert "use_pallas" not in inspect.getsource(mod)


def test_segscan_wrapper_takes_plain_on_cpu():
    """On CPU tensors ``seg_scans`` runs the plain version and launches
    nothing; the CUDA entry point refuses CPU tensors and a reach beyond
    the kernel's."""
    rng = np.random.default_rng(4)
    cols = [torch.from_numpy(rng.random(300).astype(np.float32))
            for _ in range(2)]
    key = np.repeat(np.arange(300), 3)[:300]
    st = torch.from_numpy(np.concatenate([[True], key[1:] != key[:-1]]))
    en = torch.from_numpy(np.concatenate([key[1:] != key[:-1], [True]]))
    before = dict(kernels.LAUNCHES)
    got = compact.seg_scans(cols, st, en, 4, 1)
    want = compact.seg_scans_plain(cols, st, en, 4, 1)
    assert got[0].shape == (2, 300) and got[1].shape == (1, 300)
    for g, w in zip([*got[0], *got[1]], want[0] + want[1]):
        assert torch.equal(g, w)
    hi, tot = got[0][0], got[1][0]  # runs of three rows
    assert torch.equal(tot.view(100, 3), hi[2::3, None].expand(100, 3))
    torch.testing.assert_close(hi[2::3], cols[0].view(100, 3).sum(1),
                               rtol=1e-6, atol=0)
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        compact.seg_scans_cuda(cols, st, en, 4, 1)
    with pytest.raises(ValueError):
        compact.seg_scans_cuda(cols, st, en, compact.KERNEL_MAX_REACH + 1, 0)
    assert kernels.LAUNCHES == before


def test_jv_dispatcher_takes_plain_on_cpu(monkeypatch):
    """On CPU tensors ``solve_assignment``'s JV is ``_jv_plain`` and never
    the kernel; ``jv_solve_cuda`` refuses a CPU, float64 or non-contiguous
    cost (and a cost past the kernel's width) without building or
    launching anything."""
    rng = np.random.default_rng(12)
    cost = torch.from_numpy(rng.integers(0, 4, (16, 16)).astype(np.float32))
    rv = torch.ones(16, dtype=torch.bool)
    cv = torch.ones(16, dtype=torch.bool)
    called = []
    plain = assignment._jv_plain

    def recorded(a, n_rows, R):
        called.append((tuple(a.shape), int(n_rows), R))
        return plain(a, n_rows, R)

    def refused(*args):
        raise AssertionError("the kernel was reached from a CPU tensor")

    built = []
    monkeypatch.setattr(assignment, "_jv_plain", recorded)
    monkeypatch.setattr(assignment, "jv_solve_cuda", refused)
    monkeypatch.setattr(kernels, "lib", lambda: built.append(1))
    before = dict(kernels.LAUNCHES)
    got = assignment.solve_assignment(cost, rv, cv)
    assert called == [((16, 16), 16, 16)]
    assert sorted(got.tolist()) == list(range(16))
    monkeypatch.undo()
    monkeypatch.setattr(kernels, "lib", lambda: built.append(1))
    a = torch.zeros((16, 16))
    n_rows = torch.tensor(16)
    for bad in (lambda: assignment.jv_solve_cuda(a, n_rows, 16),
                lambda: assignment.jv_solve_cuda(a.double(), n_rows, 16),
                lambda: assignment.jv_solve_cuda(a.t(), n_rows, 16),
                lambda: assignment.jv_solve_cuda(
                    torch.zeros((1024, 1024)), n_rows, 16)):
        with pytest.raises((RuntimeError, AssertionError, ValueError,
                            TypeError)):
            bad()
    assert not built and kernels.LAUNCHES == before
