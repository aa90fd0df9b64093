"""The batched relayout (K5) and the pool pass fed flat working planes (CPU).

* ``to_flat_many`` / ``from_flat_many`` on CPU tensors (the plain versions):
  f32 and i32 planes mixed in one call, bit-equal to the one-plane plain
  versions and to ``dspmap_tpu.ops.pallas.relayout`` in interpret mode at
  the shapes of ``tests/test_torch_presets_relayout.py``; the working
  buffers of one call are ``[S*V + 1]`` each, apart and 16-byte strided;
* ``state.flatten_pool`` / ``unflatten_pool`` make one call for the planes
  over the size line;
* ``occupancy_and_resample`` fed flat working planes (which the pool pass
  reads as views) equals the same call fed ``[S, V]`` planes bit for bit,
  writes none of its inputs and returns planes of the exact size;
* the table of planes ``pool_pass_cuda`` hands the pool-pass kernel, and the
  per-device memory of ``kernels.check_cuda``.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu.ops.pallas import relayout as jax_relayout
from dspmap_tpu_torch import geometry, kernels, state as tstate
from dspmap_tpu_torch.ops import occupancy, relayout
from dspmap_tpu_torch.ops.common import padded_buffer

torch.set_num_threads(2)

PLANES = ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")


def _bits(x):
    return x.view(torch.int32)


def _mixed_planes(S, V, n, seed):
    """n planes [S, V] of random bits: every third one i32, the rest f32
    (finite: NaN payloads do not survive ``jnp.asarray``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 3 == 0:
            out.append(torch.from_numpy(rng.integers(
                -2**31, 2**31 - 1, (S, V)).astype(np.int32)))
        else:
            out.append(torch.from_numpy(
                (rng.normal(size=(S, V)) * 1000).astype(np.float32)))
    return out


@pytest.mark.parametrize("S,V", [(18, 2048), (10, 1024), (60, 3072)])
def test_many_plain_matches_one_plane_and_pallas(S, V):
    planes = _mixed_planes(S, V, 4, seed=S)
    keep = [x.clone() for x in planes]
    n0 = dict(kernels.LAUNCHES)
    flats = relayout.to_flat_many(planes)
    backs = relayout.from_flat_many(flats, S, V)
    assert kernels.LAUNCHES == n0  # CPU tensors launch nothing
    for src, k, flat, back in zip(planes, keep, flats, backs):
        one = relayout.to_flat_plain(src)
        assert flat.dtype == src.dtype and flat.shape == (S * V,)
        assert torch.equal(_bits(flat), _bits(one))
        want_flat = np.asarray(jax_relayout.to_flat(jnp.asarray(src.numpy()),
                                                    interpret=True))
        np.testing.assert_array_equal(flat.numpy(), want_flat)
        assert torch.equal(_bits(back),
                           _bits(relayout.from_flat_plain(one, S, V)))
        want_back = np.asarray(jax_relayout.from_flat(
            jnp.asarray(want_flat), S, V, interpret=True))
        np.testing.assert_array_equal(back.numpy(), want_back)
        assert torch.equal(_bits(src), _bits(k))  # the source is untouched
        assert back.untyped_storage().nbytes() == S * V * 4
        assert padded_buffer(back) is None
        assert back.data_ptr() != flat.data_ptr()


@pytest.mark.parametrize("n", [1, 7, 9])
def test_working_buffers_of_one_call_are_apart(n):
    """Each buffer is ``[S*V + 1]`` in its plane's dtype, the flat plane its
    prefix; the buffers are ``S*V + 4`` words apart (16-byte strided), so a
    scatter's sentinel word never lands in another plane."""
    S, V = 3, 1024
    planes = _mixed_planes(S, V, n, seed=n)
    flats = relayout.to_flat_many(planes)
    bufs = [padded_buffer(f) for f in flats]
    for src, flat, buf in zip(planes, flats, bufs):
        assert buf.shape == (S * V + 1,) and buf.dtype == src.dtype
        assert buf.data_ptr() == flat.data_ptr()
    starts = [b.data_ptr() for b in bufs]
    assert [b - a for a, b in zip(starts, starts[1:])] == [
        4 * (S * V + 4)] * (n - 1)
    for i, buf in enumerate(bufs):  # writing one sentinel touches no plane
        buf[-1] = 7
    for src, flat in zip(planes, flats):
        assert torch.equal(_bits(flat), _bits(src).reshape(-1))
    # the one-plane entry points are the one-plane case
    one = relayout.to_flat(planes[0])
    assert torch.equal(_bits(one), _bits(flats[0]))
    assert torch.equal(_bits(relayout.from_flat(one, S, V)), _bits(planes[0]))


def test_many_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 1024))
    with pytest.raises(ValueError):
        relayout.to_flat_many([x] * (relayout.MAX_PLANES + 1))
    with pytest.raises(ValueError):
        relayout.to_flat_many([x, torch.zeros((4, 1024))])
    with pytest.raises(TypeError):
        relayout.to_flat_many([x, x.double()])
    with pytest.raises(ValueError):
        relayout.from_flat_many([torch.zeros(2 * 1024), torch.zeros(1024)],
                                2, 1024)
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        relayout.to_flat_many_cuda([x])
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        relayout.from_flat_many_cuda([x.reshape(-1)], 2, 1024)


def _count_calls(monkeypatch):
    calls = {"to_flat_many": [], "from_flat_many": []}  # planes of each call

    def counted(name):
        orig = getattr(relayout, name)

        def fn(planes, *a):
            calls[name].append(len(planes))
            return orig(planes, *a)
        return fn

    for name in calls:
        monkeypatch.setattr(relayout, name, counted(name))
    return calls


def test_flatten_pool_makes_one_call_for_the_large_planes(monkeypatch):
    cfg = T.dsp_static(nx=16, ny=16, nz=8, max_input_points=128)
    p = T.init_state(cfg, device="cpu").particles
    S, V = p.flags.shape
    calls = _count_calls(monkeypatch)
    flat = tstate.flatten_pool(p, skip=("t",))
    assert calls == {"to_flat_many": [], "from_flat_many": []}  # views
    assert all(padded_buffer(getattr(flat, n)) is None for n in PLANES)
    monkeypatch.setattr(tstate, "_DMA_RELAYOUT_BYTES", 0)
    flat = tstate.flatten_pool(p, skip=("t",))
    assert calls == {"to_flat_many": [8], "from_flat_many": []}
    assert flat.t is p.t
    assert all(padded_buffer(getattr(flat, n)) is not None
               for n in PLANES if n != "t")
    back = tstate.unflatten_pool(flat, S, views=("flags", "weight"))
    assert calls == {"to_flat_many": [8], "from_flat_many": [6]}
    assert back.flags.data_ptr() == flat.flags.data_ptr()
    assert back.weight.data_ptr() == flat.weight.data_ptr()
    assert padded_buffer(back.flags) is None
    for n in ("px", "py", "pz", "vx", "vy", "vz"):
        plane = getattr(back, n)
        assert plane.shape == (S, V)
        assert plane.untyped_storage().nbytes() == S * V * 4
    assert tstate.unflatten_pool(back, S) is back  # already 2-D


def _random_pool(cfg, seed):
    rng = np.random.default_rng(seed)
    S, V = cfg.slots_per_voxel, cfg.storage_voxels
    flags = np.where(rng.random((S, V)) < 0.5,
                     rng.choice([1, 1, 3], size=(S, V)), 0).astype(np.int32)
    half = np.asarray(cfg.half_extent, np.float32)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    n_vel = occupancy._n_vel(cfg)
    mv = rng.random((S, V)) < 0.3
    vel = [np.where(mv, rng.normal(0, 1, (S, V)), 0) if k < n_vel
           else np.zeros((S, V)) for k in range(3)]
    return T.Particles(
        flags=torch.from_numpy(flags),
        px=f(rng.uniform(-half[0], half[0], (S, V))),
        py=f(rng.uniform(-half[1], half[1], (S, V))),
        pz=f(rng.uniform(0, 2 * half[2], (S, V))),
        vx=f(vel[0]), vy=f(vel[1]), vz=f(vel[2]),
        weight=f(np.where(flags != 0, rng.uniform(0.0005, 1, (S, V)), 0)),
        t=f(rng.uniform(0, 5, (S, V))))


ARMS = {
    "limit_xy": lambda kw: T.example_node_settings(T.dsp_dynamic(**kw)),
    "static": lambda kw: T.example_node_settings(T.dsp_static(**kw)),
    "particle_time": lambda kw: T.example_node_settings(
        T.dsp_dynamic(record_particle_time=True, **kw)),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_occupancy_and_resample_reads_flat_working_planes(arm, monkeypatch):
    """With every plane over the size line: the planes the pool pass
    rewrites reach it as views of the working buffers, only the planes it
    hands through (vz; all three velocities in the static model) are copied
    out, in one call.  Result, counters and future grid equal the call fed
    ``[S, V]`` planes; no input is written; every returned plane that went
    through the flat phase has a storage of exactly S*V*4 bytes."""
    cfg = ARMS[arm](dict(nx=16, ny=16, nz=8, voxel_resolution=0.25,
                         max_input_points=128, pyramid_slot_capacity=96))
    p = _random_pool(cfg, seed=3)
    S, V = p.flags.shape
    rng = np.random.default_rng(4)
    live = np.flatnonzero(p.flags.numpy().reshape(-1))
    fm = (torch.from_numpy(rng.choice(live, 256).astype(np.int32)),
          torch.from_numpy(rng.random(256) < 0.8), torch.tensor(3))
    origin = geometry.window_origin_np(np.zeros(3, np.float32), cfg)
    future_in = torch.from_numpy(rng.random((cfg.n_horizons, V)).astype(
        np.float32))
    want = occupancy.occupancy_and_resample(p, cfg, origin, future_in, fm)

    monkeypatch.setattr(tstate, "_DMA_RELAYOUT_BYTES", 0)
    calls = _count_calls(monkeypatch)
    zero = tuple(n for n in ("vx", "vy", "vz")
                 if n not in occupancy.rewritten_planes(cfg))
    skip = zero + (() if cfg.record_particle_time else ("t",))
    flat = tstate.flatten_pool(p, skip=skip)
    flat = dataclasses.replace(flat, **{
        n: relayout.zeros_flat(S * V, torch.float32, "cpu") for n in zero})
    n_in = 9 - len(skip)
    assert calls == {"to_flat_many": [n_in], "from_flat_many": []}
    held = {n: getattr(flat, n) for n in PLANES}
    snapshot = {n: padded_buffer(x).clone() for n, x in held.items()
                if n not in skip or n in zero}
    got = occupancy.occupancy_and_resample(flat, cfg, origin, future_in, fm)
    assert calls == {"to_flat_many": [n_in], "from_flat_many": [len(zero)]}

    for n in PLANES:
        a, b = getattr(got[0], n), getattr(want[0], n)
        assert a.shape == (S, V) and torch.equal(a, b), n
        if n in snapshot:  # no input written, no working buffer returned
            assert torch.equal(_bits(padded_buffer(held[n])),
                               _bits(snapshot[n])), n
            assert a.untyped_storage().nbytes() == S * V * 4, n
            assert a.data_ptr() != held[n].data_ptr(), n
        assert torch.equal(getattr(p, n), getattr(_random_pool(cfg, 3), n)), n
    for a, b in zip(got[1:4], want[1:4]):
        assert torch.equal(a, b)
    assert got[4].keys() == want[4].keys()
    for k, v in want[4].items():
        assert torch.equal(got[4][k], v), k
    assert int(want[4]["resample_copies"]) > 0
    assert int(want[4]["future_moving"]) > 0 or arm == "static"


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_pool_pass_wrapper_hands_the_kernel_its_table(arm, monkeypatch):
    """What ``pool_pass_cuda`` gives ``csrc/occupancy.cu``: the planes the
    pool pass rewrites, in staging order, then as many fresh output planes,
    the moving mask, eight per-voxel vectors and three velocity sums (null
    beyond the carried ones); six integers and the cull threshold.  No tile
    width and no thread count: the kernel derives both from the depth."""
    cfg = ARMS[arm](dict(nx=16, ny=16, nz=8, voxel_resolution=0.25,
                         max_input_points=128, pyramid_slot_capacity=96))
    p = _random_pool(cfg, seed=1)
    S, V = p.flags.shape
    seen = {}
    monkeypatch.setattr(kernels, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(kernels, "launch",
                        lambda *a: seen.update(zip(("name", "p", "f", "i"), a)))
    out = occupancy.pool_pass_cuda(p, cfg, with_moving=True)
    names = occupancy.rewritten_planes(cfg)
    n, n_vel = len(names), occupancy._n_vel(cfg)
    assert seen["name"] == "occupancy_pool_pass"
    assert seen["f"] == (cfg.weight_cull_threshold,)
    assert seen["i"] == (S, V, n_vel, n, cfg.resample_min_count,
                         cfg.max_particles_per_voxel)
    ptrs = seen["p"]
    assert len(ptrs) == 2 * n + 1 + 8 + 3
    for k, name in enumerate(names):
        assert ptrs[k] is getattr(p, name), name
        assert ptrs[n + k] is out[0][name], name
        assert out[0][name].shape == (S, V)
        assert out[0][name].dtype == getattr(p, name).dtype
    assert ptrs[2 * n] is out[5] and out[5].dtype == torch.bool
    assert ptrs[2 * n + 1] is out[1]  # weight_sum, an allocation of its own
    assert out[1].untyped_storage().nbytes() == V * 4
    assert all(x.shape == (V,) for x in ptrs[2 * n + 1:2 * n + 9 + n_vel])
    assert ptrs[2 * n + 9 + n_vel:] == [None] * (3 - n_vel)
    for name in ("vx", "vy", "vz", "t"):  # handed through, not copied
        if name not in names:
            assert out[0][name] is getattr(p, name), name


def test_check_cuda_asks_the_card_once_a_device(monkeypatch):
    asked = []
    monkeypatch.setattr(kernels, "_capability", {})
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev: asked.append(dev.index) or (9, 0))

    def fake(index, contiguous=True, shape=(4,)):
        dev = types.SimpleNamespace(index=index)
        return types.SimpleNamespace(device=dev, shape=shape,
                                     is_contiguous=lambda: contiguous), dev

    x0, d0 = fake(0)
    x1, _ = fake(1)
    for _ in range(3):
        kernels.check_cuda(x0)
        kernels.check_cuda(x1)
    assert asked == [0, 1]
    y0 = types.SimpleNamespace(device=d0, shape=(4,),
                               is_contiguous=lambda: False)
    with pytest.raises(ValueError):
        kernels.check_cuda(x0, y0)
    with pytest.raises(ValueError):
        kernels.check_cuda(x0, shape=(5,))
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev: (8, 0))
    monkeypatch.setattr(kernels, "_capability", {})
    with pytest.raises(RuntimeError):
        kernels.check_cuda(x0)
