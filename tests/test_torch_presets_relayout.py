"""The relayout kernels' plain versions (K5) and the multi-neighbor step with
busy spill tiers, against the JAX package (CPU).

* ``to_flat`` / ``from_flat`` on CPU tensors against
  ``dspmap_tpu.ops.pallas.relayout`` in interpret mode at the shapes of
  ``tests/test_pallas.py`` ((18, 2048), (10, 1024), (60, 3072)), f32 and
  i32: exact;
* ``state.ravel_plane`` / ``unravel_plane`` follow the JAX package's size
  line (16 MiB, V % 1024 == 0);
* the multi-neighbor step of ``tests/test_torch_presets_multi.py`` with
  both dense tiers cut to 2, teacher-forced with the newborn weight pinned:
  the particle and the observation spill tiers carry data there (the
  preset's tiers stay nearly empty at this map size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu as J
import dspmap_tpu_torch as T
from dspmap_tpu.ops.pallas import relayout as jax_relayout
from dspmap_tpu_torch import kernels, state as tstate
from dspmap_tpu_torch.ops import relayout
from dspmap_tpu_torch.ops.common import padded_buffer
from torch_parity import preset_configs, record, teacher_forced

torch.set_num_threads(2)

SMALL = dict(nx=16, ny=16, nz=8, max_input_points=128, mover_capacity=1024,
             max_clusters=4)
N_FRAMES = 8


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ K5


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("S,V", [(18, 2048), (10, 1024), (60, 3072)])
def test_relayout_plain_matches_pallas_interpret(S, V, dtype):
    """``to_flat`` / ``from_flat`` on CPU tensors (the plain versions)
    against the Pallas kernels in interpret mode at the shapes of
    ``tests/test_pallas.py``: exact, the source untouched, the flat plane a
    working plane of S*V + 1 words, the restored plane a fresh tensor."""
    rng = np.random.default_rng(S)
    plane = (rng.normal(size=(S, V)) * 1000).astype(dtype)
    want_flat = np.asarray(jax_relayout.to_flat(jnp.asarray(plane),
                                                interpret=True))
    want_back = np.asarray(jax_relayout.from_flat(jnp.asarray(want_flat), S, V,
                                                  interpret=True))
    src = torch.from_numpy(plane.copy())
    n0 = dict(kernels.LAUNCHES)
    flat = relayout.to_flat(src)
    assert flat.dtype == src.dtype and flat.shape == (S * V,)
    np.testing.assert_array_equal(_n(flat), want_flat)
    buf = padded_buffer(flat)
    assert buf.shape == (S * V + 1,) and buf.data_ptr() == flat.data_ptr()
    back = relayout.from_flat(flat, S, V)
    np.testing.assert_array_equal(_n(back), want_back)
    np.testing.assert_array_equal(_n(src), plane)
    assert back.data_ptr() != flat.data_ptr() and padded_buffer(back) is None
    assert back.untyped_storage().nbytes() == S * V * 4
    assert kernels.LAUNCHES == n0  # CPU tensors launch nothing


def test_relayout_dispatch_follows_the_size_line(monkeypatch):
    """``ravel_plane`` copies planes of ``_DMA_RELAYOUT_BYTES`` or more with
    V % 1024 == 0 into a working plane and views every other plane; the
    CUDA wrappers refuse CPU tensors, other word sizes and ragged widths."""
    x = torch.arange(4 * 2048, dtype=torch.float32).view(4, 2048)
    assert tstate._DMA_RELAYOUT_BYTES == 16 << 20
    small = tstate.ravel_plane(x)
    assert padded_buffer(small) is None and small.data_ptr() == x.data_ptr()
    assert tstate.unravel_plane(small, 4).data_ptr() == x.data_ptr()
    monkeypatch.setattr(tstate, "_DMA_RELAYOUT_BYTES", 4 * 2048 * 4)
    big = tstate.ravel_plane(x)
    assert padded_buffer(big) is not None and big.data_ptr() != x.data_ptr()
    assert torch.equal(tstate.unravel_plane(big, 4), x)
    ragged = torch.zeros((4, 2049))
    assert padded_buffer(tstate.ravel_plane(ragged)) is None
    with pytest.raises(ValueError):
        relayout.to_flat(ragged)
    with pytest.raises(TypeError):
        relayout.to_flat(x.double())
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        relayout.to_flat_cuda(x)
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        relayout.from_flat_cuda(big, 4, 2048)
    with pytest.raises(ValueError):
        tstate.flatten_pool(T.init_state(T.dsp_static(**SMALL), device="cpu"
                                         ).particles, skip=("flags",))


# ------------------------------------------- busy spill tiers


def test_multi_step_with_busy_spill_tiers_matches_jax(monkeypatch):
    """Dense tiers of 2: most in-FOV particles and observation points take
    the spill tiers, so the dense x spill, spill x dense and spill x spill
    blocks of the update all carry data (the observation spill even
    overflows its 64 cells, which both packages count alike)."""
    jcfg, tcfg = preset_configs("multi", pyramid_dense_slots=2,
                                obs_dense_points=2)
    frames, _ = record(jcfg, jax.jit(J.make_step(jcfg)),
                       J.init_state(jcfg, jax.random.key(0)),
                       n_frames=N_FRAMES)
    assert tcfg.dense_slots == 2 and tcfg.obs_dense == 2
    fracs = teacher_forced(frames[2:], tcfg, monkeypatch, pinned=True)
    assert np.mean(fracs) >= 0.999, fracs
    last = frames[-1]["metrics"]
    assert int(last["obs_spill_overflow"]) > 0
    assert int(last["updated_particles"]) > 100
