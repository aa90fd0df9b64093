"""Relayout between a pool plane ``[S, V]`` and its flat working form
(mirrors ``dspmap_tpu/ops/pallas/relayout.py``: ``to_flat`` / ``from_flat``).

Both directions are an exact copy of ``S*V`` 4-byte words: kernel K5
(``csrc/relayout.cu``) on CUDA tensors, :func:`to_flat_plain` /
:func:`from_flat_plain` on the CPU.

``to_flat`` copies the plane into the first ``S*V`` words of a buffer of
``S*V + 1`` words that belongs to the step (the last word is the drop
sentinel of the pool scatters) and returns the ``[S*V]`` prefix view of it,
marked as a working plane (``ops.common.working_plane``): ``pool_put``
scatters into such a plane in place, where it would otherwise copy the
whole plane into a padded buffer first.  The step never writes its input
state, and this one copy per plane is what keeps that true through the
flat phase.  ``from_flat`` returns a fresh plane of the exact size, so the
returned state keeps no padded buffer alive.

``state.ravel_plane`` / ``state.unravel_plane`` send planes of 16 MiB or
more with ``V % 1024 == 0`` here; smaller planes change form as views.
"""

from __future__ import annotations

import torch

from .. import kernels
from .common import working_plane


def _check(x: torch.Tensor, rows: int, cols: int) -> None:
    if x.element_size() != 4:
        raise TypeError(f"relayout copies 4-byte words, got {x.dtype}")
    if cols % 1024 != 0:
        raise ValueError(f"relayout needs V % 1024 == 0, got V={cols}")
    if x.numel() != rows * cols:
        raise ValueError(f"plane of {x.numel()} words, expected {rows}x{cols}")


def zeros_flat(n: int, dtype, device) -> torch.Tensor:
    """An all-zero flat working plane ``[n]`` (no copy kernel: the step
    makes its constant-zero velocity planes anew in this form)."""
    return working_plane(torch.zeros(n + 1, dtype=dtype, device=device))


def to_flat_plain(plane: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``to_flat``."""
    S, V = plane.shape
    _check(plane, S, V)
    buf = torch.empty(S * V + 1, dtype=plane.dtype, device=plane.device)
    buf[:S * V] = plane.reshape(-1)
    return working_plane(buf)


def from_flat_plain(flat: torch.Tensor, S: int, V: int) -> torch.Tensor:
    """Plain PyTorch ``from_flat``."""
    _check(flat, S, V)
    return flat.view(S, V).clone()


def to_flat_cuda(plane: torch.Tensor) -> torch.Tensor:
    """Kernel K5a: ``[S, V]`` -> flat working plane ``[S*V]``."""
    S, V = plane.shape
    _check(plane, S, V)
    kernels.check_cuda(plane)
    buf = torch.empty(S * V + 1, dtype=plane.dtype, device=plane.device)
    if plane.data_ptr() % 16 or buf.data_ptr() % 16:
        raise ValueError("relayout needs 16-byte aligned planes")
    kernels.launch("to_flat", [plane, buf], (), (S, V))
    return working_plane(buf)


def from_flat_cuda(flat: torch.Tensor, S: int, V: int) -> torch.Tensor:
    """Kernel K5b: flat ``[S*V]`` -> a fresh plane ``[S, V]``."""
    _check(flat, S, V)
    if flat.dim() != 1:
        raise ValueError(f"flat plane of shape {tuple(flat.shape)}")
    kernels.check_cuda(flat)
    out = torch.empty((S, V), dtype=flat.dtype, device=flat.device)
    if flat.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("relayout needs 16-byte aligned planes")
    kernels.launch("from_flat", [flat, out], (), (S, V))
    return out


def to_flat(plane: torch.Tensor) -> torch.Tensor:
    """Plain version for a CPU tensor, kernel K5a for a CUDA tensor."""
    if plane.is_cuda:
        return to_flat_cuda(plane)
    return to_flat_plain(plane)


def from_flat(flat: torch.Tensor, S: int, V: int) -> torch.Tensor:
    """Plain version for a CPU tensor, kernel K5b for a CUDA tensor."""
    if flat.is_cuda:
        return from_flat_cuda(flat, S, V)
    return from_flat_plain(flat, S, V)
