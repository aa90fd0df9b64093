"""Relayout between pool planes ``[S, V]`` and their flat working form
(mirrors ``dspmap_tpu/ops/pallas/relayout.py``: ``to_flat`` / ``from_flat``).

Both directions are an exact copy of ``S*V`` 4-byte words a plane: kernel K5
(``csrc/relayout.cu``) on CUDA tensors, the plain versions on the CPU.  One
call -- one kernel launch -- takes all the planes of a frame
(:func:`to_flat_many`, :func:`from_flat_many`; f32 and i32 planes of one
shape mixed); :func:`to_flat` and :func:`from_flat` are the one-plane case.

``to_flat_many`` copies each plane into the first ``S*V`` words of a buffer
of ``S*V + 1`` words that belongs to the step (the last word is the drop
sentinel of the pool scatters) and returns the ``[S*V]`` prefix views,
marked as working planes (``ops.common.working_plane``): ``pool_put``
scatters into such a plane in place, where it would otherwise copy the
whole plane into a padded buffer first.  The buffers of one call are cut
from one allocation, ``S*V + 4`` words apart so that each starts on a
16-byte boundary.  The step never writes its input state, and this one
copy per plane is what keeps that true through the flat phase.
``from_flat_many`` returns fresh planes, each its own allocation of the
exact size, so a returned state keeps no larger buffer alive.

``state.flatten_pool`` / ``state.unflatten_pool`` send planes of 16 MiB or
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


#: planes one launch takes (the kernel's table of pairs, ``kMaxCopies``)
MAX_PLANES = 9


def _check_many(xs, rows: int, cols: int) -> None:
    if not 1 <= len(xs) <= MAX_PLANES:
        raise ValueError(f"relayout takes 1..{MAX_PLANES} planes a call, "
                         f"got {len(xs)}")
    for x in xs:
        _check(x, rows, cols)


def _working_planes(planes, block=None) -> list:
    """One flat working plane ``[S*V]`` a plane (contents undefined), in the
    plane's dtype, over padded buffers ``[S*V + 1]`` cut from one allocation
    (``block``, i32 words) at a stride of ``S*V + 4`` words."""
    k, n = len(planes), planes[0].numel()
    stride = n + 4
    if block is None:
        block = torch.empty(k * stride, dtype=torch.int32,
                            device=planes[0].device)
    typed = {dtype: block.view(dtype) for dtype in {p.dtype for p in planes}}
    out = []
    for i, p in enumerate(planes):
        buf = typed[p.dtype][i * stride:i * stride + n + 1]
        out.append(working_plane(buf, buf[:n]))
    return out


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


def to_flat_many_plain(planes) -> list:
    """Plain PyTorch ``to_flat_many``."""
    S, V = planes[0].shape
    _check_many(planes, S, V)
    flats = _working_planes(planes)
    for flat, plane in zip(flats, planes):
        flat.copy_(plane.reshape(-1))
    return flats


def from_flat_many_plain(flats, S: int, V: int) -> list:
    """Plain PyTorch ``from_flat_many``."""
    _check_many(flats, S, V)
    return [flat.view(S, V).clone() for flat in flats]


def _launch(name: str, srcs, dst_ptrs, S: int, V: int) -> None:
    kernels.check_cuda(*srcs)
    ptrs = []
    for x, dst in zip(srcs, dst_ptrs):
        ptrs += (x.data_ptr(), dst)
    if any(q % 16 for q in ptrs):
        raise ValueError("relayout needs 16-byte aligned planes")
    kernels.launch(name, ptrs, (), (S, V, len(srcs)))


def to_flat_many_cuda(planes) -> list:
    """Kernel K5a: planes ``[S, V]`` -> flat working planes ``[S*V]``, one
    launch."""
    S, V = planes[0].shape
    _check_many(planes, S, V)
    if any(p.shape != planes[0].shape for p in planes):
        raise ValueError("relayout takes planes of one shape a call")
    # one allocation, launched on before it is cut into the planes' buffers
    stride = S * V + 4
    block = torch.empty(len(planes) * stride, dtype=torch.int32,
                        device=planes[0].device)
    base = block.data_ptr()
    _launch("to_flat", planes, [base + 4 * i * stride
                                for i in range(len(planes))], S, V)
    return _working_planes(planes, block)


def from_flat_many_cuda(flats, S: int, V: int) -> list:
    """Kernel K5b: flat planes ``[S*V]`` -> fresh planes ``[S, V]``, one
    launch."""
    _check_many(flats, S, V)
    if any(f.dim() != 1 for f in flats):
        raise ValueError("flat planes are 1-D")
    outs = [torch.empty((S, V), dtype=f.dtype, device=f.device) for f in flats]
    _launch("from_flat", flats, [x.data_ptr() for x in outs], S, V)
    return outs


def to_flat_many(planes) -> list:
    """Plain version for CPU tensors, kernel K5a for CUDA tensors."""
    if planes[0].is_cuda:
        return to_flat_many_cuda(planes)
    return to_flat_many_plain(planes)


def from_flat_many(flats, S: int, V: int) -> list:
    """Plain version for CPU tensors, kernel K5b for CUDA tensors."""
    if flats[0].is_cuda:
        return from_flat_many_cuda(flats, S, V)
    return from_flat_many_plain(flats, S, V)


def to_flat_cuda(plane: torch.Tensor) -> torch.Tensor:
    """Kernel K5a on one plane."""
    return to_flat_many_cuda([plane])[0]


def from_flat_cuda(flat: torch.Tensor, S: int, V: int) -> torch.Tensor:
    """Kernel K5b on one plane."""
    return from_flat_many_cuda([flat], S, V)[0]


def to_flat(plane: torch.Tensor) -> torch.Tensor:
    """``to_flat_many`` of one plane."""
    return to_flat_many([plane])[0]


def from_flat(flat: torch.Tensor, S: int, V: int) -> torch.Tensor:
    """``from_flat_many`` of one plane."""
    return from_flat_many([flat], S, V)[0]
