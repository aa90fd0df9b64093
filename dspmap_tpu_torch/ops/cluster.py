"""Euclidean clustering as min-label propagation with pointer jumping
(mirrors ``dspmap_tpu/ops/cluster.py``).

Full width only: the JAX package's prefix-bucket ``lax.switch`` over the
realized point count compacts the problem without changing any label.
Its ``while_loop`` with early exit becomes a fixed number of sweeps: a
sweep is monotone and idempotent at convergence, so the labels are equal.

On the card the propagation is one launch of the ``euclidean_cluster``
kernel (``csrc/cluster.cu``) over a bit-packed adjacency, which stops
after a sweep that changes no label; on the CPU it is
:func:`euclidean_cluster_plain`.  Both take the Gram product from the same
``torch.matmul``, so the adjacency, and with it every label, is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .common import full_f32_matmul

#: the largest point count the kernel takes: a block holds two ints a
#: point in shared memory
KERNEL_MAX_P = 28672

#: by device index: ``[sweeps run, runs]`` (int32) of the kernel on that
#: card, summed there over every run since the first call
_COUNTERS: dict = {}


def euclidean_cluster(points: torch.Tensor, valid: torch.Tensor,
                      tolerance: float, iters: int = 16) -> torch.Tensor:
    """Connected components under ``dist <= tolerance``: each point's label
    is the smallest member index of its component; invalid points get the
    sentinel ``P``.  The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if points.device.type == "cpu":
        return euclidean_cluster_plain(points, valid, tolerance, iters)
    return euclidean_cluster_cuda(points, valid, tolerance, iters)


@full_f32_matmul()
def euclidean_cluster_plain(points: torch.Tensor, valid: torch.Tensor,
                            tolerance: float, iters: int = 16) -> torch.Tensor:
    """Plain version of :func:`euclidean_cluster`: ``iters`` sweeps over a
    ``[P, P]`` boolean adjacency."""
    n = points.shape[0]
    dev = points.device
    sq = (points * points).sum(-1)
    tol2 = float(np.float32(tolerance * tolerance))
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    labels = torch.where(valid, iota, n)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (points @ points.T)
    adj = (d2 <= tol2) & valid[:, None] & valid[None, :]
    sentinel = torch.full((1,), n, dtype=torch.int32, device=dev)
    for _ in range(iters):
        new = torch.where(adj, labels[None, :], n).amin(dim=1)
        new = torch.minimum(labels, new)
        ext = torch.cat([new, sentinel])
        labels = torch.minimum(new, ext[new.clamp(max=n).to(torch.int64)])
    return torch.where(valid, labels, n)


def _counter(device: torch.device) -> torch.Tensor:
    """The kernel's ``[sweeps run, runs]`` on ``device``, made at the first
    call there, which must not be inside a graph's capture: a counter
    made there would come from the graph's pool."""
    counter = _COUNTERS.get(device.index)
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the clustering kernel's first call on "
                               f"{device} is inside a CUDA graph's capture")
        counter = _COUNTERS[device.index] = torch.zeros(
            2, dtype=torch.int32, device=device)
    return counter


@full_f32_matmul()
def euclidean_cluster_cuda(points: torch.Tensor, valid: torch.Tensor,
                           tolerance: float, iters: int = 16) -> torch.Tensor:
    """:func:`euclidean_cluster_plain` as the Gram product and one launch of
    the ``euclidean_cluster`` kernel: ``points`` f32 ``[P, 3]`` and
    ``valid`` bool ``[P]`` on one card, ``1 <= P <= KERNEL_MAX_P``.  Returns
    the labels, int32 ``[P]``, bit for bit the plain version's.  ``points``
    only feeds PyTorch's products, so it may be strided."""
    n = points.shape[0]
    if points.dim() != 2 or points.shape[1] != 3 or valid.shape != (n,):
        raise ValueError(f"points {tuple(points.shape)} and valid "
                         f"{tuple(valid.shape)}, expected [P, 3] and [P]")
    if points.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"points {points.dtype} and valid {valid.dtype}, "
                        "expected float32 and bool")
    if not 1 <= n <= KERNEL_MAX_P or iters < 0:
        raise ValueError(f"P = {n}, iters = {iters}: the kernel takes "
                         f"1 <= P <= {KERNEL_MAX_P} and iters >= 0")
    kernels.check_cuda(valid)
    dev = points.device
    if dev != valid.device:
        raise ValueError(f"points on {dev}, valid on {valid.device}")
    counter = _counter(dev)
    sq = (points * points).sum(-1)
    gram = points @ points.T
    tol2 = float(np.float32(tolerance * tolerance))
    words = (n + 31) // 32
    bits = torch.empty(n * words, dtype=torch.int32, device=dev)
    minima = torch.empty(2 * n, dtype=torch.int32, device=dev)
    flags = torch.empty(iters + 1, dtype=torch.int32, device=dev)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    kernels.launch("euclidean_cluster",
                   (gram, sq, valid, bits, minima, flags, labels, counter),
                   fparams=(tol2,), iparams=(n, iters))
    return labels


def sweeps_run(device) -> tuple[int, int]:
    """``(sweeps, runs)``: the sweeps the kernel ran on ``device`` and its
    runs there, graph replays included, since the first call there (both 0
    before it).  Reads the card, so it waits for it: never on the hot
    path."""
    device = torch.device(device)
    counter = _COUNTERS.get(device.index if device.index is not None
                            else torch.cuda.current_device())
    if counter is None:
        return 0, 0
    sweeps, runs = counter.tolist()
    return sweeps, runs
