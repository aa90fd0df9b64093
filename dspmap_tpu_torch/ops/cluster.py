"""Euclidean clustering as min-label propagation with pointer jumping
(mirrors ``dspmap_tpu/ops/cluster.py``).

Full width only: the JAX package's prefix-bucket ``lax.switch`` over the
realized point count compacts the problem without changing any label.
Its ``while_loop`` with early exit becomes a fixed number of sweeps: a
sweep is monotone and idempotent at convergence, so the labels are equal.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import full_f32_matmul


@full_f32_matmul()
def euclidean_cluster(points: torch.Tensor, valid: torch.Tensor,
                      tolerance: float, iters: int = 16) -> torch.Tensor:
    """Connected components under ``dist <= tolerance``: each point's label
    is the smallest member index of its component; invalid points get the
    sentinel ``P``."""
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
