"""Exact linear assignment (mirrors ``dspmap_tpu/ops/assignment.py``):
Jonker-Volgenant shortest augmenting paths plus the exhaustive 8x8 path.

Both paths run and a mask picks the result (the JAX package's
``lax.cond``), so the solve needs no host decision.  On the card the JV
solve is one launch of the ``jv_solve`` kernel (``csrc/assignment.cu``:
one warp for ``N <= WARP_MAX_N``, one block of a thread a column above);
on the CPU it is :func:`_jv_plain`, which runs a fixed number of masked
steps: row ``i`` (1-based) finds its augmenting path within ``i`` steps --
each step visits one of the ``i - 1`` columns already matched or ends on a
free one -- and unwinds it within ``i`` steps, so the result equals the
``while_loop`` form.  The kernel ends each loop where the ``while_loop``
does and gives the plain version's bits.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from .. import kernels
from .common import full_f32_matmul

INF = 1.0e12
_BRUTE_N = 8
#: the largest square cost the kernel takes: one thread a column and one
#: for the virtual column 0 in a block of at most 1,024 threads
KERNEL_MAX_N = 1023
#: the largest square cost the kernel's warp arm takes: a lane a column
#: and lane 0 for the virtual column 0 (every preset's ``max_clusters`` is
#: 16); larger costs take the block arm
WARP_MAX_N = 31


@functools.lru_cache(maxsize=None)
def _perm_tables_np():
    perms = np.array(list(itertools.permutations(range(_BRUTE_N))), np.int32)
    n = perms.shape[0]
    onehot = np.zeros((n, _BRUTE_N * _BRUTE_N), np.float32)
    rows = np.repeat(np.arange(n), _BRUTE_N)
    cols = (np.arange(_BRUTE_N)[None, :] * _BRUTE_N + perms).ravel()
    onehot[rows, cols] = 1.0
    return perms, onehot


@functools.lru_cache(maxsize=None)
def _perm_tables(device: torch.device):
    """The 8! permutations and their one-hot cost selectors on ``device``
    (10 MB, copied once per device)."""
    perms, onehot = _perm_tables_np()
    return torch.from_numpy(perms).to(device), torch.from_numpy(onehot).to(device)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor ``i`` without a host sync (indexing
    with a 0-d tensor reads it on the host)."""
    return x.index_select(0, i.reshape(1))[0]


def _jv_plain(a: torch.Tensor, n_rows: torch.Tensor, R: int) -> torch.Tensor:
    """JV over the square cost ``a [N, N]``, augmenting rows ``1..n_rows``.
    Returns ``p [N+1]``: the (1-based) row owning each column."""
    N = a.shape[0]
    dev = a.device
    iota1 = torch.arange(N + 1, dtype=torch.int64, device=dev)
    u = torch.zeros(N + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(N + 1, dtype=torch.float32, device=dev)
    p = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(1, R + 1):
        row_on = n_rows >= i
        p_row = torch.where(iota1 == 0, i, p)
        m_abs = torch.full((N,), INF, dtype=torch.float32, device=dev)
        way = torch.zeros(N, dtype=torch.int64, device=dev)
        used = torch.zeros(N + 1, dtype=torch.bool, device=dev)
        d_use = torch.zeros(N + 1, dtype=torch.float32, device=dev)
        j0 = zero
        d_now = torch.zeros((), dtype=torch.float32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(i):
            go = ~done
            used_n = used | (iota1 == j0)
            d_use_n = torch.where(iota1 == j0, d_now, d_use)
            i0 = _at(p_row, j0)
            # i0 = 0 only on finished (masked) steps; wrap like a[-1]
            cand = (_at(a, torch.remainder(i0 - 1, N)) - _at(u, i0) - v[1:]
                    + d_now)
            better = (~used_n[1:]) & (cand < m_abs)
            m_abs_n = torch.where(better, cand, m_abs)
            way_n = torch.where(better, j0, way)
            masked = torch.where(used_n[1:], INF, m_abs_n)
            j1 = torch.argmin(masked) + 1
            d_next = _at(masked, j1 - 1)
            m_abs = torch.where(go, m_abs_n, m_abs)
            way = torch.where(go, way_n, way)
            used = torch.where(go, used_n, used)
            d_use = torch.where(go, d_use_n, d_use)
            done = done | (go & (_at(p_row, j1) == 0))
            j0 = torch.where(go, j1, j0)
            d_now = torch.where(go, d_next, d_now)
        amt = torch.where(used, d_now - d_use, 0.0)
        u_row = u.index_add(0, p_row, amt)
        v_row = v - amt
        way_full = torch.cat([zero[None], way])
        for _ in range(i):
            on = j0 != 0
            j1 = _at(way_full, j0)
            p_row = torch.where(on & (iota1 == j0), _at(p_row, j1), p_row)
            j0 = torch.where(on, j1, j0)
        u = torch.where(row_on, u_row, u)
        v = torch.where(row_on, v_row, v)
        p = torch.where(row_on, p_row, p)
    return p


def jv_solve_cuda(a: torch.Tensor, n_rows: torch.Tensor, R: int) -> torch.Tensor:
    """:func:`_jv_plain` as one launch of the ``jv_solve`` kernel: ``a``
    contiguous f32 ``[N, N]`` with ``N <= KERNEL_MAX_N``, ``n_rows`` a 0-d
    int64 tensor on the same card (read by the kernel), ``R <= N`` a host
    int.  Returns ``p [N+1]`` int64, bit for bit the plain version's."""
    N = a.shape[0]
    if a.dim() != 2 or a.shape[1] != N:
        raise ValueError(f"cost of shape {tuple(a.shape)}, expected square")
    if a.dtype != torch.float32 or n_rows.dtype != torch.int64:
        raise TypeError(f"cost {a.dtype} and n_rows {n_rows.dtype}, expected "
                        "float32 and int64")
    if n_rows.dim() != 0 or not a.is_contiguous():
        raise ValueError("n_rows must be a 0-d tensor and the cost contiguous")
    if not 1 <= N <= KERNEL_MAX_N or not 0 <= R <= N:
        raise ValueError(f"N = {N}, R = {R}: the kernel takes 1 <= N <= "
                         f"{KERNEL_MAX_N} and 0 <= R <= N")
    kernels.check_cuda(a, n_rows)
    p = torch.empty(N + 1, dtype=torch.int64, device=a.device)
    kernels.launch("jv_solve", (a, n_rows, p), iparams=(N, R))
    return p


def _jv(a: torch.Tensor, n_rows: torch.Tensor, R: int) -> torch.Tensor:
    """The JV solve: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if a.device.type == "cpu":
        return _jv_plain(a, n_rows, R)
    return jv_solve_cuda(a, n_rows, R)


@full_f32_matmul()
def solve_assignment(cost: torch.Tensor, row_valid: torch.Tensor,
                     col_valid: torch.Tensor) -> torch.Tensor:
    """Min-cost one-to-one assignment; returns ``col_of_row[R]`` (-1 = none)."""
    R, C = cost.shape
    N = max(R, C, _BRUTE_N)
    dev = cost.device
    pair_ok = row_valid[:, None] & col_valid[None, :]
    spread = torch.clamp(torch.where(pair_ok, cost, 0.0).max(), min=1.0)
    dummy = spread * 2.0 + 1.0
    a = torch.zeros((N, N), dtype=torch.float32, device=dev)
    a[:R, :C] = torch.where(pair_ok, cost.to(torch.float32), dummy)
    ar = torch.arange(N, device=dev)
    a = torch.where((ar[:, None] >= R) | (ar[None, :] >= C), dummy, a)

    # JV
    rows1 = torch.arange(1, R + 1, dtype=torch.int64, device=dev)
    n_rows = torch.where(row_valid, rows1, 0).max()
    p = _jv(a, n_rows, R)
    col_of_row = torch.full((N + 1,), -1, dtype=torch.int64, device=dev)
    col_of_row[p[1:]] = torch.arange(1, N + 1, dtype=torch.int64, device=dev)
    r_jv = col_of_row[1:R + 1] - 1
    r_jv = torch.where((r_jv >= 0) & (r_jv < C), r_jv, -1)

    # exhaustive 8x8
    perms, onehot = _perm_tables(dev)
    totals = onehot @ a[:_BRUTE_N, :_BRUTE_N].reshape(-1)
    cols8 = _at(perms, torch.argmin(totals)).to(torch.int64)
    r_bf = torch.full((N,), -1, dtype=torch.int64, device=dev)
    r_bf[:_BRUTE_N] = cols8
    r_bf = r_bf[:R]
    r_bf = torch.where(r_bf < C, r_bf, -1)

    small = ~(row_valid[_BRUTE_N:].any() | col_valid[_BRUTE_N:].any())
    res = torch.where(small, r_bf, r_jv)
    is_real = (row_valid & (res >= 0)
               & pair_ok.gather(1, res.clamp(min=0)[:, None])[:, 0])
    return torch.where(is_real, res, -1).to(torch.int32)
