"""Fixed-shape building blocks: masked compaction, within-group ranking and
drop-mode scatters (mirrors ``dspmap_tpu/ops/common.py``).

The semantics are the JAX package's -- fixed capacity, stable order,
overflow counts -- without its TPU mechanisms (the MXU bitmask pack,
``pool_take_stacked``).  Nothing here syncs the host: counts stay tensors.

Scatters in JAX's ``mode="drop"`` route out-of-range rows to a sentinel
element of a buffer one larger and slice it off; ``index_put_`` raises on
out-of-range rows, and clamping an index would overwrite a live slot.

Pool planes come in two forms (:func:`pool_sv`): ``[S, V]`` and the flat
``[S*V]`` form of the step's mid-frame phase (``state.flatten_pool``).  A
flat plane may be a *working plane* (:func:`working_plane`): the prefix view
of a padded buffer that the step owns, into which :func:`pool_put` and
:func:`pool_fill` write in place.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

I32_MAX = 2**31 - 1


def to_device(x, dtype, device) -> torch.Tensor:
    """A host value (scalar, list or numpy array) as a tensor on ``device``.
    A CUDA copy goes through pinned memory without blocking: a copy from
    pageable memory would wait for the stream to drain."""
    t = torch.tensor(np.asarray(x), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@contextlib.contextmanager
def full_f32_matmul():
    """Within the block, float32 matrix products on the card run in full
    float32 (``torch.backends.cuda.matmul.allow_tf32 = False``); on exit
    the caller's setting is restored."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _vals(vals, target: torch.Tensor) -> torch.Tensor:
    """Scatter values in ``target``'s dtype; a Python scalar is filled on
    the device (``as_tensor`` would copy it from the host)."""
    if isinstance(vals, torch.Tensor):
        return vals.to(target.dtype)
    return torch.full((), vals, dtype=target.dtype, device=target.device)


def _safe(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as int64 with every out-of-range row sent to sentinel ``n``."""
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _put(buf: torch.Tensor, target: torch.Tensor, idx: torch.Tensor,
         vals) -> None:
    """``buf[idx] = vals`` with out-of-range rows sent to ``buf``'s last
    (sentinel) row; ``buf`` is one row longer than ``target``."""
    vals = _vals(vals, target)
    if vals.dim() < idx.dim() + target.dim() - 1:
        vals = vals.expand(tuple(idx.shape) + tuple(target.shape[1:]))
    buf.index_put_((_safe(idx, target.shape[0]),), vals)


def scatter_set(target: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``target.at[idx].set(vals, mode="drop")`` along dim 0 (functional).

    Dropped rows land in a sentinel row of a buffer one larger; the
    returned tensor is a contiguous prefix view of that buffer."""
    n = target.shape[0]
    buf = torch.empty((n + 1,) + tuple(target.shape[1:]), dtype=target.dtype,
                      device=target.device)
    buf[:n] = target
    _put(buf, target, idx, vals)
    return buf[:n]


def scatter_add(target: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``target.at[idx].add(vals, mode="drop")`` along dim 0 (functional)."""
    n = target.shape[0]
    buf = torch.zeros((n + 1,) + tuple(target.shape[1:]), dtype=target.dtype,
                      device=target.device)
    buf[:n] = target
    vals = _vals(vals, target)
    if vals.dim() < idx.dim() + target.dim() - 1:
        vals = vals.expand(tuple(idx.shape) + tuple(target.shape[1:]))
    buf.index_add_(0, _safe(idx, n), vals)
    return buf[:n]


def scatter_max(target: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``target.at[idx].max(vals, mode="drop")`` for 1-D ``target``."""
    n = target.shape[0]
    buf = torch.cat([target, target.new_zeros(1)])
    return buf.scatter_reduce(0, _safe(idx, n), vals, "amax",
                              include_self=True)[:n]


def pool_sv(plane: torch.Tensor, cfg) -> tuple:
    """``(S, V)`` of a pool plane in the ``[S, V]`` or the flat ``[S*V]``
    form."""
    if plane.dim() == 2:
        return tuple(plane.shape)
    s = cfg.slots_per_voxel
    return s, plane.shape[0] // s


def working_plane(buf: torch.Tensor, flat=None) -> torch.Tensor:
    """The ``[n]`` prefix view of a padded 1-D buffer ``[n + 1]`` that the
    step owns, marked so that :func:`pool_put` and :func:`pool_fill` write
    into it in place (the last element is the scatters' drop sentinel).
    The mark lives on this tensor object only: anything computed from it is
    an ordinary tensor.  ``flat`` hands in the prefix view where the caller
    has cut it already."""
    if flat is None:
        flat = buf[:buf.shape[0] - 1]
    flat.padded = buf
    return flat


def padded_buffer(plane: torch.Tensor):
    """The padded buffer behind a working plane, else ``None``."""
    return getattr(plane, "padded", None)


def pool_take(plane: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Gather flat pool positions from a contiguous plane of any shape;
    out-of-range ``flat`` (the ``S*V`` sentinel) clamps, like the JAX
    package's flat-form gather."""
    f = plane.reshape(-1)
    return f[flat.to(torch.int64).clamp(0, f.shape[0] - 1)]


def pool_put(plane: torch.Tensor, flat: torch.Tensor, vals) -> torch.Tensor:
    """Scatter ``vals`` at flat pool positions, dropping out-of-range rows
    (the ``S*V`` drop sentinel).  Returns a new plane of ``plane``'s shape,
    or, for a working plane, ``plane`` itself written in place."""
    buf = padded_buffer(plane)
    if buf is not None:
        _put(buf, plane, flat, vals)
        return plane
    return scatter_set(plane.reshape(-1), flat, vals).view(plane.shape)


def pool_fill(plane: torch.Tensor, mask: torch.Tensor, value) -> torch.Tensor:
    """``where(mask, value, plane)``: a new plane, or, for a working plane,
    ``plane`` itself filled in place."""
    if padded_buffer(plane) is not None:
        return plane.masked_fill_(mask, value)
    return torch.where(mask, value, plane)


def compact_mask(mask: torch.Tensor, capacity: int):
    """Compact the True positions of ``mask`` (first-to-last) into a fixed
    buffer.  Returns ``(indices[capacity] i32, valid[capacity],
    n_kept, n_overflow)``; invalid entries carry index 0."""
    m = mask.reshape(-1)
    pos = torch.cumsum(m, 0, dtype=torch.int64) - 1
    n_selected = pos[-1] + 1 if m.numel() else pos.new_zeros(())
    tgt = torch.where(m & (pos < capacity), pos, capacity)
    src = torch.arange(m.shape[0], dtype=torch.int32, device=m.device)
    out = torch.zeros(capacity + 1, dtype=torch.int32, device=m.device)
    out.index_put_((tgt,), src)
    valid = torch.arange(capacity, device=m.device) < n_selected
    n_kept = torch.clamp(n_selected, max=capacity)
    return (torch.where(valid, out[:capacity], 0), valid,
            n_kept.to(torch.int32), (n_selected - n_kept).to(torch.int32))


def group_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal (sorted) keys."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=sorted_keys.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    return idx - run_start


def sort_by_destination(dest: torch.Tensor, valid: torch.Tensor):
    """Stable sort by destination, invalid entries last.  Returns
    ``(order i32, sorted_dest i32, ranks i32)``; invalid entries carry the
    ``I32_MAX`` sentinel in ``sorted_dest``."""
    keys = torch.where(valid, dest.to(torch.int32), I32_MAX)
    sorted_dest, order = torch.sort(keys, stable=True)
    return order.to(torch.int32), sorted_dest, group_ranks(sorted_dest)


def inverse_ranks(order: torch.Tensor, ranks_sorted: torch.Tensor):
    """``zeros.at[order].set(ranks_sorted)``: ranks back in input order."""
    out = torch.empty_like(ranks_sorted)
    out[order.to(torch.int64)] = ranks_sorted
    return out


def compact_and_group(mask: torch.Tensor, group: torch.Tensor, capacity: int,
                      n_groups: int):
    """Compaction + stable grouping by ``group`` id.  Returns
    ``(indices, group_ids, ranks, valid, n_selected)``."""
    c_idx, c_valid, n_kept, n_over = compact_mask(mask, capacity)
    g = torch.where(c_valid, pool_take(group, c_idx).to(torch.int32), n_groups)
    sorted_group, perm = torch.sort(g, stable=True)
    indices = c_idx[perm]
    return (indices, sorted_group, group_ranks(sorted_group),
            sorted_group < n_groups, n_kept + n_over)


def segment_counts(ids: torch.Tensor, valid: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Count of valid entries per segment id."""
    ones = torch.ones_like(ids, dtype=torch.int32)
    z = torch.zeros(num_segments, dtype=torch.int32, device=ids.device)
    return scatter_add(z, torch.where(valid, ids, num_segments), ones)


def select_rows(table: torch.Tensor, row_idx: torch.Tensor, n_rows: int):
    """``out[...] = table[row_idx[...], ...]`` for a small leading axis."""
    out = torch.where(row_idx == 0, table[0], torch.zeros((), dtype=table.dtype,
                                                          device=table.device))
    for j in range(1, n_rows):
        out = torch.where(row_idx == j, table[j], out)
    return out
