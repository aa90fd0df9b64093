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

:class:`ShardCtx` is the map-parallel context of the sharded step: one
process per shard, each holding a contiguous slab of the voxel grid, with
the JAX package's ``psum`` / ``all_gather`` / ``ppermute`` as
``torch.distributed`` collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

I32_MAX = 2**31 - 1


def to_device(x, dtype, device) -> torch.Tensor:
    """A host value (scalar, list or numpy array) as a tensor on ``device``.
    A CUDA copy goes through pinned memory without blocking: a copy from
    pageable memory would wait for the stream to drain."""
    t = torch.tensor(np.asarray(x), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# --------------------------------------------------- per-frame scalars
#
# A stage takes each per-frame value (the time step, the update time, the
# sensor pose, the window origin, the runtime parameters) either as a
# tensor -- a view of the step's frame blocks (``scalars.py``), the
# form the step passes, so that a captured CUDA graph reads each frame's
# values where the frame's copy puts them -- or as a host value, the form
# of a caller that runs one stage.  The two give the same bits.  The
# attitude is the one value whose forms differ in kind: a stage takes the
# host wxyz quaternion as ``quat`` and the block's rotation matrix as the
# keyword ``R=`` (``geometry.frame_rotation``).  Host values become blocks
# in one place, ``scalars.host_blocks``; the helpers below only read either
# form.


def frame_float(x):
    """A per-frame float: a tensor as it is; a host value rounded to
    float32, as a Python float (an operation reads either as a float32)."""
    return x if isinstance(x, torch.Tensor) else float(np.float32(x))


def frame_floats(x, n: int = 3) -> list:
    """The ``n`` components of a per-frame float vector: 0-d views of a
    tensor, or the host values rounded to float32 as Python floats."""
    if isinstance(x, torch.Tensor):
        return list(x.unbind(0))
    return [float(v) for v in np.asarray(x, np.float32)[:n]]


def frame_ints(x, n: int = 3) -> list:
    """The ``n`` components of a per-frame int vector (the window origin):
    0-d views of a tensor, or Python ints."""
    if isinstance(x, torch.Tensor):
        return list(x.unbind(0))
    return [int(v) for v in np.asarray(x)[:n]]


def frame_tensor(x, dtype, device) -> torch.Tensor:
    """A per-frame value as a tensor: a tensor as it is, a host value
    copied by :func:`to_device`."""
    return x if isinstance(x, torch.Tensor) else to_device(x, dtype, device)


def div_frame(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` for a per-frame divisor ``d``, with the bits of ``x /
    float(d)`` on either form: PyTorch's CUDA division by a host scalar
    multiplies by its float32 reciprocal, so a tensor divisor on the card
    does the same; the CPU divides."""
    if isinstance(d, torch.Tensor) and x.is_cuda:
        return x * (1.0 / d)
    return x / d


def device_constant(values, dtype, device) -> torch.Tensor:
    """A ``[len(values)]`` tensor of configuration constants made on
    ``device`` by fills (no copy from host memory, which a captured graph
    would read again on every replay)."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


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


#: sentinel rows of a scatter-add's buffer: its dropped entries spread over
#: them in turn, since :func:`add_at` on the card adds each index's
#: duplicates one after another in one warp
DROP_ROWS = 1024


def drop_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as int64 with its out-of-range entries sent to the
    :data:`DROP_ROWS` sentinel rows ``n, n + 1, ...`` in turn."""
    idx = idx.to(torch.int64)
    spread = n + torch.arange(idx.numel(), device=idx.device).view(
        idx.shape) % DROP_ROWS
    return torch.where((idx >= 0) & (idx < n), idx, spread)


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


def add_at(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
           dim: int = 0) -> torch.Tensor:
    """``out.index_add_(dim, idx, vals)`` in place (``dim`` 0, or 1 of a
    contiguous 2-D ``out``), its bits the same from call to call.  On the
    CPU ``index_add_`` adds duplicates in index order, as XLA's scatter
    does; on the card its float atomics add them in no fixed order, so a
    float ``out`` there takes ``index_put_`` with ``accumulate``, whose
    stable sort of the indices fixes the order in which duplicates add
    (``dim`` 1 as one index into the flat rows, which copies nothing).
    Integer sums are exact in any order and keep the atomics.  A long run
    of one index costs the card its length in serial adds (see
    :func:`drop_rows`).  Returns ``out``."""
    if not (out.is_cuda and out.is_floating_point()):
        return out.index_add_(dim, idx, vals)
    if dim == 1:
        rows = torch.arange(out.shape[0], device=out.device)[:, None]
        out.view(-1).index_put_(((rows * out.shape[1] + idx).reshape(-1),),
                                vals.reshape(-1), accumulate=True)
    else:
        out.index_put_((idx,), vals, accumulate=True)
    return out


def scatter_add(target: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``target.at[idx].add(vals, mode="drop")`` along dim 0 (functional),
    through :func:`add_at`; dropped rows land in sentinel rows
    (:func:`drop_rows`)."""
    n = target.shape[0]
    buf = torch.zeros((n + DROP_ROWS,) + tuple(target.shape[1:]),
                      dtype=target.dtype, device=target.device)
    buf[:n] = target
    vals = _vals(vals, target)
    if vals.dim() < idx.dim() + target.dim() - 1:
        vals = vals.expand(tuple(idx.shape) + tuple(target.shape[1:]))
    return add_at(buf, drop_rows(idx, n), vals)[:n]


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``zeros[n, ...].at[seg].add(vals)`` with every ``seg`` in ``[0, n)``
    (:func:`add_at`).  Replicated computation in the sharded step needs its
    repeatable bits: every rank must reach the same ones."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return add_at(out, seg, vals)


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


#: the transports of :meth:`ShardCtx.gather_ring`
RING_TRANSPORTS = ("p2p", "all_gather")


def ring_transport(group, device) -> str:
    """The transport :meth:`ShardCtx.gather_ring` takes for ``group``'s
    backend and tensors on ``device``: point-to-point sends
    (``batch_isend_irecv``), except where the backend cannot send CUDA
    tensors point to point (gloo), where it is an ``all_gather`` from which
    each rank takes its ring neighbours.  Both deliver the same tensor."""
    if not dist.is_initialized():
        return "p2p"  # a mesh of one process: no transport is used
    if (torch.device(device).type == "cuda"
            and dist.get_backend(group) == "gloo"):
        return "all_gather"
    return "p2p"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Map-axis context of the sharded step (the JAX package's ``ShardCtx``
    of its ``shard_map`` fast path).  Every ``[S, V]`` / ``[V, ...]`` /
    ``[P]`` operand is this rank's contiguous slab; ``lo`` is the slab's
    first global storage cell, so ``global_cell - lo`` is the local column
    and ownership is ``0 <= global_cell - lo < V_local``.

    ``group`` is the process group (``None``: the default group; with
    ``n_shards == 1`` and no process group initialized, every collective is
    the identity).  ``transport`` is :meth:`gather_ring`'s, chosen once by
    the caller (:func:`ring_transport`); it never changes the result."""

    n_shards: int
    rank: int
    lo: int
    group: object = None
    transport: str = "p2p"

    def __post_init__(self):
        if self.transport not in RING_TRANSPORTS:
            raise ValueError(f"transport {self.transport!r} not in "
                             f"{RING_TRANSPORTS}")
        if not 0 <= self.rank < self.n_shards:
            raise ValueError(f"rank {self.rank} outside [0, {self.n_shards})")

    @property
    def _alone(self) -> bool:
        return self.n_shards == 1 and not dist.is_initialized()

    def owns(self, cell: torch.Tensor, v_local: int) -> torch.Tensor:
        local = cell - self.lo
        return (local >= 0) & (local < v_local)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor; ``x`` is kept)."""
        y = x.clone()
        if not self._alone:
            dist.all_reduce(y, group=self.group)
        return y

    def _all_gather(self, x: torch.Tensor) -> list:
        if self._alone:
            return [x]
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.n_shards)]
        dist.all_gather(out, x, group=self.group)
        return out

    def gather_flat(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order
        (shard-major: the cross-shard arrival order)."""
        return torch.cat(self._all_gather(x))

    def _ring_peers(self, hops: int) -> list:
        """``(h, sign)`` in the order of the parts after this rank's own:
        the buffer of rank ``rank - sign*h`` for ``h = 1..min(hops,
        (n-1)//2)`` and ``sign = +1, -1``."""
        reach = min(hops, (self.n_shards - 1) // 2)
        return [(h, sign) for h in range(1, reach + 1) for sign in (1, -1)]

    def _global(self, rank: int) -> int:
        return (rank if self.group is None
                else dist.get_global_rank(self.group, rank))

    def gather_ring(self, x: torch.Tensor, hops: int = 1) -> torch.Tensor:
        """This rank's ``x`` followed by its ``hops`` nearest neighbours'
        in each direction (``ppermute`` in the JAX package): the buffers of
        ranks ``r-1, r+1, r-2, r+2, ...`` with ``hops`` clamped to
        ``(n-1)//2``.  Movers bound further away are not delivered; the
        caller counts them (:meth:`ring_reachable`)."""
        n, r = self.n_shards, self.rank
        peers = self._ring_peers(hops)
        if not peers:
            return x
        if self.transport == "all_gather":
            parts = self._all_gather(x)
            return torch.cat([x] + [parts[(r - sign * h) % n]
                                    for h, sign in peers])
        x = x.contiguous()
        bufs = [torch.empty_like(x) for _ in peers]
        ops = []
        for (h, sign), buf in zip(peers, bufs):
            to, frm = (self._global((r + d) % n) for d in (sign * h,
                                                            -sign * h))
            ops.append(dist.P2POp(dist.isend, x, to, self.group))
            ops.append(dist.P2POp(dist.irecv, buf, frm, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return torch.cat([x] + bufs)

    def ring_reachable(self, cell: torch.Tensor, v_local: int,
                       hops: int) -> torch.Tensor:
        """True where a global destination ``cell`` lies within ``hops``
        slabs of this rank's slab on the ring."""
        n = self.n_shards
        d = torch.remainder(cell // v_local - self.lo // v_local, n)
        return torch.minimum(d, n - d) <= min(hops, (n - 1) // 2)

    def exchange(self, cols, ring_hops=None) -> list:
        """Exchange the columns ``cols`` (``[m]`` tensors of f32, i32 or
        bool) in one collective: :meth:`gather_flat` or, with
        ``ring_hops``, :meth:`gather_ring`.  The columns ride one i32
        ``[m, C]`` block (f32 as its bits); each comes back in its dtype."""
        block = torch.stack([c.view(torch.int32) if c.dtype == torch.float32
                             else c.to(torch.int32) for c in cols], dim=1)
        got = (self.gather_flat(block) if ring_hops is None
               else self.gather_ring(block, ring_hops))
        out = []
        for k, c in enumerate(cols):
            col = got[:, k].contiguous()
            out.append(col.view(torch.float32) if c.dtype == torch.float32
                       else col.to(c.dtype))
        return out
