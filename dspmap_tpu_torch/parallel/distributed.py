"""Process-group set-up for map parallelism (mirrors
``dspmap_tpu/parallel/distributed.py``).

One process runs each shard of the map (``parallel.make_shardmap_step``).
:func:`init` joins the processes into the default process group, from the
environment that ``torchrun`` sets or from explicit arguments::

    from dspmap_tpu_torch.parallel import distributed, make_mesh, shard_state
    distributed.init("tcp://localhost:29500", num_processes=2, process_id=r)
    mesh = make_mesh()
    state = shard_state(init_state(cfg, seed=0), mesh)

NCCL refuses two ranks on one card; ranks that share a card take
``backend="gloo"``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

#: the variables ``torchrun`` sets for ``init_method="env://"``
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None,
         backend: str | None = None) -> None:
    """Initialize the default process group, unless it is initialized
    already.  With ``coordinator_address`` (``"host:port"`` or a URL such
    as ``"tcp://localhost:29500"``) ``num_processes`` and ``process_id``
    name the world size and this process's rank; without it they come
    from the environment (``torchrun``), and a single process with nothing
    configured is left alone (no process group: a mesh of one).
    ``backend`` defaults to NCCL where CUDA is present, else gloo."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not all(k in os.environ for k in _ENV):
            return
        init_method = "env://"
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def is_coordinator() -> bool:
    """Whether this process is rank 0 (or runs alone)."""
    return not dist.is_initialized() or dist.get_rank() == 0
