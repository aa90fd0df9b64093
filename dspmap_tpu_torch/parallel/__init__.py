"""Map parallelism on ``torch.distributed``: the voxel grid and the
particles in it split into contiguous slabs, one process (rank) a slab
(mirrors ``dspmap_tpu/parallel``)."""

from .sharding import (  # noqa: F401
    Mesh,
    make_mesh,
    state_shardings,
    shard_state,
    gather_state,
    make_sharded_step,
    make_graphed_sharded_step,
)
from .shard_step import (  # noqa: F401
    make_shardmap_step,
    make_graphed_shardmap_step,
)
