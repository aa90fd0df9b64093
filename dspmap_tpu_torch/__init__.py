"""dspmap_tpu_torch: the DSP map on PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of ``dspmap_tpu`` (which stays the reference): the same
``MapConfig`` presets, the same per-frame step on the pool and the compact
layout on both prediction arms (deterministic and noisy), the same
multi-sensor step, the same readouts and live setters.  Tensors on the CPU run every
stage in plain PyTorch; tensors on a CUDA card run the occupancy pool
pass, the fused sweep, the measurement-update pair passes, the compact
layout's segmented scans and the relayout copies of large pool planes as
CUDA kernels (``csrc/``, built by ``nvcc`` at first use).  This package
never imports jax or ``dspmap_tpu``; a state is built on the CUDA card
unless the caller names another device.  ``io`` holds the replay entry
point (``python -m dspmap_tpu_torch.io.replay``), checkpoints in the JAX
package's file format (they load in either package), the particle CSV, bag
and native ingestion and the ROS bridges; ``utils`` the markers, PLY
exports and ``torch.profiler`` tracing.  ``parallel`` splits the map over
processes, a slab of the voxel grid each, on ``torch.distributed``
(``make_shardmap_step``, ``shard_state``, ``gather_state``; on NCCL ranks,
a card each, ``make_graphed_shardmap_step`` captures each rank's step as a
CUDA graph).

Quick start::

    import dspmap_tpu_torch as dm
    from dspmap_tpu_torch.utils import sim

    cfg = dm.example_node_settings(dm.dsp_dynamic())
    state = dm.init_state(cfg, seed=0)  # on the card; device="cpu" for the CPU
    step = dm.make_graphed_step(cfg)    # one CUDA graph a frame
    for pts, n, pos, quat, t in sim.generate_sequence(10, cfg, seed=0):
        state, out = step(state, dm.Frame(pts, n, pos, quat, t))
    occ, centers, future, state = dm.get_occupancy_map(state, cfg, 0.2)

``make_graphed_step`` is the counterpart of the JAX package's
``jax.jit(make_step(cfg), donate_argnums=0)`` and
``make_graphed_multisensor_step(cfg, n)`` of ``jax.jit(
make_multisensor_step(cfg, n), donate_argnums=0)``; a CPU state takes
``make_step(cfg)`` or ``make_multisensor_step(cfg, n)``, the same steps
run op by op.
"""

from .config import (  # noqa: F401
    MapConfig,
    dsp_dynamic,
    dsp_dynamic_multi_neighbors,
    dsp_static,
    large_urban,
    example_node_settings,
    performance_level_parameters,
)
from .state import (  # noqa: F401
    MapState,
    Particles,
    EstimatorState,
    RuntimeParams,
    init_state,
    add_random_particles,
    state_from_numpy,
    state_to_numpy,
)
from .models.pipeline import (  # noqa: F401
    Frame,
    StepOutput,
    make_step,
    make_draws,
    make_multisensor_step,
    make_multisensor_draws,
    init_multisensor_state,
    stack_frames,
    get_occupancy_map,
    read_occupancy,
    clear_future_prediction,
    set_prediction_variance,
    set_observation_stddev,
    set_newborn_particle_weight,
    set_detection_probability,
    set_clutter_intensity,
)
from .models.graphed import (  # noqa: F401
    make_graphed_step,
    make_graphed_multisensor_step,
)
from .parallel import (  # noqa: F401
    make_mesh,
    state_shardings,
    shard_state,
    gather_state,
    make_sharded_step,
    make_shardmap_step,
    make_graphed_sharded_step,
    make_graphed_shardmap_step,
)
