"""K4, the compact layout's segmented scans (``csrc/segscan.cu``): four
launches a frame over the ``[P]`` rows, with the columns the step passes
(the port's ``utils/kernel_times.py::SEGSCAN_CALLS`` at ``S`` slots a
voxel): ``occupancy_compact``'s two at a reach of ``2 S`` rows, then
``segment_table``'s two at ``S``.  A launch reads its columns (4 bytes, or
1 for a bool) and two flag bytes a row and writes a 4-byte ``hi`` column a
column and ``n_tot`` total columns; each of ``log2(reach)`` steps adds a
column forward.  The arithmetic of the port's ``chip_smoke.py``
(``check_segscan``)."""

from __future__ import annotations

import math

#: the kernels' names in the profiler's trace hold this (the warp and the
#: tile form)
NAME = "segscan_"
SIZES = {"bool": 1, "f32": 4, "i32": 4}


def calls(S: int) -> tuple:
    """``(n_tot, max_run, column types)`` of a frame's four calls."""
    return (
        (2, 2 * S, ("bool", "f32", "bool", "f32", "f32", "f32", "f32")),
        (2, 2 * S, ("bool", "i32")),
        (0, S, ("f32", "f32", "f32", "bool")),
        (0, S, ("bool",)),
    )


def reach(max_run: int) -> int:
    r = 1
    while r < max_run:
        r *= 2
    return r


def launch(P: int, n_tot: int, max_run: int, types) -> tuple:
    """``(bytes, flops)`` of one launch."""
    C = len(types)
    in_bytes = sum(SIZES[t] for t in types) + 2
    steps = int(math.log2(reach(max_run)))
    return P * (in_bytes + 4 * (C + n_tot)), P * C * steps


def launches(cfg: dict, shapes: dict, cameras: int) -> list:
    """``[(bytes, flops)]`` of a frame's launches, compact layout only."""
    if shapes["layout"] != "compact":
        return []
    return [launch(shapes["compact_capacity"], *c)
            for c in calls(shapes["slots_per_voxel"])]
