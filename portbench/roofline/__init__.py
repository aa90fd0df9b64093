"""A kernel's least time on one H100 from the shapes of the cell: one file
a kernel, ``<kernel>.py``, whose ``launches(cfg, cameras)`` gives the bytes
and float operations of each launch a frame makes, in launch order, and
:func:`bound_s`, the larger of bytes over the card's bandwidth and
operations over its float32 rate (``peaks.json``)."""

from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent
                    / "peaks.json").read_text())


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least seconds a launch of ``n_bytes`` and ``n_flops`` takes."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"],
               n_flops / PEAKS["f32_flops_per_s"])
