"""Median over the window's frames of the occupancy readout and the host
copy of its occupied mask, by the benchmark's clock
(``get_occupancy_map`` and ``.cpu()``)."""

import statistics


def read(run):
    return statistics.median(run.readout_ms) if run.readout_ms else None
