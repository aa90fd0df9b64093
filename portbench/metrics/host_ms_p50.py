"""Median over the window's frames of the step call's host time, from the
call to its return and before the wait for the card: the prologue, the
draws, the staged copy of the frame and the graph's launch."""

import statistics


def read(run):
    return statistics.median(run.host_ms) if run.host_ms else None
