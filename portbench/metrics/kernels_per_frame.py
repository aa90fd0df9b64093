"""Kernels, copies and sets the card ran a frame in the profiled frames."""


def read(run):
    t = run.trace
    if t is None or not t.frames or not t.events:
        return None
    return t.events / t.frames
