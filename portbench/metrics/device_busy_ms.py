"""Device milliseconds a frame in the profiled frames: the union of the
card's kernels, copies and sets over the frames' span, per frame.  A
steadier reading of the card's part of a frame than the host clock's
frame times (the busy time of one cell's traced runs agrees within 1%)."""


def read(run):
    t = run.trace
    if t is None or not t.frames or t.busy_s <= 0:
        return None
    return t.busy_s / t.frames * 1e3
