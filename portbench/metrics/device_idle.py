"""The share of the profiled frames' wall span in which the card ran no
kernel, copy or set: 1 - busy / span."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
