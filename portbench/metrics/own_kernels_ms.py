"""Device milliseconds a frame of the port's hand-written kernels (K1-K5
and the JV solve) in the profiled frames."""


#: the kernels' names in the trace hold one of these
NAMES = ("occupancy_tile_kernel", "sweep_kernel", "pass1_kernel",
         "pass2_kernel", "segscan_", "copy16_kernel", "jv_warp_kernel",
         "jv_kernel")


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    s = sum(sec for name, sec in t.seconds_by_name.items()
            if any(n in name for n in NAMES))
    return s / t.frames * 1e3 if s > 0 else None
