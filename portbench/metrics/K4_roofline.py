"""K4's share of its roofline in the profiled frames: the least time its
launches could take on the card (``roofline/K4.py``, the compact layout's
four segmented scans a frame) over the device time they took, in percent.
Nothing where a frame's launches are not the four the file counts."""

KERNEL = "K4"


def read(run):
    k = run.roofline(KERNEL)
    from portbench.roofline import bound_s
    t = run.trace
    per_frame = k.launches(run.config_file["config"],
                           run.config_file["shapes"], run.cameras)
    spent = t.seconds_matching(k.NAME) if t else 0.0
    if not per_frame or spent <= 0:
        return None
    launches = t.count_matching(k.NAME)
    if launches != len(per_frame) * t.frames:
        return None
    least = t.frames * sum(bound_s(b, f) for b, f in per_frame)
    return 100.0 * least / spent
