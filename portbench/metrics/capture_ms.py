"""The graphed step's capture time, summed over its graphs (its
``capture_ms``: a warm-up run, the capture and a wait)."""


def read(run):
    return float(sum(run.capture_ms.values())) if run.capture_ms else None
