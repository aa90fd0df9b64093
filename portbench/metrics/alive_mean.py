"""Mean over the window's frames of the step's ``alive`` counter: the
particles the map holds after a frame."""

import statistics


def read(run):
    alive = run.counters.get("alive")
    return float(statistics.fmean(alive)) if alive else None
