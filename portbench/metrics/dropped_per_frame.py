"""Mean over the window's frames of the particles the step's budgets
dropped: the sum of its counters with ``overflow`` or ``killed`` in their
names (pyramid, FOV, spill, mover, voxel, observation, future-mover and
compact-row budgets, as the step reports them)."""


def read(run):
    names = [k for k in run.counters if "overflow" in k or "killed" in k]
    if not names:
        return None
    frames = len(run.counters[names[0]])
    return sum(sum(run.counters[k]) for k in names) / frames
