"""The share of the update's particles that its spill tier updated over
the window's frames: the sum of the step's ``update_spilled`` over the sum
of its ``updated_particles`` (``updated_particles`` less ``update_spilled``
is the dense tier's share, K3's).  A step without the counter reads
nothing."""


def read(run):
    spilled = run.counters.get("update_spilled")
    updated = run.counters.get("updated_particles")
    if not spilled or not updated:
        return None
    return sum(spilled) / max(sum(updated), 1.0)
