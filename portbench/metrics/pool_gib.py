"""The memory the graphed step's graphs reserved, summed over their pools
(its ``pool_bytes``)."""


def read(run):
    if not run.pool_bytes:
        return None
    return float(sum(run.pool_bytes.values())) / float(1 << 30)
