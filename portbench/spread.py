#!/usr/bin/env python3
"""The spread of a cell's end-to-end metrics over sets of runs, from which
the bounds in ``BENCHMARK.json`` are set.

    python3 portbench/spread.py runs.jsonl [...]

Each input line is ``{"set": <label>, "seed": <n>, "result": <a run's
result line>}``.  For each cell's set and metric it prints the median and
the spread: the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median.  Then,
for each metric, the widest spread over the sets and five times it, the
bound that spread suggests (never under 1%).
"""

import json
import statistics
import sys


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values) -> float:
    """The spread without the run farthest from the median."""
    m = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - m))
    return spread([v for i, v in enumerate(values) if i != far])


def main(paths) -> int:
    sets = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if not rec.get("result"):
                    continue
                for name, m in rec["result"]["metrics"].items():
                    sets.setdefault((rec["set"], name), []).append(m["value"])
    widest, tight = {}, {}
    for (label, name), values in sorted(sets.items()):
        s = spread(values) if len(values) >= 2 else 0.0
        widest[name] = max(widest.get(name, 0.0), s)
        cell = label.rsplit(".", 1)[0]
        if len(values) >= 3:
            tight.setdefault((cell, name), []).append(trimmed(values))
        print(json.dumps({"set": label, "metric": name, "runs": len(values),
                          "median": statistics.median(values),
                          "spread": s}))
    for name, s in sorted(widest.items()):
        least = max([2 * statistics.fmean(v) for (c, n), v in tight.items()
                     if n == name] or [0.0])
        print(json.dumps({"metric": name, "widest_spread": s,
                          "bound_5x": max(0.01, 5 * s),
                          "bound_at_least": least, "bound_at_most": 8 * s}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
