#!/usr/bin/env python3
"""The benchmark of the port ``dspmap_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload flagship.street --seed 12345 \\
        --seconds 20 --trace 0

Run from the root of a checkout on a machine with the cell's CUDA cards.
It renders the cell's traffic from the seed, builds the program's state
and graphed step, warms up, measures for ``--seconds`` seconds, and checks
frames of the window against the plain reference.  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
run that also profiles some frames after the window.  The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``compared``: each compared number beside its limit); the compared
numbers are also the last lines of standard error.  Without the cards the
cell asks for it exits with code 3 and prints no result.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


def process_start() -> float:
    """The wall time at which this process started (``/proc``), or the
    time this file began to run where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return min(STARTED, boot + ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, StopIteration):
        return STARTED


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()

    # every cache of a build or a compile inside the checkout, at a fixed
    # path; the program builds its kernels under its own build directory
    cache = REPO / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(REPO))

    from portbench import spec as spec_mod
    spec = spec_mod.Spec(REPO, HERE)
    cell = spec.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3

    from portbench import harness
    out = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                           bool(args.trace), started)
    lines = out.pop("_lines")
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
