#!/usr/bin/env python3
"""The readings a cell's limits are set from: the compared numbers of the
program on many seeds (the lower readings) and of the control on some (the
upper readings), all in one process, each against the cell's own
reference (its configuration file's ``reference``).

    python3 portbench/calibrate.py --workload flagship.street \\
        --seeds 12 --control-seeds 3 --seconds 4 --first-seed 1000

For each seed it runs the cell's set-up and a window of ``--seconds`` at
the cell's own load, then computes each compared frame with the reference
and holds the program's result against it; on the first
``--control-seeds`` seeds it also computes the frame with the control (the
reference in the lower precision, ``run(..., control=True)``) from the same
state and holds that against the reference.  One JSON line a compared
frame and side, then a summary: a seed's reading of a number is its worst
over the seed's compared frames, as a run's is; ``lower`` is the largest
over the program's seeds, ``upper`` the smallest over the control's.  The
benchmark's own runs never run the control.
"""

import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=1000)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness, judge, spec as spec_mod

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    spec = spec_mod.Spec(HERE.parent, HERE)
    program, control = [], []
    for k in range(args.seeds):
        seed = args.first_seed + k
        cell = harness.Cell(spec, args.workload, seed, "cuda")
        t0 = time.time()
        harness.measure(cell, args.seconds, False, t0)
        cell.release()
        for rec in cell.compared:
            mine = cell.reference_frame(rec)
            start = rec.before is None
            got = judge.compare((rec.after, rec.readout), mine,
                                cell.cfg.voxel_resolution, start)
            program.append((seed, got))
            print(json.dumps({"seed": seed, "frame": rec.index,
                              "side": "program", "numbers": got}),
                  flush=True)
            if k < args.control_seeds:
                low = cell.reference_frame(rec, control=True)
                got = judge.compare(low, mine, cell.cfg.voxel_resolution,
                                    start)
                control.append((seed, got))
                print(json.dumps({"seed": seed, "frame": rec.index,
                                  "side": "control", "numbers": got}),
                      flush=True)
        print(f"seed {seed}: {time.time() - t0:.1f} s", file=sys.stderr,
              flush=True)
    def per_seed(rows):
        """Each seed's worst reading of each number (a run's reading)."""
        seeds = sorted({r[0] for r in rows})
        return [judge.worst([r[1] for r in rows if r[0] == s])
                for s in seeds]

    lower, upper = per_seed(program), per_seed(control)
    summary = {"workload": args.workload, "seeds": len(lower),
               "control_seeds": len(upper),
               "lower": {k: max(r[k] for r in lower) for k in lower[0]},
               "upper": ({k: min(r[k] for r in upper) for k in upper[0]}
                         if upper else None),
               "device": torch.cuda.get_device_name(0)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
