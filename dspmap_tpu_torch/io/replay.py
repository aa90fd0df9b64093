"""Replay harness: the ROS-free equivalent of the reference example node
(``src/map_sim_example.cpp``): feed a frame stream (synthetic scene, saved
``.npz`` sequence, or a converted rosbag) through the map and report
occupancy, future status and timing.  The port's counterpart of
``dspmap_tpu/io/replay.py``, with the same flags and files; it runs on the
CUDA card, or on the CPU with ``--cpu``.

CLI::

    python -m dspmap_tpu_torch.io.replay --frames 40 --variant dynamic
    python -m dspmap_tpu_torch.io.replay --npz frames.npz --out outputs.npz
    python -m dspmap_tpu_torch.io.replay --cpu --tiny --frames 3
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import (Frame, dsp_dynamic, dsp_dynamic_multi_neighbors, dsp_static,
                example_node_settings, get_occupancy_map, init_state,
                make_graphed_step, make_step)
from ..utils import sim
from ..utils.profiling import force_sync
from .checkpoint import save_state
from .particles_csv import export_particles_csv

#: the 16x16x8 smoke-test map of ``--tiny``: 9.6 x 9.6 x 4.8 m at coarse
#: 0.6 m voxels, big enough that the synthetic street scene's pillars and
#: pedestrians (x in [3, 8]) fall inside the map
TINY = dict(nx=16, ny=16, nz=8, voxel_resolution=0.6, max_input_points=256,
            mover_capacity=2048, pyramid_slot_capacity=32, max_clusters=8)


def load_npz_frames(path):
    """Frame stream from an ``.npz`` with arrays points[N,P,3], n_points[N],
    sensor_pos[N,3], quat[N,4], timestamps[N]."""
    data = np.load(path)
    for i in range(len(data["timestamps"])):
        yield (
            data["points"][i],
            int(data["n_points"][i]),
            data["sensor_pos"][i],
            data["quat"][i],
            float(data["timestamps"][i]),
        )


def save_npz_frames(path, frames) -> None:
    pts, ns, poss, quats, ts = zip(*frames)
    np.savez_compressed(
        path,
        points=np.asarray(pts, np.float32),
        n_points=np.asarray(ns, np.int32),
        sensor_pos=np.asarray(poss, np.float32),
        quat=np.asarray(quats, np.float32),
        timestamps=np.asarray(ts, np.float64),
    )


def replay(cfg, frames, device, draws=None, threshold: float = 0.2,
           keep_centers: bool = False):
    """Run ``frames`` (items ``(points, n, sensor_pos, quat, t)`` of numpy
    values) from ``init_state(cfg, seed=0)`` on ``device``, printing one
    line a frame: through ``make_graphed_step(cfg)`` on a CUDA card (one
    captured graph a frame, where the JAX replay runs ``jax.jit``), through
    ``make_step(cfg)`` on the CPU.  ``draws``, one entry a frame
    (see ``make_step``), injects the random numbers; ``None`` draws them
    from the state's generator.

    A frame's wall time ends on the device: the clock stops after
    :func:`~dspmap_tpu_torch.utils.profiling.force_sync` of its
    ``weight_sum``.  The occupancy readout follows, copied to the host once.

    Returns ``(state, walls in seconds, outputs)``: per frame
    ``{"n_occupied": int}`` with ``"occupied_centers"`` (``[n, 3]``) when
    ``keep_centers``."""
    state = init_state(cfg, seed=0, device=device)
    step = (make_graphed_step(cfg) if state.device.type == "cuda"
            else make_step(cfg))
    walls, outputs = [], []
    for i, (pts, n, pos, quat, t) in enumerate(frames):
        frame = Frame(np.asarray(pts, np.float32), int(n),
                      np.asarray(pos, np.float32),
                      np.asarray(quat, np.float32), np.float32(t))
        t0 = time.perf_counter()
        state, out = step(state, frame, None if draws is None else draws[i])
        force_sync(out.weight_sum)
        wall = time.perf_counter() - t0
        walls.append(wall)

        occ, centers, future, state = get_occupancy_map(state, cfg,
                                                        threshold)
        occ_np = occ.cpu().numpy()
        alive = int(out.metrics["alive"])
        output = {"n_occupied": int(occ_np.sum())}
        if keep_centers:
            output["occupied_centers"] = centers.cpu().numpy()[occ_np]
        outputs.append(output)
        print(f"frame {i:03d}: {wall*1e3:7.2f} ms  "
              f"occupied={output['n_occupied']:5d}  alive={alive}")
    return state, walls, outputs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--variant", default="dynamic",
                    choices=["dynamic", "static", "multi"])
    ap.add_argument("--npz", help="frame stream .npz instead of synthetic")
    ap.add_argument("--out", help="write per-frame outputs to this .npz")
    ap.add_argument("--threshold", type=float, default=0.2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--tiny", action="store_true",
                    help="16x16x8 smoke-test map (CI use)")
    ap.add_argument("--csv", help="dump final particle CSV here")
    ap.add_argument("--checkpoint", help="save final state here (.npz)")
    args = ap.parse_args(argv)

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        ap.error("no CUDA device: the replay runs on the card; pass --cpu "
                 "to run it on the CPU")

    preset = {
        "dynamic": dsp_dynamic,
        "static": dsp_static,
        "multi": dsp_dynamic_multi_neighbors,
    }[args.variant]
    cfg = example_node_settings(preset(**(TINY if args.tiny else {})))
    if args.npz:
        frames = load_npz_frames(args.npz)
    else:
        frames = sim.generate_sequence(args.frames, cfg, seed=0)

    state, walls, outputs = replay(cfg, frames, device,
                                   threshold=args.threshold,
                                   keep_centers=bool(args.out))

    walls = np.asarray(walls[3:]) if len(walls) > 6 else np.asarray(walls)
    print(
        json.dumps(
            {
                "mean_ms": round(float(walls.mean() * 1e3), 2),
                "p50_ms": round(float(np.median(walls) * 1e3), 2),
                "updates_per_sec": round(1.0 / float(walls.mean()), 1),
            }
        )
    )
    if args.out:
        np.savez_compressed(
            args.out,
            n_occupied=np.asarray([o["n_occupied"] for o in outputs]),
            **{
                f"centers_{i}": o["occupied_centers"]
                for i, o in enumerate(outputs)
            },
        )
    if args.csv:
        n = export_particles_csv(state, cfg, args.csv)
        print(f"wrote {n} particles to {args.csv}")
    if args.checkpoint:
        save_state(state, args.checkpoint)
        print(f"checkpointed state to {args.checkpoint}")


if __name__ == "__main__":
    main()
