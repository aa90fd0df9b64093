"""Everything the benchmark takes from the program under test, the port
``dspmap_tpu_torch``, and nothing else: the configuration built by its own
presets, a fresh state, the graphed step, the occupancy readout, and the
state's tensors read back as numpy for the judge.

The window drives the per-frame sequence of ``io/replay.py::replay``: the
graphed step, a wait for its ``weight_sum``, ``get_occupancy_map``, and the
occupied mask copied to the host.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

import dspmap_tpu_torch as dm


def build_config(builder: dict):
    """The program's ``MapConfig`` from a configuration file's
    ``builder``: ``preset(**overrides)``, then each function of ``wrap``."""
    cfg = getattr(dm, builder["preset"])(**builder.get("overrides", {}))
    for name in builder.get("wrap", []):
        cfg = getattr(dm, name)(cfg)
    return cfg


def config_values(cfg) -> dict:
    """The configuration's fields, tuples as lists (as its file holds
    them)."""
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(cfg).items()}


def init_state(cfg, cameras: int, seed: int, sensor_pos, device):
    if cameras == 1:
        return dm.init_state(cfg, seed=seed, sensor_pos=sensor_pos,
                             device=device)
    return dm.init_multisensor_state(cfg, cameras, seed=seed,
                                     sensor_pos=sensor_pos, device=device)


def make_step(cfg, cameras: int, device):
    """The step users run: one CUDA graph a frame on the card
    (``make_graphed_step``, ``make_graphed_multisensor_step`` for a rig);
    on the CPU, which only the benchmark's own tests use, the same steps
    op by op."""
    graphed = torch.device(device).type == "cuda"
    if cameras == 1:
        return dm.make_graphed_step(cfg) if graphed else dm.make_step(cfg)
    return (dm.make_graphed_multisensor_step(cfg, cameras) if graphed
            else dm.make_multisensor_step(cfg, cameras))


def frame(cameras: int, points, n, pos, quat, t):
    """The program's frame from a rendered frame of ``cameras`` cameras
    (arrays with a leading camera axis)."""
    if cameras == 1:
        return dm.Frame(points[0], int(n[0]), pos[0], quat[0],
                        np.float32(t[0]))
    return dm.stack_frames([dm.Frame(points[c], int(n[c]), pos[c], quat[c],
                                     np.float32(t[c]))
                            for c in range(cameras)])


def readout(state, cfg, threshold: float):
    """``get_occupancy_map``: ``(occupied, centers, future, new_state)``."""
    return dm.get_occupancy_map(state, cfg, threshold)


def release(step) -> None:
    """Free a graphed step's graphs and pools."""
    if hasattr(step, "release"):
        step.release()


def to_tree(obj):
    """A state (dataclasses of tensors and host values) as a tree of
    namespaces holding numpy arrays and host values; the generator is left
    out."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return types.SimpleNamespace(**{
            f.name: to_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not isinstance(getattr(obj, f.name), torch.Generator)})
    if isinstance(obj, np.ndarray):
        return obj.copy()
    return obj
