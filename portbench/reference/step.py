"""The pool layout's reference, the one a configuration names by leaving
out its file's ``reference`` key: the reference's side of a compared frame,
and the control.

A reference is a module (or package) under ``portbench/reference/`` with
this interface: ``config(values)`` (a configuration file's ``config``, with
the sizes that follow), ``shapes(c)`` (held against the file's
``shapes``), ``init_tree(c, cameras, sensor_pos)`` (a fresh map) and
``run(c, cameras, tree, frame, draws, threshold, control=False)``; it may
define ``make_draws(c, cameras, seed, device)`` where the frame takes
other draws than ``harness.make_draws`` makes.

:func:`run` takes a state read back from the program before a frame (a
tree of numpy arrays and host values), the frame as the traffic rendered
it, and the frame's random draws, and computes the frame with the plain
NumPy step of :mod:`.dsp` on the CPU: the state after it and the occupancy
readout that follows.  With ``control=True`` it computes the same in the
nearest precision below the configuration's: every float32 value of the
state, the frame and the draws, and of what the step returns, rounded to
bfloat16, and the one matrix product (the clustering's Gram matrix, which
the configuration keeps in full float32) with its operands rounded to
TF32.  A program that computed so must come out not correct.
"""

from __future__ import annotations

import types

import numpy as np

from . import dsp

config = dsp.config
init_tree = dsp.init_tree
to_bf16 = dsp.to_bf16
to_tf32 = dsp.to_tf32


def shapes(c, layout: str = "pool", rows=None) -> dict:
    """The sizes a configuration file's ``shapes`` states, as the
    reference derives them."""
    return {"storage_voxels": c.V, "slots_per_voxel": c.S,
            "n_pyramids": c.n_pyr, "layout": layout, "compact_capacity": rows,
            "max_input_points": c.max_input_points, "n_horizons": c.T}


def _numpy(x):
    """A draw as a float32 numpy array (a tensor is read back)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def map_draws(fn, draws):
    """``fn`` of each array in a nest of draws (``None`` kept)."""
    if draws is None:
        return None
    if isinstance(draws, (tuple, list)):
        return tuple(map_draws(fn, d) for d in draws)
    return fn(draws)


def _round_tree(tree, fn):
    """``tree`` with ``fn`` applied to every float32 array in it."""
    if isinstance(tree, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: _round_tree(v, fn)
                                        for k, v in vars(tree).items()})
    if isinstance(tree, np.ndarray) and tree.dtype == np.float32:
        return fn(tree)
    return tree


def run(c, cameras: int, tree, frame, draws, threshold: float,
        control: bool = False):
    """One frame of the plain step from the state ``tree``: ``(state after
    it as a tree, readout)`` with the readout ``{"occupied": bool [V],
    "centers": f32 [V, 3], "future": f32 [V, T]}`` at ``threshold``.
    ``control`` computes it in the lower precision (see the module's
    docstring)."""
    return run_with(dsp.step, c, tree, frame, draws, threshold, control)


def run_with(step, c, tree, frame, draws, threshold: float, control: bool):
    """:func:`run` with ``step(tree, frame, draws, c, tf32=...)`` as the
    frame's plain step (a layout's own)."""
    draws = map_draws(_numpy, draws)
    points, n, pos, quat, t = frame
    points = np.asarray(points, np.float32)
    if control:
        tree = _round_tree(tree, to_bf16)
        draws = map_draws(to_bf16, draws)
        points = to_bf16(points)
    frame = (points, np.asarray(n), np.asarray(pos, np.float32),
             np.asarray(quat, np.float32), np.asarray(t, np.float32))
    after = step(tree, frame, draws, c, tf32=control)
    readout = dsp.readout(after, c, threshold)
    if control:
        after = _round_tree(after, to_bf16)
        readout = {k: (to_bf16(v) if v.dtype == np.float32 else v)
                   for k, v in readout.items()}
    return after, readout
