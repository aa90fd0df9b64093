"""Checkpoint / resume in the JAX package's file format, so a checkpoint
crosses between the two packages in both directions.

The JAX writer (``dspmap_tpu/io/checkpoint.py``) stores one array a leaf,
``leaf_0`` ... ``leaf_29``, in the order of ``jax.tree.flatten(state)``:
the ``data_fields`` of the JAX ``MapState`` and of its nested dataclasses.
:data:`LEAVES` holds that order and each leaf's dtype once; both functions
here walk it, so a file written by either package loads in the other with
every leaf but the random key bit for bit.

The random key (``leaf_12``, uint32 ``[2]`` in JAX, from
``jax.random.key_data``) has no torch counterpart; the port draws from the
``torch.Generator`` in :attr:`MapState.gen`.  :func:`save_state` writes
``leaf_12`` as two words of a hash of the generator's state, without
drawing from it, and the generator's exact state beside it
(``torch_gen_state``, with its device type in ``torch_gen_device``).  The
JAX loader reads ``leaf_i`` only.  :func:`load_state` restores the exact
generator when the file has one from the same kind of device (a port save
loaded by the port on the CPU, or on a card); otherwise (a JAX file, or a
card's generator loaded on the CPU) it seeds a new generator from
``leaf_12``, since JAX's key stream has no torch counterpart.

Config-switch hazard (velocity-clamp invariant): the step keeps "velocities
conform to the motion model" as a write-site invariant (vz == 0 on every
slot under ``limit_motion_to_xy_plane``, v == 0 under the static model), and
the occupancy kernel leaves the invariant-zero planes out of its I/O.  A
state saved under a free-motion configuration and resumed under a clamped
one breaks it, so :func:`load_state` re-applies the clamp of ``cfg``
(``sanitize=True``): a no-op for a matched configuration.

Only the ``.npz`` backend exists; the JAX package's ``orbax`` backend needs
a package the port does not depend on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import types
from pathlib import Path

import numpy as np
import torch

from ..state import MapState, state_from_numpy, state_to_numpy

_F32, _I32, _BOOL = np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.bool_)

#: the JAX ``MapState``'s leaves in ``jax.tree.flatten`` order: (path in
#: :func:`~dspmap_tpu_torch.state.state_to_numpy`'s tree, dtype); ``rng`` is
#: the key's raw data
LEAVES = (
    *((f"particles.{n}", _I32 if n == "flags" else _F32)
      for n in ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t")),
    ("weight_sum", _F32), ("vel_avg", _F32), ("future", _F32),
    ("rng", np.dtype(np.uint32)),
    ("sensor_pos", _F32), ("last_sensor_pos", _F32), ("origin", _I32),
    ("update_time", _F32), ("last_timestamp", _F32),
    ("update_counter", _I32), ("initialized", _BOOL),
    ("estimator.prev_centers", _F32), ("estimator.prev_point_num", _I32),
    ("estimator.prev_intensity", _F32), ("estimator.prev_valid", _BOOL),
    *((f"params.{n}", _F32)
      for n in ("sigma_ob", "position_noise_std", "velocity_noise_std",
                "p_detection", "kappa", "newborn_particle_weight")),
)


def _check_backend(backend: str) -> None:
    if backend != "npz":
        raise ValueError(f"checkpoint backend {backend!r} is not available in "
                         "the port; use backend='npz'")


def _get(tree: dict, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _shape(state: MapState, path: str) -> tuple:
    x = state
    for key in path.split("."):
        x = getattr(x, key)
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _key_data(gen: torch.Generator) -> np.ndarray:
    """Two uint32 words of a hash of ``gen``'s state (no draw)."""
    digest = hashlib.sha256(gen.get_state().numpy().tobytes()).digest()
    return np.frombuffer(digest[:8], np.uint32).copy()


def save_state(state: MapState, path, backend: str = "npz") -> None:
    """Write ``state`` to ``path`` as the JAX package's ``.npz`` checkpoint,
    plus the generator's exact state (module docstring).  Draws nothing."""
    _check_backend(backend)
    tree = state_to_numpy(state)
    arrays = {}
    for i, (name, dtype) in enumerate(LEAVES):
        value = _key_data(state.gen) if name == "rng" else _get(tree, name)
        arrays[f"leaf_{i}"] = np.asarray(value, dtype)
    np.savez_compressed(
        Path(path), **arrays,
        torch_gen_state=state.gen.get_state().numpy(),
        torch_gen_device=np.asarray(state.gen.device.type))


def load_state(template: MapState, path, backend: str = "npz", cfg=None,
               sanitize: bool = True) -> MapState:
    """Restore a checkpoint of either package into the structure of
    ``template`` (same configuration and shapes), every tensor on the
    template's device.  Raises ``ValueError`` on a leaf whose shape or dtype
    differs from the template's.

    The generator: see the module docstring.  ``cfg`` (a
    :class:`~dspmap_tpu_torch.config.MapConfig`) re-applies its motion
    model's velocity clamp, on the template's device; ``sanitize=False``
    skips it (a bit-exact restore)."""
    _check_backend(backend)
    device = template.device
    with np.load(Path(path)) as data:
        leaves = {}
        for i, (name, dtype) in enumerate(LEAVES):
            arr = data[f"leaf_{i}"]
            shape = (2,) if name == "rng" else _shape(template, name)
            if arr.shape != shape or arr.dtype != dtype:
                raise ValueError(
                    f"checkpoint leaf_{i} ({name}) is {arr.dtype}{arr.shape}; "
                    f"the template needs {dtype}{shape}")
            leaves[name] = arr
        gen_state = (data["torch_gen_state"]
                     if "torch_gen_state" in data.files
                     and str(data["torch_gen_device"]) == device.type
                     else None)

    def fields(prefix):
        return types.SimpleNamespace(**{
            name[len(prefix):]: leaf for name, leaf in leaves.items()
            if name.startswith(prefix)})

    top = {name: leaf for name, leaf in leaves.items() if "." not in name}
    state = state_from_numpy(types.SimpleNamespace(
        **top, particles=fields("particles."), estimator=fields("estimator."),
        params=fields("params.")), cfg, device)
    gen = torch.Generator(device=device)
    if gen_state is not None:
        gen.set_state(torch.from_numpy(gen_state.copy()))
    else:
        k0, k1 = (int(x) for x in leaves["rng"])
        gen.manual_seed(k0 << 32 | k1)
    state = dataclasses.replace(state, gen=gen)
    return _sanitize(state, cfg) if sanitize else state


def _sanitize(state: MapState, cfg) -> MapState:
    """Re-apply ``cfg``'s velocity clamp (vz = 0 under limit-xy, v = 0 in
    the static model) on the state's device; ``cfg=None`` leaves the state
    as it is."""
    if cfg is None:
        return state
    from ..models.pipeline import _clamp_velocities

    return dataclasses.replace(
        state, particles=_clamp_velocities(state.particles, cfg))
