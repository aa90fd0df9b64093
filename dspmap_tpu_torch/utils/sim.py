"""Synthetic depth-camera scene generator: the JAX package's numpy-only
``utils/sim.py`` loaded by path (one source of truth, no jax import)."""

from __future__ import annotations

from .._jaxfree import load

_sim = load("utils/sim.py", "dspmap_tpu_torch._sim_src")

Box = _sim.Box
Scene = _sim.Scene
street_scene = _sim.street_scene
occlusion_scene = _sim.occlusion_scene
occlusion_sequence = _sim.occlusion_sequence
fast_ego_sequence = _sim.fast_ego_sequence
render_frame = _sim.render_frame
generate_sequence = _sim.generate_sequence
