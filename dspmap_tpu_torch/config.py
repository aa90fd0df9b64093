"""Map configuration: the JAX package's ``config.py`` loaded by path.

``MapConfig``, the presets and ``example_node_settings`` live in exactly one
place (``dspmap_tpu/config.py``, which imports only ``dataclasses``, ``math``
and ``typing``).  The port reads none of the ``use_pallas_*`` flags: on a
CUDA tensor its kernels always run.
"""

from __future__ import annotations

from ._jaxfree import load

_cfg = load("config.py", "dspmap_tpu_torch._config_src")

MapConfig = _cfg.MapConfig
dsp_dynamic = _cfg.dsp_dynamic
dsp_dynamic_multi_neighbors = _cfg.dsp_dynamic_multi_neighbors
dsp_static = _cfg.dsp_static
large_urban = _cfg.large_urban
example_node_settings = _cfg.example_node_settings
performance_level_parameters = _cfg.performance_level_parameters
