"""Load a jax-free module of the JAX package by file path.

``dspmap_tpu/__init__.py`` imports jax, so ``import dspmap_tpu.config``
would pull jax in even though ``config.py`` itself needs only the standard
library.  Loading the file by path keeps one source of truth for the
configuration and the scene generator while the port stays importable on
a machine without jax.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

_JAX_PKG = pathlib.Path(__file__).resolve().parent.parent / "dspmap_tpu"


def load(relpath: str, name: str):
    """Import ``dspmap_tpu/<relpath>`` as module ``name`` (cached in
    ``sys.modules`` so every caller shares one copy of its classes)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _JAX_PKG / relpath)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {_JAX_PKG / relpath}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
