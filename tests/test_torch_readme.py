"""The README's two quick starts run against their own packages: the JAX
one (under "## Quick start", ``import dspmap_tpu as dm``) and the port's
(under "## PyTorch / H100 port", ``import dspmap_tpu_torch as dm``).

Each block is parsed, not run (it reads the caller's frames).  Every
import must resolve, every ``dm.<name>`` must be an attribute of the
block's own package, and every call of a function of that package --
``dm.<name>(...)`` or a name the block imports from it -- must bind to
the function's signature (``init_multisensor_state(cfg, 2, seed=0)`` is
the port's call and does not bind to the JAX function, which takes a
key)."""

import ast
import importlib
import inspect
import pathlib
import re

import pytest

README = pathlib.Path(__file__).resolve().parent.parent / "README.md"
#: heading -> the package its first python block imports as ``dm``
BLOCKS = {"## Quick start": "dspmap_tpu",
          "## PyTorch / H100 port": "dspmap_tpu_torch"}


def _block(heading):
    text = README.read_text()
    at = text.index("\n" + heading + "\n")
    m = re.compile(r"```python\n(.*?)```", re.S).search(text, at)
    return ast.parse(m.group(1))


def _imports(tree):
    """``(module, name or None, alias)`` of every import of the block."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, None, a.asname or a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                yield node.module, a.name, a.asname or a.name


def _resolve(module, name):
    """``from module import name``: an attribute, or a submodule."""
    mod = importlib.import_module(module)
    if name is None or hasattr(mod, name):
        return mod if name is None else getattr(mod, name)
    return importlib.import_module(f"{module}.{name}")


def _bound(tree, package):
    """The block's names bound to its package or to an object of it, by
    alias."""
    out = {}
    for module, name, alias in _imports(tree):
        if module.split(".")[0] != package:
            continue
        out[alias] = _resolve(module, name)
    return out


@pytest.mark.parametrize("heading", list(BLOCKS))
def test_quick_start_imports_resolve_on_its_own_package(heading):
    tree, package = _block(heading), BLOCKS[heading]
    seen = list(_imports(tree))
    assert ("dm" in {alias for _, _, alias in seen}
            and (package, None, "dm") in seen), seen
    for module, name, _ in seen:
        root = module.split(".")[0]
        assert root in (package, "jax", "torch", "numpy"), (
            f"{heading}: imports {module}, not of {package}")
        try:
            _resolve(module, name)
        except (ImportError, AttributeError) as e:
            pytest.fail(f"{heading}: from {module} import {name}: {e}")


@pytest.mark.parametrize("heading", list(BLOCKS))
def test_quick_start_dm_names_resolve_on_its_own_package(heading):
    tree, package = _block(heading), BLOCKS[heading]
    dm = importlib.import_module(package)
    names = {n.attr for n in ast.walk(tree)
             if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
             and n.value.id == "dm"}
    assert len(names) >= 8, names
    missing = sorted(n for n in names if not hasattr(dm, n))
    assert not missing, f"{heading}: {package} lacks {missing}"


@pytest.mark.parametrize("heading", list(BLOCKS))
def test_quick_start_calls_bind_to_their_signatures(heading):
    tree, package = _block(heading), BLOCKS[heading]
    bound = _bound(tree, package)
    checked = []
    for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
        f = call.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id in bound):
            fn, what = getattr(bound[f.value.id], f.attr, None), f.attr
        elif isinstance(f, ast.Name) and f.id in bound:
            fn, what = bound[f.id], f.id
        else:
            continue
        if not callable(fn) or inspect.isclass(fn):
            continue
        if any(isinstance(a, ast.Starred) for a in call.args) or any(
                k.arg is None for k in call.keywords):
            continue
        try:
            inspect.signature(fn).bind(*call.args,
                                       **{k.arg: k for k in call.keywords})
        except TypeError as e:
            pytest.fail(f"{heading}: {ast.unparse(call)} does not bind to "
                        f"{package}'s {what}: {e}")
        checked.append(what)
    assert {"init_state", "make_multisensor_step", "init_multisensor_state",
            "make_shardmap_step"} <= set(checked), checked
