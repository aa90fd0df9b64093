"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, cell, per-layer
metric or kernel sits in a file of its own under the benchmark's folder:

* ``configs/<config>.json``: the configuration's builder, its values and
  shapes (named by the configuration's ``file`` in ``BENCHMARK.json``),
  and under ``reference`` the name of its plain reference;
* ``reference/<name>.py`` (or a package ``reference/<name>/``): a plain
  reference, its interface that of ``reference/step.py``, the pool
  layout's, which a configuration file without ``reference`` names;
* ``traffic/<traffic>.json``: a mix's parameters, read by
  ``traffic/generator.py``;
* ``workloads/<cell>.json``: a cell's frames to compare and profile and the
  limit of each compared number;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``
  (its layer, unit, direction, source and the metric it moves are its
  entry in ``BENCHMARK.json``);
* ``roofline/<kernel>.py``: a kernel's bytes and operations a launch.

A later change adds a cell, a mix, a configuration or a metric by adding
such files and entries; no file of the harness changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# Each entry's keys ("workloads" optional on a metric) and its free texts.
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
TEXTS = ("why", "layer", "source")
#: the reference of a configuration file without a ``reference`` key
DEFAULT_REFERENCE = "step"
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


class Spec:
    """The benchmark rooted at ``repo`` (its ``BENCHMARK.json``) with its
    files under ``folder``."""

    def __init__(self, repo: pathlib.Path = HERE.parent,
                 folder: pathlib.Path = HERE):
        self.repo = pathlib.Path(repo)
        self.folder = pathlib.Path(folder)
        self.bench = json.loads((self.repo / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.repo / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def reference_name(self, config: str) -> str:
        return self.config(config).get("reference", DEFAULT_REFERENCE)

    def reference(self, config: str):
        """The plain reference the configuration ``config`` names, loaded
        from ``<folder>/reference/``."""
        return importlib.import_module(
            f"{self._reference_package()}.{self.reference_name(config)}")

    def _reference_package(self) -> str:
        """The importable name of ``<folder>/reference``: ``portbench.
        reference`` for the benchmark's own folder, a package of its own
        for another (a copy with files added)."""
        if self.folder.resolve() == HERE:
            return "portbench.reference"
        name = "portbench_reference_" + hashlib.blake2b(
            str(self.folder.resolve()).encode(), digest_size=6).hexdigest()
        if name not in sys.modules:
            init = self.folder / "reference" / "__init__.py"
            spec = importlib.util.spec_from_file_location(
                name, init, submodule_search_locations=[str(init.parent)])
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
        return name

    def traffic(self, name: str) -> dict:
        return json.loads((self.folder / "traffic" / f"{name}.json")
                          .read_text())

    def workload(self, name: str) -> dict:
        return json.loads((self.folder / "workloads" / f"{name}.json")
                          .read_text())

    def module(self, kind: str, name: str):
        """``<folder>/<kind>/<name>.py`` loaded as a module."""
        path = self.folder / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell])]

    def problems(self) -> list:
        """What in ``BENCHMARK.json`` and its files breaks the benchmark's
        rules (an empty list when nothing does)."""
        b, out = self.bench, []
        configs = {c["name"] for c in b["configs"]}
        cells = {w["name"]: w for w in b["workloads"]}
        e2e = {m["name"]: m for m in b["end_to_end"]}
        names = [c["name"] for c in b["configs"]] + list(cells) + [
            m["name"] for m in b["end_to_end"] + b["per_layer"]]
        out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
        for kind, keys in KEYS.items():
            for e in b[kind]:
                extra = {"workloads"} if kind in ("end_to_end",
                                                  "per_layer") else set()
                if not keys <= set(e) <= keys | extra:
                    out.append(f"{kind} {e.get('name')}: keys "
                               f"{sorted(set(e))}, not {sorted(keys)}")
                out += [f"{kind} {e.get('name')}: bad {t}" for t in TEXTS
                        if t in e and not (1 <= len(e[t]) <= 200 and not
                                           re.search(r"[\t\n\r]", e[t]))]
        if len(set(names)) != len(names):
            out.append("a name is used twice")
        for c in b["configs"]:
            path = self.repo / c["file"]
            if not path.is_file():
                out.append(f"configuration file {c['file']} is missing")
                continue
            data = json.loads(path.read_text())
            if data.get("reduced", []) != c["reduced"]:
                out.append(f"{c['name']}: reduced differs from its file")
            ref = data.get("reference", DEFAULT_REFERENCE)
            where = self.folder / "reference"
            if not (isinstance(ref, str) and MODULE.match(ref) and (
                    (where / f"{ref}.py").is_file()
                    or (where / ref / "__init__.py").is_file())):
                out.append(f"{c['name']}: no reference module {ref!r} "
                           "under reference/")
        for w in cells.values():
            if w["config"] not in configs:
                out.append(f"{w['name']}: no configuration {w['config']}")
            for kind, name in (("traffic", w["traffic"]),
                               ("workloads", w["name"])):
                if not (self.folder / kind / f"{name}.json").is_file():
                    out.append(f"{w['name']}: no {kind}/{name}.json")
        used = {w["config"] for w in cells.values()}
        out += [f"configuration {c} has no cell" for c in configs - used]
        if "setup_s" not in e2e:
            out.append("no setup_s")
        for m in b["end_to_end"] + b["per_layer"]:
            if not UNIT.match(m["unit"]) or m["better"] not in (
                    "lower", "higher") or m["source"] not in SOURCES:
                out.append(f"{m['name']}: bad unit, better or source")
            out += [f"{m['name']}: no cell {c}"
                    for c in m.get("workloads", []) if c not in cells]
        for m in b["per_layer"]:
            if m["moves"] not in e2e:
                out.append(f"{m['name']}: moves {m['moves']}, no such "
                           "end-to-end metric")
                continue
            for c in m.get("workloads", cells):
                if c not in e2e[m["moves"]].get("workloads", cells):
                    out.append(f"{m['name']} in {c}, which does not report "
                               f"{m['moves']}")
            path = self.folder / "metrics" / f"{m['name']}.py"
            if not path.is_file():
                out.append(f"{m['name']}: no reader metrics/{m['name']}.py")
        return out
