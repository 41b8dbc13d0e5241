"""Everything of a cell found by name: the manifest (``BENCHMARK.json``
beside the benchmark's folder), a configuration (``configs/<name>.json``),
a traffic mix (``mixes/<name>.json``), the limits of a cell's compared
numbers (``limits/<workload>.json``), and the readers of end-to-end
(``end_to_end/<metric>.py``) and per-layer (``metrics/<metric>.py``)
metrics, each a module with ``read(ctx)``. A metric named ``<base>.<part>``
with no file of its own is read by ``<base>.py``: one reader serves the
names that split a quantity by the cells that report it. A later change
adds a cell by adding such files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root(root: str = BENCH) -> str:
    return os.path.dirname(root)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = BENCH) -> Dict:
    return _json(os.path.join(repo_root(root), "BENCHMARK.json"))


def workload(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in man['workloads']]}")


def config(root: str, name: str) -> Dict:
    return _json(os.path.join(root, "configs", f"{name}.json"))


def mix(root: str, name: str) -> Dict:
    return _json(os.path.join(root, "mixes", f"{name}.json"))


def limits(root: str, cell: str) -> Dict[str, float]:
    return _json(os.path.join(root, "limits", f"{cell}.json"))


def metrics_of(man: Dict, kind: str, cell: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    that list it, and those that list no cells."""
    return [m for m in man[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader_path(root: str, kind: str, name: str) -> str:
    """``<root>/<kind>/<name>.py``, else ``<root>/<kind>/<base>.py`` for a
    name ``<base>.<part>`` (``kind``: ``end_to_end`` or ``metrics``)."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(root, kind, f"{stem}.py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader for {kind} metric {name!r} under "
                            f"{os.path.join(root, kind)}")


def reader(root: str, kind: str, name: str):
    """The module that reads metric ``name`` (:func:`reader_path`)."""
    path = reader_path(root, kind, name)
    mod_name = "portbench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
