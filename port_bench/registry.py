"""Finds a cell's files by name: ``BENCHMARK.json`` at the checkout's root,
``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py`` and
``loops/<loop>.py``. Adding a cell, a configuration, a traffic mix or a
metric adds files; no file here names them."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in bench['workloads']]})")


def workload(name: str, base: str = HERE) -> Dict[str, Any]:
    return _load(os.path.join(base, "workloads", f"{name}.json"))


def config(name: str, base: str = HERE) -> Dict[str, Any]:
    return _load(os.path.join(base, "configs", f"{name}.json"))


def traffic(name: str, base: str = HERE) -> Dict[str, Any]:
    return _load(os.path.join(base, "traffic", f"{name}.json"))


def resolve(bench: Dict[str, Any], name: str, base: str = HERE):
    """``(cell entry, workload, config, traffic)`` of cell ``name``; the
    workload file must agree with ``BENCHMARK.json`` on the configuration,
    the traffic and the chips."""
    entry = cell(bench, name)
    wl = workload(name, base)
    for key in ("config", "traffic", "chips"):
        if wl.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key}="
                             f"{wl.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return entry, wl, config(entry["config"], base), \
        traffic(entry["traffic"], base)


def metrics_for(bench: Dict[str, Any], name: str, kind: str
                ) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` entries that cell ``name``
    reports: those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def metric_reader(name: str, base: str = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py`` (a name may
    hold dots, so the file is loaded by path)."""
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loop(name: str):
    return importlib.import_module(f"port_bench.loops.{name}")


def family(kind: str, name: str):
    """``program/<name>.py`` (the port's side) or ``reference/<name>.py``
    (the plain side) of a model family."""
    return importlib.import_module(f"port_bench.{kind}.{name}")
