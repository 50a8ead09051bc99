"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each lives in a file of its own, and so does everything they name:

- ``configs`` entry ``file``: the program's TOML with a ``[bench]`` table,
  whose ``reference`` names the scene's plain reference,
  ``reference/<reference>.py`` (the functions listed at the end of
  ``reference/physics.py``);
- ``traffic/<traffic>.toml``: the mix's parameters, read by the general
  generator (:mod:`spectrobench.inputs`) and by the driver of its
  ``kind``, ``kinds/<kind>.py`` (a class ``Driver``, see
  :mod:`spectrobench.drivers`);
- ``metrics/<metric>.py``: ``read(rec)`` -> a number, or None where the
  run holds nothing to read;
- ``limits/<cell>.toml``: the limit of each number the cell compares.

Adding a cell, a configuration, a scene, a mix, a kind of traffic or a
metric is adding files and entries: nothing here lists them.

``pending.json`` holds entries of the same form for cells that are built
and checked but not in ``BENCHMARK.json`` (its ``about`` says why); the
tests and ``spectrobench.calibrate`` read them with ``pending=True``, a
run of the benchmark never does.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import tomllib
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


def load(pending: bool = False) -> dict:
    """``BENCHMARK.json``; with ``pending`` also ``pending.json``'s entries
    whose names it does not hold."""
    with open(REPO / "BENCHMARK.json") as f:
        man = json.load(f)
    if pending:
        with open(HERE / "pending.json") as f:
            more = json.load(f)
        for group in GROUPS:
            have = {e["name"] for e in man[group]}
            man[group] += [e for e in more.get(group, [])
                           if e["name"] not in have]
    return man


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in man['workloads']]})")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config_path(man: dict, name: str) -> Path:
    return REPO / config(man, name)["file"]


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.toml"


def traffic(name: str) -> dict:
    with open(traffic_path(name), "rb") as f:
        return tomllib.load(f)


def limits_path(cell: str) -> Path:
    return HERE / "limits" / f"{cell}.toml"


def limits(cell: str) -> dict:
    """{number: limit} of the cell's comparison."""
    with open(limits_path(cell), "rb") as f:
        return {k: float(v["limit"]) for k, v in tomllib.load(f).items()}


def _module(folder: str, name: str):
    """The module ``<folder>/<name>.py``, loaded by path once and kept
    under the name ``spectrobench.<folder>.<name>``."""
    full = f"spectrobench.{folder}.{name}"
    if full not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            full, HERE / folder / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[full]
            raise
    return sys.modules[full]


def reference(name: str):
    """The plain reference module ``reference/<name>.py``."""
    return _module("reference", name)


def driver(kind: str):
    """The driver class of a traffic ``kind``, ``kinds/<kind>.py``."""
    return _module("kinds", kind).Driver


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py`` (loaded by path: a
    metric's name may hold dots)."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "spectrobench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(man: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics with
    ``trace`` false, its per-layer metrics with ``trace`` true (an entry
    without ``workloads`` holds for every cell)."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
