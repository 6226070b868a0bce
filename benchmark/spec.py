"""A cell of the benchmark, found by name from ``BENCHMARK.json``.

A cell names a configuration (``benchmark/configs/<config>.json``: its
streams, their format, the pool, the contract and its limits, the
kernel the pool launches, the control), a traffic mix (``benchmark/
traffic/<traffic>.json``: the driver of its window, how many streams it
uses, the watched slots; it may set the pool's arguments and the kernel
the trace counts, "pool" and "kernel", over the configuration's) and,
through the metrics that list it, its end-to-end metrics and its
per-layer metrics.  A driver is a file ``benchmark/drivers/<driver>.py``
(``drive``); a metric is read by a file ``benchmark/metrics/
<metric>.py`` (a function ``read(run)`` that returns the number, or
None where it finds nothing to read).  A new cell, configuration,
traffic mix, driver or metric is a new file and an entry in
``BENCHMARK.json``: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, with its "name"
    traffic: dict         # the traffic mix's file, with its "name"
    end_to_end: list      # BENCHMARK.json metric entries of this cell
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of root's BENCHMARK.json (KeyError if none)."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(_load_json(os.path.join(root, cfg_entry["file"])),
                  name=w["config"])
    traffic = dict(_load_json(os.path.join(
        root, "benchmark", "traffic", w["traffic"] + ".json")),
        name=w["traffic"])
    return Cell(workload, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _in_cell(m, workload)],
                [m for m in bench["per_layer"] if _in_cell(m, workload)])


def _module(kind: str, name: str, root: str):
    path = os.path.join(root, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The read(run) function of benchmark/metrics/<metric>.py."""
    return _module("metrics", metric, root).read


def driver(name: str, root: str = ROOT):
    """The run(...) function of benchmark/drivers/<name>.py."""
    return _module("drivers", name, root).run
