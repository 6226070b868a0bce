"""A cell of the benchmark, found by name from ``BENCHMARK.json``.

A cell names a configuration (``benchmark/configs/<config>.json``: its
streams, their format, the pool, the contract and its limits, the
kernel the pool launches, the control, and by name the modules that
know its format: its stream reader, its plain reference and the bytes of
one launch of its kernel, ``NAMED``), a traffic mix (``benchmark/
traffic/<traffic>.json``: the driver of its window, how many streams it
uses, the watched slots; it may set the pool's arguments and the kernel
the trace counts, "pool" and "kernel", over the configuration's) and,
through the metrics that list it, its end-to-end metrics and its
per-layer metrics.  A driver is a file ``benchmark/drivers/<driver>.py``
(``drive``); a metric is read by a file ``benchmark/metrics/
<metric>.py`` (a function ``read(run)`` that returns the number, or
None where it finds nothing to read).  A new cell, configuration,
stream format, traffic mix, driver or metric is a new file and an entry
in ``BENCHMARK.json``: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re

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


# the modules a configuration names, by the key that names each (a
# dotted key lies in a nested entry) and the folder under benchmark/
# that holds them: its stream reader (``frames``, ``stats``), its plain
# reference (``periods``; ``TF32`` where it has the reference_tf32
# control's path) and the bytes of one launch of its kernel
# (``launch_bytes``)
NAMED = {"reader": "readers", "reference": "reference",
         "kernel.bytes": "kernel_bytes"}


def named(config: dict, key: str, root: str = ROOT):
    """The module that the configuration's `key` (of ``NAMED``) names,
    ``benchmark.<folder>.<name>``; ValueError, naming the key and the
    module, where the configuration names none or no such file is in
    root's benchmark/."""
    folder, name = NAMED[key], config
    for part in key.split("."):
        name = name.get(part) if isinstance(name, dict) else None
    where = f"configuration {config.get('name')!r}"
    if name is None:
        raise ValueError(f'{where} names no "{key}": a module of '
                         f"benchmark/{folder}/")
    path = f"benchmark/{folder}/{name}.py"
    if not (isinstance(name, str) and re.fullmatch(r"[A-Za-z0-9_]+", name)
            and os.path.isfile(os.path.join(root, path))):
        raise ValueError(f'{where}: "{key}" names {name!r}, and there is '
                         f"no {path}")
    return importlib.import_module(f"benchmark.{folder}.{name}")


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of root's BENCHMARK.json (KeyError if none);
    ValueError where its configuration lacks a module of ``NAMED``, or
    asks for the reference_tf32 control of a reference without one."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(_load_json(os.path.join(root, cfg_entry["file"])),
                  name=w["config"])
    traffic = dict(_load_json(os.path.join(
        root, "benchmark", "traffic", w["traffic"] + ".json")),
        name=w["traffic"])
    kernel = {**config.get("kernel", {}), **traffic.get("kernel", {})}
    mods = {key: named(dict(config, kernel=kernel), key, root)
            for key in NAMED}
    if (config["control"]["kind"] == "reference_tf32"
            and not getattr(mods["reference"], "TF32", False)):
        raise ValueError(
            f"configuration {w['config']!r} asks for the reference_tf32 "
            f"control, and its reference benchmark/reference/"
            f"{config['reference']}.py has no TF32 path")
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
