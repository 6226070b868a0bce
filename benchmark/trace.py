"""The traced run's device timeline, from ``torch.profiler``.

The profiler starts at the window's start, in the run's own process, and
records the CPU (the harness's spans, as annotations) and the card.  Its
Chrome trace is written under the temporary directory, read, and
deleted.  From it:

- ``busy_s``: the union of the device's kernels, copies and sets within
  the window (the "window" annotation), and ``window_s``, its length;
- ``kernels_s``: the device seconds of every kernel within the window;
- the kernel launches of the cell's granule kernel, which must equal the
  port's own launch counter over the same span (a profiler run can
  lose launches; a run that finds fewer fails and reports no device
  metric), and their device seconds;
- ``breakdown``: the device operations that took most time, and the idle
  time of the device by the harness span that was open on the host.
"""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class LostLaunches(RuntimeError):
    """The profiler saw other launches of the cell's kernel than the port
    counted: its device times cannot be trusted."""


def verify(summary: dict, counted: int, kernel: str) -> None:
    """Raise LostLaunches unless the trace holds exactly the `counted`
    launches of `kernel` that the port's counter saw."""
    if summary["launches"] != counted:
        raise LostLaunches(
            f"the profiler saw {summary['launches']} launches of {kernel}, "
            f"the port counted {counted}: the profiler lost launches, so "
            "no device metric is reported")


class Profile:
    """torch.profiler over the CPU and CUDA."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def start(self):
        self._prof.__enter__()

    def stop(self) -> list:
        """Stop profiling; the trace events."""
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="benchmark_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


def _short(name: str) -> str:
    """A device operation's name without its return type and its
    argument list (which may nest parentheses)."""
    name = re.sub(r"^void ", "", name.strip())
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].strip() or name
    return name


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list, kernel: str) -> dict:
    """busy_s, window_s, every kernel's device seconds ("kernels_s"), the
    kernel's launches and device seconds ("launches", "kernel_s"),
    "device_ops" and "idle_gaps" for the breakdown, and "gaps": the ten
    longest idle gaps (label, seconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("cat") == "user_annotation"
           and e["name"] == "window"]
    if len(win) != 1:
        raise RuntimeError(f"trace holds {len(win)} window annotations")
    ws, we = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    kern = [e for e in dev if e.get("cat") == "kernel"
            and kernel in e["name"]]
    busy = _union((max(e["ts"], ws), min(e["ts"] + e["dur"], we))
                  for e in dev if e["ts"] < we and e["ts"] + e["dur"] > ws)
    busy_us = sum(b - a for a, b in busy)
    ops = collections.defaultdict(float)
    kernels_s = 0.0
    for e in dev:
        if e["ts"] < we and e["ts"] + e["dur"] > ws:
            sec = (min(e["ts"] + e["dur"], we) - max(e["ts"], ws)) * 1e-6
            ops[_short(e["name"])] += sec
            if e["cat"] == "kernel":
                kernels_s += sec
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                   if e.get("cat") == "user_annotation"
                   and e["name"] != "window")
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = collections.defaultdict(float)
    labelled = []
    j = 0
    for a, b in gaps:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        best, label = 0.0, "between spans"
        for s0, s1, name in spans[j:]:
            if s0 >= b:
                break
            ov = min(b, s1) - max(a, s0)
            if ov > best:
                best, label = ov, name
        idle[label] += (b - a) * 1e-6
        labelled.append((label, (b - a) * 1e-6))
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (we - ws) * 1e-6,
        "kernels_s": kernels_s,
        "launches": len(kern),
        "kernel_s": sum(e["dur"] for e in kern) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:TOP],
        "gaps": sorted(labelled, key=lambda g: -g[1])[:TOP],
    }
