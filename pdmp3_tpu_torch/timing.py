"""Device times of the port's kernels on a CUDA card.

A kernel's time is what the card spends on it, not what one Python call
costs: a wrapper checks its operands, allocates its outputs and calls
the C entry point before the kernel is queued, and when the card waits
on that host work, events around a single call count the wait as kernel
time.  Three figures, all from CUDA events, never from a host clock:

- ``graph_ms``: the calls captured into one CUDA graph, the graph
  replayed between two events, over the calls; the median of several
  replays.  The kernel's own time even where the host cannot keep up (a
  kernel over one slot): a replay queues the launches without the
  wrapper, so only the graph's gap between two launches (under a
  microsecond on an H100, PERF.md) is added to each.
- ``burst_ms``: events before and after a burst of back-to-back calls,
  one synchronisation, divided by the calls; the median of several
  bursts, after a warm-up.  The kernel's time wherever the host enqueues
  faster than the card runs (a kernel over many slots).
- ``per_call_ms``: events around one call, synchronised after each; the
  launcher's host time included (kept beside the others to compare).

Device times come from events and not from ``torch.profiler``: on an
H100 a profiler session sometimes recorded only some of the launches it
ran, or none (PERF.md).

``fn`` is called with no arguments and must not allocate what the
caller can allocate outside it: outputs and cloned state belong before
the timed window.  It must be capturable into a CUDA graph: kernel
launches and tensor ops on the current stream, no synchronisation and
no copy to the host.
"""
from __future__ import annotations

import numpy as np
import torch

GRAPH_REPLAYS = 5


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def burst_ms(fn, calls: int = 25, bursts: int = 5, warmup: int = 3) -> float:
    """Median over `bursts` of the device time per call of `calls`
    back-to-back calls of fn."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(bursts):
        a, b = _events()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def per_call_ms(fn, calls: int = 25) -> float:
    """Median over `calls` of events around one call of fn, synchronised
    after each: the launcher's host time included."""
    times = []
    for _ in range(calls):
        a, b = _events()
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, calls: int = 25) -> float:
    """Median over GRAPH_REPLAYS replays of the device time per call of
    one CUDA graph that holds `calls` calls of fn, after 3 calls outside
    it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        a, b = _events()
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del g  # its private memory pool goes with it
    return float(np.median(times))


def kernel_times(fn, calls: int = 25) -> dict:
    """A kernel's three figures: {ms (graph_ms, device time per launch),
    burst_ms, per_call_ms}."""
    return {"ms": graph_ms(fn, calls),
            "burst_ms": burst_ms(fn, calls),
            "per_call_ms": per_call_ms(fn, calls)}
