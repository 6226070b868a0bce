"""Device times of the port's kernels on a CUDA card.

A kernel's time is what the card spends on it, not what one Python call
costs: a wrapper checks its operands, allocates its outputs and calls
the C entry point before the kernel is queued, and when the card waits
on that host work, events around a single call count the wait as kernel
time.  Three figures, all from CUDA events or the profiler, never from a
host clock:

- ``burst_ms``: events before and after a burst of back-to-back calls,
  one synchronisation, divided by the calls; the median of several
  bursts, after a warm-up.  The kernel's time wherever the host enqueues
  faster than the card runs (a kernel over many slots).
- ``profiled_ms``: each launch's device time from ``torch.profiler``
  (CUPTI), the median over a burst; the kernel's own time even where
  the host cannot keep up (a kernel over one slot).
- ``per_call_ms``: events around one call, synchronised after each; the
  launcher's host time included (the figure this module replaces, kept
  beside the others to compare).

``fn`` is called with no arguments and must not allocate what the
caller can allocate outside it: outputs and cloned state belong before
the timed window.
"""
from __future__ import annotations

import numpy as np
import torch


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


def profiled_ms(fn, kernel: str, calls: int = 25, warmup: int = 3) -> float:
    """Median device time of the launches of the kernels whose name
    contains `kernel` over `calls` calls of fn, from torch.profiler;
    raises RuntimeError when the profiler recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not us:
        raise RuntimeError(f"the profiler recorded no launch of {kernel!r}")
    return float(np.median(us)) / 1e3


def kernel_times(fn, kernel: str, calls: int = 25) -> dict:
    """A kernel's three figures: {ms (device time per launch), burst_ms,
    per_call_ms}."""
    return {"ms": profiled_ms(fn, kernel, calls),
            "burst_ms": burst_ms(fn, calls),
            "per_call_ms": per_call_ms(fn, calls)}
