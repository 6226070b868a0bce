"""Tracing & metrics.

Counterpart of ``pdmp3_tpu/utils/trace.py``: wall-clock stage timers
and counters (``StageTimer``, as in the JAX package), and an optional
``torch.profiler`` trace written as a Chrome trace for perfetto or
chrome://tracing.  The trace is for inspection only: on an H100 the
profiler's sessions have lost kernel launches, so device times are taken
with CUDA events (``pdmp3_tpu_torch.timing``), never from a trace.
"""
from __future__ import annotations

import collections
import contextlib
import time


class StageTimer:
    """Accumulating per-stage wall-clock timers + counters."""

    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def count(self, name: str, n: int = 1):
        self.counts[name] += n

    def report(self) -> dict:
        return {
            name: {"seconds": round(self.totals[name], 6),
                   "count": self.counts[name]}
            for name in sorted(set(self.totals) | set(self.counts))
        }


@contextlib.contextmanager
def Trace(dirname: str | None = None):
    """``torch.profiler`` scope over every activity this build of PyTorch
    can trace (the CPU, and CUDA where built for it) that writes one
    Chrome trace file (``*.pt.trace.json``) into dirname at its end; a
    no-op when dirname is None."""
    if dirname is None:
        yield
        return
    from torch.profiler import (profile, supported_activities,
                                tensorboard_trace_handler)
    with profile(activities=supported_activities(),
                 on_trace_ready=tensorboard_trace_handler(dirname)):
        yield
