"""Tracing & metrics.

Counterpart of ``pdmp3_tpu/utils/trace.py``, and three things:

- ``StageTimer``: wall-clock stage timers and counters, as in the JAX
  package.
- ``RECORDER`` and ``span(name)``: the program's own spans.  The pools
  and the model step open a span around each part of a step (the span
  table of ``PERF.md``).  While a ``torch.profiler`` session records, a
  span adds its seconds and count to ``RECORDER``, which the
  benchmark's traced runs read (``RECORDER.spans()``); otherwise it is a
  shared no-op and records nothing.  Inside ``Trace`` it is besides a
  profiler annotation, so it lands in the trace beside the device's
  kernels and copies, on the same clock.
- ``Trace(dir)``: a ``torch.profiler`` session over the CPU and the
  card that writes one Chrome trace for perfetto or chrome://tracing.
  A profiler session can lose kernel launches on an H100: the benchmark
  takes device times from its trace only where the trace holds every
  launch the port's counters saw (``pdmp3_tpu_torch.tools.launches``);
  a kernel's time alone comes from CUDA events
  (``pdmp3_tpu_torch.timing``).
"""
from __future__ import annotations

import collections
import contextlib
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler


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

    def reset(self):
        """Forget every stage and count."""
        self.totals.clear()
        self.counts.clear()

    def spans(self) -> dict:
        """{stage: (seconds, count)} of every timed stage, unrounded."""
        return {name: (sec, self.counts[name])
                for name, sec in self.totals.items()}


# the program's spans (``span``), recorded while a profiler session records
RECORDER = StageTimer()

# whether spans are profiler annotations too: inside ``Trace`` alone
_annotate = False


class _Off:
    """What ``span`` gives while no profiler session records: nothing.
    ``__enter__`` and ``__exit__`` are one C function, an empty string's
    ``format``: it takes any arguments and returns "", which is false, so
    an exception in the span's body propagates.  Python methods in their
    place cost a frame a call: an idle span about 40% dearer."""

    __slots__ = ()
    __enter__ = __exit__ = staticmethod("".format)


_OFF = _Off()


class _On:
    """A span while a profiler session records: ``RECORDER``'s totals
    and counts, as ``StageTimer.stage`` keeps them but without its
    generator frame, and inside ``Trace`` the profiler's cheapest
    annotation (``_RecordFunctionFast``, a CPU op of the span's name).
    The annotation stays out of other sessions, the benchmark's among
    them: on an H100 host it costs 2-8 us a span, and a dozen a step
    raised a traced MPEG-1 window's idle share by 10-20 points and slowed
    the host inside ``advance`` by a fifth, where the recorder alone
    reads as no spans at all.  The clock includes the annotation's own
    cost, as the benchmark's spans around the program's calls do."""

    __slots__ = ("_name", "_note", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._note = _RecordFunctionFast(name) if _annotate else None

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self._note is not None:
            self._note.__enter__()

    def __exit__(self, *exc):
        if self._note is not None:
            self._note.__exit__(*exc)
        RECORDER.totals[self._name] += time.perf_counter() - self._t0
        RECORDER.counts[self._name] += 1


def span(name: str):
    """A context over one part of the program's work: while a
    ``torch.profiler`` session records, a ``RECORDER`` stage named
    `name` (inside ``Trace`` also a profiler annotation), else a shared
    no-op (one flag read)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


@contextlib.contextmanager
def Trace(dirname: str | None = None):
    """``torch.profiler`` scope over every activity this build of PyTorch
    can trace (the CPU, and CUDA where built for it) that writes one
    Chrome trace file (``*.pt.trace.json``) into dirname at its end, the
    program's spans in it as annotations; a no-op when dirname is
    None."""
    global _annotate
    if dirname is None:
        yield
        return
    from torch.profiler import (profile, supported_activities,
                                tensorboard_trace_handler)
    was, _annotate = _annotate, True
    try:
        with profile(activities=supported_activities(),
                     on_trace_ready=tensorboard_trace_handler(dirname)):
            yield
    finally:
        _annotate = was
