"""What every driver of a cell's window shares.  A driver is a file
``benchmark/drivers/<name>.py``, named by the traffic mix's "driver", with
a function ``run(pool, corpus, traffic, seconds, spans, window) ->
Record`` that prepares and warms the cell's own shapes, calls
``window.start()``, runs its traffic for `seconds`, calls
``window.end()`` and delivers what is still in flight.  A driver records
the host clock around its calls into each layer (``Spans``; in a traced
run also as profiler annotations) and the PCM of the watched slots,
from the first step of set-up on, for the reference.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np

class Spans:
    """Host-clock totals of named spans; in a traced run each span is also
    a profiler annotation, so the trace shows what the host was doing."""

    def __init__(self, traced: bool):
        self.total = collections.defaultdict(float)
        self._annotate = None
        if traced:
            from torch.profiler import record_function
            self._annotate = record_function

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self._annotate is None:
            yield
        else:
            with self._annotate(name):
                yield
        self.total[name] += time.perf_counter() - t0


@dataclasses.dataclass
class Record:
    """What a window delivered, and the watched slots' PCM."""
    steps: int = 0               # steps started in the window
    slot_frames: int = 0         # slot-frames delivered in the window
    attempted: int = 0           # slot-frames the window's steps carried
    t_start: float = 0.0
    t_last: float = 0.0          # the window's last delivery
    watched: list = dataclasses.field(default_factory=list)  # (pcm, act)
    window_active: list = dataclasses.field(default_factory=list)
    step_starts: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_last - self.t_start


def now() -> float:
    return time.perf_counter()


def watched_frames(rec: Record) -> tuple[list, int]:
    """Each watched slot's delivered frames in order (int16 [n, spf, 2])
    and the count of watched slot-steps that delivered no frame."""
    if not rec.watched:
        return [], 0
    acts = np.stack([a for _, a in rec.watched])      # [T, W]
    out = []
    for j in range(acts.shape[1]):
        rows = [pcm[j] for pcm, a in rec.watched if a[j]]
        out.append(np.stack(rows) if rows else
                   np.zeros((0,) + rec.watched[0][0].shape[1:], np.int16))
    return out, int((~acts).sum())
