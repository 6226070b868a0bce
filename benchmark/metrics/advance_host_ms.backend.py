"""advance_host_ms.backend: host milliseconds inside the pool's
``advance`` a window step, from the program's own span ``pool.advance``
(``program_spans``): None untraced, where the program has no such span,
or where its count is not the window's steps."""
from benchmark.metrics.program_spans import read_span


def read(run):
    return read_span(run, "pool.advance", 1e3)
