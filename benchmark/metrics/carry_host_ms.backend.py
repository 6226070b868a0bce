"""carry_host_ms.backend: host milliseconds a window step that the
pool's ``advance`` spends after the model step (active and meta carried
over, the wire buffers swapped, their views bound, the other buffer
reclaimed), from the program's own span ``pool.carry``
(``program_spans``): None untraced, where the program has no such span,
or where its count is not the window's steps."""
from benchmark.metrics.program_spans import read_span


def read(run):
    return read_span(run, "pool.carry", 1e3)
