"""enqueue_host_ms.backend: host milliseconds of the model step's
enqueue a window step (the wire's widening, the granule steps' calls
into the kernels, the granules' join), from the program's own span
``pool.decode`` inside ``advance`` (``program_spans``): None untraced,
where the program has no such span, or where its count is not the
window's steps."""
from benchmark.metrics.program_spans import read_span


def read(run):
    return read_span(run, "pool.decode", 1e3)
