"""launch_host_us.backend: host microseconds of one granule step's call
into the kernels (operand and alignment checks, the PCM's allocation,
the table pointers, the C launch), from the program's own span
``step.launch`` over its count (``program_spans``): None untraced, where
the program has no such span, or where its count is not the launches of
the cell's kernel in the trace."""
from benchmark.metrics.program_spans import read_span


def read(run):
    return read_span(run, "step.launch", 1e6, per_launch=True)
