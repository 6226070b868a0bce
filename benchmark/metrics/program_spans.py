"""What the ``*_host_*`` readers share: a span of the program's own
(``pdmp3_tpu_torch.utils.trace.RECORDER``, which records while the traced
window's profiler runs) over its count.  No entry of BENCHMARK.json names
this file."""


def read_span(run, name: str, scale: float, per_launch: bool = False):
    """`scale` times the seconds of the program's span `name` over the
    window's steps, or with `per_launch` over the traced launches of the
    cell's kernel (which the traced run holds to the port's launch
    counter).  None untraced, where the program has no recorder, or where
    the span's count is not that number."""
    if run.trace is None:
        return None
    per = run.trace["launches"] if per_launch else run.steps
    if not per:
        return None
    try:
        from pdmp3_tpu_torch.utils.trace import RECORDER
    except ImportError:
        return None
    sec, count = RECORDER.spans().get(name, (0.0, 0))
    if count != per:
        return None
    return scale * sec / per
