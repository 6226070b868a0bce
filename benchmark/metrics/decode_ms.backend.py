"""decode_ms.backend: device milliseconds of the model step a window step,
from the trace: every kernel on the card within the traced window (the
pool's ``advance``, which runs decode_frame_packed[_lsf], launches them
all; the harness's own work is copies) over the window's steps."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    return 1e3 * run.trace["kernels_s"] / run.steps
