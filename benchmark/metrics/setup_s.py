"""setup_s: seconds from the process's start to the window's first
step: libraries, streams, the pool, warm-up or recording."""


def read(run):
    return run.setup_s
