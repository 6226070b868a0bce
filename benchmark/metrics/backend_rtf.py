"""backend_rtf: audio seconds decoded from the parsed wire and delivered
to pinned host memory over the window, per wall second of the window."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.slot_frames * run.frame_s / run.window_s
