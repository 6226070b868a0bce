"""The comparison that decides ``correct``: each watched slot's delivered
frames against the plain reference that the configuration names
(``benchmark/reference/<name>.py``), which decodes from the same bytes
the slot was fed and nothing the program made."""
from __future__ import annotations

import numpy as np


class Reference:
    """The frames the watched slots should deliver, by slot and count:
    the reference module's ``periods`` over each slot's source, in the
    configuration's format fmt."""

    def __init__(self, corpus, module, fmt: dict, tf32: bool = False):
        self.c, self.module, self.fmt, self.tf32 = corpus, module, fmt, tf32
        self._periods = {}

    def frames(self, j: int, count: int) -> np.ndarray:
        """int16 [count, spf, 2]: the first `count` frames watched slot j
        should deliver."""
        slot = int(self.c.watch[j])
        key = int(self.c.source[slot]), int(self.c.rotation[slot])
        if key not in self._periods:
            st = self.c.streams[key[0]]
            self._periods[key] = self.module.periods(
                st["data"], st["offsets"], key[1], self.fmt, self.tf32)
        first, second = self._periods[key]
        n = len(first)
        out = second[(np.arange(count) - n) % n]
        out[:n] = first[:count]
        return out


# a watched slot-step that delivered no frame: every sample of the frame
# counts as off by the widest gap S16 has
NO_FRAME_LSB = 65535


def numbers(got: list, missing: int, ref: Reference) -> dict:
    """The numbers compared: the largest gap in LSB between a delivered
    sample and the reference's, and the share of samples that differ,
    over every frame the watched slots delivered and every frame one of
    them failed to deliver (``missing``, each off in every sample by
    ``NO_FRAME_LSB``); and the frames compared."""
    worst, off, total, frames = 0, 0, 0, 0
    for j, g in enumerate(got):
        if not len(g):
            continue
        d = np.abs(g.astype(np.int32) - ref.frames(j, len(g)))
        worst = max(worst, int(d.max()))
        off += int((d != 0).sum())
        total += d.size
        frames += len(g)
    if missing:
        size = next((g[0].size for g in got if len(g)), 1)
        worst = NO_FRAME_LSB
        off += missing * size
        total += missing * size
    return {"max_abs_lsb": worst,
            "off_share": off / total if total else 1.0,
            "frames_compared": frames}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit, and some frame compared."""
    checks = {k: {"value": nums[k], "limit": v} for k, v in limits.items()}
    ok = nums["frames_compared"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
