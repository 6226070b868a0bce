"""granule: the bytes one launch of a granule kernel (K1, K2 or K3) has
to move.

Frozen from ``chip_smoke.py``'s bound arithmetic (``STATE_BYTES``,
``granule_wire_bytes``, the byte term of ``granule_bound``), so that a
launch's count stays the same whatever a later change does to the wire
or the kernels.  Every input is read once and every output written once:
an idle slot reads its active flag and writes silent PCM; an active slot
reads its wire and reads and writes its recurrent state.

A launch-byte count is a file ``benchmark/kernel_bytes/<name>.py`` that
a configuration's "kernel" names under "bytes", with a function
``launch_bytes(n_slots, n_active, fmt)``: the bytes of one launch over
n_slots slots, n_active of them active, in the configuration's
"format".  It imports nothing of the program and not torch.
"""
from __future__ import annotations

# store (f32 [2,32,18]), v (f32 [2,15,64]) and prev_lines (f32 [3]) of
# one slot, read and written
STATE_BYTES = 2 * (4608 + 7680 + 12)


def granule_wire_bytes(lsf: bool = False) -> int:
    """Wire bytes one active slot reads per granule: ix (int16 [2,576]),
    the scalefactors (int16 [2,22] and [2,39]), meta (int32 [32]) and
    the LSF intensity sidecar (int16 [64])."""
    return 2304 + 2 * 22 * 2 + 2 * 39 * 2 + 32 * 4 + (128 if lsf else 0)


def granule_launch_bytes(n_slots: int, n_active: int,
                         lsf: bool = False) -> int:
    """Bytes of one granule launch (K1, K2 or K3) over n_slots slots,
    n_active of them active: per slot its active flag (4 B) and its S16
    PCM (2,304 B), per active slot its wire and its state."""
    return (n_slots * (4 + 2304)
            + n_active * (granule_wire_bytes(lsf) + STATE_BYTES))


def launch_bytes(n_slots: int, n_active: int, fmt: dict) -> int:
    """Bytes of one granule launch in the format `fmt`: the LSF wire
    where its "family" is 1 or 2, MPEG-1's where it is 0."""
    return granule_launch_bytes(n_slots, n_active, lsf=bool(fmt["family"]))
