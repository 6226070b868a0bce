"""The bytes a granule kernel's launch has to move, and the card's peak.

Frozen from ``chip_smoke.py``'s bound arithmetic (``STATE_BYTES``,
``granule_wire_bytes``, the byte term of ``granule_bound``), so that a
launch's count stays the same whatever a later change does to the wire
or the kernels.  Every input is read once and every output written once:
an idle slot reads its active flag and writes silent PCM; an active slot
reads its wire and reads and writes its recurrent state.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12

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
