"""k7: the bytes one launch of K7, the Layer I/II synthesis kernel
(``subband_synth_kernel``), has to move with S16 PCM.

Frozen from the byte term of ``chip_smoke.py``'s ``l12_bound``, so that a
launch's count stays the same whatever a later change does to the wire
or the kernel.  Every input is read once and every output written once:
per slot its nch and active flags (int16 each) and its PCM row (S x 32
samples of two int16 channels); per active slot its subband samples
(f32 [2, S, 32]) and its synthesis FIFO (f32 [2, 15, 64]), read and
written.  S is the frame's synthesis steps: 12 in Layer I, 36 in Layer
II.

A launch-byte count is a file ``benchmark/kernel_bytes/<name>.py`` (see
``kernel_bytes/granule.py``).  It imports nothing of the program and not
torch.
"""
from __future__ import annotations

# the FIFO of one slot (f32 [2, 15, 64])
FIFO_BYTES = 2 * 15 * 64 * 4


def steps(fmt: dict) -> int:
    """Synthesis steps S of a frame in the format `fmt`: 12 for "layer"
    1, 36 for 2."""
    return {1: 12, 2: 36}[fmt["layer"]]


def launch_bytes(n_slots: int, n_active: int, fmt: dict) -> int:
    """Bytes of one K7 launch over n_slots slots, n_active of them
    active, with S16 PCM, in the format `fmt`."""
    S = steps(fmt)
    return (n_slots * (4 + S * 128)
            + n_active * (S * 256 + 2 * FIFO_BYTES))
