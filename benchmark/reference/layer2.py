"""layer2: what the plain MPEG-1 Layer II reference says a watched slot
should have delivered.

A plain reference is a file ``benchmark/reference/<name>.py`` that a
configuration names under "reference" (see ``reference/layer3.py``).
Here the frozen ``Frontend``, with Layer I/II accepted, parses and
requantizes each frame (ISO/IEC 11172-3 2.4.3.3; the CRC is read and
not checked, as the reference decoder does) and ``OracleDSP`` runs the
polyphase synthesis of its subband samples, the same ``_synth_step``
that Layer III's reference runs.  It is written in Python and NumPy and
imports nothing of the program and not torch.

A slot's source is a stream of N frames, looped, entered at any frame r
(Layer II has no reservoir).  The PCM of a frame depends on its own
samples and on the synthesis FIFO, 16 blocks of 64, which holds the
last 16 of the 36 steps of the frame before: ``HISTORY`` is one frame.
So the first pass over the loop from the zero state differs from the
second only in its first frame, and every later pass is the second
(``periods`` checks it on the frames that follow).

``tf32=True`` computes the synthesis' products with operands rounded to
TF32 (``reference/layer3.py``'s ``_TF32DSP``: the tables, the subband
samples and the FIFO), the precision below float32 on the card: the
control of the configuration.
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .frontend import Frontend
from .layer3 import _TF32DSP, _pcm
from .oracle import OracleDSP

# periods(..., tf32=True) is the reference_tf32 control
TF32 = True


def decode_frames(data: bytes, n: int, tf32: bool = False) -> np.ndarray:
    """The first n MPEG-1 Layer II frames of data decoded from the zero
    state: int16 [n, 1152, 2].  data must hold them whole."""
    fe = Frontend(layers12=True)
    dsp = _TF32DSP() if tf32 else OracleDSP()
    out = np.zeros((n, 1152, 2), np.int16)
    pos = k = 0
    while k < n:
        # top the 16 KiB ring up in 4 KiB chunks, never to full (a full
        # ring reads as empty, as in the reference decoder)
        while fe.inbuf_filled() < 8192 and pos < len(data):
            fe.feed(data[pos:pos + 4096])
            pos += 4096
        mark, done = fe.istart, fe.processed
        res, fd = fe.read_frame()
        if res != T.OK:
            fe.istart, fe.processed = mark, done
            if pos >= len(data):
                raise ValueError(f"decoded {k} of {n} frames: {res}")
            continue
        if fd.sb_samples is None or fd.sb_samples.shape[1] != 36:
            raise ValueError(f"frame {k} is not a Layer II frame")
        out[k] = _pcm(dsp.decode_frame(fd), 1152)
        k += 1
    return out


# frames whose decode a frame's PCM depends on besides its own
HISTORY = 1


def periods(data: bytes, offsets: list, r: int, fmt: dict,
            tf32: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """int16 [N, 1152, 2] twice: the looped stream data (N frames) from
    frame r decoded from the zero state, its first pass and its second;
    ValueError unless the frames after the second pass repeat its first
    ones.  fmt is the configuration's "format": MPEG-1 ("family" 0)
    Layer II ("layer" 2)."""
    if fmt.get("family", 0) != 0 or fmt.get("layer", 2) != 2:
        raise ValueError(f"the Layer II reference decodes MPEG-1 Layer II, "
                         f"not {fmt}")
    n, h = len(offsets), HISTORY
    rot = data[offsets[r]:] + data[:offsets[r]]
    pcm = decode_frames(rot * 3, 2 * n + h + 1, tf32)
    if not np.array_equal(pcm[2 * n:], pcm[n:n + h + 1]):
        raise ValueError("the looped stream's decode does not repeat after "
                         "its second pass")
    return pcm[:n], pcm[n:2 * n]
