"""layer3: what the plain Layer III reference says a watched slot should
have delivered.

A plain reference is a file ``benchmark/reference/<name>.py`` that a
configuration names under "reference".  It has ``periods(data, offsets,
r, fmt, tf32)``, below, for the configuration's "format" `fmt`, and
``TF32 = True`` where ``tf32=True`` is its path for the
``reference_tf32`` control.  It imports nothing of the program and not
torch.

A slot's source is a stream of N frames, looped, entered at a frame r
whose main data starts at its own side information (main_data_begin 0),
so no frame the slot is fed borrows bytes that it was not fed.  The
slot's first N frames are the looped stream decoded from r and from the
zero state; every later frame repeats the second pass over the loop
(``periods``).  Not the first: a frame's decode can depend on more than
the frames just before it, as the reference decoder's count1 table B
keeps a pointer from an earlier granule, so the first pass, which starts
from a fresh state, need not repeat; the second does, which ``periods``
checks on the frames that follow it.

``tf32=True`` computes the DSP's products with operands rounded to TF32
(10 mantissa bits), the precision below float32 on the card: the
control of a cell whose program has no lower-precision path of its own.
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .frontend import Frontend
from .oracle import OracleDSP

F32 = np.float32

# periods(..., tf32=True) is the reference_tf32 control
TF32 = True


def _tf32(x):
    """x (f32) rounded to TF32, to nearest even in the 13 dropped bits."""
    b = np.asarray(x, F32).view(np.uint32)
    r = (b + np.uint32(0x0FFF) + ((b >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return r.view(F32)


class _TF32DSP(OracleDSP):
    """OracleDSP whose IMDCT and synthesis products take TF32 operands:
    the tables and the samples and state they multiply."""

    def decode_frame(self, fd):
        saved = T.COS_N36, T.SYNTH_NWIN, T.SYNTH_D
        T.COS_N36, T.SYNTH_NWIN, T.SYNTH_D = (_tf32(t) for t in saved)
        try:
            return super().decode_frame(fd)
        finally:
            T.COS_N36, T.SYNTH_NWIN, T.SYNTH_D = saved

    def _hybrid_synthesis(self, fd, gr, ch, x):
        x[:] = _tf32(x)
        super()._hybrid_synthesis(fd, gr, ch, x)

    def _synth_step(self, ch, nch, s_vec, outdata, ss):
        self.v_vec[ch] = _tf32(self.v_vec[ch])
        super()._synth_step(ch, nch, _tf32(s_vec), outdata, ss)


def _pcm(words: np.ndarray, spf: int) -> np.ndarray:
    """Packed PCM words uint32 [2, 576] -> int16 [spf, 2] (L, R)."""
    w = words.reshape(-1)[:spf]
    out = np.empty((spf, 2), np.int16)
    out[:, 0] = (w >> 16).astype(np.uint16).view(np.int16)
    out[:, 1] = (w & 0xFFFF).astype(np.uint16).view(np.int16)
    return out


def decode_frames(data: bytes, n: int, family: int,
                  tf32: bool = False) -> np.ndarray:
    """The first n frames of data decoded from the zero state: int16
    [n, spf, 2].  data must hold them whole and start at a frame whose
    main_data_begin is 0."""
    fe = Frontend(lsf=bool(family))
    dsp = _TF32DSP() if tf32 else OracleDSP()
    spf = 576 if family else 1152
    out = np.zeros((n, spf, 2), np.int16)
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
        out[k] = _pcm(dsp.decode_frame(fd), spf)
        k += 1
    return out


def history(fmt: dict) -> int:
    """Frames whose decode a frame's PCM depends on besides its own: the
    two granules before it."""
    return 1 if fmt["family"] == 0 else 2


def periods(data: bytes, offsets: list, r: int, fmt: dict,
            tf32: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """int16 [N, spf, 2] twice: the looped stream data (N frames) from
    frame r decoded from the zero state, its first pass and its second;
    ValueError unless the frames after the second pass repeat its first
    ones (then every later pass is the second).  fmt's "family" is 0 for
    MPEG-1, 1 or 2 for the LSF families."""
    n, h = len(offsets), history(fmt)
    rot = data[offsets[r]:] + data[:offsets[r]]
    pcm = decode_frames(rot * 4, 2 * n + h + 1, fmt["family"], tf32)
    if not np.array_equal(pcm[2 * n:], pcm[n:n + h + 1]):
        raise ValueError("the looped stream's decode does not repeat after "
                         "its second pass")
    return pcm[:n], pcm[n:2 * n]
