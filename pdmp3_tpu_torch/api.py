"""libmpg123-subset streaming API, protocol-compatible with the reference.

Implements the exact 7-function state machine of the reference decoder
(pdmp3.c:2301-2535): feed/read return-code protocol, the 1152-byte read
gate, input-cursor rollback on frame errors, the one-shot NEW_FORMAT
handshake acknowledged by getformat, partial-frame PCM draining via the
``ostart`` resume offset, and the all-or-nothing feed admission.

The DSP backend is pluggable: :class:`~pdmp3_tpu_torch.oracle.OracleDSP`
(NumPy, bit-exact vs the reference binary) or the PyTorch backend
(:class:`pdmp3_tpu_torch.models.decoder.TorchDSP`).  A native C ABI with
the same semantics lives in ``pdmp3_tpu_torch/host`` for C callers.
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .frontend import Frontend
from .oracle import OracleDSP


class PDMP3:
    """One decoder stream handle (pdmp3_new/open_feed/feed/read/decode)."""

    def __init__(self, dsp=None, lsf: bool = False,
                 free_format: bool = False, id3: bool = False,
                 layers12: bool = False, crc_check: bool = False):
        self.fe = Frontend(lsf=lsf, free_format=free_format, id3=id3,
                           layers12=layers12, crc_check=crc_check)
        self.dsp = dsp if dsp is not None else OracleDSP()
        self.out = np.zeros((2, 576), np.uint32)  # packed PCM words
        self.ostart = 0
        # PCM words the current frame actually carries: 1152 for MPEG-1
        # (2 granules), 576 for LSF frames (Frontend(lsf=True) only),
        # 384/1152 for Layer I/II frames (layers12=True only)
        self.owords = 2 * 576

    # -- pdmp3_open_feed (pdmp3.c:2369-2384) --
    def open_feed(self) -> int:
        self.fe.reset()
        self.dsp.reset()
        self.ostart = 0
        return T.OK

    # -- pdmp3_feed (pdmp3.c:2391-2423) --
    def feed(self, data: bytes) -> int:
        return self.fe.feed(data)

    def _convert_frame_s16(self, outsize: int) -> bytes:
        """Convert_Frame_S16 (pdmp3.c:2307-2345): drain packed PCM words
        into interleaved S16LE honoring the ostart resume offset."""
        nch = self.fe.header.nch
        framesz = 2 * nch
        # ostart can exceed owords when an odd-sized read leaves a
        # partially-drained 1152-word frame and an LSF frame follows
        # (owords 576): recover by resetting the drain cursor (native
        # api.cc convert_s16 parity)
        if self.ostart >= self.owords:
            self.ostart = 0
            return b""
        nsamps = min(outsize // framesz, self.owords - self.ostart)
        flat = self.out.reshape(-1)[self.ostart:self.ostart + nsamps]
        if nch == 1:
            pcm = (flat & 0xFFFF).astype(np.uint16)
        else:
            pcm = np.empty(2 * nsamps, np.uint16)
            pcm[0::2] = (flat >> 16) & 0xFFFF
            pcm[1::2] = flat & 0xFFFF
        self.ostart += nsamps
        if self.ostart == self.owords:
            self.ostart = 0
        return pcm.astype("<u2").tobytes()

    # -- pdmp3_read (pdmp3.c:2431-2481) --
    def read(self, outsize: int) -> tuple[int, bytes]:
        if outsize == 0:
            return T.NO_SPACE, b""
        chunks = []
        res = T.ERR
        if self.ostart:
            b = self._convert_frame_s16(outsize)
            chunks.append(b)
            outsize -= len(b)
            res = T.OK
        # Layer I/II frames can be far smaller than the reference's
        # 1152-byte read gate (pdmp3.c:2445) — layers12 handles rely on
        # read_frame's NEED_MORE + rollback instead (native api.cc parity)
        gate = 8 if self.fe.layers12 else 2 * 576
        while outsize > 0:
            if self.fe.id3:
                # consume tag bytes OUTSIDE the rollback snapshot so the
                # skip persists across NEED_MORE round trips
                self.fe.skip_id3()
            if self.fe.inbuf_filled() >= gate:
                pos = self.fe.processed
                mark = self.fe.istart
                res, fd = self.fe.read_frame()
                if res == T.OK:
                    self.out = self.dsp.decode_frame(fd)
                    self.owords = fd.header.pcm_samples
                    b = self._convert_frame_s16(outsize)
                    chunks.append(b)
                    outsize -= len(b)
                else:
                    self.fe.processed = pos
                    self.fe.istart = mark
                    if res != T.ERR and res != T.NEED_MORE:
                        res = T.ERR
                    break
            else:
                res = T.NEED_MORE
                break
        if self.fe.new_header == 1 and res == T.OK:
            res = T.NEW_FORMAT
        return res, b"".join(chunks)

    # -- pdmp3_decode (pdmp3.c:2491-2520) --
    def decode(self, data: bytes, outsize: int) -> tuple[int, bytes]:
        free = self.fe.inbuf_free()
        res = self.feed(data[:free] if len(data) > free else data)
        pcm = b""
        if res == T.OK:
            if outsize:
                res, pcm = self.read(outsize)
            elif self.fe.processed == 0:
                pos = self.fe.processed
                mark = self.fe.istart
                res = self.fe.search_header()
                self.fe.processed = pos
                self.fe.istart = mark
                if self.fe.new_header == 1:
                    res = T.NEW_FORMAT
        return res, pcm

    # -- pdmp3_getformat (pdmp3.c:2526-2535) --
    def getformat(self) -> tuple[int, int, int, int]:
        rate = self.fe.header.sample_rate
        channels = self.fe.header.nch
        self.fe.new_header = -1
        return T.OK, rate, channels, T.ENC_SIGNED_16


def decode_file(data: bytes, dsp=None, chunk: int = 4096,
                lsf: bool = False, free_format: bool = False,
                id3: bool = False, layers12: bool = False,
                crc_check: bool = False) -> bytes:
    """CLI-equivalent loop (pdmp3.c:2540-2589): feed/read to exhaustion."""
    h = PDMP3(dsp=dsp, lsf=lsf, free_format=free_format, id3=id3,
              layers12=layers12, crc_check=crc_check)
    h.open_feed()
    pos = 0
    out = []
    while True:
        res, pcm = h.read(T.INBUF_SIZE)
        out.append(pcm)
        if res == T.ERR:
            break
        if res == T.NEED_MORE:
            if pos >= len(data):
                break
            h.feed(data[pos:pos + chunk])
            pos += chunk
    return b"".join(out)
