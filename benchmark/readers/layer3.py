"""layer3: the stream reader of MPEG audio Layer III streams (MPEG-1 and
the LSF families), which reads each frame's side information without
decoding the main data: where each frame lies, where its main data
starts, and what its granules code (bits, block types, stereo mode).  A
slot may enter a stream at a frame whose main data starts at its own
side information (``main_data_begin`` 0), so that no frame it is fed
borrows bytes it was not fed.

A stream reader is a file ``benchmark/readers/<name>.py`` that a
configuration names under "reader".  It has ``frames(data)``, a dict per
frame with at least its byte ``offset``, its ``size`` and ``entry``
(whether a slot may enter the stream there), and ``stats(frame_lists)``,
the streams' content that a run logs at set-up.  It imports nothing of
the program and not torch."""
from __future__ import annotations

import numpy as np

# kbps by bitrate index: MPEG-1 Layer III, and the LSF families (MPEG-2
# and MPEG-2.5) Layer III
BITRATE = {0: (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
               256, 320),
           1: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
               160)}
SAMPLE_RATE = {3: (44100, 48000, 32000), 2: (22050, 24000, 16000),
               0: (11025, 12000, 8000)}
BLOCKS = ("long", "start", "short", "stop")


class _Bits:
    def __init__(self, data: bytes):
        self.v = int.from_bytes(data, "big")
        self.n = 8 * len(data)
        self.pos = 0

    def get(self, nb: int) -> int:
        self.pos += nb
        return (self.v >> (self.n - self.pos)) & ((1 << nb) - 1)


def frames(data: bytes) -> list:
    """Every frame of data, which holds whole Layer III frames back to
    back: a dict each with its byte offset, size, bitrate, sample rate,
    main-data capacity in bits, main_data_begin, whether a slot may
    enter there (``entry``: main_data_begin 0), the MS flag, and per
    granule and channel its part2_3_length, big_values, block type and
    mixed flag."""
    out, pos = [], 0
    while pos + 4 <= len(data):
        h = int.from_bytes(data[pos:pos + 4], "big")
        if h >> 21 != 0x7FF or (h >> 17) & 3 != 1:
            raise ValueError(f"no Layer III header at byte {pos}")
        version, crc = (h >> 19) & 3, not (h >> 16) & 1
        lsf = version != 3
        kbps = BITRATE[int(lsf)][(h >> 12) & 15]
        rate = SAMPLE_RATE[version][(h >> 10) & 3]
        pad, mode, ext = (h >> 9) & 1, (h >> 6) & 3, (h >> 4) & 3
        nch = 1 if mode == 3 else 2
        size = (72 if lsf else 144) * kbps * 1000 // rate + pad
        side_len = (9 if nch == 1 else 17) if lsf else (
            17 if nch == 1 else 32)
        start = pos + 4 + 2 * crc
        b = _Bits(data[start:start + side_len])
        ngr = 1 if lsf else 2
        f = {"offset": pos, "size": size, "nch": nch, "kbps": kbps,
             "sample_rate": rate,
             "capacity_bits": 8 * (size - 4 - 2 * crc - side_len),
             "ms": mode == 1 and bool(ext & 2),
             "main_data_begin": b.get(8 if lsf else 9),
             "granules": []}
        f["entry"] = f["main_data_begin"] == 0
        b.get((1 if nch == 1 else 2) if lsf else (5 if nch == 1 else 3))
        if not lsf:
            b.get(4 * nch)                       # scfsi
        for _ in range(ngr):
            for _ in range(nch):
                g = {"part2_3_length": b.get(12), "big_values": b.get(9)}
                b.get(8 + (9 if lsf else 4))     # global gain, compress
                if b.get(1):                     # window switching
                    g["block_type"], g["mixed"] = b.get(2), b.get(1)
                    b.get(10 + 9)                # tables, subblock gains
                else:
                    g["block_type"], g["mixed"] = 0, 0
                    b.get(15 + 7)                # tables, region counts
                b.get(2 if lsf else 3)           # preflag, scale, count1
                f["granules"].append(g)
        out.append(f)
        pos += size
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the last frame")
    return out


def stats(streams: list) -> dict:
    """The content of streams (lists of ``frames``): coded bits a frame
    against its main-data capacity, the shares of block types (of
    granule-channels) and of MS frames, big_values, the reservoir's
    reach (main_data_begin) and the share of frames a slot may enter at
    (main_data_begin 0)."""
    fs = [f for s in streams for f in s]
    gs = [g for f in fs for g in f["granules"]]
    coded = sum(g["part2_3_length"] for g in gs)
    cap = sum(f["capacity_bits"] for f in fs)
    bt = np.bincount([g["block_type"] for g in gs], minlength=4)
    bv = [g["big_values"] for g in gs]
    mdb = [f["main_data_begin"] for f in fs]
    return {
        "streams": len(streams), "frames": len(fs),
        "coded_bits_per_frame": coded / len(fs),
        "capacity_bits_per_frame": cap / len(fs),
        "frame_bits_per_frame": 8 * sum(f["size"] for f in fs) / len(fs),
        "fill": coded / cap,
        "block_share": {k: float(n) / len(gs) for k, n in zip(BLOCKS, bt)},
        "mixed_share": sum(g["mixed"] for g in gs) / len(gs),
        "ms_frame_share": sum(f["ms"] for f in fs) / len(fs),
        "big_values_mean": float(np.mean(bv)),
        "big_values_max": int(max(bv)),
        "main_data_begin_mean": float(np.mean(mdb)),
        "entry_frame_share": mdb.count(0) / len(fs),
    }
