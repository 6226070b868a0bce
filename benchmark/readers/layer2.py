"""layer2: the stream reader of MPEG-1 Layer II streams, which reads each
frame's header alone: where each frame lies, its bitrate, sample rate,
mode and the bound of its joint stereo, and whether a CRC protects it.
Layer II has no bit reservoir: every frame's samples lie between its
header and the next, so a slot may enter a stream at any frame
(``entry`` is true for each).

A stream reader is a file ``benchmark/readers/<name>.py`` that a
configuration names under "reader" (see ``readers/layer3.py``).  It
imports nothing of the program and not torch."""
from __future__ import annotations

# kbps by bitrate index, MPEG-1 Layer II (ISO/IEC 11172-3, 2.4.2.3)
BITRATE = (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320,
           384)
SAMPLE_RATE = (44100, 48000, 32000)
MODES = ("stereo", "joint", "dual", "mono")


def frames(data: bytes) -> list:
    """Every frame of data, which holds whole MPEG-1 Layer II frames back
    to back: a dict each with its byte offset, size, bitrate, sample
    rate, mode, the first subband its joint stereo codes as intensity
    (``bound``: 4, 8, 12 or 16; 32, no intensity, in the other modes),
    whether a CRC follows the header, and ``entry`` (always true).
    ValueError at a header that is not MPEG-1 Layer II, a frame cut
    short, or bytes after the last frame."""
    out, pos = [], 0
    while pos + 4 <= len(data):
        h = int.from_bytes(data[pos:pos + 4], "big")
        rate_index, kbps_index = (h >> 10) & 3, (h >> 12) & 15
        if (h >> 20 != 0xFFF or (h >> 17) & 3 != 2 or rate_index == 3
                or kbps_index in (0, 15)):
            raise ValueError(f"no MPEG-1 Layer II header at byte {pos}")
        kbps, rate = BITRATE[kbps_index], SAMPLE_RATE[rate_index]
        mode, ext = (h >> 6) & 3, (h >> 4) & 3
        size = 144 * kbps * 1000 // rate + ((h >> 9) & 1)
        if pos + size > len(data):
            raise ValueError(f"the frame at byte {pos} runs past the end")
        out.append({"offset": pos, "size": size, "kbps": kbps,
                    "sample_rate": rate, "mode": MODES[mode],
                    "bound": 4 * (ext + 1) if mode == 1 else 32,
                    "crc": not (h >> 16) & 1, "entry": True})
        pos += size
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the last frame")
    return out


def stats(streams: list) -> dict:
    """The content of streams (lists of ``frames``): the shares of the
    modes and of the bounds (of frames; 32 is no intensity), the share of
    frames with a CRC, and the frame's bits."""
    fs = [f for s in streams for f in s]

    def shares(key, values):
        return {str(v): sum(f[key] == v for f in fs) / len(fs)
                for v in values}
    return {"streams": len(streams), "frames": len(fs),
            "frame_bits_per_frame": 8 * sum(f["size"] for f in fs) / len(fs),
            "mode_share": shares("mode", MODES),
            "bound_share": shares("bound", (4, 8, 12, 16, 32)),
            "crc_share": sum(f["crc"] for f in fs) / len(fs)}
