"""Write the benchmark's MPEG-1 Layer II streams: real encoder output, kept
in the checkout.

    python3 -m benchmark.make_streams_l2

twolame (``libtwolame.so.0``) encodes the seeded pieces of synthetic
program material that ``make_streams`` generates, at 48 kHz, as DAB
(ETSI EN 300 401) and DVB (ETSI TS 101 154) carry MPEG-1 Layer II
audio: 256 kbps, two channels in joint-stereo mode, a CRC in every
frame; every other setting is twolame's default, so twolame itself
chooses, frame by frame, whether and from which subband it codes the
channels as intensity.  Of each piece the first ``FRAMES`` frames are
kept (768 B each, no padding at 256 kbps and 48 kHz).  Layer II has no
reservoir, so a segment loops as it is.  ``benchmark/streams/
twolame_48k_stereo.mp2`` holds the segments back to back,
``twolame_48k_stereo.json`` where each lies, how they were made, and
their content as ``readers/layer2.stats`` reads it.

The benchmark only reads these files; it needs no encoder.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import json
import os

import numpy as np

from .make_streams import FRAMES, PIECES, SEED, piece
from .readers import layer2

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = "twolame_48k_stereo"
RATE = 48000
SPF = 1152
# twolame's enums: TWOLAME_MPEG1, TWOLAME_JOINT_STEREO
MPEG1, JOINT_STEREO = 1, 1
SETTINGS = {"version": MPEG1, "in_samplerate": RATE,
            "out_samplerate": RATE, "num_channels": 2, "bitrate": 256,
            "mode": JOINT_STEREO, "error_protection": 1}
# the settings left at twolame's defaults, read back after init
DEFAULTS = ("psymodel", "padding", "VBR", "energy_levels",
            "num_ancillary_bits", "emphasis", "copyright", "original",
            "extension", "DAB", "ATH_level", "quick_mode", "scale")


def _twolame():
    lib = C.CDLL("libtwolame.so.0")
    lib.twolame_init.restype = C.c_void_p
    lib.get_twolame_version.restype = C.c_char_p
    lib.twolame_get_mode_name.restype = C.c_char_p
    lib.twolame_get_mode_name.argtypes = [C.c_void_p]
    lib.twolame_init_params.argtypes = [C.c_void_p]
    for k in SETTINGS:
        getattr(lib, "twolame_set_" + k).argtypes = [C.c_void_p, C.c_int]
    for k in DEFAULTS:
        getattr(lib, "twolame_get_" + k).argtypes = [C.c_void_p]
        if k in ("ATH_level", "scale"):
            getattr(lib, "twolame_get_" + k).restype = C.c_float
    lib.twolame_encode_buffer_float32_interleaved.argtypes = [
        C.c_void_p, C.c_void_p, C.c_int, C.c_void_p, C.c_int]
    lib.twolame_encode_flush.argtypes = [C.c_void_p, C.c_void_p, C.c_int]
    lib.twolame_close.argtypes = [C.POINTER(C.c_void_p)]
    return lib


def encode(pcm: np.ndarray) -> tuple[bytes, dict]:
    """Interleaved f32 stereo pcm [n, 2] in [-1, 1] at 48 kHz -> the
    stream twolame writes at ``SETTINGS``, and every setting as twolame
    reports it."""
    lib = _twolame()
    g = C.c_void_p(lib.twolame_init())
    try:
        for k, v in SETTINGS.items():
            if getattr(lib, "twolame_set_" + k)(g, v) != 0:
                raise RuntimeError(f"twolame_set_{k}({v}) failed")
        if lib.twolame_init_params(g) != 0:
            raise RuntimeError("twolame_init_params failed")
        settings = {"twolame": lib.get_twolame_version().decode(),
                    "mpeg_version": "1", "layer": 2,
                    **{k: v for k, v in SETTINGS.items() if k != "version"},
                    "mode": lib.twolame_get_mode_name(g).decode(),
                    **{k: getattr(lib, "twolame_get_" + k)(g)
                       for k in DEFAULTS}}
        x = np.ascontiguousarray(pcm, np.float32)
        cap = 2 * len(x) + 16384
        buf = (C.c_ubyte * cap)()
        n = lib.twolame_encode_buffer_float32_interleaved(
            g, x.ctypes.data_as(C.c_void_p), len(x), buf, cap)
        m = lib.twolame_encode_flush(g, C.byref(buf, max(n, 0)), cap - n)
    finally:
        lib.twolame_close(C.byref(g))
    if n < 0 or m < 0:
        raise RuntimeError(f"twolame failed: {n}, {m}")
    return bytes(buf[:n + m]), settings


def make() -> dict:
    # the piece runs on past the segment, as make_streams' do
    seconds = 2 * FRAMES * SPF / RATE
    segs, meta = [], []
    for seed in range(SEED, SEED + PIECES):
        stream, settings = encode(piece(seed, RATE, seconds))
        last = layer2.frames(stream)[FRAMES - 1]
        segs.append(stream[:last["offset"] + last["size"]])
        meta.append({"seed": seed, "bytes": len(segs[-1])})
    data = b"".join(segs)
    with open(os.path.join(HERE, "streams", NAME + ".mp2"), "wb") as f:
        f.write(data)
    info = {"file": NAME + ".mp2", "encoder": settings, "sample_rate": RATE,
            "samples_per_frame": SPF, "frames": FRAMES,
            "seconds_encoded": seconds,
            "sha256": hashlib.sha256(data).hexdigest(),
            "segments": meta,
            "stats": layer2.stats([layer2.frames(s) for s in segs])}
    with open(os.path.join(HERE, "streams", NAME + ".json"), "w") as f:
        json.dump(info, f, indent=1)
        f.write("\n")
    return info


def main() -> None:
    info = make()
    print(NAME, json.dumps(info["encoder"]), json.dumps(info["stats"]))


if __name__ == "__main__":
    main()
