"""Write the benchmark's streams: real encoder output, kept in the checkout.

    python3 -m benchmark.make_streams

For each format below, LAME (``libmp3lame``, the dominant MP3 encoder)
encodes seeded pieces of synthetic program material with its defaults:
only the input's sample rate and channel count are set, so LAME itself
chooses the bitrate, the MPEG version, joint stereo (MS or LR by
frame), block switching and the bit reservoir.  Of each piece the
stream's first ``FRAMES`` frames are kept: the first frame is the only
one whose main data starts at its own side information
(``main_data_begin`` 0; LAME never empties its reservoir later), so a
segment loops without a byte from outside it, and each holds the
encoder's lead-in once.  ``benchmark/streams/<name>.mp3`` holds the
segments back to back, ``<name>.json`` where each lies and how they
were made.

The benchmark only reads these files; it needs no encoder.  The
material: a tempo, key and chord progression drawn per piece; bass,
chords and a lead of harmonic tones with their own envelopes and pan
positions; kick, snare and hi-hat on drawn patterns in most pieces;
decorrelated echoes between the channels; a level drawn from -20 to
-10 dBFS RMS, then a soft limiter.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import json
import os

import numpy as np

from .readers import layer3

HERE = os.path.dirname(os.path.abspath(__file__))
FRAMES = 32
PIECES = 64
FORMATS = {"lame_44k1_stereo": 44100, "lame_22k05_stereo": 22050}
SEED = 20261018


def _lame():
    lib = C.CDLL("libmp3lame.so.0")
    lib.lame_init.restype = C.c_void_p
    lib.get_lame_version.restype = C.c_char_p
    for f in ("lame_set_in_samplerate", "lame_set_num_channels",
              "lame_set_bWriteVbrTag", "lame_init_params",
              "lame_get_brate", "lame_get_mode", "lame_get_version",
              "lame_close"):
        getattr(lib, f).argtypes = [C.c_void_p] + (
            [C.c_int] if f.startswith("lame_set") else [])
    lib.lame_encode_buffer_interleaved_ieee_float.argtypes = [
        C.c_void_p, C.c_void_p, C.c_int, C.c_void_p, C.c_int]
    lib.lame_encode_flush.argtypes = [C.c_void_p, C.c_void_p, C.c_int]
    return lib


def encode(pcm: np.ndarray, rate: int) -> tuple[bytes, dict]:
    """Interleaved f32 stereo pcm [n, 2] in [-1, 1] -> the stream LAME
    writes at its defaults, and those settings as LAME reports them."""
    lib = _lame()
    g = lib.lame_init()
    lib.lame_set_in_samplerate(g, rate)
    lib.lame_set_num_channels(g, 2)
    lib.lame_set_bWriteVbrTag(g, 0)     # no Info tag frame
    if lib.lame_init_params(g) < 0:
        raise RuntimeError("lame_init_params failed")
    settings = {"lame": lib.get_lame_version().decode(),
                "kbps": lib.lame_get_brate(g),
                "mode": ("stereo", "joint stereo", "dual", "mono")[
                    lib.lame_get_mode(g)],
                "mpeg_version": ("2", "1", "2.5")[lib.lame_get_version(g)]}
    x = np.ascontiguousarray(pcm, np.float32)
    cap = int(1.25 * len(x) + 7200)
    buf = (C.c_ubyte * cap)()
    n = lib.lame_encode_buffer_interleaved_ieee_float(
        g, x.ctypes.data_as(C.c_void_p), len(x), buf, cap)
    m = lib.lame_encode_flush(g, C.byref(buf, n), cap - n)
    lib.lame_close(g)
    if n < 0 or m < 0:
        raise RuntimeError(f"lame failed: {n}, {m}")
    return bytes(buf[:n + m]), settings


def _table(harmonics: int, tilt: float) -> np.ndarray:
    """One period of a harmonic tone, 4096 points."""
    ph = np.arange(4096) / 4096
    k = np.arange(1, harmonics + 1)
    return (np.sin(2 * np.pi * np.outer(ph, k)) / k ** tilt).sum(1)


def _tone(rng, rate, n, f, dur, tilt, attack, decay):
    """A note of frequency f, dur seconds, in at most n samples."""
    m = min(n, int(dur * rate))
    t = np.arange(m) / rate
    h = max(1, min(24, int(0.45 * rate / f)))
    wave = _table(h, tilt)[((f * t + rng.random()) * 4096).astype(int)
                           % 4096]
    env = np.minimum(1, t / attack) * np.exp(-t / decay)
    return wave * env


def piece(seed: int, rate: int, seconds: float) -> np.ndarray:
    """Synthetic program material: f32 [n, 2]."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    out = np.zeros((n, 2))
    beat = 60 / rng.uniform(80, 160)
    root = 36 + int(rng.integers(0, 12))
    scale = np.array([0, 2, 4, 5, 7, 9, 11] if rng.random() < 0.5
                     else [0, 2, 3, 5, 7, 8, 10])
    hz = lambda midi: 440 * 2 ** ((midi - 69) / 12)   # noqa: E731

    def add(x, at, pan):
        a = int(at * rate)
        if a >= n:
            return
        x = x[:n - a]
        out[a:a + len(x), 0] += x * np.cos((pan + 1) * np.pi / 4)
        out[a:a + len(x), 1] += x * np.sin((pan + 1) * np.pi / 4)

    bars = int(seconds / (4 * beat)) + 1
    tilt = rng.uniform(0.7, 1.6)
    drums = rng.random() < 0.8
    hat_p = rng.uniform(0.3, 1.0)
    for bar in range(bars):
        degree = int(rng.choice([0, 3, 4, 5]))
        chord = [root + 12 + scale[(degree + i) % 7]
                 + 12 * ((degree + i) // 7) for i in (0, 2, 4)]
        t0 = bar * 4 * beat
        for c in chord:                           # chords, one a bar
            add(0.12 * _tone(rng, rate, n, hz(c), 4 * beat, tilt, 0.02,
                             2.5 * beat), t0, rng.uniform(-0.7, 0.7))
        for b in range(4):                        # bass, one a beat
            add(0.25 * _tone(rng, rate, n, hz(chord[0] - 12), beat, 1.2,
                             0.005, 0.4 * beat), t0 + b * beat, 0.0)
        for e in range(8):                        # lead, on eighths
            if rng.random() < 0.6:
                note = root + 24 + scale[int(rng.integers(0, 7))]
                add(0.1 * _tone(rng, rate, n, hz(note), beat / 2,
                                tilt - 0.2, 0.003, 0.3 * beat),
                    t0 + e * beat / 2, rng.uniform(-0.5, 0.5))
        if not drums:
            continue
        for b in range(4):
            at = t0 + b * beat
            if b % 2 == 0:                        # kick
                m = int(0.25 * rate)
                t = np.arange(m) / rate
                f = 50 + 100 * np.exp(-t / 0.03)
                add(0.6 * np.sin(2 * np.pi * np.cumsum(f) / rate)
                    * np.exp(-t / 0.12), at, 0.0)
            else:                                 # snare
                m = int(0.2 * rate)
                t = np.arange(m) / rate
                add(0.3 * rng.standard_normal(m) * np.exp(-t / 0.06),
                    at, 0.1)
            for half in (0, 0.5):                 # hi-hat
                if rng.random() < hat_p:
                    m = int(0.05 * rate)
                    x = np.diff(rng.standard_normal(m + 1))
                    add(0.08 * x * np.exp(-np.arange(m) / rate / 0.015),
                        at + half * beat, rng.uniform(-0.6, 0.6))
    for ch in range(2):                           # echoes
        for _ in range(4):
            d = int(rng.uniform(0.01, 0.09) * rate)
            out[d:, ch] += rng.uniform(0.05, 0.2) * out[:-d, 1 - ch]
    rms = np.sqrt(np.mean(out ** 2)) + 1e-12
    out *= 10 ** (rng.uniform(-20, -10) / 20) / rms
    return np.tanh(1.5 * out) / 1.5


def make(name: str, rate: int) -> dict:
    spf = 1152 if rate > 24000 else 576
    # the piece runs on past the segment, so LAME's look-ahead is real
    seconds = 2 * FRAMES * spf / rate
    segs, meta = [], []
    for seed in range(SEED, SEED + PIECES):
        stream, settings = encode(piece(seed, rate, seconds), rate)
        last = layer3.frames(stream)[FRAMES - 1]
        segs.append(stream[:last["offset"] + last["size"]])
        meta.append({"seed": seed, "bytes": len(segs[-1])})
    data = b"".join(segs)
    with open(os.path.join(HERE, "streams", name + ".mp3"), "wb") as f:
        f.write(data)
    info = {"encoder": settings, "sample_rate": rate,
            "samples_per_frame": spf, "frames": FRAMES,
            "seconds_encoded": seconds,
            "sha256": hashlib.sha256(data).hexdigest(),
            "segments": meta,
            "stats": layer3.stats([layer3.frames(s) for s in segs])}
    with open(os.path.join(HERE, "streams", name + ".json"), "w") as f:
        json.dump(info, f, indent=1)
        f.write("\n")
    return info


def main() -> None:
    os.makedirs(os.path.join(HERE, "streams"), exist_ok=True)
    for name, rate in FORMATS.items():
        info = make(name, rate)
        print(name, json.dumps(info["encoder"]), json.dumps(info["stats"]))


if __name__ == "__main__":
    main()
