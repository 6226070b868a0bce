"""Minimal RIFF/WAVE writer for decoder output.

The reference CLI emits raw S16LE (pdmp3.c OUTPUT_RAW); real users
want a self-describing file.  Supports the two PCM encodings the
framework produces: interleaved S16LE (format 1) and float32
(format 3, the ``float_pcm`` serving option).
"""
from __future__ import annotations

import struct


def wav_bytes(pcm: bytes, sample_rate: int, channels: int,
              sample_format: str = "s16") -> bytes:
    """Wrap interleaved PCM in a WAV container.

    ``sample_format``: ``"s16"`` (S16LE) or ``"f32"`` (IEEE float).
    """
    if sample_format == "s16":
        fmt, bits = 1, 16
    elif sample_format == "f32":
        fmt, bits = 3, 32
    else:
        raise ValueError(f"unknown sample_format {sample_format!r}")
    block = channels * bits // 8
    byte_rate = sample_rate * block
    header = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(pcm), b"WAVE",
        b"fmt ", 16, fmt, channels, sample_rate, byte_rate, block, bits,
        b"data", len(pcm))
    return header + pcm


def write_wav(path: str, pcm: bytes, sample_rate: int, channels: int,
              sample_format: str = "s16") -> None:
    with open(path, "wb") as f:
        f.write(wav_bytes(pcm, sample_rate, channels, sample_format))
