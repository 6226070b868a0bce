"""External production-decoder oracle via the system libavcodec.

Counterpart of ``pdmp3_tpu/testing/avref.py``.  The reference binary
rejects everything but MPEG-1 Layer III (pdmp3.c:1240,1295), so the
capability extensions — LSF (MPEG-2/2.5) and Layer I/II — rest on
in-tree agreement unless an independent decoder anchors them.  This
module builds the port's own copies of the JAX package's libav helpers
(``testing/csrc/av_oracle.c``, ``av_encode.c``, ``av_encmux.c``,
``av_remux.c``) into ``build/torch_host/`` and exposes a decoder, an
encoder, an encoder-muxer and a remuxer.  Every ``ensure_*`` returns
None where libavcodec / libavformat or their headers are absent; the
callers then skip.

Comparison semantics (tests/test_av_oracle.py):

- libavcodec's float decoders do NOT clip; our S16 path clips at
  ±32767.  mp3gen streams are routinely overdriven, so av PCM must be
  clipped to ``±32767/32768`` before diffing.
- MPEG-1/LSF MS stereo: the reference processes the butterfly only
  below ``min(count1[l], count1[r])`` (pdmp3.c:1920) — lines in
  ``[min,max)`` keep the raw mid signal.  A conformant decoder (ffmpeg)
  butterflies the full spectrum, so MS joint-stereo streams only agree
  where the two channels' count1 coincide.
- count1table_select==1 streams must be generated with
  ``spec_conformant=True`` (real ISO table B codes) and decoded with
  ``Frontend(count1_table_b_spec=True)``; the default emulates the
  reference's broken stale-pointer table.
"""
from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                      "torch_host")
_AVCODEC = ["-lavcodec", "-lavutil"]
_AVFORMAT = ["-lavformat", "-lavcodec", "-lavutil"]


def _ensure(name: str, libs: list[str]) -> str | None:
    """build/torch_host/`name`, compiled from csrc/`name`.c when missing
    or older than its source (to a temporary path, then moved into
    place); None when the libraries cannot be linked."""
    src = os.path.join(_CSRC, name + ".c")
    exe = os.path.join(_BUILD, name)
    if os.path.exists(exe) and os.path.getmtime(exe) >= os.path.getmtime(src):
        return exe
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{exe}.{os.getpid()}.tmp"
    try:
        subprocess.run(["gcc", "-O2", "-o", tmp, src, *libs], check=True,
                       capture_output=True)
        os.replace(tmp, exe)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return exe


def ensure_av_oracle() -> str | None:
    """Build av_oracle on demand; None when libavcodec is unavailable."""
    return _ensure("av_oracle", _AVCODEC)


def ensure_av_encode() -> str | None:
    """Build av_encode on demand; None when libavcodec is unavailable."""
    return _ensure("av_encode", _AVCODEC)


def ensure_av_encmux() -> str | None:
    """Build av_encmux on demand; None when libavformat is unavailable."""
    return _ensure("av_encmux", _AVFORMAT)


def ensure_av_remux() -> str | None:
    """Build av_remux on demand; None when libavformat is unavailable."""
    return _ensure("av_remux", _AVFORMAT)


def av_encode(pcm: np.ndarray, codec: str, rate: int, channels: int,
              bitrate: int, mode: str = "cbr", **extras) -> bytes:
    """Encode interleaved float32 PCM with a libavcodec encoder (mp2,
    libshine, libmp3lame) — ground-truth bitstreams from production
    encoders, independent of our own generator's table choices.

    ``mode``: "cbr" (default), "abr", or "vbr:<q>" (libmp3lame).
    ``extras``: LAME preset axes forwarded as key=value — q (algorithmic
    quality 0-9), cutoff (lowpass Hz), js (joint stereo 0/1),
    reservoir (0/1)."""
    binpath = ensure_av_encode()
    if binpath is None:
        raise RuntimeError("libavcodec unavailable")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.f32")
        dst = os.path.join(d, "out.bin")
        np.asarray(pcm, np.float32).tofile(src)
        args = [binpath, src, dst, codec, str(rate), str(channels),
                str(bitrate), mode]
        args += [f"{k}={v}" for k, v in extras.items()]
        subprocess.run(args, check=True, capture_output=True)
        with open(dst, "rb") as f:
            return f.read()


def av_decode(stream: bytes, codec: str = "mp3",
              clip: bool = True) -> np.ndarray:
    """Decode an MPEG audio stream with libavcodec.

    Returns interleaved float32 PCM (all channels).  ``codec`` selects
    the Layer: mp1 / mp2 / mp3.  ``clip`` applies the S16 full-scale
    clip our quantize path applies (pdmp3.c:2028-2031), making the
    result directly comparable to our S16 output / 32768.
    """
    binpath = ensure_av_oracle()
    if binpath is None:
        raise RuntimeError("libavcodec unavailable")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.bin")
        dst = os.path.join(d, "out.raw")
        with open(src, "wb") as f:
            f.write(stream)
        subprocess.run([binpath, src, dst, codec], check=True,
                       capture_output=True)
        pcm = np.fromfile(dst, np.float32)
    if clip:
        pcm = np.clip(pcm, -32767.0 / 32768.0, 32767.0 / 32768.0)
    return pcm


def av_encmux(pcm: np.ndarray, rate: int, channels: int, bitrate: int,
              mode: str = "cbr") -> bytes:
    """Encode f32 PCM with libmp3lame THROUGH libavformat's mp3 muxer —
    the muxer sees the live encoder, so the Xing/LAME tag carries the
    real encoder delay/padding (the gapless anchor av_remux can't
    produce from an elementary stream)."""
    binpath = ensure_av_encmux()
    if binpath is None:
        raise RuntimeError("libavformat unavailable")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.f32")
        dst = os.path.join(d, "out.mp3")
        np.asarray(pcm, np.float32).tofile(src)
        subprocess.run([binpath, src, dst, str(rate), str(channels),
                        str(bitrate), mode], check=True, capture_output=True)
        with open(dst, "rb") as f:
            return f.read()


def av_remux(stream: bytes, *, id3v2: int = 0, id3v1: bool = False,
             metadata: dict | None = None) -> bytes:
    """Remux an MP3 elementary stream through libavformat's mp3 muxer,
    which prepends a production Xing/Info metadata frame — an external
    tag-*writer* oracle for pdmp3_tpu_torch.metadata's parser.

    ``metadata`` key/value pairs are written by libavformat's tag
    writer as ID3v2.{3,4} text frames (``id3v2``) and/or an ID3v1
    trailer (``id3v1``) — the anchor for the ID3 field parsers."""
    binpath = ensure_av_remux()
    if binpath is None:
        raise RuntimeError("libavformat unavailable")
    args = []
    if id3v2:
        args += ["--id3v2", str(id3v2)]
    if id3v1:
        args += ["--id3v1"]
    for k, v in (metadata or {}).items():
        args.append(f"{k}={v}")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.mp3")
        dst = os.path.join(d, "out.mp3")
        with open(src, "wb") as f:
            f.write(stream)
        subprocess.run([binpath, src, dst, *args], check=True,
                       capture_output=True)
        with open(dst, "rb") as f:
            return f.read()
