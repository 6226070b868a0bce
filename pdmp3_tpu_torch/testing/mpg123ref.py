"""Second external production-decoder oracle: libmpg123 via ctypes.

libavcodec (testing/avref.py) was the only out-of-tree decode anchor
until round 5, when real-encoder LSF conformance exposed an ecosystem
split: the ISO 13818-3 24 kHz long-band table's entry 18 is 332 in the
dist10/LAME/mpg123 lineage but 330 in libavcodec (see
tables._SFB_L_24).  Arbitrating that required a THIRD opinion, and
libmpg123 — the codebase whose streaming API the reference mirrors
(README.md:6-16) — ships in this image.  This module binds its feed
API with ctypes (no headers needed) and exposes the same comparison
surface as avref.av_decode.

Comparison semantics: mpg123's default output is s16, produced by its
own float pipeline with rounding, so agreement with our S16 PCM is
tolerance-based (~1.5e-3 full scale for synthetic streams), the same
bar as the libavcodec anchor.
"""
from __future__ import annotations

import ctypes

import numpy as np

_LIB = None
_INIT_FAILED = False


def _load():
    global _LIB, _INIT_FAILED
    if _LIB is not None or _INIT_FAILED:
        return _LIB
    try:
        m = ctypes.CDLL("libmpg123.so.0")
        m.mpg123_init()
        m.mpg123_new.restype = ctypes.c_void_p
        m.mpg123_new.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int)]
        m.mpg123_open_feed.argtypes = [ctypes.c_void_p]
        m.mpg123_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        m.mpg123_delete.argtypes = [ctypes.c_void_p]
        _LIB = m
    except OSError:
        _INIT_FAILED = True
    return _LIB


def have_mpg123() -> bool:
    return _load() is not None


def mpg123_decode(stream: bytes) -> np.ndarray:
    """Decode an MPEG audio stream with libmpg123's feed API.

    Returns interleaved float32 PCM in [-1, 1) (s16 / 32768), all
    channels — directly comparable to our S16 output and to
    avref.av_decode(clip=True).
    """
    m = _load()
    if m is None:
        raise RuntimeError("libmpg123 unavailable")
    err = ctypes.c_int(0)
    h = m.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        m.mpg123_open_feed(h)
        out = ctypes.create_string_buffer(1 << 22)
        done = ctypes.c_size_t(0)
        pcm = []
        m.mpg123_decode(h, stream, len(stream), None, 0,
                        ctypes.byref(done))
        for _ in range(100000):
            m.mpg123_decode(h, None, 0, out, len(out),
                            ctypes.byref(done))
            if done.value == 0:
                break
            pcm.append(bytes(out.raw[:done.value]))
    finally:
        m.mpg123_delete(h)
    return np.frombuffer(b"".join(pcm), "<i2").astype(np.float32) / 32768.0
