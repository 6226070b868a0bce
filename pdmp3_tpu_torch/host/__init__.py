"""ctypes bindings for the port's copy of the native host library
(libpdmp3host_torch.so, built from this package's ``host/src``).

Exposes the pdmp3-compatible streaming API (NativePDMP3) and the batch
frontend (parse_frame -> granule tensors) that feeds the port's device
half.  The sources are those of the JAX package's host library, so a
handle blob saved by either restores into the other.  The library builds
on demand with g++ (see build.py).
"""
from __future__ import annotations

import ctypes as C

import numpy as np

from .build import cli_bin, ensure_built

_lib = None


class _Granules(C.Structure):
    _fields_ = [
        ("ix", C.c_int16 * (2 * 2 * 576)),
        ("scf_l", C.c_uint8 * (2 * 2 * 22)),
        ("scf_s", C.c_uint8 * (2 * 2 * 13 * 3)),
        ("layout", C.c_int32 * 4),
        ("block_type", C.c_int32 * 4),
        ("win_switch", C.c_int32 * 4),
        ("mixed", C.c_int32 * 4),
        ("global_gain", C.c_int32 * 4),
        ("scalefac_scale", C.c_int32 * 4),
        ("preflag", C.c_int32 * 4),
        ("subblock_gain", C.c_int32 * 12),
        ("count1", C.c_int32 * 4),
        ("ms_flag", C.c_int32),
        ("is_flag", C.c_int32),
        ("nch", C.c_int32),
        ("sample_rate", C.c_int32),
        # MPEG-2/2.5 LSF extension (PDMP3_PROFILE_LSF handles)
        ("family", C.c_int32),
        ("iscale", C.c_int32),
        ("is_pos_l", C.c_int16 * 22),
        ("is_pos_s", C.c_int16 * (13 * 3)),
        ("is_pos_pad", C.c_int16),
        # Layer I/II (PDMP3_PROFILE_L12): layer 1/2 frames carry
        # requantized subband samples; layer == 3 leaves sb_samples stale
        ("layer", C.c_int32),
        ("nparts", C.c_int32),
        ("sb_samples", C.c_float * (2 * 36 * 32)),
    ]


def lib() -> C.CDLL:
    global _lib
    if _lib is None:
        path = ensure_built()
        _lib = C.CDLL(path)
        _lib.pdmp3_new.restype = C.c_void_p
        _lib.pdmp3_new.argtypes = [C.c_char_p, C.POINTER(C.c_int)]
        _lib.pdmp3_delete.argtypes = [C.c_void_p]
        _lib.pdmp3_open_feed.argtypes = [C.c_void_p]
        _lib.pdmp3_feed.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
        _lib.pdmp3_read.argtypes = [C.c_void_p, C.c_void_p, C.c_size_t,
                                    C.POINTER(C.c_size_t)]
        _lib.pdmp3_decode.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t,
                                      C.c_void_p, C.c_size_t,
                                      C.POINTER(C.c_size_t)]
        _lib.pdmp3_getformat.argtypes = [C.c_void_p, C.POINTER(C.c_long),
                                         C.POINTER(C.c_int),
                                         C.POINTER(C.c_int)]
        _lib.pdmp3_parse_frame.argtypes = [C.c_void_p, C.POINTER(_Granules)]
        _lib.pdmp3_inbuf_filled.argtypes = [C.c_void_p]
        _lib.pdmp3_inbuf_filled.restype = C.c_uint
        _lib.pdmp3_inbuf_free.argtypes = [C.c_void_p]
        _lib.pdmp3_inbuf_free.restype = C.c_uint
        _lib.pdmp3_dsp_frame.argtypes = [C.c_void_p, C.POINTER(_Granules),
                                         C.c_void_p]
        _lib.pdmp3_state_size.restype = C.c_size_t
        _lib.pdmp3_state_save.argtypes = [C.c_void_p, C.c_void_p]
        _lib.pdmp3_state_restore.argtypes = [C.c_void_p, C.c_void_p]
        _lib.pdmp3_set_profile.argtypes = [C.c_void_p, C.c_uint]
        _lib.pdmp3_get_profile.argtypes = [C.c_void_p]
        _lib.pdmp3_get_profile.restype = C.c_uint
    return _lib


# decode-profile flags (pdmp3.h): default 0 = bit-exact reference-bug
# emulation; see PDMP3_PROFILE_* docs
PROFILE_COUNT1B_SPEC = 1
PROFILE_SPEC_INTENSITY = 2
PROFILE_LSF = 4  # accept MPEG-2 / MPEG-2.5 (13818-3 LSF) streams
PROFILE_FREE_FORMAT = 8  # accept free-format bitrate (sync-spacing size)
PROFILE_ID3 = 16  # skip ID3v2 tags (incremental across NEED_MORE)
PROFILE_L12 = 32  # also decode Layer I/II frames (beyond-reference)
PROFILE_CRC = 64  # verify ISO CRC-16; skip failing frames (ref discards)


class NativePDMP3:
    """pdmp3-compatible stream handle backed by the C library."""

    def __init__(self):
        err = C.c_int(0)
        self._h = lib().pdmp3_new(None, C.byref(err))
        if not self._h:
            raise MemoryError("pdmp3_new failed")

    def __del__(self):
        if getattr(self, "_h", None):
            lib().pdmp3_delete(self._h)
            self._h = None

    def open_feed(self) -> int:
        return lib().pdmp3_open_feed(self._h)

    def feed(self, data: bytes) -> int:
        return lib().pdmp3_feed(self._h, data, len(data))

    def read(self, outsize: int) -> tuple[int, bytes]:
        buf = C.create_string_buffer(outsize)
        done = C.c_size_t(0)
        res = lib().pdmp3_read(self._h, buf, outsize, C.byref(done))
        return res, buf.raw[:done.value]

    def decode(self, data: bytes, outsize: int) -> tuple[int, bytes]:
        buf = C.create_string_buffer(max(outsize, 1))
        done = C.c_size_t(0)
        res = lib().pdmp3_decode(self._h, data, len(data),
                                 buf if outsize else None, outsize,
                                 C.byref(done))
        return res, buf.raw[:done.value]

    def getformat(self) -> tuple[int, int, int, int]:
        rate = C.c_long(0)
        ch = C.c_int(0)
        enc = C.c_int(0)
        res = lib().pdmp3_getformat(self._h, C.byref(rate), C.byref(ch),
                                    C.byref(enc))
        return res, rate.value, ch.value, enc.value

    def set_profile(self, flags: int) -> None:
        """Select the decode profile (PROFILE_* flags; 0 = reference
        parity).  Survives open_feed and checkpoints."""
        lib().pdmp3_set_profile(self._h, flags)

    def get_profile(self) -> int:
        return lib().pdmp3_get_profile(self._h)

    def inbuf_filled(self) -> int:
        return lib().pdmp3_inbuf_filled(self._h)

    def inbuf_free(self) -> int:
        return lib().pdmp3_inbuf_free(self._h)

    def save_state(self) -> bytes:
        """Checkpoint: the full resumable stream state as one blob."""
        n = lib().pdmp3_state_size()
        buf = C.create_string_buffer(n)
        lib().pdmp3_state_save(self._h, buf)
        return buf.raw

    def restore_state(self, blob: bytes) -> None:
        assert len(blob) == lib().pdmp3_state_size()
        lib().pdmp3_state_restore(self._h, blob)

    def parse_frame(self):
        """Native frontend: parse one frame -> granule dict of numpy
        arrays (layouts match models.decoder.GranuleBatch), or (status,
        None)."""
        g = _Granules()
        res = lib().pdmp3_parse_frame(self._h, C.byref(g))
        if res != 0:
            return res, None
        if g.layer in (1, 2):
            # Layer I/II frame (PROFILE_L12): subband samples only
            S = int(g.nparts)
            sb = np.ctypeslib.as_array(g.sb_samples) \
                .reshape(2, 36, 32)[:, :S].copy()
            return 0, {
                "layer": int(g.layer), "nparts": S, "sb_samples": sb,
                "nch": int(g.nch), "sample_rate": int(g.sample_rate),
                "family": int(g.family),
            }
        out = {
            "ix": np.ctypeslib.as_array(g.ix).reshape(2, 2, 576).copy(),
            "scf_l": np.ctypeslib.as_array(g.scf_l).reshape(2, 2, 22)
            .astype(np.int32),
            "scf_s": np.ctypeslib.as_array(g.scf_s).reshape(2, 2, 13, 3)
            .astype(np.int32),
            "ms_flag": int(g.ms_flag), "is_flag": int(g.is_flag),
            "nch": int(g.nch), "sample_rate": int(g.sample_rate),
            "family": int(g.family), "iscale": int(g.iscale),
            "is_pos_l": np.ctypeslib.as_array(g.is_pos_l)
            .astype(np.int32),
            "is_pos_s": np.ctypeslib.as_array(g.is_pos_s)
            .reshape(13, 3).astype(np.int32),
        }
        for name in ("layout", "block_type", "win_switch", "mixed",
                     "global_gain", "scalefac_scale", "preflag", "count1"):
            out[name] = np.ctypeslib.as_array(getattr(g, name)) \
                .reshape(2, 2).copy()
        out["subblock_gain"] = np.ctypeslib.as_array(g.subblock_gain) \
            .reshape(2, 2, 3).copy()
        return 0, out

    def dsp_frame(self, granules: _Granules) -> np.ndarray:
        out = np.zeros((2, 576), np.uint32)
        lib().pdmp3_dsp_frame(self._h, C.byref(granules),
                              out.ctypes.data_as(C.c_void_p))
        return out


def native_decode_file(data: bytes, chunk: int = 4096,
                       profile: int = 0) -> bytes:
    """CLI-equivalent loop through the native library."""
    h = NativePDMP3()
    if profile:
        h.set_profile(profile)
    h.open_feed()
    pos = 0
    out = []
    while True:
        res, pcm = h.read(16384)
        out.append(pcm)
        if res == -1:
            break
        if res == -10:
            if pos >= len(data):
                break
            h.feed(data[pos:pos + chunk])
            pos += chunk
    return b"".join(out)


def cli_path() -> str:
    """The port's native ``pdmp3`` CLI, built on first use."""
    return cli_bin()
