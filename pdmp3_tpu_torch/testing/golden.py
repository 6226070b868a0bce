"""Golden-reference harness: build and run the upstream C decoder.

Counterpart of ``pdmp3_tpu/testing/golden.py``, over the port's own
``api`` and ``tables``.  Builds the reference decoder from
``/root/reference`` with -DOUTPUT_RAW (the deterministic file-output
configuration, Makefile:15) into ``build/torch_ref/`` (apart from the
JAX package's ``build/ref/``, so the two never race) and runs it on byte
strings, returning the packed S16LE PCM it produces.

The reference's C sources are not part of this repository.  Where they
are absent, ``ensure_reference_binary`` raises (``OSError`` or
``subprocess.CalledProcessError``) and ``reference_status`` says why:
tests skip, tools record ``"reference": "not built: <reason>"``, and the
port's native decoder (``host.native_decode_file``, bit-exact with the
reference CLI) stays the oracle that is always there.
"""
from __future__ import annotations

import os
import subprocess
import tempfile

REF_SRC = "/root/reference"
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "torch_ref")
BIN = os.path.join(BUILD_DIR, "pdmp3_ref")

CFLAGS = ("-Os -ffast-math -fassociative-math -fomit-frame-pointer "
          "-ffinite-math-only -fno-math-errno -fno-trapping-math "
          "-freciprocal-math -frounding-math -funsafe-math-optimizations "
          "-DOUTPUT_RAW -DIMDCT_TABLES -DIMDCT_NTABLES -DPOW34_TABLE "
          "-DNDEBUG").split()


def ensure_reference_binary() -> str:
    """Path of the reference binary, compiled on first use (linked to a
    temporary path and moved into place, so parallel callers never run a
    half-written file)."""
    if os.path.exists(BIN):
        return BIN
    srcs = [os.path.join(REF_SRC, "pdmp3.c"), os.path.join(REF_SRC, "main.c")]
    for s in srcs:
        if not os.path.exists(s):
            raise FileNotFoundError(f"reference source {s} is absent")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{BIN}.{os.getpid()}.tmp"
    try:
        subprocess.run(["gcc", *CFLAGS, "-o", tmp, *srcs, "-lm"], check=True,
                       capture_output=True)
        os.replace(tmp, BIN)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return BIN


def reference_status() -> str:
    """"built" when the reference binary is available, else "not built:
    <reason>" (the record a tool writes in place of its comparison)."""
    try:
        ensure_reference_binary()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"not built: {e}"
    return "built"


def first_oob_frame(stream: bytes) -> int | None:
    """PCM byte offset at which bit-parity with the reference stops being
    defined: the start of the first decoded frame where any granule's
    spectrum extent escapes the defined region — count1/big_values past
    576 lines (the reference overflows is[] and corrupts its own handle,
    pdmp3.c:2078-2088).  The in-bounds scalefactor OOB aliasing (count1
    past band 21/12 but <= 576) is emulated exactly and needs no carve-
    out.  Instruments the exact decode_file feed/read loop: in starved
    regimes the parse results depend on feed boundaries.  None if the
    stream never hits it."""
    from .. import tables as TT
    from ..api import PDMP3

    oob_at = None

    class Spy(PDMP3):
        def read(self, outsize):
            nonlocal oob_at
            orig = self.fe.read_frame

            def spy():
                nonlocal oob_at
                res, fd = orig()
                if res == TT.OK and oob_at is None:
                    s = fd.side
                    for gr in range(2):
                        for ch in range(fd.header.nch):
                            if (int(s.count1[gr][ch]) > 576
                                    or int(s.big_values[gr][ch]) * 2 > 576):
                                oob_at = self._pcm_bytes
                    self._pcm_bytes += 1152 * 2 * fd.header.nch
                return res, fd

            self.fe.read_frame = spy
            try:
                return super().read(outsize)
            finally:
                self.fe.read_frame = orig

    h = Spy()
    h._pcm_bytes = 0
    h.open_feed()
    pos = 0
    while True:
        res, _ = h.read(TT.INBUF_SIZE)
        if res == TT.ERR or oob_at is not None:
            break
        if res == TT.NEED_MORE:
            if pos >= len(stream):
                break
            h.feed(stream[pos:pos + 4096])
            pos += 4096
    return oob_at


def reference_decode(stream: bytes, timeout: float = 120.0) -> bytes:
    """Decode an MP3 byte string with the reference binary -> S16LE PCM."""
    binpath = ensure_reference_binary()
    with tempfile.TemporaryDirectory() as d:
        mp3 = os.path.join(d, "in.mp3")
        with open(mp3, "wb") as f:
            f.write(stream)
        subprocess.run([binpath, mp3], cwd=d, timeout=timeout,
                       capture_output=True)
        raw = mp3 + ".raw"
        if not os.path.exists(raw):
            return b""
        with open(raw, "rb") as f:
            return f.read()


def probe_is_ratio_oob():
    """Read what the reference binary's Stereo_Process_Intensity_Long
    actually loads for is_pos 6..15: the 10 float32 words following
    is_ratios[6] in the built binary's .rodata (the section maps
    verbatim, so file bytes == the bytes the OOB loads hit).  Used by
    the provenance test for tables.IS_RATIO_OOB_BITS."""
    import numpy as np

    with open(ensure_reference_binary(), "rb") as f:
        blob = f.read()
    pat = np.array([0.000000, 0.267949, 0.577350, 1.000000, 1.732051,
                    3.732051], np.float32).tobytes()
    idx = blob.find(pat)
    if idx < 0 or blob.find(pat, idx + 1) >= 0:
        raise RuntimeError("is_ratios pattern not unique in the reference "
                           "binary")
    return np.frombuffer(blob[idx + len(pat):idx + len(pat) + 40],
                         np.uint32).copy()
