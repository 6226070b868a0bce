"""The port's testing helpers (pdmp3_tpu_torch/testing/) against the JAX
package's (pdmp3_tpu/testing/):

- ``golden.first_oob_frame`` gives the same offset on streams whose
  big_values run past 576 lines and on streams that stay inside, and
  ``golden.reference_decode`` the same bytes where the reference binary
  builds (it skips where its C sources are absent);
- ``avref``'s libav decoder, encoder, encoder-muxer and remuxer, built
  from the port's copies of ``tools/av_*.c``, give the JAX helpers'
  bytes (skipped where libavcodec / libavformat are absent);
- ``mpg123ref`` and ``signals`` (byte-equal copies) give the same PCM.

Tolerance: none; every comparison is equality.
"""
import subprocess

import numpy as np
import pytest

from pdmp3_tpu.testing import avref as jax_avref
from pdmp3_tpu.testing import golden as jax_golden
from pdmp3_tpu.testing import mpg123ref as jax_mpg123
from pdmp3_tpu.testing import signals as jax_signals
from pdmp3_tpu_torch.testing import avref, golden, mp3gen, mpg123ref, signals


def _frame_starts(stream: bytes) -> list[int]:
    """Offsets of the frames of a CBR mp3gen stream: syncs with the first
    header's two bytes, each at least 400 bytes past the previous."""
    starts = [0]
    for i in range(1, len(stream) - 1):
        if stream[i:i + 2] == stream[:2] and i - starts[-1] >= 400:
            starts.append(i)
    return starts


def _overrun(frame: int) -> bytes:
    """A 44.1 kHz stereo stream whose frame `frame` has granule 0 ch 0's
    big_values near 511 (its side info's byte 8 set), past 576 lines."""
    s = bytearray(mp3gen.make_stream(n_frames=8, seed=62, blocks="long"))
    s[_frame_starts(bytes(s))[frame] + 8] = 0xFF
    return bytes(s)


OOB_STREAMS = {
    "overrun_frame_2": lambda: _overrun(2),
    "overrun_frame_5": lambda: _overrun(5),
    "clean_long": lambda: mp3gen.make_stream(n_frames=8, seed=62,
                                             blocks="long"),
    "clean_varied_ms": lambda: mp3gen.make_stream(
        n_frames=8, seed=63, blocks="varied", mode=1, mode_extension=2,
        use_reservoir=True),
}


@pytest.mark.parametrize("name", sorted(OOB_STREAMS))
def test_first_oob_frame_equals_jax(name):
    stream = OOB_STREAMS[name]()
    got = golden.first_oob_frame(stream)
    assert got == jax_golden.first_oob_frame(stream)
    assert (got is not None) == name.startswith("overrun")


def test_reference_status_names_why_it_is_missing():
    status = golden.reference_status()
    assert status == "built" or status.startswith("not built: ")
    assert golden.BUILD_DIR != jax_golden.BUILD_DIR


def test_reference_decode_equals_jax():
    try:
        golden.ensure_reference_binary()
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the reference decoder cannot be built here ({e})")
    stream = OOB_STREAMS["clean_varied_ms"]()
    assert golden.reference_decode(stream) == \
        jax_golden.reference_decode(stream)


def _need(path):
    if path is None:
        pytest.skip("libavcodec / libavformat unavailable")


def test_av_decode_equals_jax():
    _need(avref.ensure_av_oracle())
    stream = OOB_STREAMS["clean_varied_ms"]()
    got = avref.av_decode(stream)
    assert got.size > 0
    np.testing.assert_array_equal(got, jax_avref.av_decode(stream))


@pytest.mark.parametrize("codec,rate,channels,bitrate,mode", [
    ("libmp3lame", 44100, 2, 128000, "vbr:4"),
    ("libshine", 32000, 1, 64000, "cbr")])
def test_av_encode_equals_jax(codec, rate, channels, bitrate, mode):
    _need(avref.ensure_av_encode())
    pcm = signals.make_pcm("transient", rate, channels, seconds=0.3,
                           seed=913)
    got = avref.av_encode(pcm, codec, rate, channels, bitrate, mode)
    assert len(got) > 400
    assert got == jax_avref.av_encode(pcm, codec, rate, channels, bitrate,
                                      mode)


def test_av_encmux_and_remux_equal_jax():
    _need(avref.ensure_av_encmux())
    _need(avref.ensure_av_remux())
    pcm = signals.make_pcm("sweep", 48000, 2, seconds=0.3, seed=915)
    muxed = avref.av_encmux(pcm, 48000, 2, 128000, "vbr:5")
    assert muxed == jax_avref.av_encmux(pcm, 48000, 2, 128000, "vbr:5")
    stream = OOB_STREAMS["clean_long"]()
    kw = dict(id3v2=3, id3v1=True, metadata={"title": "t", "artist": "a"})
    remuxed = avref.av_remux(stream, **kw)
    assert len(remuxed) > len(stream)
    assert remuxed == jax_avref.av_remux(stream, **kw)


def test_mpg123_decode_equals_jax():
    if not mpg123ref.have_mpg123():
        pytest.skip("libmpg123 unavailable")
    stream = OOB_STREAMS["clean_varied_ms"]()
    got = mpg123ref.mpg123_decode(stream)
    assert got.size > 0
    np.testing.assert_array_equal(got, jax_mpg123.mpg123_decode(stream))


@pytest.mark.parametrize("material", ["transient", "tonal", "sweep",
                                      "noise", "speech", "silence",
                                      "clipped", "dc"])
def test_signals_equal_jax(material):
    got = signals.make_pcm(material, 22050, 2, seconds=0.2, seed=5)
    np.testing.assert_array_equal(
        got, jax_signals.make_pcm(material, 22050, 2, seconds=0.2, seed=5))
