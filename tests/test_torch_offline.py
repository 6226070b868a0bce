"""The port's offline corpus decode (pdmp3_tpu_torch/models/offline.py
decode_files_scan) on the CPU against the native scalar decoder, as
tests/test_runtime.py holds the JAX package's, and its parse against the
JAX package's parse_corpus.

Tolerances: the parsed corpus equal; exact mode byte-equal to the native
decoder over the aligned prefix (the scan may decode trailing frames the
native decoder holds back); fast mode at most 1 LSB on fewer than 1% of
samples.
"""
import numpy as np
import pytest

from pdmp3_tpu.host import native_decode_file
from pdmp3_tpu.models import offline as jax_offline
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch.models.offline import decode_files_scan, parse_corpus
from test_torch_fused_step import assert_pcm_contract


@pytest.fixture(scope="module")
def corpus():
    """tests/test_runtime.py's corpus: long, short, MS, mixed 32 kHz,
    mono, 48 kHz with the bit reservoir."""
    def mk(seed, **kw):
        return mp3gen.make_stream(n_frames=6, seed=seed, **kw)
    return [mk(70, blocks="long"), mk(71, blocks="short"),
            mk(72, blocks="varied", mode=1, mode_extension=2),
            mk(73, blocks="mixed", sfreq=2), mk(74, blocks="long", mode=3),
            mk(75, blocks="varied", sfreq=1, use_reservoir=True)]


class _ZeroedNumpy:
    """numpy with np.empty giving zeros: the parse does not write every
    word of its buffers (a mono file's ch1, meta words it has no field
    for), which the JAX package allocates uninitialised."""

    def __getattr__(self, name):
        return np.zeros if name == "empty" else getattr(np, name)


def test_parse_corpus_equals_jax(corpus, monkeypatch):
    """The parsed corpus equals the JAX package's, a file shorter than T
    included, with the JAX buffers zeroed as the port's are."""
    monkeypatch.setattr(jax_offline, "np", _ZeroedNumpy())
    files = corpus + [corpus[0][:1500]]
    got, want = parse_corpus(files), jax_offline.parse_corpus(files)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_scan_decode_equals_native(corpus, exact):
    got = decode_files_scan(corpus, exact=exact, device="cpu")
    for i, data in enumerate(corpus):
        want = native_decode_file(data)
        n = min(len(got[i]), len(want))
        assert n >= len(want) - 2 * 1152 * 2 * 2
        if exact:
            assert got[i][:n] == want[:n], f"file {i}"
        else:
            assert_pcm_contract(np.frombuffer(got[i][:n], "<i2"),
                                np.frombuffer(want[:n], "<i2"), f"file {i}")


def test_scan_decode_uneven_lengths_and_empty(corpus):
    """Files of other lengths pad with idle steps (state frozen); an
    empty corpus and an unparseable file give empty PCM."""
    files = [corpus[1][:1800], corpus[2], b"\x00" * 300]
    got = decode_files_scan(files, exact=True, device="cpu")
    for i in range(2):
        want = native_decode_file(files[i])
        n = min(len(got[i]), len(want))
        assert n >= len(want) - 2 * 1152 * 2 * 2 and n > 0
        assert got[i][:n] == want[:n], f"file {i}"
    assert got[2] == b""
    assert decode_files_scan([b"\x00" * 10], device="cpu") == [b""]
