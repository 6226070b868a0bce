"""MPEG-1 Layer II broadcast streams (48 kHz, 256 kbps, joint stereo, a
CRC in every frame, as DAB and DVB carry them; twolame's output kept in
``benchmark/streams/twolame_48k_stereo.mp2``) through the port's Layer II
pool on the CPU, against the benchmark's plain Layer II reference
(``benchmark/reference/layer2.py``), and the reference against the
native ``PROFILE_L12`` decode.

``L12StreamDecoder`` at 8 slots plays the looped segments from the
frames that the benchmark's corpus draws from a seed, for a pass over
the loop and two frames more (the second pass's first frame starts from
the FIFO the loop's last frame left).  Tolerances: the exact pool
bitwise; the fast pool within 1 LSB on fewer than 1% of samples (the
fast contract, ``assert_pcm_contract``).
"""
import numpy as np
import pytest

from benchmark import corpus
from benchmark.readers import layer2 as R2
from benchmark.readers import layer3 as R3
from benchmark.reference import layer2 as REF
from pdmp3_tpu_torch import L12StreamDecoder, LoopFeeder
from pdmp3_tpu_torch.host import PROFILE_L12, native_decode_file
from test_torch_fused_step import assert_pcm_contract

STREAMS = "twolame_48k_stereo"
FMT = {"family": 0, "layer": 2}
SLOTS = 8
MIX = {"distinct": 3, "watch": {"sources": 1, "slots_per_source": 1}}
SEEDS = [20261018, 2**31 + 77]


@pytest.fixture(scope="module", params=SEEDS)
def served(request):
    """A corpus of 8 slots from the seed, each slot's reference frames
    (a pass over its loop from its rotation, then the second pass's
    first two), and the PCM of the fast and the exact pool over as many
    steps."""
    c = corpus.build(STREAMS, MIX, SLOTS, request.param, R2)
    want, refs = [], {}
    for s, r in zip(c.source.tolist(), c.rotation.tolist()):
        if (s, r) not in refs:
            st = c.streams[s]
            refs[s, r] = REF.periods(st["data"], st["offsets"], r, FMT)
        first, second = refs[s, r]
        want.append(np.concatenate([first, second[:2]]))
    steps = c.period + 2
    got = {}
    for exact in (False, True):
        dec = L12StreamDecoder(SLOTS, layer=2, exact=exact, device="cpu")
        feeder = LoopFeeder(dec, c.feeds)
        pcm = []
        for _ in range(steps):
            feeder.step()
            assert dec.parse_step() == SLOTS
            pcm.append(dec.decode_step())
        got[exact] = np.stack(pcm, 1)              # [slots, steps, 1152, 2]
    return c, np.stack(want), got


def test_rotations_differ(served):
    c, _, _ = served
    assert len(set(zip(c.source.tolist(), c.rotation.tolist()))) > 1


def test_exact_pool_equals_the_reference(served):
    _, want, got = served
    assert got[True].shape == want.shape
    np.testing.assert_array_equal(got[True], want)


def test_fast_pool_is_within_the_fast_contract(served):
    _, want, got = served
    assert got[False].shape == want.shape
    assert_pcm_contract(got[False], want, "fast pool")


@pytest.mark.parametrize("k", [0, 4, 63])
def test_reference_equals_the_native_decode(k):
    """0 LSB against the native PROFILE_L12 decode over a segment looped
    once (segment 4 codes two frames in intensity, 63 one)."""
    seg = corpus.load(STREAMS)[0][k]
    native = np.frombuffer(native_decode_file(seg * 2, profile=PROFILE_L12),
                           np.int16)
    n = len(native) // (2 * 1152)
    assert n == 2 * len(R2.frames(seg))
    np.testing.assert_array_equal(
        REF.decode_frames(seg * 3, n).reshape(-1), native)


def test_readers_frames_are_the_native_parse_frames():
    """The whole file: as many frames as the native decode gives, each
    768 B with a CRC, every one an entry; some in intensity stereo."""
    segs, info = corpus.load(STREAMS)
    data = b"".join(segs)
    fs = R2.frames(data)
    native = native_decode_file(data, profile=PROFILE_L12)
    assert len(native) == len(fs) * 1152 * 2 * 2
    assert len(fs) == info["frames"] * len(segs)
    assert {(f["size"], f["kbps"], f["sample_rate"], f["crc"], f["entry"])
            for f in fs} == {(768, 256, 48000, True, True)}
    assert 0 < R2.stats([fs])["mode_share"]["joint"] < 0.1


def test_each_reader_rejects_the_other_layer():
    mp2 = corpus.load(STREAMS)[0][0]
    for name in ("lame_44k1_stereo", "lame_22k05_stereo"):
        with pytest.raises(ValueError, match="no MPEG-1 Layer II header"):
            R2.frames(corpus.load(name)[0][0])
    with pytest.raises(ValueError, match="no Layer III header"):
        R3.frames(mp2)
    with pytest.raises(ValueError, match="at byte 23808 runs past the end"):
        R2.frames(mp2[:-1])
    with pytest.raises(ValueError, match="2 bytes after the last frame"):
        R2.frames(mp2 + b"\0\0")
