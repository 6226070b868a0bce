"""The Layer I/II pools' coded wire (host/src/wire_l12_codes.cc,
``pdmp3_parse_step_wire_l12_codes``) requantized by the plain version of
K9 (``ops.l12_requant.l12_requant_ref``), against the f32 packer
``pdmp3_parse_step_wire_l12``, which requantizes on the host and stays
the oracle.

Two sets of native handles take the same bytes step by step; one runs
the f32 packer, the other the coded packer and the plain requantization.
Every step: the count of active slot-frames, ``active`` and ``meta``
equal (meta rows the packers leave alone keep their fill in both), the
samples of the active slot-frames equal bit for bit, signed zeros
included, the idle ones +0.0 in the coded wire, and every handle left at
the same input position with the same state.  Cases: Layer I and II; the
five Layer II allocation tables (B.2a-d and LSF B.1), mono, stereo and
joint stereo at bounds 4, 8, 12 and 16; scfsi 0-3 (the generator draws
them); scalefactor index 63; free format; twolame's broadcast stream
(``benchmark/streams``) with its CRCs checked; a corrupt CRC; frames cut
between feeds and a stream that ends inside a frame; a stray Layer III
frame and a frame of the other layer in a pool; 70 slots on three
threads; one and two frames a step.

On the card (``cuda``-marked): K9 bit for bit against the plain version
at B = 12,800 and F = 2 for both layers, one launch a call, and one
launch a step of a Layer II pool.
"""
import ctypes as C
import os
import random

import numpy as np
import pytest
import torch

from pdmp3_tpu_torch import L12StreamDecoder, LoopFeeder
from pdmp3_tpu_torch import tables as T
from pdmp3_tpu_torch.host import (PROFILE_CRC, PROFILE_FREE_FORMAT,
                                  PROFILE_L12, PROFILE_LSF, NativePDMP3, lib)
from pdmp3_tpu_torch.models import l12 as L
from pdmp3_tpu_torch.ops import l12_requant as RQ
from pdmp3_tpu_torch.ops import launch as LA
from pdmp3_tpu_torch.testing import mp3gen
from pdmp3_tpu_torch.testing.l12wire import coded_wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWOLAME = os.path.join(REPO, "benchmark", "streams", "twolame_48k_stereo.mp2")
META_FILL = -7


def _packer(name: str, n_ptrs: int):
    fn = getattr(lib(), name)
    fn.argtypes = ([C.c_void_p, C.c_size_t, C.c_int, C.c_size_t, C.c_int]
                   + [C.c_void_p] * n_ptrs)
    return fn


def _ptr(a):
    return a.ctypes.data_as(C.c_void_p)


def _handles(n: int, profile: int) -> list:
    out = []
    for _ in range(n):
        h = NativePDMP3()
        h.set_profile(profile)
        h.open_feed()
        out.append(h)
    return out


def _serve_both(streams: list[bytes], layer: int, F: int = 1,
                profile: int = PROFILE_L12, threads: int = 1,
                chunk: int = 1 << 20, max_steps: int = 400,
                scf_seen: set | None = None) -> int:
    """Both packers over `streams`, fed alike each step (at most `chunk`
    bytes a slot and step), until every stream is fed and a step finds no
    frame; the assertions of the module's docstring every step.  Returns
    the active slot-frames seen; adds the scalefactor indices of the
    active side records to `scf_seen`."""
    B, S = len(streams), L.l12_steps(layer)
    old, new = _handles(B, profile), _handles(B, profile)
    arr_old = (C.c_void_p * B)(*[h._h for h in old])
    arr_new = (C.c_void_p * B)(*[h._h for h in new])
    f32 = _packer("pdmp3_parse_step_wire_l12", 3)
    codes = _packer("pdmp3_parse_step_wire_l12_codes", 5)
    pos = [0] * B
    seen = 0
    for _ in range(max_steps):
        for s, data in enumerate(streams):
            n = min(chunk, old[s].inbuf_free(), len(data) - pos[s])
            if n > 0:
                old[s].feed(data[pos[s]:pos[s] + n])
                new[s].feed(data[pos[s]:pos[s] + n])
                pos[s] += n
        sb = np.zeros((F, B, 2, S, 32), np.float32)
        meta = np.full((F, B, 4), META_FILL, np.int16)
        active = np.full((F, B), 9, np.int16)
        n_old = f32(arr_old, B, threads, F, layer, _ptr(sb), _ptr(meta),
                    _ptr(active))
        buf = torch.zeros(L.l12_layout(B, layer, F)["total"],
                          dtype=torch.uint8)
        w = {k: v.numpy() for k, v in L.l12_sections(buf, B, layer,
                                                      F).items()}
        w["meta"][:] = META_FILL
        w["active"][:] = 9
        n_new = codes(arr_new, B, threads, F, layer,
                      *(_ptr(w[k]) for k in ("body", "side", "meta", "geom",
                                             "active")))
        assert n_new == n_old
        np.testing.assert_array_equal(w["active"].reshape(F, B), active)
        np.testing.assert_array_equal(w["meta"], meta)
        t = L.l12_sections(buf, B, layer, F)
        got = RQ.l12_requant_ref(t["body"], t["side"], t["geom"],
                                 layer).numpy()
        on = active != 0
        if scf_seen is not None:
            scf_seen.update(np.unique(w["side"][on][:, RQ.SIDE_SCF:
                                                   RQ.SIDE_OFF]).tolist())
        np.testing.assert_array_equal(got[on].view(np.uint32),
                                      sb[on].view(np.uint32))
        assert not got[~on].view(np.uint32).any()
        assert not w["body"][~on].any() and not w["side"][~on].any()
        assert [h.inbuf_filled() for h in new] == [h.inbuf_filled()
                                                   for h in old]
        assert [h.save_state() for h in new] == [h.save_state()
                                                 for h in old]
        seen += n_old
        if n_old == 0 and all(p == len(d) for p, d in zip(pos, streams)):
            return seen
    raise AssertionError(f"streams not done in {max_steps} steps")


def _stream(layer, seed, n=4, **kw) -> bytes:
    return mp3gen.make_l12_stream(layer=layer, n_frames=n, seed=seed, **kw)


class _Scf63(random.Random):
    """A generator whose 6-bit scalefactor draws (randrange(63)) give
    63, the index the tables lack, one time in three."""

    def randrange(self, *args, **kw):
        if args == (63,) and self.random() < 1 / 3:
            return 63
        return super().randrange(*args, **kw)


def _frames(rng, n, **kw) -> bytes:
    return b"".join(mp3gen.make_l12_frame(rng, **kw) for _ in range(n))


def _joint(layer, seed, **kw) -> list[bytes]:
    """Mono, stereo and joint stereo at the four bounds."""
    out = [_stream(layer, seed, mode=3, **kw), _stream(layer, seed + 1,
                                                       mode=0, **kw)]
    out += [_stream(layer, seed + 2 + e, mode=1, mode_extension=e, **kw)
            for e in range(4)]
    return out


# Layer II allocation tables (11172-3 B.2a-d) by (bitrate_index, sfreq)
# for the two channels of a stereo stream: 48 kHz 256 kbps (A), 44.1 kHz
# 256 kbps (B), 44.1 kHz 64 kbps (C), 32 kHz 64 kbps (D)
TABLES = {"a": (12, 1, T.L2_ALLOC_A), "b": (12, 0, T.L2_ALLOC_B),
          "c": (4, 0, T.L2_ALLOC_C), "d": (4, 2, T.L2_ALLOC_D)}


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_layer2_tables_joint_stereo(table, F):
    """Each MPEG-1 allocation table, mono, stereo and joint stereo at
    bounds 4, 8, 12 and 16 (a mono stream at the stereo bitrate takes
    another table: it runs too)."""
    br, sfreq, want = TABLES[table]
    assert T.l2_alloc_table(br, sfreq, 2) is want
    streams = _joint(2, 100 + F, bitrate_index=br, sfreq=sfreq)
    assert _serve_both(streams, 2, F) == 6 * 4


@pytest.mark.parametrize("F", [1, 2])
def test_layer2_lsf_table(F):
    """MPEG-2 LSF Layer II (table B.1) at 16, 22.05 and 24 kHz, mono,
    stereo and joint stereo, in a pool whose handles take LSF."""
    streams = []
    for sfreq in range(3):
        streams += _joint(2, 200 + 10 * sfreq, family=1, sfreq=sfreq,
                          bitrate_index=8)
    assert _serve_both(streams, 2, F, PROFILE_L12 | PROFILE_LSF) == 18 * 4


@pytest.mark.parametrize("F", [1, 2])
def test_layer1_joint_stereo(F):
    """Layer I at three rates and bitrates, mono, stereo and joint stereo
    at bounds 4, 8, 12 and 16."""
    streams = []
    for sfreq, br in ((0, 6), (1, 12), (2, 3)):
        streams += _joint(1, 300 + sfreq, n=6, sfreq=sfreq, bitrate_index=br)
    assert _serve_both(streams, 1, F) == 18 * 6


@pytest.mark.parametrize("layer", [1, 2])
def test_scalefactor_index_63(layer):
    """Scalefactor indices of 63, which the requantization clamps to
    table entry 62 as parse_l1 / parse_l2 do."""
    rng = _Scf63(63 + layer)
    kw = dict(layer=layer, sfreq=1, bitrate_index=12, family=0)
    streams = [_frames(rng, 5, mode=m, mode_extension=2, **kw)
               for m in (0, 1, 3)]
    seen = set()
    assert _serve_both(streams, layer, scf_seen=seen) == 15
    assert 63 in seen


def test_free_format():
    """Free-format Layer II (bitrate_index 0 in every header; the frame
    size measured from the sync spacing), whose allocation table is the
    one of its rate (B.2a at 48 kHz)."""
    streams = []
    for seed, mode in ((7, 0), (8, 1), (9, 3)):
        raw = bytearray(_stream(2, seed, n=6, sfreq=1, bitrate_index=12,
                                mode=mode, mode_extension=1))
        for o in range(0, len(raw), 768):
            raw[o + 2] &= 0x0F
        streams.append(bytes(raw))
    assert _serve_both(streams, 2, 1,
                       PROFILE_L12 | PROFILE_FREE_FORMAT) == 3 * 6


@pytest.mark.parametrize("F", [1, 2])
def test_twolame_broadcast_stream(F):
    """twolame's 48 kHz 256 kbps joint-stereo stream with a CRC in every
    frame, checked, in whole and in 1,000-byte feeds."""
    with open(TWOLAME, "rb") as f:
        data = f.read()
    streams = [data[:40 * 768], data[5 * 768:30 * 768 + 100]]
    assert _serve_both(streams, 2, F, PROFILE_L12 | PROFILE_CRC,
                       chunk=1000) == 40 + 25


@pytest.mark.parametrize("layer", [1, 2])
def test_corrupt_crc_skips_the_frame(layer):
    """Protected streams with one frame's allocation bits flipped: with
    PROFILE_CRC both packers consume and skip that frame; without it
    both decode it as it stands (Layer II here) or stop the slot at it,
    where the flipped bits leave a frame that parse_frame_l12 refuses
    (Layer I here)."""
    size = 384 if layer == 1 else 768
    streams = []
    for k, mode in enumerate((1, 0)):
        raw = bytearray(_stream(layer, 50 + k, n=5, sfreq=1,
                                bitrate_index=12, mode=mode,
                                mode_extension=3, protection=True))
        assert len(raw) == 5 * size
        raw[2 * size + 6] ^= 0x10      # frame 2's first allocation bits
        streams.append(bytes(raw))
    assert _serve_both(streams, layer, 1, PROFILE_L12 | PROFILE_CRC) == 8
    assert _serve_both(streams, layer, 1, PROFILE_L12) == (7 if layer == 1
                                                           else 10)


@pytest.mark.parametrize("chunk", [333, 769])
def test_truncated_frames(chunk):
    """Frames cut between feeds (NEED_MORE and the rollback, then the
    frame whole a step later) and a stream that ends inside its last
    frame, which neither packer decodes."""
    full = _stream(2, 60, n=6, sfreq=1, bitrate_index=12, mode=0)
    streams = [full[:-100], _stream(2, 61, n=5, sfreq=0, bitrate_index=9,
                                    mode=3)]
    assert _serve_both(streams, 2, 1, chunk=chunk) == 5 + 5


def test_stray_frames_in_a_layer2_pool():
    """A Layer III frame and a Layer I frame inside Layer II streams: the
    stray frames are consumed and their rows stay idle, in both packers,
    at one and two frames a step."""
    l2 = [_stream(2, 70 + k, n=3, sfreq=1, bitrate_index=12, mode=1,
                  mode_extension=k) for k in range(3)]
    l3 = mp3gen.make_stream(n_frames=2, seed=71)
    l1 = _stream(1, 72, n=2, sfreq=1, bitrate_index=12)
    streams = [l2[0] + l3 + l2[1], l2[1] + l1 + l2[2], l3 + l2[2]]
    for F in (1, 2):
        assert _serve_both(streams, 2, F) == 6 + 6 + 3


def test_stray_layer2_frame_in_a_layer1_pool():
    """A Layer II frame inside a Layer I stream, in a Layer I pool."""
    l1 = _stream(1, 80, n=6, sfreq=0, bitrate_index=10, mode=1,
                 mode_extension=1)
    l2 = _stream(2, 81, n=1, sfreq=0, bitrate_index=12)
    cut = len(l1) // 2
    assert _serve_both([l1[:cut] + l2 + l1[cut:], l1], 1, 2) == 12


def test_threads_split_the_slots():
    """70 slots on three threads, two frames a step: the split of
    pdmp3_parse_step_wire_l12, both packers equal."""
    streams = [_stream(2, 90 + s, n=3, sfreq=s % 3, bitrate_index=8 + s % 5,
                       mode=[0, 1, 3][s % 3], mode_extension=s % 4)
               for s in range(70)]
    assert _serve_both(streams, 2, 2, threads=3) == 70 * 3


@pytest.mark.cuda
def test_k9_matches_its_plain_version_at_pool_size():
    """K9 against l12_requant_ref at B = 12,800 and F = 2, both layers,
    with mono slots and idle slot-frames: every sample's bits; one launch
    a call; then one launch a step of a Layer II pool (K7 once a frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    B, F = 12800, 2
    for layer in (1, 2):
        buf = coded_wire(B, layer, F, seed=9 + layer, mono=range(0, B, 7),
                         idle=range(3, F * B, 11))
        w = L.l12_sections(buf, B, layer, F)
        want = RQ.l12_requant_ref(w["body"], w["side"], w["geom"], layer)
        dw = L.l12_sections(buf.to(dev), B, layer, F)
        n0 = LA.LAUNCHES["l12_requant"]
        got = RQ.l12_requant(dw["body"], dw["side"], dw["geom"], layer)
        torch.cuda.synchronize()
        assert LA.LAUNCHES["l12_requant"] == n0 + 1
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), layer
    dec = L12StreamDecoder(8, layer=2, frames_per_step=2, device=dev)
    feeder = LoopFeeder(dec, [_stream(2, 95 + s, n=5, sfreq=1,
                                      bitrate_index=12) for s in range(8)])
    for _ in range(3):
        n0, k0 = LA.LAUNCHES["l12_requant"], LA.LAUNCHES["l12_synth"]
        feeder.step()
        assert dec.parse_step() == 16
        dec.decode_step()
        assert (LA.LAUNCHES["l12_requant"],
                LA.LAUNCHES["l12_synth"]) == (n0 + 1, k0 + 2)
