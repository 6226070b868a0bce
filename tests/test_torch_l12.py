"""Layer I/II on the port (pdmp3_tpu_torch/models/l12.py, the
L12StreamDecoder pool and TorchDSP's Layer I/II frames) on the CPU,
against the JAX package's decode_l12_frames / JaxL12 / L12StreamDecoder /
JaxDSP and the oracle, with streams made from seeds by mp3gen; and the
step-count-agnostic polyphase synthesis against the JAX one.

Tolerances: exact mode bitwise everywhere (PCM, state, checkpoints).
Fast mode: within 1 LSB of the oracle on fewer than 1% of samples (the
fast contract; held against the oracle, never against JAX fast).  Float
PCM: within 1.001/32767 of the same pool's S16 PCM / 32767.
"""
import numpy as np
import pytest
import torch

from pdmp3_tpu import tables as JT
from pdmp3_tpu.api import decode_file as jax_decode_file
from pdmp3_tpu.frontend import Frontend
from pdmp3_tpu.models import l12 as JL
from pdmp3_tpu.models.decoder import JaxDSP
from pdmp3_tpu.ops import dsp as JD
from pdmp3_tpu.oracle import OracleDSP
from pdmp3_tpu.runtime import L12StreamDecoder as JaxL12StreamDecoder
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch import L12StreamDecoder, LoopFeeder, TorchDSP
from pdmp3_tpu_torch.api import decode_file
from pdmp3_tpu_torch.models import l12 as L
from pdmp3_tpu_torch.ops import dsp as D
from test_torch_fused_step import assert_pcm_contract

# tests/test_l12.py's five cases (Layer I/II, mono, LSF Layer II)
CASES = {
    "l1-stereo": (1, dict(bitrate_index=12)),
    "l1-mono": (1, dict(bitrate_index=8, mode=3)),
    "l2-stereo": (2, dict(bitrate_index=12)),
    "l2-mono": (2, dict(bitrate_index=8, mode=3)),
    "l2-lsf": (2, dict(family=1, sfreq=0, bitrate_index=8)),
}
FLOAT_TOL = 1.001 / 32767


def _frames(stream: bytes):
    fe = Frontend(layers12=True, lsf=True)
    fe.feed(stream)
    out = []
    while True:
        res, fd = fe.read_frame()
        if res != JT.OK:
            break
        out.append(fd)
    assert out
    return out


def _words_to_pcm(words, n):
    w = words.reshape(-1)[:n]
    return np.stack([(w >> 16).astype(np.uint16).view(np.int16),
                     (w & 0xFFFF).astype(np.uint16).view(np.int16)], -1)


@pytest.mark.parametrize("case", list(CASES))
def test_torch_l12_matches_jax_and_oracle(case):
    """TorchL12 (exact) frame by frame against JaxL12 and OracleDSP:
    bitwise across the carried FIFO; fast within the fast contract of
    the oracle."""
    layer, kw = CASES[case]
    fds = _frames(mp3gen.make_l12_stream(layer=layer, n_frames=6, seed=11,
                                         **kw))
    oracle, jx = OracleDSP(), JL.JaxL12(exact=True)
    tx = L.TorchL12(exact=True, device="cpu")
    tf = L.TorchL12(exact=False, device="cpu")
    for i, fd in enumerate(fds):
        want = oracle.decode_frame(fd)
        got = tx.decode_frame(fd)
        np.testing.assert_array_equal(got, want, f"frame {i}")
        np.testing.assert_array_equal(got, jx.decode_frame(fd))
        n = fd.header.pcm_samples
        assert_pcm_contract(_words_to_pcm(tf.decode_frame(fd), n),
                            _words_to_pcm(want, n), f"fast frame {i}")


@pytest.mark.parametrize("float_pcm", [False, True])
def test_decode_l12_frames_matches_jax_exact(float_pcm):
    """decode_l12_frames on a batch of three Layer II streams, a mono
    one and a starved slot against JAX decode_l12_frames: PCM and
    v_blocks bitwise every step."""
    streams = [_frames(mp3gen.make_l12_stream(layer=2, n_frames=3, seed=s,
                                              bitrate_index=12))
               for s in range(2)]
    streams.append(_frames(mp3gen.make_l12_stream(
        layer=2, n_frames=2, seed=9, mode=3, bitrate_index=8)))
    jstate = JL.init_l12_state(4)
    tstate = L.init_l12_state(4, "cpu")
    for t in range(3):
        fds = [s[t] if t < len(s) else None for s in streams] + [None]
        sb, nch, act = JL.batch_from_frames(fds, layer=2)
        sb2, nch2, act2 = L.batch_from_frames(fds, layer=2)
        for a, b in ((sb, sb2), (nch, nch2), (act, act2)):
            np.testing.assert_array_equal(a, b)
        pj, jstate = JL.decode_l12_frames(sb, nch, act, jstate,
                                          float_pcm=float_pcm)
        pt, tstate = L.decode_l12_frames(
            torch.from_numpy(sb), torch.from_numpy(nch),
            torch.from_numpy(act), tstate, float_pcm=float_pcm)
        pj, pt = np.asarray(pj), pt.numpy()
        assert pt.dtype == pj.dtype
        np.testing.assert_array_equal(pt.view(np.uint8), pj.view(np.uint8))
        np.testing.assert_array_equal(tstate.v_blocks.numpy(),
                                      np.asarray(jstate.v_blocks))
        assert not pt[act == 0].any()


def test_l12_batched_equals_per_stream():
    """Slot isolation: a batch of distinct streams with starved slots
    (state frozen) gives each stream's per-stream PCM, bitwise."""
    streams = [_frames(mp3gen.make_l12_stream(layer=2, n_frames=4, seed=s,
                                              bitrate_index=12))
               for s in range(3)]
    streams.append(_frames(mp3gen.make_l12_stream(
        layer=2, n_frames=2, seed=9, mode=3, bitrate_index=8)))
    B = len(streams)
    state = L.init_l12_state(B, "cpu")
    got = [[] for _ in range(B)]
    for t in range(max(len(s) for s in streams)):
        fds = [s[t] if t < len(s) else None for s in streams]
        sb, nch, act = (torch.from_numpy(a) for a in
                        L.batch_from_frames(fds, layer=2))
        pcm, state = L.decode_l12_frames(sb, nch, act, state)
        for b in range(B):
            if fds[b] is not None:
                got[b].append(pcm[b].numpy())
    for b, s in enumerate(streams):
        tx = L.TorchL12(device="cpu")
        for t, fd in enumerate(s):
            want = _words_to_pcm(tx.decode_frame(fd),
                                 fd.header.pcm_samples)
            np.testing.assert_array_equal(got[b][t], want)


@pytest.mark.parametrize("S", [12, 18, 36])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_subband_synthesis_any_steps(S, exact):
    """The port's synthesis at S = 12, 18, 36 on seeded inputs: exact
    form bitwise equal to JAX's; both forms bitwise equal to the S = 18
    formulation the port had before it took any S (a 33-block window
    and a new FIFO of blocks[18:]) when S = 18."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((3, 2, 32, S)).astype(np.float32)
    v = rng.standard_normal((3, 2, 15, 64)).astype(np.float32)
    sums, new_v = D.subband_synthesis(torch.from_numpy(x),
                                      torch.from_numpy(v), exact)
    if exact:
        js, jv = JD.subband_synthesis(x, v, exact=True)
        np.testing.assert_array_equal(sums.numpy(), np.asarray(js))
        np.testing.assert_array_equal(new_v.numpy(), np.asarray(jv))
    if S == 18:
        c = D.device_consts("cpu")
        dot = D._dot_seq if exact else D._dot_tree
        nb = dot(torch.from_numpy(x).transpose(-1, -2), c["nwin"].T)
        blocks = torch.cat([torch.from_numpy(v), nb], 2)
        acc = torch.zeros_like(nb[..., :32])
        for j in range(16):
            half = 32 * (j & 1)
            acc = acc + c["synth_d"][j] * blocks[:, :, 15 - j:33 - j,
                                                 half:half + 32]
        assert torch.equal(sums.view(torch.int32), acc.view(torch.int32))
        assert torch.equal(new_v, blocks[:, :, 18:])


def oracle_pcm_bytes(stream: bytes) -> bytes:
    """The oracle's PCM (tests/test_l12_native.py): mono one channel."""
    out = []
    dsp = OracleDSP()
    for fd in _frames(stream):
        pcm = _words_to_pcm(dsp.decode_frame(fd), fd.header.pcm_samples)
        out.append(pcm[:, 1].tobytes() if fd.header.nch == 1
                   else pcm.tobytes())
    return b"".join(out)


def _pool_decode(dec, streams):
    """Drive an L12 pool (port or JAX) to completion: per-slot PCM bytes
    (mono slots one channel)."""
    pos = [0] * len(streams)
    out = [[] for _ in streams]
    while True:
        for s, data in enumerate(streams):
            while pos[s] < len(data) and dec.inbuf_free(s) >= 4096:
                n = min(4096, len(data) - pos[s])
                dec.feed(s, data[pos[s]:pos[s] + n])
                pos[s] += n
        if dec.parse_step() == 0:
            break
        pcm = dec.decode_step()
        for s in range(len(streams)):
            if dec.active[s]:
                p = pcm[s]
                out[s].append(p[:, 0].tobytes() if dec.nch(s) == 1
                              else p.tobytes())
    return [b"".join(c) for c in out]


def _pool_streams(layer):
    """tests/test_l12_native.py test_l12_pool_matches_oracle's streams:
    stereo, mono, and a short one that starves mid-pool."""
    return [mp3gen.make_l12_stream(layer=layer, n_frames=5, seed=1,
                                   bitrate_index=12),
            mp3gen.make_l12_stream(layer=layer, n_frames=5, seed=2,
                                   bitrate_index=8, mode=3),
            mp3gen.make_l12_stream(layer=layer, n_frames=2, seed=3,
                                   bitrate_index=12)]


@pytest.mark.parametrize("layer", [1, 2])
def test_l12_pool_matches_oracle(layer):
    """L12StreamDecoder (exact) byte-equal to the oracle per slot; fast
    within the fast contract."""
    streams = _pool_streams(layer)
    got = _pool_decode(L12StreamDecoder(3, layer=layer, exact=True,
                                        device="cpu"), streams)
    fast = _pool_decode(L12StreamDecoder(3, layer=layer, device="cpu"),
                        streams)
    for s, stream in enumerate(streams):
        want = oracle_pcm_bytes(stream)
        assert len(want) > 0 and got[s] == want, f"slot {s}"
        assert_pcm_contract(np.frombuffer(fast[s], "<i2"),
                            np.frombuffer(want, "<i2"), f"fast slot {s}")


def test_l12_pool_float_pcm_and_two_frames():
    """float_pcm=True within FLOAT_TOL of the S16 pool; two frames a step
    byte-equal to one; a LoopFeeder drives the pool."""
    streams = _pool_streams(2)[:2]
    a = L12StreamDecoder(2, layer=2, exact=True, device="cpu")
    f = L12StreamDecoder(2, layer=2, exact=True, float_pcm=True,
                         device="cpu")
    two = L12StreamDecoder(2, layer=2, exact=True, frames_per_step=2,
                           device="cpu")
    for dec in (a, f, two):
        LoopFeeder(dec, streams).step()
    for _ in range(2):
        assert a.parse_step() == f.parse_step() == 2
        pa, pf = a.decode_step(), f.decode_step()
        assert pf.dtype == np.float32 and pf.shape == (2, 1152, 2)
        assert float(np.abs(pf - pa / 32767.0).max()) <= FLOAT_TOL
    assert two.parse_step() == 4
    p2 = two.decode_step()
    one = L12StreamDecoder(2, layer=2, exact=True, device="cpu")
    LoopFeeder(one, streams).step()
    want = []
    for _ in range(2):
        one.parse_step()
        want.append(one.decode_step())
    np.testing.assert_array_equal(p2, np.concatenate(want, 1))


def test_l12_pool_checkpoint_resume_and_jax_restore():
    """A pool checkpointed mid-serving resumes bit-identically, in the
    port and from the JAX pool's checkpoint."""
    streams = [mp3gen.make_l12_stream(layer=2, n_frames=6, seed=s,
                                      bitrate_index=12) for s in range(2)]
    dec = L12StreamDecoder(2, layer=2, exact=True, device="cpu")
    jdec = JaxL12StreamDecoder(2, layer=2, exact=True)
    for s, d in enumerate(streams):
        dec.feed(s, d)
        jdec.feed(s, d)
    for _ in range(3):
        assert dec.parse_step() == jdec.parse_step() > 0
        np.testing.assert_array_equal(dec.decode_step(), jdec.decode_step())
    for ckpt in (dec.save_checkpoint(), jdec.save_checkpoint()):
        dec2 = L12StreamDecoder(2, layer=2, exact=True, device="cpu")
        dec2.restore_checkpoint(ckpt)
        ref = L12StreamDecoder(2, layer=2, exact=True, device="cpu")
        ref.restore_checkpoint(dec.save_checkpoint())
        for _ in range(2):
            assert dec2.parse_step() == ref.parse_step() > 0
            np.testing.assert_array_equal(dec2.decode_step(),
                                          ref.decode_step())
    for _ in range(2):
        assert dec.parse_step() == jdec.parse_step() > 0
        np.testing.assert_array_equal(dec.decode_step(), jdec.decode_step())


@pytest.mark.parametrize("case", ["l1-stereo", "l2-mono", "l2-lsf"])
def test_decode_file_layers12_matches_jax(case):
    """The port's streaming API with TorchDSP on Layer I/II streams
    against the JAX package's decode_file with JaxDSP: byte-equal."""
    layer, kw = CASES[case]
    s = mp3gen.make_l12_stream(layer=layer, n_frames=4, seed=13, **kw)
    lsf = bool(kw.get("family"))
    got = decode_file(s, layers12=True, lsf=lsf,
                      dsp=TorchDSP(device="cpu"))
    want = jax_decode_file(s, layers12=True, lsf=lsf, dsp=JaxDSP())
    assert len(want) > 0 and got == want
