"""The port's serving wires beyond the one-frame dense step
(pdmp3_tpu_torch/runtime/scheduler.py, pdmp3_tpu_torch/models/decoder.py)
on the CPU: multi-frame steps (frames_per_step), the sparse
count1-bounded wire (SparseStreamDecoder), the pipelined PCM drain and
the frame-fused route, for MPEG-1 and the LSF pools.

They are held to the port's own dense one-frame route and to the native
scalar decoder (ports of tests/test_runtime.py and
tests/test_sparse_wire.py), and to the JAX package where a layout or a
checkpoint crosses over.  Tolerance: every route here decodes the same
granule steps on the same state, so PCM is byte-equal to the dense
route's; exact mode is byte-equal to native, fast mode within the fast
contract (at most 1 LSB on fewer than 1% of samples).
"""
import numpy as np
import pytest
import torch

from pdmp3_tpu.host import PROFILE_LSF, native_decode_file
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.runtime import SparseStreamDecoder as JaxSparseStreamDecoder
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch import SparseStreamDecoder, StreamDecoder
from pdmp3_tpu_torch.models import decoder as TM
from test_torch_fused_step import assert_pcm_contract
from test_torch_lsf import _pool_streams

FAMILIES = (1, 2)


@pytest.fixture(scope="module")
def corpus():
    """tests/test_sparse_wire.py's corpus: long / varied / short / mixed
    blocks, mono, MS, dual channel."""
    return [mp3gen.make_stream(n_frames=8, seed=40 + i,
                               blocks=["long", "varied", "short",
                                       "mixed"][i % 4],
                               mode=[0, 1, 1, 3][i % 4],
                               mode_extension=2 if i % 2 else 0)
            for i in range(6)]


def _serve(dec, streams, pipelined=False, steps=None):
    """Feed each slot its stream in 4 KiB pieces as its ring frees, step
    until no slot is active.  Returns (per-slot PCM int16 [n, 2] of its
    active frames, wire bytes summed over the steps); each step's wire
    bytes also appended to `steps` when given."""
    n, F = dec.n, dec.F
    spf = 576 if dec.family else 1152
    per = [[] for _ in range(n)]
    pos = [0] * n
    wire = 0
    masks = []

    def take(pcm, act):
        act = act.reshape(F, n)
        for s in range(n):
            for f in range(F):
                if act[f, s]:
                    per[s].append(pcm[s, f * spf:(f + 1) * spf])

    while True:
        for s in range(n):
            d = streams[s % len(streams)]
            while pos[s] < len(d) and dec.inbuf_free(s) >= 4096:
                k = min(4096, len(d) - pos[s])
                assert dec.feed(s, d[pos[s]:pos[s] + k]) == 0
                pos[s] += k
        if dec.parse_step() == 0:
            break
        nbytes = (dec.wire_bytes() if hasattr(dec, "wire_bytes")
                  else 2 * dec._lay["total"])
        wire += nbytes
        if steps is not None:
            steps.append(nbytes)
        if pipelined:
            out = dec.decode_step_pipelined()
            masks.append(dec.active.copy())
            if out is not None:
                take(out, masks.pop(0))
        else:
            take(dec.decode_step(), dec.active.copy())
    if pipelined:
        tail = dec.drain_pending()
        if tail is not None:
            take(tail, masks.pop(0))
        assert dec.drain_pending() is None and not masks
    return ([np.concatenate(p) if p else np.zeros((0, 2), np.int16)
             for p in per], wire)


def _assert_native(data, got, exact, lsf=False):
    """A slot's PCM against the native decoder over the whole stream."""
    want = np.frombuffer(native_decode_file(
        data, profile=PROFILE_LSF if lsf else 0), "<i2")
    mono = (data[3] >> 6) == 3
    if mono:
        np.testing.assert_array_equal(got[:, 0], got[:, 1])
    a = got[:, 0] if mono else got.reshape(-1)
    assert len(want) > 0 and len(a) == len(want)
    if exact:
        np.testing.assert_array_equal(a, want)
    else:
        assert_pcm_contract(a, want)


# ---- layouts ---------------------------------------------------------------

@pytest.mark.parametrize("B,F", [(1, 1), (6, 1), (8, 2), (127, 3),
                                 (8192, 2)])
@pytest.mark.parametrize("kind", ["dense", "sparse", "sparse_lsf"])
def test_layout_offsets_equal_jax(kind, B, F):
    """soa_layout (F frames), sparse_layout and sparse_layout_lsf, at the
    worst-case and at a bucketed cap, give the JAX package's offsets."""
    if kind == "dense":
        assert TM.soa_layout(B, F) == JM.soa_layout(B, F)
        return
    mine, theirs = {"sparse": (TM.sparse_layout, JM.sparse_layout),
                    "sparse_lsf": (TM.sparse_layout_lsf,
                                   JM.sparse_layout_lsf)}[kind]
    assert mine(B, F) == theirs(B, F)
    assert mine(B, F, 64) == theirs(B, F, 64)
    lay = mine(B, F)
    assert lay["ix_flat"][0] == lay["fixed"]
    assert lay["cap_blocks"] == F * (1 if kind == "sparse_lsf" else 2) \
        * B * 2 * 5
    assert TM.sparse_worst_blocks(B, F) == JM.sparse_worst_blocks(B, F)


# ---- multi-frame steps -----------------------------------------------------

@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_multi_frame_step_equals_native(corpus, exact):
    """tests/test_runtime.py::test_multi_frame_step: frames_per_step=3
    decodes [B, 3*1152, 2] per step with active [3, B], every slot equal
    to the native per-file decode (exact byte-equal, fast within the
    contract)."""
    dec = StreamDecoder(3, exact=exact, frames_per_step=3, device="cpu")
    streams = [corpus[0], corpus[3], corpus[2]]   # corpus[3]: mono
    assert dec.active.shape == (3, 3) and dec.codes.shape == (6, 3, 2, 288)
    got, _ = _serve(dec, streams)
    for s, d in enumerate(streams):
        _assert_native(d, got[s], exact)
    assert dec.nch(1) == 1 and dec.nch(0) == 2


@pytest.mark.parametrize("family", FAMILIES)
def test_lsf_multi_frame_pool_equals_native(family):
    """An LSF pool with frames_per_step=2: PCM [B, 2*576, 2] per step,
    byte-equal to the native decoder with PROFILE_LSF and to the
    one-frame pool."""
    streams = _pool_streams(family)
    n = len(streams)
    two, _ = _serve(StreamDecoder(n, exact=True, family=family,
                                  frames_per_step=2, device="cpu"), streams)
    one, _ = _serve(StreamDecoder(n, exact=True, family=family,
                                  device="cpu"), streams)
    for s, d in enumerate(streams):
        np.testing.assert_array_equal(two[s], one[s])
        _assert_native(d, two[s], True, lsf=True)


# ---- the sparse wire -------------------------------------------------------

@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_sparse_equals_dense_and_saves_bytes(corpus, exact, F):
    """test_sparse_wire.py::test_sparse_equals_dense_and_saves_bytes and
    ::test_sparse_multi_frame_step: the sparse wire decodes byte-equal to
    StreamDecoder's (the coded MPEG-1 wire, itself the dense wire's
    lines: tests/test_torch_l3_codes_wire.py) and uploads fewer bytes
    than the dense wire (``soa_layout``) would over the same steps."""
    coded, sparse_steps = [], []
    dense, _ = _serve(StreamDecoder(6, exact=exact, frames_per_step=F,
                                    device="cpu"), corpus, steps=coded)
    sparse, s_wire = _serve(SparseStreamDecoder(6, exact=exact,
                                                frames_per_step=F,
                                                device="cpu"), corpus,
                            steps=sparse_steps)
    for s in range(6):
        assert dense[s].shape == sparse[s].shape and len(dense[s])
        np.testing.assert_array_equal(dense[s], sparse[s])
    d_wire = len(coded) * 2 * TM.soa_layout(6, F)["total"]
    assert len(sparse_steps) == len(coded) and s_wire < d_wire, (s_wire,
                                                                 d_wire)
    if exact:
        for s, d in enumerate(corpus):
            _assert_native(d, dense[s], True)


@pytest.mark.parametrize("family", FAMILIES)
def test_sparse_lsf_equals_dense_and_native(family):
    """test_sparse_wire.py::test_sparse_lsf_equals_dense_and_native: the
    sparse LSF wire is byte-equal to the dense LSF pool and to native in
    both precisions, and the spectra lines it ships are fewer than the
    dense wire's 2 x 576 per slot (the bucketed upload's 64-block floor
    outweighs them at 4 slots)."""
    streams = _pool_streams(family)
    n = len(streams)
    for exact in (True, False):
        sdec = SparseStreamDecoder(n, exact=exact, family=family,
                                   device="cpu")
        used = []
        parse = sdec.parse_step

        def counted():
            k = parse()
            used.append(int(sdec._used.value))
            return k
        sdec.parse_step = counted
        sparse, _ = _serve(sdec, streams)
        dense, _ = _serve(StreamDecoder(
            n, exact=exact, family=family, device="cpu"), streams)
        for s, d in enumerate(streams):
            np.testing.assert_array_equal(sparse[s], dense[s])
            _assert_native(d, sparse[s], exact, lsf=True)
        steps = len(used) - 1
        assert steps >= 4
        assert 0 < sum(used) * TM.SPARSE_BLOCK < steps * n * 2 * 576


def test_sparse_multithread_deterministic(corpus):
    """Block placement depends on the parse threads; the block table
    makes the PCM identical anyway."""
    one, _ = _serve(SparseStreamDecoder(6, parse_threads=1, device="cpu"),
                    corpus)
    four, _ = _serve(SparseStreamDecoder(6, parse_threads=4, device="cpu"),
                     corpus)
    for s in range(6):
        np.testing.assert_array_equal(one[s], four[s])


def test_sparse_starved_slot_isolated(corpus):
    """test_sparse_wire.py::test_sparse_starved_slot_isolated: a
    drip-fed neighbour does not perturb a fully fed stream, and an idle
    slot's zeroed block-table entries decode to silence."""
    dec = SparseStreamDecoder(2, exact=True, device="cpu")
    dec.feed(0, corpus[0])
    full, drip, pos, idle_steps = [], corpus[1], 0, 0
    for _ in range(40):
        if pos < len(drip):
            k = min(100, len(drip) - pos)
            dec.feed(1, drip[pos:pos + k])
            pos += k
        if dec.parse_step() == 0:
            continue
        pcm = dec.decode_step()
        if dec.active[0]:
            full.append(pcm[0].tobytes())
        if not dec.active[1]:
            idle_steps += 1
            assert not pcm[1].any()
    assert idle_steps > 0
    want = native_decode_file(corpus[0])
    assert b"".join(full)[:len(want)] == want


def test_sparse_upload_is_bucketed_prefix(corpus):
    """wire_bytes() is the pinned prefix fixed + cap * 128 (int16), cap
    the blocks rounded up to an eighth of the worst case and sticky
    upward, as the JAX decoder buckets them."""
    dec = SparseStreamDecoder(6, device="cpu")
    for s, d in enumerate(corpus):
        dec.feed(s, d)
    caps = []
    while dec.parse_step():
        used = int(dec._used.value)
        nbytes = dec.wire_bytes()
        cap = (nbytes // 2 - dec._lay["fixed"]) // TM.SPARSE_BLOCK
        gran = max(64, -(-dec._cap_full // 8))
        assert cap >= used and cap % gran == 0 or cap == dec._cap_full
        assert nbytes < 2 * dec._lay["total"] or cap == dec._cap_full
        caps.append(cap)
        dec.decode_step()
    assert caps == sorted(caps) and len(caps) >= 4


# ---- the pipelined drain ---------------------------------------------------

@pytest.mark.parametrize("cls", [StreamDecoder, SparseStreamDecoder],
                         ids=["dense", "sparse"])
def test_pipelined_equals_sync(cls):
    """tests/test_runtime.py::test_pipelined_drain_equals_sync:
    decode_step_pipelined returns each step's PCM one step late and
    drain_pending flushes the last; the PCM equals the synchronous
    decoder's step for step."""
    B = 4
    streams = [mp3gen.make_stream(n_frames=5, seed=600 + i,
                                  blocks=["long", "short", "varied",
                                          "mixed"][i % 4],
                                  mode=1 if i % 2 else 0,
                                  mode_extension=2 if i % 2 else 0)
               for i in range(B)]
    dec_s = cls(B, exact=True, device="cpu")
    dec_p = cls(B, exact=True, device="cpu")
    for s in range(B):
        assert dec_s.feed(s, streams[s]) == 0
        assert dec_p.feed(s, streams[s]) == 0
    assert dec_p.drain_pending() is None
    want, got = [], []
    while True:
        n = dec_s.parse_step()
        assert dec_p.parse_step() == n
        if n == 0:
            break
        want.append(dec_s.decode_step())
        out = dec_p.decode_step_pipelined()
        assert (out is None) == (len(want) == 1)
        if out is not None:
            got.append(out)
    got.append(dec_p.drain_pending())
    assert dec_p.drain_pending() is None
    assert len(want) == len(got) >= 3
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_pipelined_lsf_multi_frame_equals_native():
    """The pipelined drain on an LSF pool with two frames per step:
    byte-equal to native."""
    streams = _pool_streams(1)
    dec = StreamDecoder(len(streams), exact=True, family=1,
                        frames_per_step=2, device="cpu")
    got, _ = _serve(dec, streams, pipelined=True)
    for s, d in enumerate(streams):
        _assert_native(d, got[s], True, lsf=True)


# ---- the frame-fused route -------------------------------------------------

@pytest.mark.parametrize("cls", [StreamDecoder, SparseStreamDecoder],
                         ids=["dense", "sparse"])
def test_frame_fused_serving_equals_per_granule(corpus, monkeypatch, cls):
    """Fast serving with two frames per step under the _FRAME_FUSED
    opt-in (one frame step per frame) is byte-equal to the per-granule
    route, pipelined, and within the fast contract of native."""
    runs = []
    for ff in (False, True):
        monkeypatch.setattr(TM, "_FRAME_FUSED", ff)
        runs.append(_serve(cls(6, frames_per_step=2, device="cpu"), corpus,
                           pipelined=ff)[0])
    for s, d in enumerate(corpus):
        np.testing.assert_array_equal(runs[0][s], runs[1][s])
        _assert_native(d, runs[1][s], False)


# ---- checkpoints -----------------------------------------------------------

def test_jax_sparse_checkpoint_continues_in_port(corpus):
    """A JAX SparseStreamDecoder(kernel="pallas") checkpoint, taken after
    two exact steps, restores into the port's SparseStreamDecoder, which
    continues byte-equal to the JAX decoder and, over the whole stream,
    to native."""
    n = 3
    streams = corpus[:n]
    jdec = JaxSparseStreamDecoder(n, exact=True, kernel="pallas")
    for s, d in enumerate(streams):
        assert jdec.feed(s, d) == 0
    head = []
    for _ in range(2):
        assert jdec.parse_step() == n
        head.append((np.asarray(jdec.decode_step()), jdec.active.copy()))
    tdec = SparseStreamDecoder(n, exact=True, device="cpu")
    tdec.restore_checkpoint(jdec.save_checkpoint())
    tail = []
    while True:
        k = tdec.parse_step()
        assert jdec.parse_step() == k
        if k == 0:
            break
        pt, pj = tdec.decode_step(), np.asarray(jdec.decode_step())
        np.testing.assert_array_equal(pt, pj)
        tail.append((pt, tdec.active.copy()))
    assert len(tail) >= 4
    for s, d in enumerate(streams):
        pcm = np.concatenate([p[s] for p, a in head + tail if a[s]])
        _assert_native(d, pcm, True)


@pytest.mark.cuda
def test_cuda_frame_fused_sparse_pipelined_serving(corpus, monkeypatch):
    """On the card: the sparse wire, two frames per step, the pipelined
    drain and the frame-fused route (K5 once per frame, no K1) decode
    byte-equal to the CPU decoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pdmp3_tpu_torch.ops import launch as LA
    monkeypatch.setattr(TM, "_FRAME_FUSED", True)
    want, _ = _serve(SparseStreamDecoder(6, frames_per_step=2,
                                         device="cpu"), corpus)
    k5, k1 = LA.LAUNCHES["frame_fused"], LA.LAUNCHES["fused_granule"]
    gdec = SparseStreamDecoder(6, frames_per_step=2, device="cuda")
    got, _ = _serve(gdec, corpus, pipelined=True)
    assert LA.LAUNCHES["frame_fused"] > k5
    assert LA.LAUNCHES["fused_granule"] == k1
    for s in range(6):
        np.testing.assert_array_equal(got[s], want[s])
