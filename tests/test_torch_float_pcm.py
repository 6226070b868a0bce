"""Float PCM on the port: ``ops.dsp.float_pack`` against the JAX
package's ``dsp.float_pack``; K4's raw sums in fast mode
(``back_half_step_ref(raw=True)``, the plain version of K4 instance 8)
against the fast synthesis sums; ``StreamDecoder(float_pcm=True)`` on
the CPU against the JAX package's exact float-PCM decode and against the
port's own S16 output; float PCM at the function level for every family
(``decode_granules(float_pcm=True)``, ``decode_frame_packed_lsf(
float_pcm=True)``) against the JAX package's and against the port's
S16; the CUDA instances 7 and 8 against their plain version, on MPEG-1
and on LSF spectra (``cuda`` marker).

Tolerances: float_pack, the raw sums, exact float PCM (PCM, store and
v_blocks), the sparse wire and F = 2 steps: bitwise.  Fast float PCM:
within 1.001/32767 of the same decoder's S16 PCM / 32767 (trunc toward
zero loses under one step, plus rounding of the division).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pdmp3_tpu import tables as JT
from pdmp3_tpu.frontend import Frontend
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import dsp as JD
from pdmp3_tpu.runtime import StreamDecoder as JaxStreamDecoder
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch import SparseStreamDecoder, StreamDecoder
from pdmp3_tpu_torch.models import decoder as TM
from pdmp3_tpu_torch.models.decoder import DecoderState
from pdmp3_tpu_torch.ops import back_half as BH
from pdmp3_tpu_torch.ops import dsp as D
from pdmp3_tpu_torch.ops import launch as LA
from test_torch_back_half import _inputs, _port, _tiled
from test_torch_fused_step import IDLE_SEAMS, idle_slots, ragged_batch
from test_torch_lsf import (N_FRAMES, _pool_streams,  # noqa: F401
                            family_frames, lsf_wire_from_batch)

N = 4
FLOAT_TOL = 1.001 / 32767


@pytest.fixture(scope="module")
def corpus():
    """Long, short MS, mono 48 kHz, mixed 32 kHz with the reservoir."""
    return [mp3gen.make_stream(n_frames=5, seed=90, blocks="long"),
            mp3gen.make_stream(n_frames=5, seed=91, blocks="short", mode=1,
                               mode_extension=2),
            mp3gen.make_stream(n_frames=5, seed=92, blocks="varied", mode=3,
                               sfreq=1),
            mp3gen.make_stream(n_frames=5, seed=93, blocks="mixed", sfreq=2,
                               use_reservoir=True)]


def _directed_sums(S: int, seed: int = 3) -> np.ndarray:
    """Synthesis sums [4,2,S,32] from a seed, with NaN, +-inf, the rails
    (+-1 and just beyond), -0.0, and values whose x32767 escapes int32
    (the S16 wrap) planted in slots 0-1."""
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((4, 2, S, 32)) * 0.6).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 1.0, -1.0, 1.0000001,
                        -1.0000001, -0.0, 0.0, 7e4, -7e4, 1e30, -1e30,
                        32767.5 / 32767, 65537.0 / 32767], np.float32)
    s[0, 0, 0, :len(special)] = special
    s[1, 1, S - 1, :len(special)] = special[::-1]
    return s


@pytest.mark.parametrize("S", [18, 12, 36])
def test_float_pack_matches_jax_bitwise(S):
    """The port's float_pack against JAX dsp.float_pack on the same sums,
    slot 1 mono: bitwise, NaN at -1, the rails and the wrap values at
    +-1."""
    sums = _directed_sums(S)
    nch = np.array([2, 1, 2, 2], np.int32)
    want = np.asarray(JD.float_pack(sums, nch))
    got = D.float_pack(torch.from_numpy(sums), torch.from_numpy(nch),
                       torch.ones(4, dtype=torch.int32)).numpy()
    assert got.shape == (4, S * 32, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0, 0, 0] == -1.0 and got[0, 1, 0] == 1.0
    np.testing.assert_array_equal(got[1, :, 0], got[1, :, 1])


def test_float_pack_differs_from_s16_only_at_the_wrap():
    """trunc(float_pack * 32767) equals the S16 quantize everywhere but
    where |sum * 32767| escapes int32: S16 wraps to -32767 there (the
    reference's cvttsd2si), float PCM saturates at +-1."""
    sums = torch.from_numpy(_directed_sums(18))
    nch = torch.full((4,), 2, dtype=torch.int32)
    act = torch.ones(4, dtype=torch.int32)
    fl = D.float_pack(sums, nch, act)
    s16 = D.pack(D.quantize(sums, True), nch, act).to(torch.int32)
    q = torch.trunc(fl.double() * 32767).to(torch.int32)
    x = sums.reshape(4, 2, 576).transpose(1, 2).double()   # stereo
    wrap = ((x * 32767).abs() > 2147483647) & ~torch.isnan(x)
    assert int(wrap.sum()) == 12   # +-inf, +-7e4, +-1e30 in two slots
    assert torch.equal(q[~wrap], s16[~wrap])
    assert (s16[wrap] == -32767).all()
    assert (fl[wrap].abs() == 1).all()


@pytest.mark.parametrize("seed", [4, 7])
def test_raw_fast_sums_are_the_sums_fast_mode_quantizes(seed):
    """back_half_step_ref(raw=True) in fast mode: the fast synthesis sums
    (hybrid synthesis, frequency inversion, polyphase synthesis in fast
    order) bit for bit, whose fast quantize is the raw=False output; the
    state update and prev3 are raw=False's.  Slot 6 idle: zero sums."""
    inputs = _inputs(False, seed)
    raw_args = _port(*inputs, False)
    q_args = _port(*inputs, False)
    raw, prev_raw = BH.back_half_step_ref(*raw_args, raw=True)
    q, prev_q = BH.back_half_step_ref(*q_args)
    xa, st0 = _port(*inputs, False)[:2]
    bt = raw_args[2]
    x_time, _ = D.hybrid_synthesis(xa, st0.store, bt, False)
    sums, _ = D.subband_synthesis(D.freq_invert(x_time), st0.v_blocks,
                                  False)
    active = raw_args[3]
    sums = torch.where((active != 0)[:, None, None, None], sums,
                       torch.zeros_like(sums))
    assert torch.equal(raw.view(torch.int32),
                       sums.reshape(-1, 2, 576).view(torch.int32))
    assert torch.equal(D.quantize(raw.view(-1, 2, 18, 32), False), q)
    assert torch.equal(prev_raw, prev_q)
    for name in ("store", "v_blocks"):
        assert torch.equal(getattr(raw_args[1], name),
                           getattr(q_args[1], name))
    assert not raw[6].any()


def _serve(decs, max_steps=12):
    out = [[] for _ in decs]
    for _ in range(max_steps):
        n = [d.parse_step() for d in decs]
        assert len(set(n)) == 1, n
        if n[0] == 0:
            break
        for k, d in enumerate(decs):
            out[k].append((d.decode_step(), d.active.copy()))
    return out


def _fed(dec, corpus):
    for s, data in enumerate(corpus):
        assert dec.feed(s, data) == 0
    return dec


def test_float_pcm_exact_matches_jax_bitwise(corpus):
    """StreamDecoder(exact=True, float_pcm=True) on the CPU against the
    JAX package's StreamDecoder(exact=True, float_pcm=True) (its XLA
    route, decode_frame_soa(float_pcm=True)) on the same feed: bitwise
    every step, idle slot-frames silent."""
    t = _fed(StreamDecoder(N, exact=True, float_pcm=True, device="cpu"),
             corpus)
    j = _fed(JaxStreamDecoder(N, exact=True, float_pcm=True), corpus)
    ts, js = _serve([t, j])
    assert len(ts) >= 4
    for (pt, at), (pj, aj) in zip(ts, js):
        np.testing.assert_array_equal(at, aj)
        assert pt.dtype == np.float32 and pt.shape == (N, 1152, 2)
        np.testing.assert_array_equal(pt.view(np.uint32),
                                      np.asarray(pj).view(np.uint32))
        assert not pt[at == 0].any()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_float_pcm_within_one_step_of_s16(corpus, exact):
    """Float PCM against the same decoder's S16 PCM / 32767: exact mode
    trunc(pcm * 32767) equal to S16 (no sum escapes int32 here); fast
    mode within FLOAT_TOL."""
    f = _fed(StreamDecoder(N, exact=exact, float_pcm=True, device="cpu"),
             corpus)
    i = _fed(StreamDecoder(N, exact=exact, device="cpu"), corpus)
    fs, is_ = _serve([f, i])
    for (pf, af), (pi, ai) in zip(fs, is_):
        np.testing.assert_array_equal(af, ai)
        d = np.abs(pf - pi.astype(np.float32) / 32767)
        assert float(d.max()) <= FLOAT_TOL
        if exact:
            np.testing.assert_array_equal(
                np.trunc(pf.astype(np.float64) * 32767).astype(np.int16),
                pi)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_float_pcm_sparse_and_two_frames_equal_dense(corpus, exact):
    """The sparse wire and two frames a step give the dense one-frame
    decoder's float PCM bit for bit."""
    dense = _fed(StreamDecoder(N, exact=exact, float_pcm=True,
                               device="cpu"), corpus)
    sparse = _fed(SparseStreamDecoder(N, exact=exact, float_pcm=True,
                                      device="cpu"), corpus)
    ds, ss = _serve([dense, sparse])
    for (a, _), (b, _) in zip(ds, ss):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    two = _fed(StreamDecoder(N, exact=exact, float_pcm=True,
                             frames_per_step=2, device="cpu"), corpus)
    steps = _serve([two])[0]
    got = np.concatenate([p for p, _ in steps], 1)
    want = np.concatenate([p for p, _ in ds], 1)
    n = min(got.shape[1], want.shape[1])
    assert n >= 4 * 1152
    np.testing.assert_array_equal(got[:, :n].view(np.uint32),
                                  want[:, :n].view(np.uint32))


@pytest.mark.parametrize("family", [1, 2])
def test_float_pcm_refused_for_lsf_pools(family):
    """LSF pools emit S16 PCM, as in the JAX package: ValueError."""
    with pytest.raises(ValueError):
        StreamDecoder(2, float_pcm=True, family=family, device="cpu")


# ---- float PCM at the function level, every family -------------------------

def _mpeg1_frames(corpus) -> list:
    """The corpus' MPEG-1 streams as per-stream lists of N_FRAMES
    FrameData (the JAX package's frontend, as test_torch_lsf.py's
    family_frames)."""
    out = []
    for data in corpus:
        fe = Frontend()
        fe.feed(data)
        fds = []
        for _ in range(N_FRAMES):
            res, fd = fe.read_frame()
            assert res == JT.OK
            fds.append(fd)
        out.append(fds)
    return out


def _family_streams(family, corpus, family_frames) -> list:
    return family_frames[family] if family else _mpeg1_frames(corpus)


def _u32(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("family", [0, 1, 2])
def test_decode_granules_float_pcm_exact_matches_jax_bitwise(
        family, corpus, family_frames):
    """decode_granules(float_pcm=True, exact=True) against the JAX
    package's decode_granules(float_pcm=True, exact=True, family=f) over
    N_FRAMES frames of every stream (both granules of an MPEG-1 frame),
    state carried, slot 0 idle in frame 1: the f32 PCM bits, store and
    v_blocks bitwise after every granule; the idle slot silent."""
    streams = _family_streams(family, corpus, family_frames)
    B = len(streams)
    jst = JM.init_state(B)
    st = TM.init_state(B, "cpu")
    for t in range(N_FRAMES):
        fds = [s[t] for s in streams]
        for jb, tb in zip(JM.frame_to_batches(fds),
                          TM.frame_to_batches(fds, "cpu")):
            if t == 1:
                act = np.ones(B, np.int32)
                act[0] = 0
                jb = jb._replace(active=jnp.asarray(act))
                tb = dataclasses.replace(tb, active=torch.from_numpy(act))
            pj, jst = JM.decode_granules(jb, jst, exact=True, float_pcm=True,
                                         family=family)
            pt, st = TM.decode_granules(tb, st, exact=True, float_pcm=True,
                                        family=family)
            what = f"frame {t} granule {tb.gr1}"
            assert pt.dtype == torch.float32 and pt.shape == (B, 576, 2)
            np.testing.assert_array_equal(pt.numpy().view(np.uint32),
                                          _u32(pj), err_msg=what)
            for name in ("store", "v_blocks"):
                np.testing.assert_array_equal(
                    getattr(st, name).numpy().view(np.uint32),
                    _u32(getattr(jst, name)), err_msg=f"{what} {name}")
            if t == 1:
                assert not pt[0].any()
            assert pt.abs().max() <= 1 and pt[1].any()


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("family", [1, 2])
def test_decode_frame_packed_lsf_float_pcm_exact_matches_jax(family, F):
    """decode_frame_packed_lsf(float_pcm=True, exact=True) on the native
    LSF wire of F frames a step against the JAX package's
    decode_frame_packed_lsf(float_pcm=True, exact=True, kernel="xla") on
    the same wire, state carried over every step: f32 PCM [B, F*576, 2],
    store and v_blocks bitwise."""
    streams = _pool_streams(family)
    B = len(streams)
    dec = StreamDecoder(B, family=family, frames_per_step=F, device="cpu")
    for s, data in enumerate(streams):
        assert dec.feed(s, data) == 0
    jst = JM.init_state(B)
    st = TM.init_state(B, "cpu")
    steps = 0
    while dec.parse_step():
        wire = dec.wire.copy()
        pj, jst = JM.decode_frame_packed_lsf(
            jnp.asarray(wire), jst, B=B, F=F, family=family, exact=True,
            float_pcm=True, kernel="xla")
        pt, st = TM.decode_frame_packed_lsf(
            torch.from_numpy(wire), st, B, family, F, exact=True,
            float_pcm=True)
        assert pt.dtype == torch.float32 and pt.shape == (B, F * 576, 2)
        np.testing.assert_array_equal(pt.numpy().view(np.uint32), _u32(pj),
                                      err_msg=f"step {steps}")
        for name in ("store", "v_blocks"):
            np.testing.assert_array_equal(
                getattr(st, name).numpy().view(np.uint32),
                _u32(getattr(jst, name)), err_msg=f"step {steps} {name}")
        dec.decode_step()
        steps += 1
    assert steps * F >= 6


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("family", [1, 2])
def test_lsf_float_pcm_within_one_step_of_s16(family, exact):
    """decode_frame_packed_lsf with and without float_pcm on the same
    native LSF wires, each with its own state: exact trunc(pcm x 32767)
    equal to the S16 PCM (no sum escapes int32 here), fast within
    FLOAT_TOL of S16 / 32767 (the JAX package's fast route is off the
    reference, so the port's own S16 is the yardstick); idle slots
    silent in both."""
    streams = _pool_streams(family)
    B = len(streams)
    dec = StreamDecoder(B, family=family, exact=exact, device="cpu")
    for s, data in enumerate(streams):
        assert dec.feed(s, data) == 0
    sf, si = TM.init_state(B, "cpu"), TM.init_state(B, "cpu")
    steps = 0
    while dec.parse_step():
        wire = torch.from_numpy(dec.wire.copy())
        pf, sf = TM.decode_frame_packed_lsf(wire, sf, B, family,
                                            exact=exact, float_pcm=True)
        pi, si = TM.decode_frame_packed_lsf(wire, si, B, family,
                                            exact=exact)
        np.testing.assert_array_equal(pi.numpy(), dec.decode_step())
        pf, pi = pf.numpy(), pi.numpy()
        assert float(np.abs(pf - pi.astype(np.float32) / 32767).max()) \
            <= FLOAT_TOL
        if exact:
            np.testing.assert_array_equal(
                np.trunc(pf.astype(np.float64) * 32767).astype(np.int16),
                pi)
        idle = dec.active == 0
        assert not pf[idle].any() and not pi[idle].any()
        steps += 1
    assert steps >= 6


@pytest.mark.parametrize("family", [0, 2])
def test_decode_granules_family_mismatch_raises(family, family_frames):
    """decode_granules' family, when given, must be the batch's."""
    fds = [s[0] for s in family_frames[1]]
    (batch,) = TM.frame_to_batches(fds, "cpu")
    with pytest.raises(ValueError, match="family"):
        TM.decode_granules(batch, TM.init_state(len(fds), "cpu"),
                           float_pcm=True, family=family)


def _k4():
    """K4's launch counts: (back_half, back_half_raw)."""
    return LA.LAUNCHES["back_half"], LA.LAUNCHES["back_half_raw"]


def test_launch_instance_of_the_raw_sums():
    """K4 fast raw sums is persistent instance 8; exact K4 returns raw
    sums anyway (7); raw without the back half raises."""
    assert LA.launch_instance(back_half=True, raw=True) == 8
    assert LA.launch_instance(back_half=True, exact=True, raw=True) == 7
    with pytest.raises(ValueError):
        LA.launch_instance(raw=True)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", IDLE_SEAMS)
@pytest.mark.parametrize("n", ["1", "grid-1", "grid+1", "2grid+3"])
def test_k4_raw_fast_instance_matches_plain_on_cuda(n, pattern):
    """K4 instance 8 (fast, raw sums) against back_half_step_ref(raw=True)
    at B = 1, grid - 1, grid + 1 and 2 grid + 3 with idle slots at the
    seams of its slot ring: out, prev3, store and v_blocks bitwise; the
    raw-sums launch counter moves, the other does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    grid = LA.granule_launch_info(dev, back_half=True, raw=True)["grid"]
    Bn = ragged_batch(n, grid)
    xa, st0, bt, active = _tiled(Bn, dev)
    active[idle_slots(pattern, Bn, grid)] = 0
    sk = DecoderState(*(t.clone() for t in (st0.store, st0.v_blocks,
                                             st0.prev_lines)))
    sr = DecoderState(*(t.clone() for t in (st0.store, st0.v_blocks,
                                             st0.prev_lines)))
    n0, r0 = _k4()
    ok, pk = BH.back_half_step(xa, sk, bt, active, False, raw=True)
    assert _k4() == (n0, r0 + 1)
    orf, pr = BH.back_half_step_ref(xa, sr, bt, active, False, raw=True)
    torch.cuda.synchronize()
    for a, b in ((ok, orf), (pk, pr), (sk.store, sr.store),
                 (sk.v_blocks, sr.v_blocks)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", IDLE_SEAMS)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("family", [1, 2])
def test_k4_raw_sums_on_lsf_spectra_match_plain_on_cuda(family, exact,
                                                        pattern,
                                                        family_frames):
    """K4 instance 7 (exact) and 8 (fast raw sums), the float-PCM route
    of the LSF families, against back_half_step_ref(raw=True) on the
    post-antialias spectra of an LSF granule (the family's front half:
    LSF gains, intensity sidecar, full-spectrum MS) tiled to B = 2 grid
    + 3, with idle slots at the seams of the slot ring and a random
    state: out, prev3, store and v_blocks bitwise; the instance's launch
    counter moves by one, the other not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    (b,) = TM.frame_to_batches([s[0] for s in family_frames[family]], dev)
    n0 = b.ix.shape[0]
    xa0 = D.front_half(b.ix, b.scf_l, b.scf_s, b.meta, 0,
                       torch.zeros(n0, 3, device=dev), exact, True, family,
                       b.is_pos)
    f = D.fields(b.meta)
    bt0 = D.effective_block_types(f.win_switch, f.block_type, f.mixed)
    grid = LA.granule_launch_info(dev, exact, back_half=True,
                                  raw=True)["grid"]
    n = ragged_batch("2grid+3", grid)
    idx = torch.arange(n, device=dev) % n0
    xa, bt = xa0[idx].contiguous(), bt0[idx].contiguous()
    active = torch.ones(n, dtype=torch.int32, device=dev)
    active[idle_slots(pattern, n, grid)] = 0
    rng = np.random.default_rng(family)
    st0 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           .to(dev) for s in ((n, 2, 32, 18), (n, 2, 15, 64), (n, 3))]
    sk = DecoderState(*(t.clone() for t in st0))
    sr = DecoderState(*(t.clone() for t in st0))
    before = _k4()
    ok, pk = BH.back_half_step(xa, sk, bt, active, exact, raw=True)
    assert _k4() == (before[0] + exact, before[1] + (not exact))
    orf, pr = BH.back_half_step_ref(xa, sr, bt, active, exact, raw=True)
    torch.cuda.synchronize()
    for a, r in ((ok, orf), (pk, pr), (sk.store, sr.store),
                 (sk.v_blocks, sr.v_blocks)):
        assert torch.equal(a.view(torch.int32), r.view(torch.int32))
    idle = active == 0
    assert not ok[idle].any() and ok[~idle].any()
