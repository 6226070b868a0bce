"""The port's LSF (MPEG-2 / MPEG-2.5) path on the CPU: the per-family
constants, the stage ops' LSF branches, the LSF granule step on both
routes, the LSF wire, the LSF serving pools, a checkpoint the JAX LSF
pool saved, and TorchDSP on LSF streams; one ``cuda``-marked test holds
K3 to its plain version on the card.

Everything is held against the JAX package on the same inputs (its
Pallas kernel run in interpret mode at block_lanes=8, as its own tests
run it on the CPU), against ``OracleDSP`` and against the native scalar
C++ decoder with PROFILE_LSF, which tests/test_sparse_wire.py already
holds bit-exact with both JAX LSF pools.

Tolerances:
- exact: bitwise (PCM, store, v_blocks, prev_lines, stage outputs);
- fast PCM: the fast contract, at most 1 LSB on fewer than 1% of
  samples (the port reads |x|^(4/3) from the correctly rounded table
  where JAX computes a Newton cube root, <= 2 ulp apart, and its dots
  sum in another order than XLA's);
- fast float stages and state: |port - jax| <= STATE_RTOL * max(1,
  max|jax|) (test_torch_fused_step.py explains the bound);
- constants and layouts: equal.
"""
import numpy as np
import pytest
import torch

from pdmp3_tpu import tables as JT
from pdmp3_tpu.api import decode_file as jax_decode_file
from pdmp3_tpu.frontend import Frontend
from pdmp3_tpu.host import PROFILE_LSF, native_decode_file
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import dsp as JD
from pdmp3_tpu.ops import pallas_step as PSF
from pdmp3_tpu.oracle import OracleDSP
from pdmp3_tpu.runtime import StreamDecoder as JaxStreamDecoder
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch import LoopFeeder, StreamDecoder, TorchDSP
from pdmp3_tpu_torch.api import decode_file
from pdmp3_tpu_torch.models import decoder as TM
from pdmp3_tpu_torch.models.decoder import DecoderState, init_state
from pdmp3_tpu_torch.ops import back_half as BH
from pdmp3_tpu_torch.ops import consts as K
from pdmp3_tpu_torch.ops import dsp as TD
from pdmp3_tpu_torch.ops import fused_step as FS
from pdmp3_tpu_torch.ops import launch as LA
from test_lsf import JAX_MATRIX, _JAX_IDS
from test_torch_consts import _onehot_matrix
from test_torch_fused_step import (STATE_RTOL, assert_pcm_contract,
                                   assert_state_close, wire_from_batch)
from test_torch_serving import _run, _slot_pcm

FAMILIES = (1, 2)
N_FRAMES = 3          # frames per stream in the step and stage tests
ROUTES = {"fused": FS.fused_granule_step, "split": BH.split_granule_step}


def _fds(stream: bytes) -> list:
    fe = Frontend(lsf=True)
    fe.feed(stream)
    out = []
    while True:
        res, fd = fe.read_frame()
        if res != JT.OK:
            return out
        out.append(fd)


def _matrix_stream(kw, n_frames=8) -> bytes:
    """test_lsf.py's stream for a JAX_MATRIX entry."""
    return mp3gen.make_stream(n_frames=n_frames, seed=31, bitrate_index=11,
                              **kw)


@pytest.fixture(scope="module")
def family_frames():
    """family -> the JAX_MATRIX streams of that family, as per-frame
    lists of FrameData (N_FRAMES each), one slot per stream."""
    out = {}
    for kw in JAX_MATRIX:
        fds = _fds(_matrix_stream(kw, N_FRAMES))
        assert len(fds) == N_FRAMES and fds[0].header.family == kw["family"]
        out.setdefault(kw["family"], []).append(fds)
    return out


def lsf_wire_from_batch(batch, family):
    """A JAX LSF GranuleBatch as the port's operands: wire_from_batch's
    (ix, scf_l, scf_s, meta, active, gr1), meta words 26/27 set to family
    and iscale as the native LSF packer writes them, and is_pos int16
    [B,64] (long [0..21], short flat [22..60], zero pad)."""
    ix, scf_l, scf_s, meta, active, gr1 = wire_from_batch(batch)
    B = ix.shape[0]
    meta[:, TD.M_FAMILY] = family
    meta[:, TD.M_ISCALE] = torch.from_numpy(
        np.array(batch.iscale, np.int32))
    ip = np.zeros((B, 64), np.int16)
    ip[:, :22] = np.asarray(batch.is_pos_l)
    ip[:, 22:61] = np.asarray(batch.is_pos_s).reshape(B, 39)
    return ix, scf_l, scf_s, meta, active, gr1, torch.from_numpy(ip)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---- constants -----------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name,row,width", [
    ("w_sfb", K.MAP_SFB_L, 22), ("w_sfs", K.MAP_SFB_S, 39),
    ("w_sfs_plain", K.MAP_SFB_S_PLAIN, 39), ("w_win", K.MAP_WIN, 3)])
def test_lsf_index_maps_reexpand_to_jax_onehots(family, name, row, width):
    maps = K.line_maps(family).astype(np.int64)
    np.testing.assert_array_equal(_onehot_matrix(maps[row], width),
                                  PSF._front_consts(family)[name])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name,row", [
    ("w_pre", K.MAP_PRETAB), ("w_short", K.MAP_SHORT),
    ("w_bs", K.MAP_BAND_START), ("w_iok", K.MAP_IOK)])
def test_lsf_value_maps_equal_jax_select_matrices(family, name, row):
    np.testing.assert_array_equal(
        K.line_maps(family)[row].T.astype(np.float32),
        PSF._front_consts(family)[name])


@pytest.mark.parametrize("family", FAMILIES)
def test_lsf_constants_equal_jax_tables(family):
    """k0/k1 are the JAX package's lsf_intensity_tables bit for bit; the
    mixed-block switch comes from the family's maps (long band 6, not 8);
    every non-map table is the family-0 one."""
    h, h0 = K.host_consts(family), K.host_consts(0)
    k0, k1 = JT.lsf_intensity_tables()
    np.testing.assert_array_equal(_bits(h["k0"]), _bits(k0))
    np.testing.assert_array_equal(_bits(h["k1"]), _bits(k1))
    for name in h:
        if name != "maps":
            np.testing.assert_array_equal(h[name], h0[name], err_msg=name)
    lm = JT.layout_maps(family)
    for sf in range(3):
        mixed = sf * 3 + JT.MIXED
        first_short = int(np.argmax(lm["is_short"][mixed]))
        assert first_short == JT.SFB_LONG_FAM[family][sf][
            JT.SWITCH_SFB_L[family]]
        assert K.line_maps(family)[K.MAP_SHORT, mixed, first_short] == 1
        assert K.line_maps(family)[K.MAP_SHORT, mixed, first_short - 1] == 0


@pytest.mark.parametrize("B,F", [(1, 1), (6, 1), (8, 2), (127, 1),
                                 (8192, 1), (33, 3)])
def test_soa_layout_lsf_offsets_equal_jax(B, F):
    assert TM.soa_layout_lsf(B, F) == JM.soa_layout_lsf(B, F)


# ---- stage ops -----------------------------------------------------------

def _rq(batch, family, exact):
    """(port, jax) requantize of one LSF batch."""
    ix, scf_l, scf_s, meta, *_ = lsf_wire_from_batch(batch, family)
    f = TD.fields(meta)
    got = TD.requantize(ix, scf_l, scf_s, f.layout, f.global_gain,
                        f.scalefac_scale, f.preflag, f.subblock_gain, exact,
                        0, None, family)
    want = JD.requantize(batch.ix, batch.scf_l, batch.scf_s, batch.layout,
                         batch.global_gain, batch.scalefac_scale,
                         batch.preflag, batch.subblock_gain, exact=exact,
                         gr1=batch.gr1, pre_reordered=True, family=family)
    return got, want


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("stage", ["requantize", "stereo"])
@pytest.mark.parametrize("family", FAMILIES)
def test_lsf_stage_matches_jax(family, stage, exact, family_frames):
    """requantize(family) and stereo(family) against pdmp3_tpu.ops.dsp on
    every frame of the family's JAX_MATRIX streams; stereo is fed the JAX
    requantize output."""
    streams = family_frames[family]
    for t in range(N_FRAMES):
        batch = JM.frame_to_batches([fds[t] for fds in streams])[0]
        if stage == "requantize":
            got, want = _rq(batch, family, exact)
        else:
            x = JD.requantize(batch.ix, batch.scf_l, batch.scf_s,
                              batch.layout, batch.global_gain,
                              batch.scalefac_scale, batch.preflag,
                              batch.subblock_gain, exact=exact,
                              gr1=batch.gr1, pre_reordered=True,
                              family=family)
            want = JD.stereo(x, batch.layout, batch.scf_l, batch.scf_s,
                             batch.count1, batch.ms_flag, batch.is_flag,
                             exact=exact, family=family,
                             is_pos_l=batch.is_pos_l,
                             is_pos_s=batch.is_pos_s, iscale=batch.iscale)
            _, scf_l, scf_s, meta, _, _, ip = lsf_wire_from_batch(batch,
                                                                  family)
            f = TD.fields(meta)
            got = TD.stereo(torch.from_numpy(np.array(x, np.float32)),
                            f.layout, scf_l, scf_s, f.count1, f.ms_flag,
                            f.is_flag, exact, True, family, ip, f.iscale)
        if exact:
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"frame {t}")
        else:
            want = np.asarray(want, np.float32)
            tol = STATE_RTOL * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                                       err_msg=f"frame {t}")


def test_lsf_stage_fixture_reaches_intensity_and_iscale(family_frames):
    """The stage fixtures exercise what the LSF branches add: intensity
    slots with legal and illegal positions in both families, and both
    iscale rows."""
    seen = {"legal": set(), "illegal": set(), "iscale": set()}
    for family, streams in family_frames.items():
        for t in range(N_FRAMES):
            batch = JM.frame_to_batches([fds[t] for fds in streams])[0]
            isf = np.asarray(batch.is_flag) != 0
            ipl = np.asarray(batch.is_pos_l)[isf]
            if (ipl != JT.LSF_IS_ILLEGAL).any():
                seen["legal"].add(family)
            if (ipl == JT.LSF_IS_ILLEGAL).any():
                seen["illegal"].add(family)
            seen["iscale"] |= set(np.asarray(batch.iscale)[isf].tolist())
    assert seen["legal"] == set(FAMILIES), seen
    assert seen["iscale"] >= {0} and seen["illegal"], seen


# ---- the granule step ----------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_lsf_fast_step_matches_jax_pallas(family, family_frames):
    """The port's plain LSF step (fast) against JAX decode_granules_pallas
    (family, interpret mode) over every frame: PCM within the fast
    contract, state within STATE_RTOL."""
    streams = family_frames[family]
    B = len(streams)
    pst = PSF.init_pallas_state(B)
    st = init_state(B, "cpu")
    for t in range(N_FRAMES):
        batch = JM.frame_to_batches([fds[t] for fds in streams])[0]
        pj, pst = PSF.decode_granules_pallas(batch, pst, exact=False,
                                             block_lanes=8, family=family)
        *ops, ip = lsf_wire_from_batch(batch, family)
        pt, st = FS.fused_granule_step(*ops, st, family=family, is_pos=ip)
        assert pt.shape == (B, 576, 2) and pt.dtype == torch.int16
        assert_pcm_contract(pt.numpy(), np.asarray(pj), f"frame {t}")
        assert_state_close(st, pst, f"frame {t}")


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("family", FAMILIES)
def test_lsf_exact_step_matches_jax_exact_routes(family, route,
                                                 family_frames):
    """The port's exact LSF step on both routes against JAX
    decode_granules(exact=True, family) and the JAX Pallas exact route
    (the route of the JAX serving pools): PCM, store and v_blocks bitwise
    against both after every frame, prev_lines (latched on every LSF
    step) bitwise against the Pallas route.  The jitted XLA route latches
    prev_lines up to 12 ulp away from its own stage chain run unjitted,
    which the port equals (a compilation artifact of the JAX package;
    no LSF step reads prev_lines, so PCM and state never see it)."""
    streams = family_frames[family]
    B = len(streams)
    xst = JM.init_state(B)
    pst = PSF.init_pallas_state(B)
    st = init_state(B, "cpu")
    for t in range(N_FRAMES):
        batch = JM.frame_to_batches([fds[t] for fds in streams])[0]
        px, xst = JM.decode_granules(batch, xst, exact=True, family=family)
        pp, pst = PSF.decode_granules_pallas(batch, pst, exact=True,
                                             block_lanes=8, family=family)
        *ops, ip = lsf_wire_from_batch(batch, family)
        pt, st = ROUTES[route](*ops, st, exact=True, family=family,
                               is_pos=ip)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(px))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pp))
        for name in ("store", "v_blocks"):
            np.testing.assert_array_equal(
                getattr(st, name).numpy().view(np.uint32),
                _bits(getattr(xst, name)), err_msg=f"frame {t} {name}")
        want = PSF.state_from_pallas(pst)
        for name in ("store", "v_blocks", "prev_lines"):
            np.testing.assert_array_equal(
                getattr(st, name).numpy().view(np.uint32),
                _bits(getattr(want, name)), err_msg=f"frame {t} {name}")
        assert st.prev_lines.abs().sum() > 0


@pytest.mark.parametrize("bad", ["no_is_pos", "gr1", "family",
                                 "is_pos_shape"])
def test_lsf_step_rejects_malformed_operands(bad, family_frames):
    batch = JM.frame_to_batches([fds[0] for fds in family_frames[1]])[0]
    *ops, ip = lsf_wire_from_batch(batch, 1)
    kw = dict(family=1, is_pos=ip)
    if bad == "no_is_pos":
        kw["is_pos"] = None
    elif bad == "gr1":
        ops[5] = 1
    elif bad == "family":
        kw["family"] = 3
    else:
        kw["is_pos"] = ip[:, :61].contiguous()
    with pytest.raises(ValueError):
        FS.fused_granule_step(*ops, init_state(ops[0].shape[0], "cpu"), **kw)


# ---- serving -------------------------------------------------------------

def _pool_streams(family):
    """Four streams of one family: sfreq 0-2 (for family 2 this includes
    8 kHz), long / varied / short / mixed blocks, MS + intensity and
    intensity alone with a short ch1 extent, MS alone, mono, the bit
    reservoir."""
    specs = [dict(blocks="varied", mode=1, mode_extension=3,
                  stereo_extent_ch1=0.4, sfreq=0),
             dict(blocks="short", mode=1, mode_extension=2, sfreq=1,
                  use_reservoir=True),
             dict(blocks="mixed", sfreq=2, mode=1, mode_extension=1,
                  stereo_extent_ch1=0.3),
             dict(blocks="long", mode=3, sfreq=2)]
    return [mp3gen.make_stream(n_frames=8, seed=900 + 10 * family + s,
                               family=family, bitrate_index=11, **kw)
            for s, kw in enumerate(specs)]


def _check_vs_native(data, got, exact):
    want = np.frombuffer(native_decode_file(data, profile=PROFILE_LSF),
                         "<i2")
    mono = (data[3] >> 6) == 3
    if mono:
        np.testing.assert_array_equal(got[:, 0], got[:, 1])
    a = got[:, 0] if mono else got.reshape(-1)
    assert len(want) > 0 and len(a) == len(want)
    if exact:
        np.testing.assert_array_equal(a, want)
    else:
        assert_pcm_contract(a, want)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("family", FAMILIES)
def test_lsf_serving_matches_jax_pallas_and_native(family, exact):
    """Port StreamDecoder(family) against JAX StreamDecoder(family,
    kernel="pallas") on the same feed, and every slot against the native
    decoder with PROFILE_LSF: exact bitwise, fast within the contract."""
    streams = _pool_streams(family)
    n = len(streams)
    tdec = StreamDecoder(n, exact=exact, family=family, device="cpu")
    jdec = JaxStreamDecoder(n, exact=exact, family=family, kernel="pallas")
    for s, data in enumerate(streams):
        assert tdec.feed(s, data) == 0
        assert jdec.feed(s, data) == 0
    tsteps, jsteps = _run([tdec, jdec])
    assert len(tsteps) >= 4
    for (pt, at), (pj, aj) in zip(tsteps, jsteps):
        np.testing.assert_array_equal(at, aj)
        assert pt.shape == (n, 576, 2) and pt.dtype == np.int16
        if exact:
            np.testing.assert_array_equal(pt, pj)
        else:
            assert_pcm_contract(pt, pj)
        assert not pt[at == 0].any()
    for s, data in enumerate(streams):
        _check_vs_native(data, _slot_pcm(tsteps, s), exact)
    assert tdec.nch(3) == 1 and tdec.nch(0) == 2


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_lsf_exact_checkpoint_restored_into_port_continues_bitwise(
        family):
    streams = _pool_streams(family)
    n = len(streams)
    jdec = JaxStreamDecoder(n, exact=True, family=family, kernel="pallas")
    for s, data in enumerate(streams):
        jdec.feed(s, data)
    head = _run([jdec], max_steps=2)[0]
    ckpt = jdec.save_checkpoint()
    tdec = StreamDecoder(n, exact=True, family=family, device="cpu")
    tdec.restore_checkpoint(ckpt)
    tail_t, tail_j = _run([tdec, jdec])
    assert len(tail_t) >= 2
    for (pt, _), (pj, _) in zip(tail_t, tail_j):
        np.testing.assert_array_equal(pt, pj)
    for s, data in enumerate(streams):
        _check_vs_native(data, _slot_pcm(head + tail_t, s), exact=True)


def test_lsf_pool_skips_mpeg1_frames_as_jax_does():
    """An MPEG-1 stream in an LSF pool: its frames are consumed and
    skipped by the native LSF packer, so the slot stays idle and silent
    and its neighbour decodes bitwise as alone."""
    lsf = _pool_streams(1)[0]
    dec = StreamDecoder(2, exact=True, family=1, device="cpu")
    dec.feed(0, lsf)
    dec.feed(1, mp3gen.make_stream(n_frames=4, seed=3))
    steps = _run([dec])[0]
    assert not any(a[1] for _, a in steps)
    _check_vs_native(lsf, _slot_pcm(steps, 0), exact=True)


# ---- the per-stream route ------------------------------------------------

@pytest.mark.parametrize("kw", JAX_MATRIX, ids=_JAX_IDS)
def test_torchdsp_lsf_exact_equals_oracle_and_native(kw):
    data = _matrix_stream(kw)
    got = decode_file(data, lsf=True, dsp=TorchDSP(exact=True, device="cpu"))
    assert len(got) > 0
    assert got == jax_decode_file(data, lsf=True, dsp=OracleDSP())
    assert got == native_decode_file(data, profile=PROFILE_LSF)


@pytest.mark.parametrize("kw", JAX_MATRIX, ids=_JAX_IDS)
def test_torchdsp_lsf_fast_within_contract(kw):
    data = _matrix_stream(kw)
    got = np.frombuffer(decode_file(data, lsf=True,
                                    dsp=TorchDSP(exact=False, device="cpu")),
                        "<i2")
    want = np.frombuffer(jax_decode_file(data, lsf=True, dsp=OracleDSP()),
                         "<i2")
    assert got.shape == want.shape
    assert_pcm_contract(got, want)


def test_lsf_frame_to_batches_equals_native_wire():
    """One LSF batch built from the Python frontend's FrameData equals
    the native LSF packer's wire: ix (line-ordered by the family's
    reorder), all 32 meta words (family and iscale included), the
    intensity sidecar of intensity slots, and the coded channels'
    scalefactors."""
    kws = [kw for kw in JAX_MATRIX if kw["family"] == 1]
    streams = [_matrix_stream(kw, 4) for kw in kws]
    per = [_fds(s) for s in streams]
    B = len(streams)
    dec = StreamDecoder(B, family=1, device="cpu")
    feeder = LoopFeeder(dec, streams)
    for t in range(4):
        feeder.step()
        assert dec.parse_step() == B
        w = TM.wire_sections_lsf(torch.from_numpy(dec.wire.copy()), B)
        w = {k: v if k == "active" else v[0] for k, v in w.items()}
        (b,) = TM.frame_to_batches([fds[t] for fds in per], "cpu")
        assert b.gr1 == 0 and b.family == 1
        assert torch.equal(b.ix, w["ix"])
        np.testing.assert_array_equal(b.meta.numpy(),
                                      w["meta"].numpy().astype(np.int32))
        nch = b.meta[:, TD.M_NCH]
        for s in range(B):
            for name in ("scf_l", "scf_s"):
                assert torch.equal(getattr(b, name)[s, :nch[s]],
                                   w[name][s, :nch[s]]), name
            if b.meta[s, TD.M_IS]:
                assert torch.equal(b.is_pos[s], w["is_pos"][s])
        dec.decode_step()


# ---- K3 on the card --------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_k3_matches_plain_version_on_cuda(family, family_frames):
    """K3, fast and exact, against its plain version on the same CUDA
    tensors, from a random state with an idle slot: PCM, store, v_blocks
    and prev_lines bitwise over every frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    streams = family_frames[family]
    B = len(streams)
    rng = np.random.default_rng(family)
    st0 = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))]
    for exact in (False, True):
        sk = DecoderState(*(torch.from_numpy(a.copy()).cuda() for a in st0))
        sr = DecoderState(*(torch.from_numpy(a.copy()).cuda() for a in st0))
        kernel = "fused_granule_lsf_exact" if exact else "fused_granule_lsf"
        n0 = LA.LAUNCHES[kernel]
        for t in range(N_FRAMES):
            batch = JM.frame_to_batches([fds[t] for fds in streams])[0]
            ops = [x.cuda() if isinstance(x, torch.Tensor) else x
                   for x in lsf_wire_from_batch(batch, family)]
            ops[4][B - 1] = 0
            *args, ip = ops
            pk, sk = FS.fused_granule_step(*args, sk, exact=exact,
                                           family=family, is_pos=ip)
            pr, sr = FS.fused_granule_step_ref(*args, sr, exact=exact,
                                               family=family, is_pos=ip)
            torch.cuda.synchronize()
            assert torch.equal(pk, pr), (exact, t)
            for name in ("store", "v_blocks", "prev_lines"):
                assert torch.equal(getattr(sk, name).view(torch.int32),
                                   getattr(sr, name).view(torch.int32)), \
                    (exact, t, name)
        n1 = LA.LAUNCHES[kernel]
        assert n1 - n0 == N_FRAMES
