"""Float PCM from the fused granule step: ``fused_granule_step(
float_pcm=True)``, whose CUDA kernels are K1, K2 and K3's float instances
9-12 (``csrc/fused_granule.cu``: the FIR sums packed as ``dsp.float_pack``
packs them, no quantize), and the serving routes that now take it.

On the CPU: the step (its plain version, ``fused_granule_step_ref(
float_pcm=True)``) against the split float route
(``back_half.float_granule_step``: the stage ops and K4's raw sums) on
natively parsed wire of every family and precision, with idle slots,
both MPEG-1 granule parities and a mono slot; the serving routes
(``decode_frame_packed``, ``decode_frame_packed_lsf``, the pools) going
through it and never through the back half; exact float PCM through
them against the JAX package's ``decode_granules(float_pcm=True,
exact=True)`` (its XLA route); the instance numbers.

On the card (``cuda``-marked, skipped without one): instances 9-12
against their plain version at the ragged batch sizes and idle seams of
``tests/test_torch_fused_step.py``, from a state that drives the FIR
sums to NaN, +-inf and past the rails, and (MPEG-1) a granule-1 step
whose band-12 carry holds subnormal bit patterns; their launch
geometry; a float pool step that launches them and no K4, bitwise equal
to ``decode_granules(float_pcm=True)`` on the same wire.

Tolerance: bitwise everywhere (PCM as uint32, store, v_blocks,
prev_lines): the kernels and both plain routes round at the same points
in the same order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu_torch import StreamDecoder
from pdmp3_tpu_torch.models import decoder as TM
from pdmp3_tpu_torch.models.decoder import DecoderState
from pdmp3_tpu_torch.ops import back_half as BH
from pdmp3_tpu_torch.ops import dsp as D
from pdmp3_tpu_torch.ops import fused_step as FS
from pdmp3_tpu_torch.ops import launch as LA
from pdmp3_tpu_torch.testing import l3wire, mp3gen
from test_torch_fused_step import (IDLE_SEAMS, RAGGED_B, idle_slots,
                                   ragged_batch, tiled_operands)
from test_torch_lsf import _pool_streams, family_frames  # noqa: F401
from test_torch_persist_lsf_frame import tiled_lsf

STATE = ("store", "v_blocks", "prev_lines")
MID_IDLE = (1, 2)    # (step, slot) made idle mid-stream
# the band-12 carry's subnormal bit patterns (chip_smoke.py SUBNORMAL_BITS)
SUBNORMAL_BITS = (126, 321)


def _mpeg1_streams():
    """Long, short MS, mono 48 kHz, mixed 32 kHz with the reservoir."""
    return [mp3gen.make_stream(n_frames=4, seed=90, blocks="long"),
            mp3gen.make_stream(n_frames=4, seed=91, blocks="short", mode=1,
                               mode_extension=2),
            mp3gen.make_stream(n_frames=4, seed=92, blocks="varied", mode=3,
                               sfreq=1),
            mp3gen.make_stream(n_frames=4, seed=93, blocks="mixed", sfreq=2,
                               use_reservoir=True)]


def _granule_steps(family: int, max_steps: int = 3):
    """Natively parsed wire of one family's streams plus one slot never
    fed, and slot MID_IDLE[1] idle on step MID_IDLE[0]: per step (wire
    int16, [per granule (ix, scf_l, scf_s, meta, active, gr1,
    is_pos)])."""
    streams = _pool_streams(family) if family else _mpeg1_streams()
    B = len(streams) + 1
    dec = StreamDecoder(B, family=family, device="cpu")
    for s, data in enumerate(streams):
        assert dec.feed(s, data) == 0
    out = []
    while len(out) < max_steps and dec.parse_step():
        if len(out) == MID_IDLE[0]:
            dec.active[MID_IDLE[1]] = 0
        # an MPEG-1 pool's coded wire, made dense
        wire = (torch.from_numpy(dec.wire.copy()) if family
                else l3wire.pool_dense_wire(dec))
        dec.decode_step()
        if family:
            w = TM.wire_sections_lsf(wire, B)
            grans = [(w["ix"][0], w["scf_l"][0], w["scf_s"][0],
                      w["meta"][0].to(torch.int32),
                      w["active"].to(torch.int32), 0, w["is_pos"][0])]
        else:
            w = TM.wire_sections(wire, B)
            grans = [(w["ix"][g], w["scf_l"][g], w["scf_s"][g],
                      w["meta"][g].to(torch.int32),
                      w["active"].to(torch.int32), g, None)
                     for g in range(2)]
        out.append((wire, grans))
    assert len(out) == max_steps
    return out


def _u32(t):
    return t.contiguous().view(torch.int32)


def _assert_same(pa, sa, pb, sb, what):
    assert pa.dtype == pb.dtype == torch.float32, what
    assert pa.shape == pb.shape, what
    assert torch.equal(_u32(pa), _u32(pb)), what
    for name in STATE:
        assert torch.equal(_u32(getattr(sa, name)),
                           _u32(getattr(sb, name))), (what, name)


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
@pytest.mark.parametrize("family", [0, 1, 2])
def test_float_step_equals_the_split_float_route_bitwise(family, exact):
    """fused_granule_step(float_pcm=True) on CPU tensors against
    float_granule_step (stage ops, back_half_step(raw=True),
    dsp.float_pack) on three steps of native wire: PCM bits, store,
    v_blocks and prev_lines bitwise after every granule; idle slots
    silent and their state frozen; the mono slot's channels equal."""
    steps = _granule_steps(family)
    B = steps[0][1][0][0].shape[0]
    sf, ss = TM.init_state(B, "cpu"), TM.init_state(B, "cpu")
    for t, (_, grans) in enumerate(steps):
        for ix, scf_l, scf_s, meta, act, gr1, ip in grans:
            before = [getattr(sf, k).clone() for k in STATE]
            pf, sf = FS.fused_granule_step(ix, scf_l, scf_s, meta, act, gr1,
                                           sf, exact=exact, family=family,
                                           is_pos=ip, float_pcm=True)
            ps, ss = BH.float_granule_step(ix, scf_l, scf_s, meta, act, gr1,
                                           ss, exact=exact, family=family,
                                           is_pos=ip)
            what = (family, exact, t, gr1)
            _assert_same(pf, sf, ps, ss, what)
            assert pf.shape == (B, 576, 2) and pf.abs().max() <= 1
            idle = act == 0
            assert not pf[idle].any() and pf[~idle].any(), what
            for k, b in zip(STATE, before):
                assert torch.equal(getattr(sf, k)[idle], b[idle]), (what, k)
            mono = D.fields(meta).nch <= 1
            assert mono.any() and torch.equal(pf[mono][..., 0],
                                              pf[mono][..., 1])
            if t in (0, MID_IDLE[0]):
                assert bool(act[MID_IDLE[1]]) == (t == 0), what
            assert not act[-1], what


@pytest.mark.parametrize("family", [0, 1, 2])
def test_serving_float_routes_take_the_fused_step(family, monkeypatch):
    """decode_frame_packed / decode_frame_packed_lsf(float_pcm=True) run
    each granule as fused_granule_step(float_pcm=True), once per granule,
    and never reach back_half_step (K4 on the card); decode_granules(
    float_pcm=True) keeps the split route through it."""
    calls = []
    real = TM.fused_granule_step

    def spy(*a, **kw):
        calls.append(kw.get("float_pcm", False))
        return real(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the float serving route reached K4")

    wire, grans = _granule_steps(family, 1)[0]
    monkeypatch.setattr(TM, "fused_granule_step", spy)
    monkeypatch.setattr(BH, "back_half_step", refuse)
    B = grans[0][0].shape[0]
    st = TM.init_state(B, "cpu")
    if family:
        pcm, _ = TM.decode_frame_packed_lsf(wire, st, B, family,
                                            float_pcm=True)
    else:
        pcm, _ = TM.decode_frame_packed(wire, st, B, float_pcm=True)
    assert calls == [True] * (1 if family else 2)
    assert pcm.dtype == torch.float32 and pcm.any()
    ix, scf_l, scf_s, meta, act, gr1, ip = grans[0]
    with pytest.raises(AssertionError, match="K4"):
        TM.decode_granules(TM.GranuleBatch(
            ix=ix, scf_l=scf_l, scf_s=scf_s, meta=meta, active=act, gr1=gr1,
            family=family, is_pos=ip), TM.init_state(B, "cpu"),
            float_pcm=True)


@pytest.mark.parametrize("family", [0, 1, 2])
def test_exact_float_serving_matches_jax_decode_granules(family):
    """Exact float PCM through the changed serving routes
    (decode_frame_packed / decode_frame_packed_lsf(float_pcm=True,
    exact=True)) against the JAX package's decode_frame_packed(_lsf)(
    float_pcm=True, exact=True, kernel="xla"), whose every granule is
    decode_granules(float_pcm=True, exact=True), on the same native wire,
    state carried: PCM bits, store and v_blocks bitwise every step."""
    steps = _granule_steps(family)
    B = steps[0][1][0][0].shape[0]
    st, jst = TM.init_state(B, "cpu"), JM.init_state(B)
    for t, (wire, _) in enumerate(steps):
        if family:
            pt, st = TM.decode_frame_packed_lsf(wire, st, B, family,
                                                exact=True, float_pcm=True)
            pj, jst = JM.decode_frame_packed_lsf(
                jnp.asarray(wire.numpy()), jst, B=B, family=family,
                exact=True, float_pcm=True, kernel="xla")
        else:
            pt, st = TM.decode_frame_packed(wire, st, B, exact=True,
                                            float_pcm=True)
            pj, jst = JM.decode_frame_packed(
                jnp.asarray(wire.numpy()), jst, B=B, exact=True,
                float_pcm=True, kernel="xla")
        np.testing.assert_array_equal(
            pt.numpy().view(np.uint32),
            np.asarray(pj, np.float32).view(np.uint32), err_msg=f"step {t}")
        for name in ("store", "v_blocks"):
            np.testing.assert_array_equal(
                getattr(st, name).numpy().view(np.uint32),
                np.asarray(getattr(jst, name), np.float32).view(np.uint32),
                err_msg=f"step {t} {name}")


@pytest.mark.parametrize("kw,instance", [
    (dict(float_pcm=True), 9), (dict(float_pcm=True, exact=True), 10),
    (dict(float_pcm=True, family=1), 11),
    (dict(float_pcm=True, family=2), 11),
    (dict(float_pcm=True, family=1, exact=True), 12),
    (dict(float_pcm=True, family=2, exact=True), 12)])
def test_launch_instance_of_the_float_granule_steps(kw, instance):
    """K1, K2, K3 fast and K3 exact writing float PCM are the persistent
    instances 9-12 of pdmp3_granule_launch_info."""
    assert LA.launch_instance(**kw) == instance


@pytest.mark.parametrize("kw", [dict(float_pcm=True, frame=True),
                                dict(float_pcm=True, back_half=True),
                                dict(float_pcm=True, back_half=True,
                                     raw=True),
                                dict(float_pcm=True, family=3)])
def test_float_instances_refuse_frames_and_the_back_half(kw):
    """Float PCM is a granule-step instance: with frame or back_half (or
    an unknown family) launch_instance and granule_launch_info raise
    ValueError before the kernel library is loaded."""
    with pytest.raises(ValueError):
        LA.launch_instance(**kw)
    with pytest.raises(ValueError):
        LA.granule_launch_info("cpu", **kw)


# ---- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _clone(st):
    return DecoderState(*(getattr(st, k).clone() for k in STATE))


def _hostile_state(B, dev, seed):
    """A random state whose FIFO rows drive the FIR sums of a few slots
    to NaN, +-inf and far past the rails: NaN, +inf, -inf and +-3e38 in
    carried rows of slots 0-4 (those that exist), the rest N(0, 1) (sums
    beyond +-1 too)."""
    rng = np.random.default_rng(seed)
    st = DecoderState(*(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
        for s in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))))
    for s, x in enumerate((np.nan, np.inf, -np.inf, 3e38, -3e38)[:B]):
        st.v_blocks[s, s % 2, 5:9, 3:40] = x
    return DecoderState(*(getattr(st, k).to(dev) for k in STATE))


def _run_pair(ops, st0, family, exact, ip=None):
    """One float step on the card and its plain version from st0; the
    instance's counter checked."""
    attr = ("fused_granule" + ("_lsf" if family else "") + "_float"
            + ("_exact" if exact else ""))
    n0 = LA.LAUNCHES[attr]
    pk, sk = FS.fused_granule_step(*ops, _clone(st0), exact=exact,
                                   family=family, is_pos=ip, float_pcm=True)
    assert LA.LAUNCHES[attr] == n0 + 1
    pr, sr = FS.fused_granule_step_ref(*ops, _clone(st0), exact=exact,
                                       family=family, is_pos=ip,
                                       float_pcm=True)
    torch.cuda.synchronize()
    return pk, sk, pr, sr


def _check(pk, sk, pr, sr, st0, idle, what):
    _assert_same(pk, sk, pr, sr, what)
    assert not pk[idle].any(), what
    for name in STATE:
        assert torch.equal(_u32(getattr(sk, name)[idle]),
                           _u32(getattr(st0, name)[idle])), (what, name)
    assert len(idle) == pk.shape[0] or pk.any(), what


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", IDLE_SEAMS)
@pytest.mark.parametrize("n", RAGGED_B)
def test_float_instances_ragged_batches_and_idle_seams_on_cuda(
        n, pattern, family_frames):  # noqa: F811
    """Instances 9-12 at B = 1, 2, grid - 1, grid + 1 and 2 grid + 3
    (each instance's grid from the library) with idle slots at the seams
    of the slot ring, from a state that drives sums to NaN, +-inf and
    past the rails: PCM bits, store, v_blocks and prev_lines bitwise
    equal to the plain version, idle slots silent and frozen; MPEG-1 over
    both granules, then granule 1 again with a band-12 carry of
    subnormal bit patterns."""
    dev = _cuda()
    for family in (0, 1, 2):
        for exact in (False, True):
            grid = LA.granule_launch_info(dev, exact, family,
                                          float_pcm=True)["grid"]
            B = ragged_batch(n, grid)
            idle = idle_slots(pattern, B, grid)
            st0 = _hostile_state(B, dev, family)
            what = (family, exact, n, pattern)
            if family:
                for t, (*ops, ip) in enumerate(
                        tiled_lsf(family_frames[family], family, B, dev)):
                    ops[4][idle] = 0
                    res = _run_pair(ops + [0], st0, family, exact, ip)
                    _check(*res, st0, idle, what + (t,))
                continue
            grans, _ = tiled_operands(B, dev)
            st = st0
            for ix, scf_l, scf_s, meta, act, gr1 in grans:
                act[idle] = 0
                pk, sk, pr, sr = _run_pair(
                    [ix, scf_l, scf_s, meta, act, gr1], st, 0, exact)
                _check(pk, sk, pr, sr, st, idle, what + (gr1,))
                st = sr
            lo, hi = SUBNORMAL_BITS
            sub = _clone(st0)
            sub.prev_lines.copy_((lo + torch.arange(B * 3, device=dev)
                                  % (hi - lo)).to(torch.int32)
                                 .view(torch.float32).reshape(B, 3))
            ix, scf_l, scf_s, meta, act, gr1 = grans[1]
            ix = ix.clone()
            ix[:, 1] = (torch.arange(576, device=dev) % 7 - 3).to(
                torch.int16)
            res = _run_pair([ix, scf_l, scf_s, meta, act, 1], sub, 0, exact)
            _check(*res, sub, idle, what + ("band-12 subnormal",))


@pytest.mark.cuda
@pytest.mark.parametrize("family", [0, 1, 2])
@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_float_instances_launch_geometry_on_cuda(exact, family):
    """Each float instance fits two blocks per SM in at most 56 registers
    with no local memory (spills)."""
    info = LA.granule_launch_info(_cuda(), exact, family, float_pcm=True)
    assert info["registers"] <= 56 and info["local_bytes"] == 0, info
    assert info["blocks_per_sm"] == 2, info
    assert info["grid"] == 2 * info["sm_count"], info


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_float_pool_step_launches_the_float_instances_on_cuda(exact):
    """A float pool step (StreamDecoder(float_pcm=True), then the LSF
    route decode_frame_packed_lsf(float_pcm=True)) launches instances
    9 / 10 (twice a frame) or 11 / 12 (once) and no K4
    (K4's counts back_half and back_half_raw unchanged); its PCM is bitwise
    decode_granules(float_pcm=True)'s (stage ops + K4) on the same wire,
    from the same state."""
    dev = _cuda()
    streams = _mpeg1_streams()
    B = len(streams) + 1
    dec = StreamDecoder(B, exact=exact, float_pcm=True, device=dev)
    for s, data in enumerate(streams):
        assert dec.feed(s, data) == 0
    st = TM.init_state(B, dev)
    for _ in range(3):
        assert dec.parse_step()
        wire = l3wire.pool_dense_wire(dec).to(dev)
        k4 = (LA.LAUNCHES["back_half"], LA.LAUNCHES["back_half_raw"])
        attr = "fused_granule_float" + ("_exact" if exact else "")
        n0 = LA.LAUNCHES[attr]
        pcm = dec.decode_step(fetch=False)
        assert LA.LAUNCHES[attr] == n0 + 2
        assert (LA.LAUNCHES["back_half"], LA.LAUNCHES["back_half_raw"]) == k4
        w = TM.wire_sections(wire, B)
        want = []
        for g in range(2):
            p, st = TM.decode_granules(TM.GranuleBatch(
                ix=w["ix"][g], scf_l=w["scf_l"][g], scf_s=w["scf_s"][g],
                meta=w["meta"][g].to(torch.int32).contiguous(),
                active=w["active"].to(torch.int32).contiguous(), gr1=g),
                st, exact=exact, float_pcm=True)
            want.append(p)
        torch.cuda.synchronize()
        assert torch.equal(_u32(pcm), _u32(torch.cat(want, 1)))
    for family in (1, 2):
        streams = _pool_streams(family)
        B = len(streams)
        dec = StreamDecoder(B, family=family, device=dev)
        for s, data in enumerate(streams):
            assert dec.feed(s, data) == 0
        assert dec.parse_step()
        wire = torch.from_numpy(dec.wire.copy()).to(dev)
        k4 = (LA.LAUNCHES["back_half"], LA.LAUNCHES["back_half_raw"])
        attr = "fused_granule_lsf_float" + ("_exact" if exact else "")
        n0 = LA.LAUNCHES[attr]
        pf, _ = TM.decode_frame_packed_lsf(wire, TM.init_state(B, dev), B,
                                           family, exact=exact,
                                           float_pcm=True)
        assert LA.LAUNCHES[attr] == n0 + 1
        assert (LA.LAUNCHES["back_half"], LA.LAUNCHES["back_half_raw"]) == k4
        w = TM.wire_sections_lsf(wire, B)
        want, _ = TM.decode_granules(TM.GranuleBatch(
            ix=w["ix"][0], scf_l=w["scf_l"][0], scf_s=w["scf_s"][0],
            meta=w["meta"][0].to(torch.int32).contiguous(),
            active=w["active"].to(torch.int32).contiguous(), gr1=0,
            family=family, is_pos=w["is_pos"][0]), TM.init_state(B, dev),
            exact=exact, float_pcm=True)
        torch.cuda.synchronize()
        assert torch.equal(_u32(pf), _u32(want))
