"""K3 (the LSF granule kernel) and K5 (the frame kernel) on the
persistent body they share with K1 and K2 (csrc/granule_persist.cuh).

On the CPU: the operand rules of their copies (fused_step.BULK_ALIGN,
check_bulk_alignment) on every offset the packed LSF wire gives its
is_pos sidecar, and the launch-geometry query's argument checks.

On the card (``cuda``-marked, skipped without one): each instance
against its plain version on the same CUDA tensors, bitwise in PCM,
store, v_blocks and prev_lines, with idle slots silent and frozen: K3
for both LSF families and precisions and K5 for both instances at the
ragged batch sizes and idle seams of tests/test_torch_fused_step.py; K5
with slots idle in one granule and active in the next at ng = 1, 2 and
4 (parities (0, 1, 0, 1)); and K3 and K5 reading is_pos from a packed
LSF wire whose B % 4 != 0, so the sidecar starts off 16-byte alignment.
"""
import numpy as np
import pytest
import torch

from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu_torch.models import decoder as TM
from pdmp3_tpu_torch.models.decoder import DecoderState
from pdmp3_tpu_torch.ops import frame_step as FR
from pdmp3_tpu_torch.ops import fused_step as FS
from pdmp3_tpu_torch.ops import launch as LA
from test_torch_fused_step import (IDLE_SEAMS, RAGGED_B, idle_slots,
                                   ragged_batch, tiled_operands)
from test_torch_lsf import family_frames  # noqa: F401
from test_torch_lsf import lsf_wire_from_batch

FAMILIES = (1, 2)
STATE = ("store", "v_blocks", "prev_lines")


# ---- on the CPU ------------------------------------------------------------

@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 8])
def test_packed_lsf_wire_sections_pass_the_alignment_check(B, F):
    """The packed LSF wire puts is_pos at F x B x 2,612 bytes (16-byte
    aligned only when F x B % 4 == 0); every frame's is_pos, scf_l and
    scf_s view passes the 4-byte rule and every ix view the 16-byte one,
    so K3 and K5 take each LSF pool's wire as it is."""
    off = TM.soa_layout_lsf(B, F)
    buf = torch.zeros(off["total"], dtype=torch.int16)
    assert buf.data_ptr() % 64 == 0
    w = TM.wire_sections_lsf(buf, B, F)
    assert w["is_pos"].data_ptr() - buf.data_ptr() == F * B * 2612
    assert (w["is_pos"].data_ptr() % 16 == 0) == (F * B % 4 == 0)
    for f in range(F):
        LA.check_bulk_alignment(ix=w["ix"][f], scf_l=w["scf_l"][f],
                                scf_s=w["scf_s"][f], is_pos=w["is_pos"][f])


@pytest.mark.parametrize("kw,instance", [
    ({}, 0), (dict(exact=True), 1), (dict(family=1), 2),
    (dict(family=2, exact=True), 3), (dict(frame=True), 4),
    (dict(family=1, frame=True), 5), (dict(family=2, frame=True), 5),
    (dict(back_half=True), 6), (dict(back_half=True, exact=True), 7)])
def test_launch_instance_names_every_persistent_kernel(kw, instance):
    """K1, K2, K3 fast / exact, K5 MPEG-1 / LSF and K4 fast / exact are
    the instances 0-7 of pdmp3_granule_launch_info."""
    assert LA.launch_instance(**kw) == instance


@pytest.mark.parametrize("kw", [dict(family=3), dict(family=-1),
                                dict(exact=True, frame=True),
                                dict(family=1, exact=True, frame=True),
                                dict(back_half=True, frame=True),
                                dict(back_half=True, family=1)])
def test_granule_launch_info_rejects_other_arguments(kw):
    """A family other than 0-2, an exact frame step (K5 is fast only), or
    K4 with a frame or a family (it takes post-antialias spectra) raises
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


def _random_state(B, dev, seed):
    rng = np.random.default_rng(seed)
    return DecoderState(*(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
        for s in ((B, 2, 32, 18), (B, 2, 15, 64), (B, 3))))


def _clone(st):
    return DecoderState(*(getattr(st, k).clone() for k in STATE))


def tiled_lsf(frames, family, B, dev, n_frames=2):
    """The first n_frames frames of one family's streams tiled over B
    slots: [(ix, scf_l, scf_s, meta, active, is_pos)] per frame."""
    idx = torch.arange(B) % len(frames)
    out = []
    for t in range(n_frames):
        batch = JM.frame_to_batches([fds[t] for fds in frames])[0]
        ix, scf_l, scf_s, meta, act, _, ip = lsf_wire_from_batch(batch,
                                                                 family)
        out.append([x[idx].contiguous().to(dev)
                    for x in (ix, scf_l, scf_s, meta, act, ip)])
    return out


def assert_kernel_equals_plain(pk, sk, pr, sr, st0, idle, what):
    """Bitwise PCM and state; idle slots (idle in every granule) silent
    and frozen."""
    torch.cuda.synchronize()
    assert torch.equal(pk, pr), what
    for name in STATE:
        assert torch.equal(getattr(sk, name).view(torch.int32),
                           getattr(sr, name).view(torch.int32)), \
            (what, name)
    assert not pk[idle].any(), what
    for name in STATE:
        assert torch.equal(getattr(sk, name)[idle].view(torch.int32),
                           getattr(st0, name)[idle].view(torch.int32)), \
            (what, name)
    assert len(idle) == pk.shape[0] or pk.any(), what


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", IDLE_SEAMS)
@pytest.mark.parametrize("n", RAGGED_B)
def test_k3_ragged_batches_and_idle_seams_on_cuda(n, pattern,
                                                  family_frames):  # noqa
    """K3, both families and precisions, at B = 1, 2, grid - 1, grid + 1
    and 2 grid + 3 (K3's grid from the library) with idle slots at the
    ring's seams, two frames from a random state: bitwise equal to the
    plain version."""
    dev = _cuda()
    for family in FAMILIES:
        for exact in (False, True):
            grid = LA.granule_launch_info(dev, exact, family)["grid"]
            B = ragged_batch(n, grid)
            idle = idle_slots(pattern, B, grid)
            st0 = _random_state(B, dev, family)
            sk, sr = _clone(st0), _clone(st0)
            attr = "fused_granule_lsf_exact" if exact else "fused_granule_lsf"
            for t, (ix, scf_l, scf_s, meta, act, ip) in enumerate(
                    tiled_lsf(family_frames[family], family, B, dev)):
                act[idle] = 0
                n0 = LA.LAUNCHES[attr]
                pk, sk = FS.fused_granule_step(ix, scf_l, scf_s, meta, act,
                                               0, sk, exact=exact,
                                               family=family, is_pos=ip)
                assert LA.LAUNCHES[attr] == n0 + 1
                pr, sr = FS.fused_granule_step_ref(ix, scf_l, scf_s, meta,
                                                   act, 0, sr, exact=exact,
                                                   family=family, is_pos=ip)
                assert_kernel_equals_plain(pk, sk, pr, sr, st0, idle,
                                           (family, exact, n, pattern, t))


def frame_case(family_frames, family, B, dev):
    """K5's operands for B slots: MPEG-1's first frame (parities (0, 1))
    or an LSF family's first two frames (parities (0, 0)), stacked [2, B,
    ...]; (ops, parities, is_pos or None)."""
    if not family:
        grans, _ = tiled_operands(B, dev)
        return ([torch.stack([g[k] for g in grans]) for k in range(5)],
                (0, 1), None)
    fr = tiled_lsf(family_frames[family], family, B, dev)
    return ([torch.stack([f[k] for f in fr]) for k in range(5)], (0, 0),
            torch.stack([f[5] for f in fr]))


def _run_frame(ops, parities, st0, family, ip):
    counter = "frame_fused_lsf" if family else "frame_fused"
    n0 = LA.LAUNCHES[counter]
    pk, sk = FR.frame_step(*ops, parities, _clone(st0), family=family,
                           is_pos=ip)
    assert LA.LAUNCHES[counter] == n0 + 1
    pr, sr = FR.frame_step_ref(*ops, parities, _clone(st0), family=family,
                               is_pos=ip)
    return pk, sk, pr, sr


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", IDLE_SEAMS)
@pytest.mark.parametrize("n", RAGGED_B)
def test_k5_ragged_batches_and_idle_seams_on_cuda(n, pattern,
                                                  family_frames):  # noqa
    """K5, MPEG-1 and LSF, at the ragged batch sizes of its own grid with
    slots idle in both granules at the ring's seams: bitwise equal to the
    plain chain."""
    dev = _cuda()
    for family in (0, 1):
        grid = LA.granule_launch_info(dev, family=family,
                                      frame=True)["grid"]
        B = ragged_batch(n, grid)
        idle = idle_slots(pattern, B, grid)
        ops, parities, ip = frame_case(family_frames, family, B, dev)
        ops[4][:, idle] = 0
        st0 = _random_state(B, dev, 10 + family)
        pk, sk, pr, sr = _run_frame(ops, parities, st0, family, ip)
        assert pk.shape == (B, 2 * 576, 2)
        assert_kernel_equals_plain(pk, sk, pr, sr, st0, idle,
                                   (family, n, pattern))


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [1, 2, 4])
def test_k5_slots_idle_in_one_granule_on_cuda(ng):
    """K5 (MPEG-1) over the first ng granules of two frames (parities
    (0, 1, 0, 1)) at B = grid + 5: slots idle in granule 0 and active in
    granule 1, active then idle, idle in every other granule, and idle
    throughout; bitwise equal to the plain chain, the carry latched and
    read around the idle granules as the chain does."""
    dev = _cuda()
    grid = LA.granule_launch_info(dev, frame=True)["grid"]
    B = grid + 5
    frames = [tiled_operands(B, dev, seed)[0] for seed in (0, 1)]
    grans = frames[0] + frames[1]
    ops = [torch.stack([g[k] for g in grans[:ng]]) for k in range(5)]
    parities = (0, 1, 0, 1)[:ng]
    act = ops[4]
    act[0, 1::7] = 0                       # idle in granule 0 only
    if ng > 1:
        act[1, 2::7] = 0                   # idle in granule 1 only
        act[::2, 3::7] = 0                 # idle in every other granule
    act[:, 4::7] = 0                       # idle throughout
    st0 = _random_state(B, dev, 3)
    pk, sk, pr, sr = _run_frame(ops, parities, st0, 0, None)
    assert pk.shape == (B, ng * 576, 2)
    idle = list(range(4, B, 7))
    assert_kernel_equals_plain(pk, sk, pr, sr, st0, idle, ng)
    for g in range(ng):
        rows = pk[:, g * 576:(g + 1) * 576]
        assert not rows[act[g] == 0].any(), g
    if ng > 1:
        assert rows[1].any()               # active in granule 1 only


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_k3_k5_read_is_pos_off_16_byte_alignment_on_cuda(family,
                                                         family_frames):  # noqa
    """A packed LSF wire of B = grid + 1 slots (B % 4 != 0 on the
    card's grids) and two frames, its is_pos section starting F x B x
    2,612 bytes in: K3 (both precisions) through decode_frame_packed_lsf
    and K5 on the wire's own sections equal their plain versions
    bitwise."""
    dev = _cuda()
    grid = LA.granule_launch_info(dev, family=family)["grid"]
    B = grid + 1 if (grid + 1) % 4 else grid + 2
    F = 2
    w_cpu = torch.zeros(TM.soa_layout_lsf(B, F)["total"], dtype=torch.int16)
    w = TM.wire_sections_lsf(w_cpu, B, F)
    for f, (ix, scf_l, scf_s, meta, act, ip) in enumerate(
            tiled_lsf(family_frames[family], family, B, "cpu", F)):
        act[B - 1] = 0
        for name, x in (("ix", ix), ("scf_l", scf_l), ("scf_s", scf_s),
                        ("meta", meta.to(torch.int16)), ("is_pos", ip)):
            w[name][f].copy_(x)
        w["active"][f].copy_(act.to(torch.int16))
    wire = w_cpu.to(dev)
    wd = TM.wire_sections_lsf(wire, B, F)
    assert wd["is_pos"].data_ptr() % 16 != 0
    st0 = _random_state(B, dev, 20 + family)
    for exact in (False, True):
        sk, sr = _clone(st0), _clone(st0)
        attr = "fused_granule_lsf_exact" if exact else "fused_granule_lsf"
        n0 = LA.LAUNCHES[attr]
        pk, sk = TM.decode_frame_packed_lsf(wire, sk, B, family, F,
                                            exact=exact)
        assert LA.LAUNCHES[attr] == n0 + F
        prs = []
        for f in range(F):
            p, sr = FS.fused_granule_step_ref(
                wd["ix"][f], wd["scf_l"][f], wd["scf_s"][f],
                wd["meta"][f].to(torch.int32), wd["active"].view(F, B)[f]
                .to(torch.int32), 0, sr, exact=exact, family=family,
                is_pos=wd["is_pos"][f])
            prs.append(p)
        assert_kernel_equals_plain(pk, sk, torch.cat(prs, 1), sr, st0,
                                   [B - 1], (family, exact))
    ops = [wd["ix"], wd["scf_l"], wd["scf_s"],
           wd["meta"].to(torch.int32).contiguous(),
           wd["active"].view(F, B).to(torch.int32)]
    pk, sk, pr, sr = _run_frame(ops, (0,) * F, st0, family, wd["is_pos"])
    assert_kernel_equals_plain(pk, sk, pr, sr, st0, [B - 1],
                               (family, "K5"))
