"""The port's frame-fused step (pdmp3_tpu_torch/ops/frame_step.py, K5 on
the card) on the CPU: against the port's own per-granule chain and
against the JAX frame-fused step decode_frames_pallas, run as the JAX
package's own tests run it (interpret mode, block_lanes=8), on the
fixture of tests/test_frame_fused.py (8 slots, 3 frames) and on the LSF
families' streams.  One ``cuda``-marked test holds K5 to its plain
version on the card.

Tolerances:
- against the port's per-granule chain (the granule steps that K1 / K3
  run, chained with each granule's gr1): bitwise, PCM and all state;
- against JAX: PCM within the fast contract (at most 1 LSB on fewer than
  1% of samples) and state within STATE_RTOL of the largest magnitude,
  as tests/test_torch_fused_step.py explains (the port reads |x|^(4/3)
  from the correctly rounded table where JAX fast computes a Newton cube
  root, and sums in another order).
"""
import numpy as np
import pytest
import torch

from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import pallas_step as PSF
from pdmp3_tpu_torch.models import decoder as TM
from pdmp3_tpu_torch.models.decoder import (DecoderState, GranuleBatch,
                                            state_from_pallas)
from pdmp3_tpu_torch.ops import frame_step as FR
from pdmp3_tpu_torch.ops import fused_step as FS
from pdmp3_tpu_torch.ops import launch as LA
from test_frame_fused import _granule_batches
from test_torch_fused_step import (assert_pcm_contract, assert_state_close,
                                   wire_from_batch)
from test_torch_lsf import family_frames, lsf_wire_from_batch  # noqa: F401

FAMILIES = (1, 2)


def _stack(jbatches, family=0):
    """Port frame-step operands (ix, scf_l, scf_s, meta, active) [ng,B,...]
    and is_pos (LSF) from JAX granule batches, plus their parities."""
    ops = [lsf_wire_from_batch(b, family) if family else wire_from_batch(b)
           for b in jbatches]
    stacked = [torch.stack([o[k] for o in ops]) for k in range(5)]
    is_pos = torch.stack([o[6] for o in ops]) if family else None
    return stacked, tuple(o[5] for o in ops), is_pos


def _random_states(B, seed):
    """The same random starting state as a JAX PallasState and a port
    DecoderState."""
    rng = np.random.RandomState(seed)
    pst = PSF.PallasState(
        store_t=rng.randn(2, 18, 32, B).astype(np.float32),
        v_t=rng.randn(2, 15, 64, B).astype(np.float32),
        prev_lines=rng.randn(B, 3).astype(np.float32))
    return pst, state_from_pallas(pst.store_t, pst.v_t, pst.prev_lines,
                                  "cpu")


def _clone(st):
    return DecoderState(st.store.clone(), st.v_blocks.clone(),
                        st.prev_lines.clone())


def _chain(ops, parities, st, family=0, is_pos=None):
    """The port's per-granule chain over stacked operands."""
    pcms = []
    for g, gr1 in enumerate(parities):
        pcm, st = FS.fused_granule_step(
            *(o[g] for o in ops), gr1, st, family=family,
            is_pos=None if is_pos is None else is_pos[g])
        pcms.append(pcm)
    return torch.cat(pcms, 1), st


def assert_bitwise(pa, sa, pb, sb, what=""):
    assert torch.equal(pa, pb), what
    for name in ("store", "v_blocks", "prev_lines"):
        assert torch.equal(getattr(sa, name).view(torch.int32),
                           getattr(sb, name).view(torch.int32)), \
            f"{what} {name}"


@pytest.fixture(scope="module")
def steps():
    """test_frame_fused's fixture: 3 frames of 8 slots (long, short,
    MS, mixed 32 kHz, mono, 48 kHz reservoir, MS + intensity, 320 kbit/s)
    as JAX granule batches, [gr0, gr1] per frame."""
    return _granule_batches(3)[0]


def test_frame_step_bitwise_equals_granule_chain(steps):
    """One frame per call (parities (0, 1)) over 3 frames from a zero
    state: PCM [B, 1152, 2] and all state bitwise the chain's."""
    B = steps[0][0].ix.shape[0]
    sf, sg = TM.init_state(B, "cpu"), TM.init_state(B, "cpu")
    for t, frame in enumerate(steps):
        ops, parities, _ = _stack(frame)
        assert parities == (0, 1)
        pf, sf = FR.frame_step(*ops, parities, sf)
        pg, sg = _chain(ops, parities, sg)
        assert pf.shape == (B, 1152, 2) and pf.dtype == torch.int16
        assert_bitwise(pf, sf, pg, sg, f"frame {t}")


def test_two_frames_in_one_call(steps):
    """Parities (0, 1, 0, 1): two frames in one call equal the chain of
    four granule steps, the carry latched and read twice."""
    ops, parities, _ = _stack(steps[0] + steps[1])
    assert parities == (0, 1, 0, 1)
    B = ops[0].shape[1]
    pst, st0 = _random_states(B, 3)
    pf, sf = FR.frame_step(*ops, parities, _clone(st0))
    pg, sg = _chain(ops, parities, _clone(st0))
    assert pf.shape == (B, 4 * 576, 2)
    assert_bitwise(pf, sf, pg, sg)


def test_band12_carry_from_random_state(steps):
    """test_frame_fused_band12_carry: from a random nonzero state the
    band-12 carry chains inside the frame step as the chain carries it
    (bitwise), and JAX decode_frames_pallas agrees within the fast
    contract."""
    B = steps[0][0].ix.shape[0]
    pst, st = _random_states(B, 7)
    sg = _clone(st)
    for t, frame in enumerate(steps[:2]):
        ops, parities, _ = _stack(frame)
        pf, st = FR.frame_step(*ops, parities, st)
        pg, sg = _chain(ops, parities, sg)
        assert_bitwise(pf, st, pg, sg, f"frame {t}")
        pj, pst = PSF.decode_frames_pallas(tuple(frame), pst, (0, 1),
                                           block_lanes=8)
        assert_pcm_contract(pf.numpy(), np.asarray(pj), f"frame {t}")
        assert_state_close(st, pst, f"frame {t}")
    assert st.prev_lines.abs().sum() > 0


def test_idle_slots_frozen(steps):
    """Slots idle in both granules emit silence with state and carry
    frozen bitwise; a slot idle in the second frame of a two-frame call
    keeps what the first frame left; the rest equal the chain."""
    ops, parities, _ = _stack(steps[0] + steps[1])
    B = ops[0].shape[1]
    ops[4][:, 1] = 0
    ops[4][:, 4] = 0
    ops[4][2:, 6] = 0
    _, st0 = _random_states(B, 1)
    pf, sf = FR.frame_step(*ops, parities, _clone(st0))
    pg, sg = _chain(ops, parities, _clone(st0))
    assert_bitwise(pf, sf, pg, sg)
    for s in (1, 4):
        assert not pf[s].any()
        for name in ("store", "v_blocks", "prev_lines"):
            assert torch.equal(getattr(sf, name)[s].view(torch.int32),
                               getattr(st0, name)[s].view(torch.int32))
    assert pf[6, :1152].any() and not pf[6, 1152:].any()
    assert pf[0].any()


@pytest.mark.parametrize("ff", [False, True], ids=["per_granule", "fused"])
def test_decode_frame_soa_routes(steps, monkeypatch, ff):
    """decode_frame_soa on the per-granule route and under the
    _FRAME_FUSED opt-in (one frame step per frame): bitwise the chain,
    and within the fast contract of JAX decode_frames_pallas, over 3
    frames; exact frames stay per granule under the opt-in."""
    monkeypatch.setattr(TM, "_FRAME_FUSED", ff)
    B = steps[0][0].ix.shape[0]
    st, sg = TM.init_state(B, "cpu"), TM.init_state(B, "cpu")
    pst = PSF.init_pallas_state(B)
    n0 = LA.LAUNCHES["frame_fused"]
    for t, frame in enumerate(steps):
        ops, parities, _ = _stack(frame)
        ix, scf_l, scf_s, meta, active = ops
        p, st = TM.decode_frame_soa(ix, scf_l, scf_s, meta.to(torch.int16),
                                    active[0].to(torch.int16), st)
        pg, sg = _chain(ops, parities, sg)
        assert_bitwise(p, st, pg, sg, f"frame {t}")
        pj, pst = PSF.decode_frames_pallas(tuple(frame), pst, (0, 1),
                                           block_lanes=8)
        assert_pcm_contract(p.numpy(), np.asarray(pj), f"frame {t}")
        assert_state_close(st, pst, f"frame {t}")
    se, sx = TM.init_state(B, "cpu"), TM.init_state(B, "cpu")
    ops, parities, _ = _stack(steps[0])
    pe, se = TM.decode_frame_soa(*ops[:4], ops[4][0], se, exact=True)
    for g in (0, 1):
        px, sx = FS.fused_granule_step(*(o[g] for o in ops), g, sx,
                                       exact=True)
        assert torch.equal(pe[:, 576 * g:576 * (g + 1)], px)
    # CPU tensors never launch a kernel
    assert LA.LAUNCHES["frame_fused"] == n0


@pytest.mark.parametrize("family", FAMILIES)
def test_lsf_frame_step(family, family_frames):  # noqa: F811
    """The LSF instance over two one-granule frames (parities (0, 0)):
    bitwise the K3-plain chain, and within the fast contract of JAX
    decode_frames_pallas(family)."""
    streams = family_frames[family]
    B = len(streams)
    jb = [JM.frame_to_batches([fds[t] for fds in streams])[0]
          for t in range(2)]
    ops, parities, is_pos = _stack(jb, family)
    assert parities == (0, 0)
    pf, sf = FR.frame_step(*ops, parities, TM.init_state(B, "cpu"),
                           family=family, is_pos=is_pos)
    pg, sg = _chain(ops, parities, TM.init_state(B, "cpu"), family, is_pos)
    assert pf.shape == (B, 2 * 576, 2)
    assert_bitwise(pf, sf, pg, sg)
    pj, pst = PSF.decode_frames_pallas(tuple(jb), PSF.init_pallas_state(B),
                                       (0, 0), block_lanes=8, family=family)
    assert_pcm_contract(pf.numpy(), np.asarray(pj))
    assert_state_close(sf, pst)


def _port_batches(frame):
    return [GranuleBatch(*wire_from_batch(b)) for b in frame]


def test_decode_frames_stacks_batches(steps):
    """decode_frames (the counterpart of decode_frames_pallas) over port
    granule batches equals frame_step on the stacked operands."""
    batches = _port_batches(steps[0])
    B = batches[0].ix.shape[0]
    pd, sd = FR.decode_frames(batches, TM.init_state(B, "cpu"), (0, 1))
    ops, parities, _ = _stack(steps[0])
    pf, sf = FR.frame_step(*ops, parities, TM.init_state(B, "cpu"))
    assert_bitwise(pd, sd, pf, sf)


def test_desynchronised_gr1_raises(steps):
    """A batch whose gr1 disagrees with its granule's parity raises (the
    JAX kernel poisons such a step instead, as traced code cannot
    raise)."""
    batches = _port_batches(steps[0])
    B = batches[0].ix.shape[0]
    with pytest.raises(ValueError, match="parity"):
        FR.decode_frames(batches, TM.init_state(B, "cpu"), (0, 0))
    with pytest.raises(ValueError, match="parity"):
        FR.decode_frames(batches[::-1], TM.init_state(B, "cpu"), (0, 1))


@pytest.mark.parametrize("bad", ["parity_value", "parity_count", "lsf_gr1",
                                 "active_shape", "meta_dtype"])
def test_frame_step_rejects_malformed_operands(steps, bad):
    ops, parities, _ = _stack(steps[0])
    B = ops[0].shape[1]
    kw = {}
    if bad == "parity_value":
        parities = (0, 2)
    elif bad == "parity_count":
        parities = (0, 1, 0)
    elif bad == "lsf_gr1":
        kw = dict(family=1, is_pos=torch.zeros((2, B, 64), dtype=torch.int16))
    elif bad == "active_shape":
        ops[4] = ops[4][0]
    else:
        ops[3] = ops[3].to(torch.int16)
    with pytest.raises(ValueError):
        FR.frame_step(*ops, parities, TM.init_state(B, "cpu"), **kw)


@pytest.mark.cuda
def test_k5_matches_plain_version_on_cuda(steps, family_frames):  # noqa
    """K5 against its plain version on the same CUDA tensors, bitwise in
    PCM and all state: MPEG-1 with two frames per launch (parities
    (0, 1, 0, 1)) from a random state, with slots idle throughout and in
    one frame; each LSF family over two frames (parities (0, 0))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ops, parities, _ = _stack(steps[0] + steps[1])
    B = ops[0].shape[1]
    ops[4][:, 3] = 0
    ops[4][2:, 5] = 0
    _, st0 = _random_states(B, 5)
    cases = [(0, [o.cuda() for o in ops], parities, None, st0)]
    for family in FAMILIES:
        streams = family_frames[family]
        jb = [JM.frame_to_batches([fds[t] for fds in streams])[0]
              for t in range(2)]
        lops, lpar, ip = _stack(jb, family)
        lops[4][:, 0] = 0
        _, lst0 = _random_states(len(streams), family)
        cases.append((family, [o.cuda() for o in lops], lpar, ip.cuda(),
                      lst0))
    for family, cops, par, ip, s0 in cases:
        sk = DecoderState(*(t.cuda() for t in (s0.store, s0.v_blocks,
                                                s0.prev_lines)))
        sr = _clone(sk)
        counter = "frame_fused_lsf" if family else "frame_fused"
        n0 = LA.LAUNCHES[counter]
        pk, sk = FR.frame_step(*cops, par, sk, family=family, is_pos=ip)
        assert LA.LAUNCHES[counter] == n0 + 1
        pr, sr = FR.frame_step_ref(*cops, par, sr, family=family,
                                   is_pos=ip)
        torch.cuda.synchronize()
        assert_bitwise(pk, sk, pr, sr, f"family {family}")
