"""The port's fused granule step (pdmp3_tpu_torch/ops/fused_step.py)
against the JAX fused Pallas kernel, run as the JAX package's own tests
run it on the CPU: decode_granules_pallas(exact=False, block_lanes=8) in
interpret mode.

Tolerances:
- PCM: the fast contract, at most 1 LSB on fewer than 1% of samples
  (tests/test_pallas.py:71-76).  The port reads |x|^(4/3) from the
  correctly rounded table where JAX computes a Newton cube root (<= 2
  ulp apart), and its dots sum in another order than XLA's.
- store / v / prev_lines: |port - jax| <= STATE_RTOL * max(1, max|jax|).
  The only differences are f32 summation order and those ulps, which
  grow with the magnitude of the summed terms, not of each result;
  1e-5 of the largest value is ~80 ulp at that scale, while a wrong
  stage is off by O(value).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdmp3_tpu.frontend import Frontend
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import pallas_step as PSF
from pdmp3_tpu_torch.models.decoder import DecoderState, init_state
from pdmp3_tpu_torch.ops import dsp as D
from pdmp3_tpu_torch.ops import fused_step as FS
from test_jax_decoder import _band12_zero_bits_stream
from test_pallas import _frames

MAX_LSB, MAX_FRAC = 1, 0.01
STATE_RTOL = 1e-5


def wire_from_batch(batch):
    """A JAX GranuleBatch as the port's wire-form operands: (ix, scf_l,
    scf_s, meta, active, gr1) with meta in PDMP3_META_* word order."""
    g = np.asarray
    B = g(batch.ix).shape[0]
    meta = np.zeros((B, D.META_WORDS), np.int32)
    for k, name in ((D.M_LAYOUT, "layout"), (D.M_BT, "block_type"),
                    (D.M_WSF, "win_switch"), (D.M_MIXED, "mixed"),
                    (D.M_GG, "global_gain"),
                    (D.M_SFS, "scalefac_scale"), (D.M_PRE, "preflag"),
                    (D.M_C1, "count1")):
        meta[:, k:k + 2] = g(getattr(batch, name))
    meta[:, D.M_SBG:D.M_SBG + 6] = g(batch.subblock_gain).reshape(B, 6)
    meta[:, D.M_MS] = g(batch.ms_flag)
    meta[:, D.M_IS] = g(batch.is_flag)
    meta[:, D.M_NCH] = g(batch.nch)
    gr1 = np.unique(g(batch.gr1))
    assert gr1.size == 1
    t = torch.from_numpy
    return (t(g(batch.ix).astype(np.int16)),
            t(g(batch.scf_l).astype(np.int16)),
            t(g(batch.scf_s).reshape(B, 2, 39).astype(np.int16)), t(meta),
            t(g(batch.active).astype(np.int32)), int(gr1[0]))


def assert_pcm_contract(got, want, what=""):
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert d.max() <= MAX_LSB, f"{what}: max {d.max()} LSB"
    assert (d != 0).mean() < MAX_FRAC, f"{what}: {(d != 0).mean():.4%}"


def assert_state_close(st, pst, what=""):
    """Port DecoderState vs JAX PallasState."""
    want = PSF.state_from_pallas(pst)
    for name in ("store", "v_blocks", "prev_lines"):
        a = getattr(st, name).numpy()
        b = np.asarray(getattr(want, name))
        tol = STATE_RTOL * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("bug_compat", [True, False])
def test_ref_matches_jax_pallas_over_6_granules(bug_compat):
    frames = _frames(3)
    B = len(frames)
    pst = PSF.init_pallas_state(B)
    st = init_state(B)
    for t in range(3):
        for batch in JM.frame_to_batches([frames[b][t] for b in range(B)]):
            pj, pst = PSF.decode_granules_pallas(
                batch, pst, exact=False, bug_compat=bug_compat,
                block_lanes=8)
            pt, st = FS.fused_granule_step(*wire_from_batch(batch), st,
                                           bug_compat=bug_compat)
            assert pt.shape == (B, 576, 2) and pt.dtype == torch.int16
            assert_pcm_contract(pt.numpy(), pj, f"frame {t}")
            assert_state_close(st, pst, f"frame {t}")


def test_inactive_slots_frozen():
    """Mirror of test_pallas_inactive_slots_frozen: idle slots keep their
    state bitwise and emit silence; the others match JAX."""
    frames = _frames(1)
    B = len(frames)
    batch = JM.frame_to_batches([frames[b][0] for b in range(B)])[0]
    act = np.ones(B, np.int32)
    act[2] = 0
    act[5] = 0
    batch = batch._replace(active=jnp.asarray(act))
    rng = np.random.RandomState(0)
    store_t = rng.randn(2, 18, 32, B).astype(np.float32)
    v_t = rng.randn(2, 15, 64, B).astype(np.float32)
    prev = rng.randn(B, 3).astype(np.float32)
    pst0 = PSF.PallasState(store_t=jnp.asarray(store_t),
                           v_t=jnp.asarray(v_t), prev_lines=jnp.asarray(prev))
    pj, pst1 = PSF.decode_granules_pallas(batch, pst0, exact=False,
                                          block_lanes=8)
    st0 = DecoderState(
        store=torch.from_numpy(store_t.transpose(3, 0, 2, 1).copy()),
        v_blocks=torch.from_numpy(v_t.transpose(3, 0, 1, 2).copy()),
        prev_lines=torch.from_numpy(prev.copy()))
    keep = DecoderState(st0.store.clone(), st0.v_blocks.clone(),
                        st0.prev_lines.clone())
    pt, st1 = FS.fused_granule_step(*wire_from_batch(batch), st0)
    pt = pt.numpy()
    for s in (2, 5):
        assert (pt[s] == 0).all()
        for name in ("store", "v_blocks", "prev_lines"):
            assert torch.equal(getattr(st1, name)[s].view(torch.int32),
                               getattr(keep, name)[s].view(torch.int32))
    assert (pt[0] != 0).any()
    assert_pcm_contract(pt, pj)
    assert_state_close(st1, pst1)


def test_band12_zero_bits_prev_lines_bit_pattern():
    """The band-12 carry is read as float BITS (+0.0 gives gain 1, -0.0
    gain 0): on the directed fixture the port's prev_lines must have the
    same bit pattern as JAX's after every granule, and PCM the fast
    contract."""
    fe = Frontend()
    fe.feed(_band12_zero_bits_stream())
    fds = []
    while True:
        res, fd = fe.read_frame()
        if res != 0:
            break
        fds.append(fd)
    assert len(fds) >= 2
    pst = PSF.init_pallas_state(1)
    st = init_state(1)
    seen_zero = False
    for fd in fds:
        for batch in JM.frame_to_batches([fd]):
            pj, pst = PSF.decode_granules_pallas(batch, pst, exact=False,
                                                 block_lanes=8)
            pt, st = FS.fused_granule_step(*wire_from_batch(batch), st)
            want = np.asarray(pst.prev_lines).view(np.uint32)
            got = st.prev_lines.numpy().view(np.uint32)
            np.testing.assert_array_equal(got, want)
            seen_zero |= bool((want == 0).all())
            assert_pcm_contract(pt.numpy(), pj)
    assert seen_zero   # the fixture reached the +0.0 carry


@pytest.mark.parametrize("bad", ["ix_dtype", "meta_shape", "gr1",
                                 "noncontig"])
def test_step_rejects_malformed_operands(bad):
    frames = _frames(1)
    batch = JM.frame_to_batches([frames[b][0] for b in range(2)])[0]
    ix, scf_l, scf_s, meta, act, gr1 = wire_from_batch(batch)
    st = init_state(2)
    if bad == "ix_dtype":
        ix = ix.to(torch.int32)
    elif bad == "meta_shape":
        meta = meta[:, :24]
    elif bad == "gr1":
        gr1 = 2
    else:
        st.store = st.store.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        FS.fused_granule_step(ix, scf_l, scf_s, meta, act, gr1, st)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_cuda():
    """The CUDA kernel vs its plain PyTorch version on the same CUDA
    tensors: bitwise by design (same rounding points, same summation
    order, no FMA contraction), so any difference fails; the fast
    contract and the state tolerance are checked as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = _frames(3)
    B = len(frames)
    act = torch.ones(B, dtype=torch.int32)
    act[3] = 0
    sk, sr = init_state(B, "cuda"), init_state(B, "cuda")
    for t in range(3):
        for batch in JM.frame_to_batches([frames[b][t] for b in range(B)]):
            ops = [x.cuda() if isinstance(x, torch.Tensor) else x
                   for x in wire_from_batch(batch)]
            ops[4] = act.cuda()
            n0 = FS.LAUNCHES
            pk, sk = FS.fused_granule_step(*ops, sk)
            assert FS.LAUNCHES == n0 + 1
            pr, sr = FS.fused_granule_step_ref(*ops, sr)
            assert_pcm_contract(pk.cpu().numpy(), pr.cpu().numpy())
            assert torch.equal(pk, pr)
            for name in ("store", "v_blocks", "prev_lines"):
                a, b = getattr(sk, name), getattr(sr, name)
                tol = STATE_RTOL * max(1.0, float(b.abs().max()))
                assert float((a - b).abs().max()) <= tol, name
                assert torch.equal(a.view(torch.int32),
                                   b.view(torch.int32)), name
            assert not pk[3].any()
