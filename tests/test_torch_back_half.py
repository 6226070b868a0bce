"""The port's back half (pdmp3_tpu_torch/ops/back_half.py back_half_step)
against the JAX back-half kernel back_half_t, run as the JAX package's
own tests run it on the CPU (interpret mode, block_lanes=8), and its
prev3 output against the JAX carry _prev3; the CUDA kernel K4 against
the plain version (``cuda`` marker).

Tolerances: exact mode bitwise (raw FIR sums, store, v, prev3: the same
sequential sums in the same order).  Fast mode: the quantized samples at
most 1 LSB apart on fewer than 1% of them, store/v/prev3 within
STATE_RTOL * max(1, max|jax|) (pairwise-tree vs XLA dot summation order,
as in test_torch_fused_step.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import dsp as JD
from pdmp3_tpu.ops import pallas_step as PSF
from pdmp3_tpu_torch.models.decoder import DecoderState
from pdmp3_tpu_torch.ops import back_half as BH
from test_pallas import _frames
from test_torch_fused_step import STATE_RTOL, assert_pcm_contract

B = 8


def _inputs(exact: bool, seed: int = 4):
    """Post-antialias spectra of one granule of the 8 streams (the JAX
    front half), a random state, the effective block types and an idle
    slot, in the JAX feature-major layout."""
    frames = _frames(1)
    batch = JM.frame_to_batches([fr[0] for fr in frames])[0]
    x = JD.requantize(batch.ix, batch.scf_l, batch.scf_s, batch.layout,
                      batch.global_gain, batch.scalefac_scale,
                      batch.preflag, batch.subblock_gain, exact=exact,
                      pre_reordered=True)
    x = JD.stereo(x, batch.layout, batch.scf_l, batch.scf_s, batch.count1,
                  batch.ms_flag, batch.is_flag, exact=exact)
    x = JD.antialias(x, batch.layout, batch.win_switch, batch.block_type,
                     batch.mixed)
    xa_t = np.asarray(x).reshape(B, 2, 32, 18).transpose(1, 3, 2, 0)
    rng = np.random.default_rng(seed)
    store_t = rng.standard_normal((2, 18, 32, B)).astype(np.float32)
    v_t = rng.standard_normal((2, 15, 64, B)).astype(np.float32)
    sb = np.arange(32)
    ws, bt, mx = (np.asarray(a) for a in (batch.win_switch,
                                          batch.block_type, batch.mixed))
    bt_eff = np.where(((ws == 1) & (mx == 1))[..., None] & (sb < 2), 0,
                      bt[..., None]).astype(np.int32)       # [B,2,32]
    active = np.ones(B, np.int32)
    active[6] = 0
    return (np.ascontiguousarray(xa_t), store_t, v_t,
            np.ascontiguousarray(bt_eff.transpose(1, 2, 0)), active)


def _port(xa_t, store_t, v_t, bt_t, active, exact, device="cpu"):
    def t(a, perm):
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(perm))).to(device)
    st = DecoderState(store=t(store_t, (3, 0, 2, 1)),
                      v_blocks=t(v_t, (3, 0, 1, 2)),
                      prev_lines=torch.zeros(B, 3, device=device))
    args = (t(xa_t, (3, 0, 2, 1)), st, t(bt_t, (2, 0, 1)),
            torch.from_numpy(active).to(device), exact)
    return args


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_back_half_matches_jax_kernel(exact):
    xa_t, store_t, v_t, bt_t, active = _inputs(exact)
    pcm_t, store_n, v_n, _ = PSF.back_half_t(
        jnp.asarray(xa_t), jnp.asarray(store_t), jnp.asarray(v_t),
        jnp.asarray(bt_t), jnp.asarray(active), block_lanes=8, exact=exact)
    prev_j = np.asarray(PSF._prev3(jnp.asarray(xa_t), jnp.asarray(store_t),
                                   jnp.asarray(bt_t), exact)).T
    args = _port(xa_t, store_t, v_t, bt_t, active, exact)
    st = args[1]
    out, prev3 = BH.back_half_step(*args)
    got = {"out": out.numpy(), "store": st.store.numpy(),
           "v_blocks": st.v_blocks.numpy(), "prev3": prev3.numpy()}
    want = {"out": np.asarray(pcm_t).transpose(2, 0, 1),
            "store": np.asarray(store_n).transpose(3, 0, 2, 1),
            "v_blocks": np.asarray(v_n).transpose(3, 0, 1, 2),
            "prev3": prev_j}
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        if exact:
            np.testing.assert_array_equal(got[name].view(np.uint32),
                                          w.view(np.uint32), name)
        elif name == "out":
            assert_pcm_contract(got[name], w, name)
        else:
            tol = STATE_RTOL * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(got[name], w, rtol=0, atol=tol,
                                       err_msg=name)
    # the idle slot: zero output, state as it was
    assert not got["out"][6].any()
    np.testing.assert_array_equal(got["store"][6],
                                  store_t[..., 6].transpose(0, 2, 1))


def test_back_half_rejects_malformed_operands():
    args = list(_port(*_inputs(True), True))
    args[2] = args[2].to(torch.int64)
    with pytest.raises(ValueError):
        BH.back_half_step(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_k4_matches_plain_version_on_cuda(exact):
    """K4 vs its plain version on the same CUDA tensors: bitwise (same
    device code as K1/K2's back half, same summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs = _inputs(exact)
    ak = _port(*inputs, exact, "cuda")
    ar = _port(*inputs, exact, "cuda")
    n0 = BH.LAUNCHES
    ok, pk = BH.back_half_step(*ak)
    assert BH.LAUNCHES == n0 + 1
    orf, pr = BH.back_half_step_ref(*ar)
    for a, b in ((ok, orf), (pk, pr), (ak[1].store, ar[1].store),
                 (ak[1].v_blocks, ar[1].v_blocks)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
