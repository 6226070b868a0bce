"""The port's back half (pdmp3_tpu_torch/ops/back_half.py back_half_step)
against the JAX back-half kernel back_half_t, run as the JAX package's
own tests run it on the CPU (interpret mode, block_lanes=8), and its
prev3 output against the JAX carry _prev3, also with no slot, the first,
the last or every slot idle, and at a ragged B = 5 that back_half_t pads
(block_lanes=4: one padded block of 3 idle lanes); the CUDA kernel K4
against the plain version (``cuda`` marker): bitwise in both modes at
the ragged batch sizes and idle seams of its persistent grid, on
subnormal spectra and state, and refusing operands its bulk copies
cannot take.

Tolerances: exact mode bitwise (raw FIR sums, store, v, prev3: the same
sequential sums in the same order).  Fast mode: the quantized samples at
most 1 LSB apart on fewer than 1% of them, store/v/prev3 within
STATE_RTOL * max(1, max|jax|) (pairwise-tree vs XLA dot summation order,
as in test_torch_fused_step.py).  K4 against its plain version: bitwise.
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
from pdmp3_tpu_torch.ops import launch as LA
from test_pallas import _frames
from test_torch_fused_step import (IDLE_SEAMS, RAGGED_B, STATE_RTOL,
                                   assert_pcm_contract, idle_slots,
                                   ragged_batch)

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
                      prev_lines=torch.zeros(len(active), 3, device=device))
    args = (t(xa_t, (3, 0, 2, 1)), st, t(bt_t, (2, 0, 1)),
            torch.from_numpy(active).to(device), exact)
    return args


def _check_against_jax(exact, inputs, block_lanes=8):
    """back_half_step on the CPU against back_half_t (interpret mode) and
    _prev3 on the same feature-major inputs: out, store, v_blocks and
    prev3 (every slot's, idle ones included) within the module's
    tolerances; idle slots' output zero and their state as it was."""
    xa_t, store_t, v_t, bt_t, active = inputs
    pcm_t, store_n, v_n, _ = PSF.back_half_t(
        jnp.asarray(xa_t), jnp.asarray(store_t), jnp.asarray(v_t),
        jnp.asarray(bt_t), jnp.asarray(active), block_lanes=block_lanes,
        exact=exact)
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
    for s in np.flatnonzero(active == 0):
        assert not got["out"][s].any()
        np.testing.assert_array_equal(got["store"][s],
                                      store_t[..., s].transpose(0, 2, 1))
        np.testing.assert_array_equal(got["v_blocks"][s], v_t[..., s])


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_back_half_matches_jax_kernel(exact):
    # slot 6 idle
    _check_against_jax(exact, _inputs(exact))


# slots made idle per pattern, and the batch size
IDLE_PATTERNS = {"none": (8, []), "first": (8, [0]), "last": (8, [7]),
                 "all": (8, list(range(8))), "ragged5": (5, [4]),
                 "ragged5_none": (5, [])}


@pytest.mark.parametrize("pattern", list(IDLE_PATTERNS))
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_back_half_matches_jax_kernel_idle_patterns(exact, pattern):
    """No slot, the first, the last or every slot idle at B = 8; B = 5,
    which back_half_t pads to 8 at block_lanes=4, with and without an
    idle slot.  Idle slots still give prev3 (the JAX carry _prev3 is
    computed for every slot)."""
    n, idle = IDLE_PATTERNS[pattern]
    xa_t, store_t, v_t, bt_t, _ = _inputs(exact)
    active = np.ones(n, np.int32)
    active[idle] = 0
    inputs = tuple(np.ascontiguousarray(a[..., :n])
                   for a in (xa_t, store_t, v_t, bt_t)) + (active,)
    _check_against_jax(exact, inputs, block_lanes=8 if n == 8 else 4)


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
    n0 = LA.LAUNCHES["back_half"]
    ok, pk = BH.back_half_step(*ak)
    assert LA.LAUNCHES["back_half"] == n0 + 1
    orf, pr = BH.back_half_step_ref(*ar)
    for a, b in ((ok, orf), (pk, pr), (ak[1].store, ar[1].store),
                 (ak[1].v_blocks, ar[1].v_blocks)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tiled(n, dev, seed=5):
    """K4's operands for n slots: the 8 streams' post-antialias spectra
    and block types tiled over the slots, a random state from numpy
    (seeded), every slot active: (xa, DecoderState, bt_eff, active)."""
    xa_t, _, _, bt_t, _ = _inputs(True)
    idx = np.arange(n) % B
    rng = np.random.default_rng(seed)
    xa = np.ascontiguousarray(xa_t.transpose(3, 0, 2, 1)[idx])
    bt = np.ascontiguousarray(bt_t.transpose(2, 0, 1)[idx])
    st = DecoderState(*(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
        for shape in ((n, 2, 32, 18), (n, 2, 15, 64), (n, 3))))
    return (torch.from_numpy(xa).to(dev), st, torch.from_numpy(bt).to(dev),
            torch.ones(n, dtype=torch.int32, device=dev))


def _clone(st):
    return DecoderState(st.store.clone(), st.v_blocks.clone(),
                        st.prev_lines.clone())


def _assert_k4_equals_plain(xa, st0, bt, active, exact, what):
    """K4 and its plain version from copies of st0: out, prev3, store and
    v_blocks bitwise; idle slots' output zero and state frozen."""
    sk, sr = _clone(st0), _clone(st0)
    n0 = LA.LAUNCHES["back_half"]
    ok, pk = BH.back_half_step(xa, sk, bt, active, exact)
    assert LA.LAUNCHES["back_half"] == n0 + 1, what
    orf, pr = BH.back_half_step_ref(xa, sr, bt, active, exact)
    torch.cuda.synchronize()
    for name, a, b in (("out", ok, orf), ("prev3", pk, pr),
                       ("store", sk.store, sr.store),
                       ("v_blocks", sk.v_blocks, sr.v_blocks)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            (what, name)
    idle = (active == 0).nonzero().flatten()
    assert not ok[idle].any(), what
    for name in ("store", "v_blocks"):
        assert torch.equal(getattr(sk, name)[idle].view(torch.int32),
                           getattr(st0, name)[idle].view(torch.int32)), \
            (what, name)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", IDLE_SEAMS + ("all",))
@pytest.mark.parametrize("n", RAGGED_B)
def test_k4_ragged_batches_and_idle_seams_on_cuda(n, pattern):
    """K4, both modes, at B = 1, 2, grid - 1, grid + 1 and 2 grid + 3
    (grid: K4's persistent grid from the library) with idle slots at the
    seams of its slot ring, and with every slot idle: bitwise equal to
    the plain version, prev3 of idle slots included."""
    dev = _cuda()
    for exact in (True, False):
        grid = LA.granule_launch_info(dev, exact, back_half=True)["grid"]
        Bn = ragged_batch(n, grid)
        xa, st0, bt, active = _tiled(Bn, dev)
        idle = (list(range(Bn)) if pattern == "all"
                else idle_slots(pattern, Bn, grid))
        active[idle] = 0
        _assert_k4_equals_plain(xa, st0, bt, active, exact,
                                (exact, n, pattern))


@pytest.mark.cuda
def test_k4_subnormal_spectra_and_state_on_cuda():
    """xa, store and v_blocks holding subnormal values (every third
    element; the rest the tiled spectra and a random state scaled down
    to 1e-36), slot 3 idle: bitwise equal to the plain version in both
    modes (the card keeps subnormals: no flush to zero)."""
    dev = _cuda()
    n = 2 * LA.granule_launch_info(dev, back_half=True)["grid"] + 3
    xa, st0, bt, active = _tiled(n, dev, seed=6)
    active[3] = 0
    for t in (xa, st0.store, st0.v_blocks):
        flat = t.view(-1)
        flat.mul_(1e-36)
        bits = (torch.arange(flat.numel(), device=dev) * 2654435761
                % (1 << 23) + 1).to(torch.int32)
        flat[::3] = bits[::3].view(torch.float32)
    assert (xa.view(-1)[::3].abs() < 1.1754944e-38).all()
    for exact in (True, False):
        _assert_k4_equals_plain(xa, st0, bt, active, exact,
                                ("subnormal", exact))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["xa", "bt_eff", "store", "v_blocks"])
def test_k4_rejects_operands_off_16_byte_alignment_on_cuda(name):
    """A contiguous operand 4 bytes past a 16-byte boundary: K4's bulk
    copies cannot take it, and the wrapper raises before launching."""
    dev = _cuda()
    xa, st, bt, active = _tiled(3, dev)
    ops = {"xa": xa, "bt_eff": bt, "store": st.store,
           "v_blocks": st.v_blocks}
    t = ops[name]
    buf = torch.zeros(t.numel() + 4, dtype=t.dtype, device=dev)
    moved = buf[1:1 + t.numel()].view(t.shape)
    moved.copy_(t)
    assert moved.data_ptr() % 16 == 4
    ops[name] = moved
    st = DecoderState(ops["store"], ops["v_blocks"], st.prev_lines)
    n0 = LA.LAUNCHES["back_half"]
    with pytest.raises(ValueError, match=name):
        BH.back_half_step(ops["xa"], st, ops["bt_eff"], active, True)
    assert LA.LAUNCHES["back_half"] == n0
