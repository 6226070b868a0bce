"""The port's stage ops (pdmp3_tpu_torch/ops/dsp.py) against the same
stages of the JAX package (pdmp3_tpu/ops/dsp.py), stage by stage, in both
precision modes, on the same inputs: the granule batches of
test_pallas._frames, each stage fed the JAX output of the stage before.

Tolerances:
- exact: bitwise (the same rounding points in the same order; the port
  reads |x|^(4/3) from the table the JAX closed form is proven equal to),
  with one rule: at the short-block intensity quirk (pdmp3.c:2212-2213)
  the reference's integer round trip turns -0.0 into +0.0, and so does
  the port, where the JAX XLA stage keeps -0.0 (jnp.mod).  The reference
  decides; test_torch_exact.py holds uq_f64 to it.
- fast: |port - jax| <= STATE_RTOL * max(1, max|jax|) for float stages
  (summation order and the <= 2 ulp pow43 difference, as in
  test_torch_fused_step.py); PCM at most 1 LSB on fewer than 1% of
  samples.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdmp3_tpu import tables as T
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import dsp as JD
from pdmp3_tpu_torch.ops import dsp as TD
from test_pallas import _frames
from test_torch_fused_step import STATE_RTOL, assert_pcm_contract

STAGES = ["requantize", "stereo", "antialias", "hybrid_synthesis",
          "freq_invert", "subband_synthesis", "quantize_pack"]


def _t(a, dtype=None):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, dtype=dtype or a.dtype, order="C"))


def _bits_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.uint32),
                                  np.asarray(want, np.float32)
                                  .view(np.uint32))


def _bits_equal_but_uq_zero(got, want, b):
    """Bitwise, except +0.0 where JAX has -0.0 on a short-block line of
    an intensity slot (the unsigned-assign site)."""
    gb = np.asarray(got).view(np.uint32)
    wb = np.asarray(want, np.float32).view(np.uint32)
    short0 = T.layout_maps(0)["is_short"][np.asarray(b.layout)[:, 0]] == 1
    site = (short0 & (np.asarray(b.is_flag) != 0)[:, None])[:, None, :]
    allowed = site & (wb == 0x80000000) & (gb == 0)
    np.testing.assert_array_equal(np.where(allowed, wb, gb), wb)


def _close(got, want):
    want = np.asarray(want, np.float32)
    tol = STATE_RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def batches():
    """The six granule batches of 3 frames of the 8 streams, plus a
    prev_lines carry whose bit patterns reach normal band-12 gains, zero
    bits, -0.0 and the 1024 clamp."""
    frames = _frames(3)
    out = []
    for t in range(3):
        out += JM.frame_to_batches([fr[t] for fr in frames])
    bits = np.array([[0, 7, 93], [0x80000000, 1, 120], [0x3F000000, 2, 64],
                     [5, 0, 0], [33, 110, 0x80000000], [1, 2, 3],
                     [126, 0, 17], [0x40490FDB, 4, 9]], np.uint32)
    return out, bits.view(np.float32)


def _rq_args(b):
    return (b.ix, b.scf_l, b.scf_s, b.layout, b.global_gain,
            b.scalefac_scale, b.preflag, b.subblock_gain)


def _stage_io(stage, b, prev, exact):
    """(port output, JAX output) of one stage on batch b."""
    rng = np.random.default_rng(5)
    B = b.ix.shape[0]
    gr1 = int(np.asarray(b.gr1)[0])
    x_rq = JD.requantize(*_rq_args(b), exact=exact, gr1=b.gr1,
                         prev_lines=jnp.asarray(prev), pre_reordered=True)
    if stage == "requantize":
        got = TD.requantize(*[_t(a, np.int32) for a in _rq_args(b)], exact,
                            gr1, _t(prev))
        return got, x_rq
    x_st = JD.stereo(x_rq, b.layout, b.scf_l, b.scf_s, b.count1, b.ms_flag,
                     b.is_flag, exact=exact)
    if stage == "stereo":
        got = TD.stereo(_t(x_rq), *[_t(a, np.int32) for a in (
            b.layout, b.scf_l, b.scf_s, b.count1, b.ms_flag, b.is_flag)],
            exact)
        return got, x_st
    x_aa = JD.antialias(x_st, b.layout, b.win_switch, b.block_type, b.mixed)
    ws, bt, mx = (_t(a, np.int32) for a in (b.win_switch, b.block_type,
                                            b.mixed))
    if stage == "antialias":
        return TD.antialias(_t(x_st), ws, bt, mx), \
            np.asarray(x_aa).reshape(B, 2, 32, 18)
    store = rng.standard_normal((B, 2, 32, 18)).astype(np.float32)
    v = rng.standard_normal((B, 2, 15, 64)).astype(np.float32)
    if stage == "hybrid_synthesis":
        xt, st = TD.hybrid_synthesis(
            _t(np.asarray(x_aa).reshape(B, 2, 32, 18)), _t(store),
            TD.effective_block_types(ws, bt, mx), exact)
        jxt, jst = JD.hybrid_synthesis(x_aa, jnp.asarray(store),
                                       b.win_switch, b.block_type, b.mixed,
                                       exact=exact)
        return torch.stack([xt, st]), np.stack([jxt, jst])
    x_time = rng.standard_normal((B, 2, 32, 18)).astype(np.float32)
    if stage == "freq_invert":
        return TD.freq_invert(_t(x_time)), JD.freq_invert(
            jnp.asarray(x_time))
    if stage == "subband_synthesis":
        sums, nv = TD.subband_synthesis(_t(x_time), _t(v), exact)
        jsums, jnv = JD.subband_synthesis(jnp.asarray(x_time),
                                          jnp.asarray(v), exact=exact)
        return (torch.cat([sums.reshape(B, -1), nv.reshape(B, -1)], 1),
                np.concatenate([np.asarray(jsums).reshape(B, -1),
                                np.asarray(jnv).reshape(B, -1)], 1))
    assert stage == "quantize_pack"
    # sums spanning the clip, the int32 edge, NaN and the borrow points
    sums = (rng.standard_normal((B, 2, 18, 32)) * 0.6).astype(np.float32)
    sums[0, 0, 0, :6] = [np.nan, 70000.0, -70000.0, 1.0 / 32767, -0.0,
                         -1e-9]
    got = TD.pack(TD.quantize(_t(sums), exact), _t(b.nch, np.int32),
                  torch.ones(B, dtype=torch.int32))
    return got, JD.quantize_pack(jnp.asarray(sums), b.nch, exact=exact)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax(stage, exact, batches):
    bs, prev = batches
    for k, b in enumerate(bs):
        got, want = _stage_io(stage, b, prev, exact)
        got = got.numpy()
        if stage == "quantize_pack":
            assert got.dtype == np.int16
            if exact:
                np.testing.assert_array_equal(got, np.asarray(want))
            else:
                assert_pcm_contract(got, want, f"batch {k}")
        elif exact and stage == "stereo":
            _bits_equal_but_uq_zero(got, want, b)
        elif exact or stage in ("antialias", "freq_invert"):
            _bits_equal(got, want)
        else:
            _close(got, want)


def test_fields_views_match_meta():
    meta = torch.arange(2 * 32, dtype=torch.int32).reshape(2, 32)
    f = TD.fields(meta)
    assert f.layout.tolist() == [[0, 1], [32, 33]]
    assert f.subblock_gain[1].tolist() == [[48, 49, 50], [51, 52, 53]]
    assert f.nch.tolist() == [24, 56]
    assert f.ms_flag.tolist() == [22, 54]
