"""The port's model layer (pdmp3_tpu_torch/models/decoder.py) against the
JAX package's: decode_frame_packed on a natively parsed wire (the
pool's coded wire for the port, the same wire made dense for JAX), and the
state converters that carry JAX state across.

Tolerances as in test_torch_fused_step.py: PCM within the fast contract
(at most 1 LSB on fewer than 1% of samples); state within 1e-5 of the
largest magnitude (f32 summation order and the <= 2 ulp pow43 table
difference).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.ops import pallas_step as PSF
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch import LoopFeeder, StreamDecoder
from pdmp3_tpu_torch.models import decoder as TM
from pdmp3_tpu_torch.testing import l3wire
from test_torch_fused_step import assert_pcm_contract, assert_state_close


def _streams():
    specs = [dict(blocks="long", seed=30),
             dict(blocks="short", seed=31, mode=1, mode_extension=2),
             dict(blocks="varied", seed=32, sfreq=1, use_reservoir=True),
             dict(blocks="mixed", seed=33, sfreq=2, mode=3),
             dict(blocks="varied", seed=34, mode=1, mode_extension=3,
                  intensity_pos=True),
             dict(blocks="long", seed=35, sfreq=2, bitrate_index=14)]
    return [mp3gen.make_stream(n_frames=5, **sp) for sp in specs]


def test_decode_frame_packed_matches_jax_pallas():
    """The port on the pool's coded wire, JAX on the same wire made dense
    (``testing.l3wire``)."""
    streams = _streams()
    B = len(streams)
    dec = StreamDecoder(B, device="cpu")   # only its native parse is used
    feeder = LoopFeeder(dec, streams)
    st = TM.init_state(B, "cpu")
    pst = PSF.init_pallas_state(B)
    for _ in range(4):
        feeder.step()
        assert dec.parse_step() == B
        wire = torch.from_numpy(dec.wire.copy())
        pt, st = TM.decode_frame_packed(wire, st, B=B)
        pj, pst = JM.decode_frame_packed(
            jnp.asarray(l3wire.dense_wire(wire, B).numpy()), pst, B=B, F=1,
            exact=False, kernel="pallas")
        assert pt.shape == (B, 1152, 2)
        assert_pcm_contract(pt.numpy(), pj)
        assert_state_close(st, pst)


def test_decode_frame_packed_rejects_wrong_wire():
    st = TM.init_state(2, "cpu")
    total = TM.soa_layout(2)["total"]
    with pytest.raises(ValueError):
        TM.decode_frame_packed(torch.zeros(total - 2, dtype=torch.int16),
                               st, B=2)
    with pytest.raises(ValueError):
        TM.decode_frame_packed(torch.zeros(total, dtype=torch.int32), st,
                               B=2)


def test_state_from_pallas_and_from_jax_round_trip():
    rng = np.random.default_rng(3)
    B = 5
    store = rng.standard_normal((B, 2, 32, 18)).astype(np.float32)
    v = rng.standard_normal((B, 2, 15, 64)).astype(np.float32)
    prev = rng.standard_normal((B, 3)).astype(np.float32)
    canon = TM.state_from_jax(store, v, prev, "cpu")
    pst = PSF.state_to_pallas(JM.DecoderState(
        store=jnp.asarray(store), v_blocks=jnp.asarray(v),
        prev_lines=jnp.asarray(prev)))
    from_p = TM.state_from_pallas(np.asarray(pst.store_t),
                                  np.asarray(pst.v_t),
                                  np.asarray(pst.prev_lines), "cpu")
    for s in (canon, from_p):
        np.testing.assert_array_equal(s.store.numpy(), store)
        np.testing.assert_array_equal(s.v_blocks.numpy(), v)
        np.testing.assert_array_equal(s.prev_lines.numpy(), prev)
        assert all(t.is_contiguous() and t.dtype == torch.float32
                   for t in (s.store, s.v_blocks, s.prev_lines))
    # and back through the JAX converter
    back = PSF.state_from_pallas(pst)
    np.testing.assert_array_equal(np.asarray(back.store),
                                  from_p.store.numpy())
    np.testing.assert_array_equal(np.asarray(back.v_blocks),
                                  from_p.v_blocks.numpy())


def test_init_state_shapes():
    s = TM.init_state(3, "cpu")
    assert s.store.shape == (3, 2, 32, 18)
    assert s.v_blocks.shape == (3, 2, 15, 64)
    assert s.prev_lines.shape == (3, 3)
    assert not any(t.any() for t in (s.store, s.v_blocks, s.prev_lines))
