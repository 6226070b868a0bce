"""The port's streaming polyphase resampler (pdmp3_tpu_torch/ops/
resample.py) on the CPU against the JAX package's
(pdmp3_tpu/ops/resample.py) on the same seeded blocks, and the serving
option StreamDecoder(resample_to=, sample_rate=).

Tolerances: the filter bank bitwise.  Float output within 0.02 (in
int16 units, inputs at int16 scale): both sum 24 products in f32, in
other orders.  int16 output at most 1 LSB apart (a sum that lands near
a half rounds either way).  Output lengths and the running phase equal
every step.  Streaming against one-shot, and the serving option against
the port's resampler over the native decoder's PCM: bitwise.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdmp3_tpu.ops import resample as JR
from pdmp3_tpu.host import native_decode_file
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch import StreamDecoder
from pdmp3_tpu_torch.ops.resample import StreamResampler, polyphase_filter

RATES = [(44100, 48000), (48000, 44100), (32000, 48000), (22050, 48000),
         (8000, 48000)]
FLOAT_TOL = 0.02


@pytest.mark.parametrize("from_rate,to_rate", RATES)
def test_polyphase_filter_equals_jax(from_rate, to_rate):
    g = math.gcd(from_rate, to_rate)
    up, down = to_rate // g, from_rate // g
    np.testing.assert_array_equal(polyphase_filter(up, down),
                                  JR.polyphase_filter(up, down))


def _blocks(seed: int, B: int = 2, C: int = 2, n: int = 5,
            sizes=(1152, 576, 1152, 384, 1152)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, sizes[i % len(sizes)], C)) * 9000)
            .astype(np.float32) for i in range(n)]


@pytest.mark.parametrize("from_rate,to_rate", RATES)
def test_stream_resampler_matches_jax(from_rate, to_rate):
    """Float and int16 outputs against JAX's on the same blocks (block
    sizes of Layer III, LSF and Layer I frames), the same n_out and
    phase after every step."""
    blocks = _blocks(from_rate % 97)
    tf = StreamResampler(from_rate, to_rate, 2, 2, dtype=torch.float32,
                         device="cpu")
    jf = JR.StreamResampler(from_rate, to_rate, 2, 2, dtype=jnp.float32)
    ti = StreamResampler(from_rate, to_rate, 2, 2, device="cpu")
    ji = JR.StreamResampler(from_rate, to_rate, 2, 2)
    for x in blocks:
        yt = tf(torch.from_numpy(x)).numpy()
        yj = np.asarray(jf(jnp.asarray(x)))
        assert yt.shape == yj.shape and tf.phase == jf.phase
        assert float(np.abs(yt - yj).max()) <= FLOAT_TOL
        x16 = np.clip(x, -32768, 32767).astype(np.int16)
        it = ti(torch.from_numpy(x16)).numpy()
        ij = np.asarray(ji(jnp.asarray(x16)))
        assert it.dtype == np.int16 and it.shape == ij.shape
        assert np.abs(it.astype(np.int32) - ij.astype(np.int32)).max() <= 1
        assert ti.phase == ji.phase


def test_streaming_equals_one_shot():
    """Blocks resampled one after the other equal the whole signal
    resampled at once, bit for bit (the carry holds the exact prior
    samples and every output sums its taps in one order)."""
    x = np.concatenate(_blocks(1, n=6, sizes=(1152,)), 1)
    one = StreamResampler(44100, 48000, 2, 2, dtype=torch.float32,
                          device="cpu")(torch.from_numpy(x)).numpy()
    rs = StreamResampler(44100, 48000, 2, 2, dtype=torch.float32,
                         device="cpu")
    multi = np.concatenate([rs(torch.from_numpy(x[:, i:i + 1152])).numpy()
                            for i in range(0, x.shape[1], 1152)], 1)
    assert one.shape == multi.shape
    np.testing.assert_array_equal(one, multi)


def test_state_restored_from_a_jax_resampler():
    """A port resampler given a JAX resampler's carry and phase continues
    it: the same n_out and phase, float output within FLOAT_TOL; a carry
    of another shape raises."""
    blocks = _blocks(2, n=4)
    jr = JR.StreamResampler(44100, 48000, 2, 2, dtype=jnp.float32)
    for x in blocks[:2]:
        jr(jnp.asarray(x))
    tr = StreamResampler(44100, 48000, 2, 2, dtype=torch.float32,
                         device="cpu", carry=np.asarray(jr.carry),
                         phase=jr.phase)
    with pytest.raises(ValueError):
        StreamResampler(44100, 48000, 3, 2, device="cpu",
                        carry=np.asarray(jr.carry))
    for x in blocks[2:]:
        yt = tr(torch.from_numpy(x)).numpy()
        yj = np.asarray(jr(jnp.asarray(x)))
        assert yt.shape == yj.shape and tr.phase == jr.phase
        assert float(np.abs(yt - yj).max()) <= FLOAT_TOL


def test_serving_resample_option():
    """StreamDecoder(resample_to=48000, sample_rate=44100) on the CPU:
    per-step n_out as the phase gives it, and each slot's PCM equal to
    the port's resampler over the native decoder's PCM; resample_to
    without sample_rate, or with float_pcm, raises."""
    streams = [mp3gen.make_stream(n_frames=5, seed=50 + s, mode=0)
               for s in range(2)]
    dec = StreamDecoder(2, exact=True, resample_to=48000,
                        sample_rate=44100, device="cpu")
    for s, d in enumerate(streams):
        dec.feed(s, d)
    per = [[] for _ in streams]
    phase = 0
    while dec.parse_step() > 0:
        pcm = dec.decode_step()
        want_n = (1152 * 160 - phase + 146) // 147
        phase += want_n * 147 - 1152 * 160
        assert pcm.shape == (2, want_n, 2) and pcm.dtype == np.int16
        for s in range(2):
            if dec.active[s]:
                per[s].append(pcm[s])
    assert len(per[0]) >= 3
    for s, d in enumerate(streams):
        raw = np.frombuffer(native_decode_file(d), np.int16).reshape(1, -1, 2)
        want = StreamResampler(44100, 48000, 1, 2, device="cpu")(
            torch.from_numpy(raw.copy())).numpy()[0]
        got = np.concatenate(per[s])
        n = min(len(got), len(want))
        assert n >= len(want) - 1254
        np.testing.assert_array_equal(got[:n], want[:n])
    with pytest.raises(ValueError):
        StreamDecoder(2, resample_to=48000, device="cpu")
    with pytest.raises(ValueError):
        StreamDecoder(2, resample_to=48000, sample_rate=44100,
                      float_pcm=True, device="cpu")
