"""The port behind the streaming API: ``pdmp3_tpu.api.decode_file`` with
``TorchDSP`` (pdmp3_tpu_torch/models/decoder.py) on the CPU, and
``frame_to_batches`` against the native wire.

Exact mode must give the same bytes as the bit-exact native scalar C++
decoder, the NumPy oracle and the JAX exact DSP on the 6 configurations
of test_jax_decoder.CONFIGS, the band-12 zero-bits fixture and the two
starved 320 kbit/s 32 kHz streams of test_jax_exact_band12_float_bits.
Fast mode must stay within the fast contract (at most 1 LSB on fewer
than 1% of samples).
"""
import copy

import numpy as np
import pytest
import torch

from pdmp3_tpu.api import decode_file
from pdmp3_tpu.frontend import Frontend
from pdmp3_tpu.host import native_decode_file
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu.oracle import OracleDSP
from pdmp3_tpu.testing import mp3gen
from pdmp3_tpu_torch import LoopFeeder, StreamDecoder, TorchDSP
from pdmp3_tpu_torch.models import decoder as TM
from pdmp3_tpu_torch.testing import l3wire
from test_jax_decoder import CONFIGS, _band12_zero_bits_stream
from test_torch_fused_step import assert_pcm_contract

STARVED = {"starved_long": (60188, "long", 2, 0),
           "starved_varied_ms": (60307, "varied", 1, 2)}
STREAMS = sorted(CONFIGS) + ["band12_zero_bits"] + sorted(STARVED)


def _stream(name: str) -> bytes:
    if name in CONFIGS:
        return mp3gen.make_stream(n_frames=8, seed=2, **CONFIGS[name])
    if name == "band12_zero_bits":
        return _band12_zero_bits_stream()
    seed, blocks, mode, ext = STARVED[name]
    return mp3gen.make_stream(n_frames=8, seed=seed, sfreq=2,
                              bitrate_index=14, mode=mode,
                              mode_extension=ext, blocks=blocks,
                              use_reservoir=True, amp=20)


@pytest.mark.parametrize("name", STREAMS)
def test_torchdsp_exact_byte_equal_to_native_oracle_and_jax(name):
    data = _stream(name)
    got = decode_file(data, dsp=TorchDSP(exact=True, device="cpu"))
    want = native_decode_file(data)
    assert len(want) > 0
    assert got == want
    assert got == decode_file(data, dsp=OracleDSP())
    assert got == decode_file(data, dsp=JM.JaxDSP(exact=True))


@pytest.mark.parametrize("name", STREAMS)
def test_torchdsp_fast_within_contract(name):
    data = _stream(name)
    got = np.frombuffer(decode_file(data, dsp=TorchDSP(exact=False,
                                                       device="cpu")),
                        "<i2")
    want = np.frombuffer(native_decode_file(data), "<i2")
    assert got.shape == want.shape
    assert_pcm_contract(got, want, name)


def _frames_of(data: bytes) -> list:
    fe = Frontend()
    fe.feed(data)
    fds = []
    while True:
        res, fd = fe.read_frame()
        if res != 0:
            return fds
        fds.append(fd)


def test_frame_to_batches_equals_native_wire():
    """Frame by frame, the batches built from the Python frontend's
    FrameData equal the native parser's int16 wire: ix (line-ordered)
    and all 32 meta words everywhere, scalefactors on the coded channels
    (for a mono stream the native parser leaves its own values in ch1's
    out-of-band slots, which nothing reads for the output), for a batch
    mixing long, short, mixed, MS, intensity, mono, 32 and 48 kHz
    streams."""
    names = ["long", "varied_ms", "ms_intensity", "mono_48k", "mixed_32k",
             "reservoir_stuffing"]
    streams = [_stream(n) for n in names]
    per_stream = [_frames_of(s) for s in streams]
    B = len(streams)
    dec = StreamDecoder(B, device="cpu")      # only its native parse
    feeder = LoopFeeder(dec, streams)
    for t in range(4):
        feeder.step()
        assert dec.parse_step() == B
        w = TM.wire_sections(l3wire.pool_dense_wire(dec), B)
        batches = TM.frame_to_batches([fds[t] for fds in per_stream], "cpu")
        for gr, b in enumerate(batches):
            assert b.gr1 == gr and b.active.tolist() == [1] * B
            assert torch.equal(b.ix, w["ix"][gr])
            nch = b.meta[:, TM.D.M_NCH]
            for name in ("scf_l", "scf_s"):
                for s in range(B):
                    assert torch.equal(getattr(b, name)[s, :nch[s]],
                                       w[name][gr][s, :nch[s]]), name
            np.testing.assert_array_equal(
                b.meta.numpy(), w["meta"][gr].numpy().astype(np.int32),
                err_msg=f"frame {t} granule {gr}")


def test_frame_to_batches_rejects_other_families():
    """LSF frames are ported (tests/test_torch_lsf.py), but one batch
    holds one family: a batch mixing MPEG-1 and LSF frames raises
    ValueError; Layer I/II frames carry no granules and raise ValueError
    there, while TorchDSP decodes them through models.l12
    (tests/test_torch_l12.py): silent subband samples, silent PCM."""
    fd = _frames_of(_stream("long"))[0]
    lsf = copy.deepcopy(fd)
    lsf.header.family = 1
    with pytest.raises(ValueError):
        TM.frame_to_batches([fd, lsf], "cpu")
    l12 = copy.deepcopy(fd)
    l12.sb_samples = np.zeros((2, 12, 32), np.float32)
    with pytest.raises(ValueError):
        TM.frame_to_batches([l12], "cpu")
    out = TorchDSP(device="cpu").decode_frame(l12)
    assert out.shape == (2, 576) and out.dtype == np.uint32
    assert not out.any()
