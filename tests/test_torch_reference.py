"""The port against the reference C decoder itself, on the streams of
tests/test_jax_decoder.py (CONFIGS: 8 frames, seed 2): the per-stream
route ``decode_file(stream, dsp=TorchDSP(...))`` on the CPU.

- exact: byte-equal to the port's ``testing.golden.reference_decode``;
- fast: the fast contract, at most 1 LSB on fewer than 1% of samples
  (tests/test_jax_decoder.py:41-43).

The reference binary is built from its C sources on first use
(``golden.ensure_reference_binary``); where they are absent each test
skips.
"""
import subprocess

import numpy as np
import pytest

from pdmp3_tpu_torch import TorchDSP
from pdmp3_tpu_torch.api import decode_file
from pdmp3_tpu_torch.testing import golden, mp3gen
from test_jax_decoder import CONFIGS


def _reference(stream: bytes) -> bytes:
    try:
        golden.ensure_reference_binary()
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the reference decoder cannot be built here ({e})")
    return golden.reference_decode(stream)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_against_reference_binary(name, exact):
    stream = mp3gen.make_stream(n_frames=8, seed=2, **CONFIGS[name])
    ref = _reference(stream)
    mine = decode_file(stream, dsp=TorchDSP(exact=exact, device="cpu"))
    if exact:
        assert mine == ref
        return
    a = np.frombuffer(mine, "<i2").astype(np.int32)
    b = np.frombuffer(ref, "<i2").astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= 1
    assert (d != 0).mean() < 0.01
