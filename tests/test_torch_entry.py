"""The port's entry points (pdmp3_tpu_torch/entry.py), after
tests/test_sharding.py's test of the JAX package's ``__graft_entry__``:
the flagship step on the CPU against its plain version and the JAX
package's exact decode of the same batch, and the multi-device dry run
over 4 CPU shards.

Tolerance: the entry step is the fast step, so against JAX exact the
fast contract (1 LSB on fewer than 1% of samples); against the port's
plain fast step bitwise (PCM and state).
"""
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from pdmp3_tpu.models import decoder as JM
from pdmp3_tpu_torch.entry import dryrun_multichip, entry
from pdmp3_tpu_torch.ops.fused_step import fused_granule_step_ref
from test_torch_fused_step import assert_pcm_contract

STATE = ("store", "v_blocks", "prev_lines")


def test_entry_step_on_cpu():
    """entry("cpu") gives the 8-slot batch of the JAX entry (the same
    generated stream's first granule, tiled) and the fast step: bitwise
    its plain version on copies of the same inputs, within the fast
    contract of the JAX package's exact decode of its own batch."""
    step, (batch, state) = entry("cpu")
    assert batch.ix.shape == (8, 2, 576) and batch.ix.device.type == "cpu"
    ref_state = type(state)(*(getattr(state, k).clone() for k in STATE))
    pcm, state = step(batch, state)
    want, ref_state = fused_granule_step_ref(
        batch.ix, batch.scf_l, batch.scf_s, batch.meta, batch.active,
        batch.gr1, ref_state, exact=False)
    assert pcm.shape == (8, 576, 2) and pcm.dtype == torch.int16
    assert torch.equal(pcm, want) and pcm.any()
    for k in STATE:
        assert torch.equal(getattr(state, k).view(torch.int32),
                           getattr(ref_state, k).view(torch.int32)), k
    jbatch, jstate = jax_entry._example_batch(8)
    np.testing.assert_array_equal(batch.ix.numpy(), np.asarray(jbatch.ix))
    jpcm, _ = JM.decode_granules(jbatch, jstate, exact=True)
    assert_pcm_contract(pcm.numpy(), np.asarray(jpcm))


def test_dryrun_multichip_on_cpu_shards():
    """dryrun_multichip(4, "cpu"): the MPEG-1, MPEG-2 and Layer II steps
    over 4 CPU shards equal their unsharded steps (it raises
    otherwise)."""
    dryrun_multichip(4, "cpu")


def test_entry_points_fail_without_the_device():
    """Asked for a CUDA device where none is visible, both raise: no
    fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
