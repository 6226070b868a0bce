"""pdmp3_tpu_torch: the PyTorch / CUDA port of pdmp3_tpu's device half.

The native host frontend (``pdmp3_tpu.host``) parses streams into the
packed int16 wire; this package decodes the wire to PCM with PyTorch,
in fast or exact (bit-exact) precision, and on an NVIDIA GPU with the
hand-written kernels of ``csrc/``.  ``TorchDSP`` plugs the same decoder
into the streaming API (``pdmp3_tpu.api.decode_file``).  It imports no
JAX.
"""
from .models.decoder import TorchDSP, decode_granules, init_state
from .ops.fused_step import fused_granule_step
from .runtime.scheduler import LoopFeeder, StreamDecoder

__all__ = ["LoopFeeder", "StreamDecoder", "TorchDSP", "decode_granules",
           "fused_granule_step", "init_state"]
