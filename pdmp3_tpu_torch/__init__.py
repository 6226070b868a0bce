"""pdmp3_tpu_torch: the PyTorch / CUDA port of pdmp3_tpu.

The package stands alone: its own copies of the JAX package's JAX-free
layers (the native host frontend ``host``, ``frontend``, ``oracle``,
``api``, ``tables`` and ``testing.mp3gen``) parse streams into the
packed int16 wire, and this package decodes the wire to PCM with
PyTorch, in fast or exact (bit-exact) precision, for MPEG-1 and the LSF
families MPEG-2 and MPEG-2.5, on an NVIDIA GPU with the hand-written
kernels of ``csrc/``.  ``TorchDSP`` plugs the same decoder into the
port's streaming API (``pdmp3_tpu_torch.api.decode_file``).  It imports
neither JAX nor the JAX package.
"""
from .models.decoder import TorchDSP, decode_granules, init_state
from .ops.frame_step import frame_step
from .ops.fused_step import fused_granule_step
from .runtime.scheduler import LoopFeeder, SparseStreamDecoder, StreamDecoder

__all__ = ["LoopFeeder", "SparseStreamDecoder", "StreamDecoder", "TorchDSP",
           "decode_granules", "frame_step", "fused_granule_step",
           "init_state"]
