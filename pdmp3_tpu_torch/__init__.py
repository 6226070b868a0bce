"""pdmp3_tpu_torch: the PyTorch / CUDA port of pdmp3_tpu.

The package stands alone: its own copies of the JAX package's JAX-free
layers (the native host frontend ``host``, ``frontend``, ``oracle``,
``api``, ``tables``, ``metadata``, ``utils.wav`` and
``testing.mp3gen``) parse streams into the packed wire, and this
package decodes the wire to PCM with PyTorch, in fast or exact
(bit-exact) precision, for MPEG-1 and the LSF families MPEG-2 and
MPEG-2.5 (and Layer I/II), on an NVIDIA GPU with the hand-written
kernels of ``csrc/``.  ``TorchDSP`` plugs the same decoder into the
port's streaming API (``pdmp3_tpu_torch.api.decode_file``);
``runtime`` serves stream pools and decodes file batches;
``models.offline`` decodes a corpus with one upload;
``runtime.sharded`` and ``runtime.multihost`` serve pools over several
devices (``parallel.make_mesh``) or processes (``torch.distributed``);
``entry`` holds the flagship step and a multi-device dry run; ``cli`` is
the command line.  It imports neither JAX nor the JAX package.
"""
from . import tables
from .api import PDMP3, decode_file
from .frontend import Frontend
from .metadata import (FrameIndex, StreamInfo, TagInfo, build_frame_index,
                       decode_file_gapless, decode_file_seek,
                       parse_stream_info, parse_tags)
from .models.decoder import TorchDSP, decode_granules, init_state
from .oracle import OracleDSP
from .ops.frame_step import frame_step
from .ops.fused_step import fused_granule_step
from .parallel import decode_granules_sharded, make_mesh
from .runtime import (L12StreamDecoder, LoopFeeder, MultiHostStreamDecoder,
                      ShardedL12StreamDecoder, ShardedStreamDecoder,
                      SlotJoin, SparseStreamDecoder, StreamDecoder,
                      decode_files_batched)
from .utils import DecodeConfig

__version__ = "0.1.0"

__all__ = ["tables", "PDMP3", "decode_file", "Frontend", "OracleDSP",
           "StreamInfo", "FrameIndex", "TagInfo", "parse_stream_info",
           "parse_tags", "build_frame_index", "decode_file_seek",
           "decode_file_gapless", "DecodeConfig", "L12StreamDecoder",
           "LoopFeeder", "MultiHostStreamDecoder", "ShardedL12StreamDecoder",
           "ShardedStreamDecoder", "SlotJoin", "SparseStreamDecoder",
           "StreamDecoder", "TorchDSP", "decode_files_batched",
           "decode_granules", "decode_granules_sharded", "frame_step",
           "fused_granule_step", "init_state", "make_mesh", "__version__"]
