"""Serving runtime: the stream pools over the native wire, the batched
offline decode, and serving over several devices (sharded pools) or
processes (multi-process pools)."""
from .multihost import MultiHostStreamDecoder
from .scheduler import (L12StreamDecoder, LoopFeeder, SlotJoin,
                        SparseStreamDecoder, StreamDecoder,
                        decode_files_batched)
from .sharded import ShardedL12StreamDecoder, ShardedStreamDecoder

__all__ = ["L12StreamDecoder", "LoopFeeder", "MultiHostStreamDecoder",
           "ShardedL12StreamDecoder", "ShardedStreamDecoder", "SlotJoin",
           "SparseStreamDecoder", "StreamDecoder", "decode_files_batched"]
