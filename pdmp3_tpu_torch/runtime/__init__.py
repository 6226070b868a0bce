"""Serving runtime: the stream pools over the native wire, and the
batched offline decode."""
from .scheduler import (L12StreamDecoder, LoopFeeder, SlotJoin,
                        SparseStreamDecoder, StreamDecoder,
                        decode_files_batched)

__all__ = ["L12StreamDecoder", "LoopFeeder", "SlotJoin",
           "SparseStreamDecoder", "StreamDecoder", "decode_files_batched"]
