"""Serving runtime: stream scheduler over the native wire."""
from .scheduler import LoopFeeder, SparseStreamDecoder, StreamDecoder

__all__ = ["LoopFeeder", "SparseStreamDecoder", "StreamDecoder"]
