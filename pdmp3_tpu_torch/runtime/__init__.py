"""Serving runtime: stream scheduler over the native wire."""
from .scheduler import LoopFeeder, StreamDecoder

__all__ = ["LoopFeeder", "StreamDecoder"]
