"""Utilities of the port: run-time configuration, tracing and stage
timers, per-stage debug dumps and the WAV writer.  ``config.py``,
``dumps.py`` and ``wav.py`` are copies of the JAX package's;
``trace.py`` traces with ``torch.profiler``."""
from .config import DecodeConfig
from .trace import StageTimer, Trace
from .wav import wav_bytes, write_wav

__all__ = ["DecodeConfig", "StageTimer", "Trace", "wav_bytes", "write_wav"]
