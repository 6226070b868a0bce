"""Utilities of the port: the WAV writer (a copy of the JAX package's
``utils/wav.py``)."""
