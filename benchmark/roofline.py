"""The card's peak bandwidth, over which a kernel's launch bytes give the
least time its launches could take.  A configuration names the count of
those bytes (``kernel_bytes/<name>.py``); the granule kernels' count,
``granule_launch_bytes``, stays importable here."""
from __future__ import annotations

from .kernel_bytes.granule import (  # noqa: F401
    STATE_BYTES, granule_launch_bytes, granule_wire_bytes)

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12
