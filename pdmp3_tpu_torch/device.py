"""Numeric guards and device selection for the PyTorch port.

The fast decode contract (PCM within 1 LSB of the reference on fewer
than 1% of samples) does not survive reduced-precision products: TF32
keeps about three decimal digits, and the JAX package measured the same
failure with bf16 matrix passes on its own backend.  Subnormals must
survive too: the band-12 scalefactor carry reads the float BITS of
three output lines, so a flushed denormal changes the next granule's
gain.  The guards are set once, when this module is imported; every
module of the port imports it.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
torch.set_flush_denormal(False)


def require_cuda() -> torch.device:
    """The CUDA device the port's kernels run on; raises when none is
    visible (a measurement path never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to PyTorch "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}); the hand-written kernels need one")
    return torch.device("cuda", torch.cuda.current_device())
