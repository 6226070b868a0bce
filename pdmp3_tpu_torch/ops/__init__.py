"""Device ops of the port: the fused granule step and its constants."""
from .fused_step import fused_granule_step, fused_granule_step_ref

__all__ = ["fused_granule_step", "fused_granule_step_ref"]
