"""Device ops of the port: the stage ops, the granule and frame steps
(``fused_step``, ``back_half``, ``frame_step``), the float64 rounding
points and their constants."""
from .back_half import (back_half_step, back_half_step_ref,
                        float_granule_step, split_granule_step)
from .fused_step import fused_granule_step, fused_granule_step_ref

__all__ = ["back_half_step", "back_half_step_ref", "float_granule_step",
           "fused_granule_step",
           "fused_granule_step_ref", "split_granule_step"]
