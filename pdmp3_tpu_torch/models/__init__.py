"""The batched granule decoder over the packed wire."""
from .decoder import (DecoderState, GranuleBatch, decode_frame_packed,
                      decode_frame_soa, init_state, soa_layout,
                      state_from_jax, state_from_pallas, wire_sections)

__all__ = ["DecoderState", "GranuleBatch", "decode_frame_packed",
           "decode_frame_soa", "init_state", "soa_layout",
           "state_from_jax", "state_from_pallas", "wire_sections"]
