"""The batched granule decoder: the packed wires and the per-stream DSP."""
from .decoder import (DecoderState, GranuleBatch, TorchDSP,
                      decode_frame_packed, decode_frame_soa,
                      decode_frame_sparse, decode_granules, frame_to_batches,
                      init_state, soa_layout, sparse_layout, state_from_jax,
                      state_from_pallas, wire_sections)

__all__ = ["DecoderState", "GranuleBatch", "TorchDSP",
           "decode_frame_packed", "decode_frame_soa", "decode_frame_sparse",
           "decode_granules", "frame_to_batches", "init_state", "soa_layout",
           "sparse_layout", "state_from_jax", "state_from_pallas",
           "wire_sections"]
