"""The batched decoders: the Layer III granule decoder with its packed
wires and per-stream DSP, the Layer I/II synthesis, and the offline
corpus decode."""
from .decoder import (DecoderState, GranuleBatch, TorchDSP, codes_layout,
                      codes_sections, decode_frame_packed, decode_frame_soa,
                      decode_frame_sparse, decode_granules, frame_to_batches,
                      init_state, soa_layout, sparse_layout, state_from_jax,
                      state_from_pallas, wire_sections)
from .l12 import (L12State, TorchL12, decode_l12_frames, init_l12_state,
                  l12_state_from_jax)

__all__ = ["DecoderState", "GranuleBatch", "L12State", "TorchDSP",
           "TorchL12", "codes_layout", "codes_sections",
           "decode_frame_packed", "decode_frame_soa",
           "decode_frame_sparse", "decode_granules", "decode_l12_frames",
           "frame_to_batches", "init_l12_state", "init_state",
           "l12_state_from_jax", "soa_layout", "sparse_layout",
           "state_from_jax", "state_from_pallas", "wire_sections"]
