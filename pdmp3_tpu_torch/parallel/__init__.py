"""Stream-axis sharding of the decode over a list of devices."""
from .sharding import (STREAM_AXIS, Mesh, clipped_count,
                       decode_granules_sharded, make_mesh, place,
                       place_batch, place_state, sharded_frame_lsf_step,
                       sharded_frame_step, sharded_l12_step)

__all__ = ["STREAM_AXIS", "Mesh", "clipped_count", "decode_granules_sharded",
           "make_mesh", "place", "place_batch", "place_state",
           "sharded_frame_lsf_step", "sharded_frame_step",
           "sharded_l12_step"]
