"""Runtime configuration.

The reference has compile-time #defines only (Makefile:17-23 —
OUTPUT_*/IMDCT_TABLES/POW34_*); here configuration is a runtime object
with environment overrides, defaulting to reference-equivalent behavior
(SURVEY.md §5 config/flag system).
"""
from __future__ import annotations

import dataclasses
import os


def _env(name: str, default, cast):
    v = os.environ.get(name)
    return default if v is None else cast(v)


@dataclasses.dataclass
class DecodeConfig:
    # precision: "exact" = bit-exact vs the reference decoder (f32 op-order
    # + f64 rounding points; needs jax_enable_x64 on the JAX path);
    # "fast" = MXU contractions + VPU transcendentals (±1 LSB)
    precision: str = "exact"
    # emulate the reference's short-block intensity-stereo transcription
    # bug (pdmp3.c:2212-2213); False = spec-correct panning
    bug_compat_short_intensity: bool = True
    # granule slots per device step (serving batch)
    batch_slots: int = 8192
    # input feed chunk for file decode (reference CLI uses 4096,
    # pdmp3.c:2578)
    feed_chunk: int = 4096
    # device mesh axis name for stream-parallel sharding
    mesh_axis: str = "streams"

    @property
    def exact(self) -> bool:
        return self.precision == "exact"

    @classmethod
    def from_env(cls) -> "DecodeConfig":
        return cls(
            precision=_env("PDMP3_PRECISION", "exact", str),
            bug_compat_short_intensity=_env("PDMP3_BUG_COMPAT", 1, int) != 0,
            batch_slots=_env("PDMP3_BATCH_SLOTS", 8192, int),
            feed_chunk=_env("PDMP3_FEED_CHUNK", 4096, int),
            mesh_axis=_env("PDMP3_MESH_AXIS", "streams", str),
        )
