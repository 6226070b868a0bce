"""A cell's streams, which slot plays which, and the slots it watches.

The streams are real encoder output kept in the checkout: the
configuration names a description ``benchmark/streams/<name>.json`` of
segments that loop, which lie back to back in the file it names under
"file" (``<name>.mp3`` where it names none; ``make_streams`` wrote the
Layer III ones), and the stream reader (``benchmark/readers/<reader>.py``)
that finds their frames.  From the seed alone: the ``distinct`` segments
the traffic mix uses, each slot's source (one of them, looped) and the
frame it enters it at (one the reader marks as an ``entry``), and the
watched slots whose PCM the reference checks: ``sources`` of the
segments, ``slots_per_source`` slots of each.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def seed_of(seed: int, *path) -> int:
    """A 64-bit seed drawn from the run's seed and a path of names."""
    key = ":".join(str(p) for p in (seed, *path)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little")


@dataclasses.dataclass
class Corpus:
    streams: list          # {"data", "offsets", "sync", "frames"} each
    source: np.ndarray     # [B] the stream each slot plays
    rotation: np.ndarray   # [B] the frame it enters it at
    watch: np.ndarray      # [W] watched slots, ascending
    feeds: list            # [B] each slot's looped source, as bytes
    encoder: dict          # the encoder and its settings
    reader: object         # the stream reader module

    @property
    def period(self) -> int:
        """Frames in each stream: the steps after which the pool's wire
        repeats."""
        return len(self.streams[0]["offsets"])

    def stats(self) -> dict:
        """The streams' content (the reader's ``stats``)."""
        return self.reader.stats([s["frames"] for s in self.streams])


def load(name: str) -> tuple[list, dict]:
    """The segments of the file that benchmark/streams/<name>.json
    describes, and the description; ValueError unless the bytes are the
    ones described."""
    base = os.path.join(HERE, "streams", name)
    with open(base + ".json") as f:
        info = json.load(f)
    path = os.path.join(HERE, "streams", info.get("file", name + ".mp3"))
    with open(path, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != info["sha256"]:
        raise ValueError(f"{path} is not the file {base}.json describes")
    segs, pos = [], 0
    for seg in info["segments"]:
        segs.append(data[pos:pos + seg["bytes"]])
        pos += seg["bytes"]
    return segs, info


def build(streams: str, traffic: dict, slots: int, seed: int,
          reader) -> Corpus:
    """The corpus of a run: streams names the configuration's
    description of segments, traffic is the mix (its "distinct" and
    "watch"), reader the configuration's stream reader module."""
    segs, info = load(streams)
    rng = np.random.default_rng(seed_of(seed, "slots"))
    n = min(traffic["distinct"], len(segs))
    made = []
    for k in sorted(rng.choice(len(segs), n, replace=False).tolist()):
        fs = reader.frames(segs[k])
        made.append({"data": segs[k], "frames": fs,
                     "offsets": [f["offset"] for f in fs],
                     "sync": [i for i, f in enumerate(fs) if f["entry"]]})
    if len({len(s["offsets"]) for s in made}) != 1:
        raise ValueError("the segments differ in length")
    source = rng.integers(0, n, slots)
    rotation = np.array([rng.choice(made[s]["sync"]) for s in source])
    watch = traffic["watch"]
    picked = []
    for s in rng.choice(n, min(watch["sources"], n), replace=False):
        users = np.nonzero(source == s)[0]
        if len(users):
            picked += list(rng.choice(users, min(watch["slots_per_source"],
                                                 len(users)), replace=False))
    feeds, cache = [], {}
    for s, r in zip(source.tolist(), rotation.tolist()):
        if (s, r) not in cache:
            d, off = made[s]["data"], made[s]["offsets"]
            cache[s, r] = d[off[r]:] + d[:off[r]]
        feeds.append(cache[s, r])
    return Corpus(made, source, rotation, np.array(sorted(picked)), feeds,
                  info["encoder"], reader)
