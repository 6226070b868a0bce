"""Serving pools sharded over a list of devices.

Counterpart of ``pdmp3_tpu/runtime/sharded.py`` (BASELINE.json
configs[4]: many concurrent streams over many devices).  The slot axis
is cut into ``len(mesh)`` contiguous shards (``parallel.sharding``), and
each shard is a pool of its own: a ``StreamDecoder`` or
``L12StreamDecoder`` on the shard's device over that shard's slots, with
its own native handles, pinned double-buffered wire, upload fences and
recurrent state.  The port's wire is one packed buffer with the slot
axis inside each section, so a contiguous slot range is no contiguous
slice of it; a pool per shard needs no host re-pack.  No state moves
between devices and nothing is reduced across them.

The surface is the pool's, over global slots: ``feed``,
``inbuf_free``, ``nch`` and ``join`` route a slot to its shard;
``parse_step`` parses every shard (one native call each) and sums their
counts; ``active`` and ``meta`` are global snapshots; ``decode_step``
launches every shard's step before it reads any PCM on the host;
``decode_step_pipelined`` / ``drain_pending`` return the previous step's
PCM, each shard's copied by its own pool's drain; checkpoints are the
canonical unsharded layout, so one resumes in an unsharded pool (of this
port or of the JAX package) and back.  ``n``
and ``_handle_arr`` span every shard's handles in slot order, so
``LoopFeeder`` feeds a sharded pool as it feeds any pool.

A pool decodes one frame per slot and step; the sharded pools take no
``float_pcm`` or resampler option for Layer III, as the JAX class has
neither.
"""
from __future__ import annotations

import ctypes as C

import numpy as np
import torch

from ..parallel.sharding import Mesh
from .scheduler import L12StreamDecoder, StreamDecoder


class _ShardedPool:
    """What the sharded pools share: the shards' pools, the routing of a
    global slot, the global views, the step and the checkpoints.  A
    subclass makes the pools (``_open``)."""

    def _open(self, n_slots: int, mesh: Mesh, frames_per_step: int,
              make_pool) -> None:
        if frames_per_step != 1:
            raise ValueError("sharded serving decodes one frame per step, "
                             f"got frames_per_step={frames_per_step!r}")
        mesh.bounds(n_slots)   # ValueError unless the slots split evenly
        self.mesh = mesh
        self.n = n_slots
        self.n_local = n_slots // mesh.size
        self.pools = [make_pool(self.n_local, dev) for dev in mesh.devices]
        self.handles = [h for p in self.pools for h in p.handles]
        self._handle_arr = (C.c_void_p * n_slots)(
            *[h._h for h in self.handles])
        self._views = None
        # the pipelined drain: per shard, its pool's copy of the previous
        # step's PCM in flight
        self._pending = None

    def _route(self, slot: int):
        """(the slot's pool, its slot there)."""
        if not 0 <= slot < self.n:
            raise IndexError(f"slot {slot} outside [0, {self.n})")
        return self.pools[slot // self.n_local], slot % self.n_local

    # ---- host side ----

    def feed(self, slot: int, data: bytes) -> int:
        pool, s = self._route(slot)
        return pool.feed(s, data)

    def inbuf_free(self, slot: int) -> int:
        pool, s = self._route(slot)
        return pool.inbuf_free(s)

    def nch(self, slot: int) -> int:
        pool, s = self._route(slot)
        return pool.nch(s)

    def parse_step(self) -> int:
        """Parse a frame per slot on every shard; the active slots in
        all."""
        self._views = None
        return sum(p.parse_step() for p in self.pools)

    def _global(self) -> dict:
        # made once per parse or decode step: a caller reading
        # active[slot] slot by slot must not concatenate B slots each time
        if self._views is None:
            self._views = {
                "active": np.concatenate([p.active for p in self.pools]),
                "meta": np.concatenate([p.meta for p in self.pools], 1)}
        return self._views

    @property
    def active(self) -> np.ndarray:
        """Every slot's active flag [B], in slot order (a snapshot: write
        to a shard's pool, not to this)."""
        return self._global()["active"]

    @property
    def meta(self) -> np.ndarray:
        """Every slot's meta words, the pools' meta joined on the slot
        axis 1 (a snapshot)."""
        return self._global()["meta"]

    # ---- device side ----

    def decode_step(self, fetch: bool = True):
        """Decode the parsed frame on every shard.  Returns numpy PCM
        [B, samples, 2] in slot order, zeros for idle slots, or with
        fetch=False the list of device tensors, one per shard; None when
        no slot was active.  Every shard's step is launched before any
        PCM is read on the host."""
        if not any(p.active.any() for p in self.pools):
            return None
        pcms = [p.decode_step(fetch=False) for p in self.pools]
        # a shard with no active slot did not step: its PCM is silence
        like = next(pcm for pcm in pcms if pcm is not None)
        pcms = [torch.zeros(like.shape, dtype=like.dtype, device=p.device)
                if pcm is None else pcm for p, pcm in zip(self.pools, pcms)]
        self._views = None
        if not fetch:
            return pcms
        return np.concatenate([pcm.cpu().numpy() for pcm in pcms])

    def decode_step_pipelined(self):
        """decode_step with an asynchronous PCM drain (the pools'
        contract): decodes this step on every shard, starts the copy of
        each shard's PCM to the host without waiting for it, and returns
        the PREVIOUS step's PCM as numpy [B, ...] in slot order (None on
        the first call or after a step in which no shard was active).
        Each shard's copy is its own pool's: on CUDA a side stream of the
        shard's device into pinned host memory."""
        pcms = self.decode_step(fetch=False)
        prev = self._pending
        self._pending = None if pcms is None else [
            p._drain(pcm) for p, pcm in zip(self.pools, pcms)]
        return self._fetch(prev)

    def drain_pending(self):
        """The last pipelined step's PCM (the flush at the end of the
        streams), or None."""
        prev, self._pending = self._pending, None
        return self._fetch(prev)

    def _fetch(self, pending):
        if pending is None:
            return None
        return np.concatenate([p._fetch(x)
                               for p, x in zip(self.pools, pending)])

    # ---- checkpoint/resume, in the canonical unsharded layout ----

    def save_checkpoint(self) -> dict:
        parts = [p.save_checkpoint() for p in self.pools]
        return {k: [h for c in parts for h in c[k]] if k == "handles"
                else np.concatenate([c[k] for c in parts])
                for k in parts[0]}

    def restore_checkpoint(self, ckpt: dict) -> None:
        if len(ckpt["handles"]) != self.n:
            raise ValueError(f"checkpoint has {len(ckpt['handles'])} "
                             f"slots, decoder {self.n}")
        for pool, (lo, hi) in zip(self.pools, self.mesh.bounds(self.n)):
            pool.restore_checkpoint({k: v[lo:hi] for k, v in ckpt.items()
                                     if v is not None})
        self._views = None


class ShardedStreamDecoder(_ShardedPool):
    """A Layer III pool (MPEG-1, or an LSF pool of ``family`` 1 / 2) of
    n_slots slots over ``mesh``: one ``StreamDecoder`` per shard on the
    shard's device (K1 fast / K2 exact, K3 for LSF on CUDA; their plain
    versions on the CPU).  n_slots must be a multiple of the mesh size.
    decode_step returns PCM [B, 1152, 2] ([B, 576, 2] for LSF)."""

    def __init__(self, n_slots: int, mesh: Mesh, *, exact: bool = False,
                 bug_compat: bool = True, parse_threads: int = 0,
                 family: int = 0, frames_per_step: int = 1):
        self._open(n_slots, mesh, frames_per_step, lambda n, dev:
                   StreamDecoder(n, exact=exact, bug_compat=bug_compat,
                                 parse_threads=parse_threads, family=family,
                                 device=dev))

    def join(self, slot: int, data: bytes, start_s: float,
             duration_s: float | None = None, *, index=None):
        """``StreamDecoder.join`` on the slot's shard (release the slot
        from a ``LoopFeeder`` first)."""
        pool, s = self._route(slot)
        return pool.join(s, data, start_s, duration_s, index=index)


class ShardedL12StreamDecoder(_ShardedPool):
    """A Layer I/II pool of n_slots slots over ``mesh``: one
    ``L12StreamDecoder`` per shard on the shard's device (K7, one launch
    a frame and shard, on CUDA).  n_slots must be a multiple of the mesh
    size.
    decode_step returns PCM [B, S*32, 2] (f32 with float_pcm)."""

    def __init__(self, n_slots: int, layer: int, mesh: Mesh, *,
                 exact: bool = False, parse_threads: int = 1,
                 profile: int = 0, float_pcm: bool = False,
                 frames_per_step: int = 1):
        self._open(n_slots, mesh, frames_per_step, lambda n, dev:
                   L12StreamDecoder(n, layer=layer, exact=exact,
                                    parse_threads=parse_threads,
                                    profile=profile, float_pcm=float_pcm,
                                    device=dev))
