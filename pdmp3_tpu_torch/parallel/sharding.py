"""Stream-axis sharding over a list of devices.

Counterpart of ``pdmp3_tpu/parallel/sharding.py``.  Streams are
independent, so spreading a batch over devices is data placement alone:
the slot axis B is cut into ``len(mesh)`` contiguous shards, each shard's
tensors and recurrent state live on its device and never move, and each
device runs the same step on its own shard (on CUDA the hand-written
kernels K1, K2 and K3, on the CPU their plain versions).  The only
cross-shard value is the clipped-sample count, summed on the first
shard's device.

A mesh here is a tuple of ``torch.device`` and an axis name, not a JAX
mesh.  A device may repeat (``["cuda:0", "cuda:0"]``, ``["cpu"] * 4``):
that is how one card, or the CPU, holds several shards.  A sharded
value is a list with one entry per shard, in slot order.  Every
function here launches every shard's work before it reads anything on
the host, so on a host with several GPUs the shards run at once.

What the JAX module has and this one does not: the ``kernel="xla"`` /
``"pallas"`` switch (the port has one route per device type),
``pallas_state_specs`` / ``place_pallas_state`` (the port has one state
layout, the canonical slot-major one) and ``replicate_tables`` (each
device's kernel tables are made at its first launch,
``ops.consts.device_consts``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import decoder as M
from ..models import l12 as L
from ..ops.fused_step import fused_granule_step

STREAM_AXIS = "streams"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D stream axis, one per shard, in slot order."""
    devices: tuple
    axis: str = STREAM_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def bounds(self, n_slots: int) -> list[tuple[int, int]]:
        """Each shard's slot range [lo, hi) of n_slots slots; ValueError
        unless n_slots is a multiple of the mesh size."""
        if n_slots % self.size:
            raise ValueError(f"{n_slots} slots do not split over "
                             f"{self.size} shards")
        k = n_slots // self.size
        return [(i * k, (i + 1) * k) for i in range(self.size)]


def make_mesh(devices, axis: str = STREAM_AXIS) -> Mesh:
    """A 1-D mesh over the given devices (names or ``torch.device``),
    stream-parallel; a device may repeat."""
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis)


def place(x, mesh: Mesh, axis: int = 0) -> list[torch.Tensor]:
    """Cut a tensor (or numpy array) along its slot axis into the mesh's
    contiguous shards, each copied to its device."""
    x = torch.as_tensor(x)
    return [x.narrow(axis, lo, hi - lo).to(
                dev, copy=True, memory_format=torch.contiguous_format)
            for (lo, hi), dev in zip(mesh.bounds(x.shape[axis]),
                                     mesh.devices)]


def _shard_tree(tree, mesh: Mesh) -> list:
    """One copy of a dataclass of tensors per shard: every tensor field
    cut on its leading (slot) axis, every other field (a granule flag, a
    family, an absent sidecar) carried as it is."""
    fields = {f.name: getattr(tree, f.name)
              for f in dataclasses.fields(tree)}
    cut = {k: place(v, mesh) for k, v in fields.items()
           if isinstance(v, torch.Tensor)}
    return [dataclasses.replace(tree, **{k: v[i] for k, v in cut.items()})
            for i in range(mesh.size)]


def place_batch(batch: M.GranuleBatch, mesh: Mesh) -> list[M.GranuleBatch]:
    """A GranuleBatch as one batch per shard on the shard's device; B must
    be a multiple of the mesh size."""
    return _shard_tree(batch, mesh)


def place_state(state, mesh: Mesh) -> list:
    """A DecoderState (or L12State) as one state per shard on the
    shard's device; B must be a multiple of the mesh size."""
    return _shard_tree(state, mesh)


def clipped_count(pcms: list[torch.Tensor], device) -> torch.Tensor:
    """Samples at the +-32767 rails over every shard's PCM: an int64
    scalar on ``device``, summed there without a host read (the serving
    telemetry of the JAX package's psum)."""
    total = torch.zeros((), dtype=torch.int64, device=device)
    for pcm in pcms:
        total += ((pcm == 32767) | (pcm == -32767)).sum().to(
            device, non_blocking=True)
    return total


def decode_granules_sharded(batch: list, state: list, mesh: Mesh,
                            exact: bool = False, bug_compat: bool = True):
    """One granule step on every shard (``place_batch`` /
    ``place_state`` made the shards): ``fused_granule_step`` on each
    shard's device, each state updated in place.  Returns (pcm shards
    int16 [B/n,576,2], state shards, clipped), clipped on the first
    shard's device."""
    if not len(batch) == len(state) == mesh.size:
        raise ValueError(f"{len(batch)} batch and {len(state)} state "
                         f"shards for a mesh of {mesh.size}")
    pcms, states = [], []
    for b, s in zip(batch, state):
        pcm, s = fused_granule_step(b.ix, b.scf_l, b.scf_s, b.meta,
                                    b.active, b.gr1, s, bug_compat, exact,
                                    b.family, b.is_pos)
        pcms.append(pcm)
        states.append(s)
    return pcms, states, clipped_count(pcms, mesh.devices[0])


def _per_shard(step, *shards) -> tuple[list, list]:
    """step(*args) on each shard's arguments; (pcm shards, state
    shards)."""
    out = [step(*args) for args in zip(*shards, strict=True)]
    return [pcm for pcm, _ in out], [st for _, st in out]


def sharded_frame_step(ix2, scf_l2, scf_s2, meta2, active, state,
                       exact: bool = False, bug_compat: bool = True):
    """``models.decoder.decode_frame_soa`` (one MPEG-1 frame, two granule
    steps) on each shard's device: every argument a list of shards, the
    section tensors cut on their slot axis 1 (``place(x, mesh, 1)``),
    active [B/n] and the states on axis 0.  Returns (pcm shards int16
    [B/n,1152,2], state shards)."""
    return _per_shard(
        lambda *a: M.decode_frame_soa(*a, bug_compat=bug_compat,
                                      exact=exact),
        ix2, scf_l2, scf_s2, meta2, active, state)


def sharded_frame_lsf_step(ix, scf_l, scf_s, meta, is_pos, active, state,
                           family: int, exact: bool = False,
                           bug_compat: bool = True):
    """``models.decoder.decode_frame_lsf_soa`` (F one-granule LSF frames)
    on each shard's device: the section tensors [F,B,...] and active
    [F,B] cut on axis 1, the states on axis 0.  Returns (pcm shards int16
    [B/n,F*576,2], state shards)."""
    return _per_shard(
        lambda *a: M.decode_frame_lsf_soa(*a, family, bug_compat=bug_compat,
                                          exact=exact),
        ix, scf_l, scf_s, meta, is_pos, active, state)


def sharded_l12_step(sb, nch, active, state, exact: bool = False,
                     float_pcm: bool = False):
    """``models.l12.decode_l12_frames`` (one Layer I/II frame) on each
    shard's device: sb [B/n,2,S,32], nch and active [B/n] and the
    L12States, all cut on axis 0.  Returns (pcm shards [B/n,S*32,2],
    state shards)."""
    return _per_shard(
        lambda *a: L.decode_l12_frames(*a, exact=exact, float_pcm=float_pcm),
        sb, nch, active, state)
