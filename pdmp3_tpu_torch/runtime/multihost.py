"""Multi-process serving: one process per device (or host), each with its
own native frontend and its own slice of the streams, joined by
``torch.distributed``.

Counterpart of ``pdmp3_tpu/runtime/multihost.py`` (BASELINE.json
configs[4], many streams over many hosts).  Streams are independent,
so each process decodes its own slots on its own device with a local
``StreamDecoder``: its native parse, its wire, its state.  The only
collective is ``global_active``, the summed active-slot count that tells
every process when all streams have ended.

Launch (one process per rank, after ``init_process_group``):

    dist.init_process_group("gloo", init_method="tcp://localhost:PORT",
                            world_size=W, rank=r)
    dec = MultiHostStreamDecoder(n_slots_global, device="cuda:0")
    dec.feed(local_slot, data)                   # this rank's slots only
    while dec.global_active(dec.parse_step()):
        pcm_local = dec.decode_step()

With gloo the count's all-reduce runs on the CPU; with NCCL on the
rank's device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .scheduler import StreamDecoder


class MultiHostStreamDecoder(StreamDecoder):
    """A StreamDecoder over this rank's slice of a pool spread over every
    process of a ``torch.distributed`` group (default: the world).

    ``n_slots`` is the GLOBAL slot count, a multiple of the group size;
    rank r owns the contiguous slots ``[r * n, (r + 1) * n)`` and feeds
    and parses only those, as local slots 0..n-1.  The process group must
    be initialised first.  As in the JAX class, every rank calls
    ``decode_step`` (and ``global_active``) the same number of times,
    stepping even while its own slots are idle: here only
    ``global_active`` communicates, but callers written to that contract
    run unchanged on either package."""

    def __init__(self, n_slots: int, *, device, group=None,
                 exact: bool = False, bug_compat: bool = True,
                 parse_threads: int = 1, family: int = 0):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("MultiHostStreamDecoder needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.procs = dist.get_world_size(group)
        self.pid = dist.get_rank(group)
        if n_slots % self.procs:
            raise ValueError(f"{n_slots} slots do not split over "
                             f"{self.procs} processes")
        self.n_global = n_slots
        super().__init__(n_slots // self.procs, exact=exact,
                         bug_compat=bug_compat, parse_threads=parse_threads,
                         family=family, device=device)

    def decode_step(self, fetch: bool = True):
        """This rank's step: PCM int16 [n, 1152, 2] ([n, 576, 2] for LSF
        pools) of its local slots, zeros for idle ones (all zeros when
        none is active), as numpy, or a device tensor with
        fetch=False."""
        pcm = super().decode_step(fetch)
        if pcm is not None:
            return pcm
        pcm = torch.zeros((self.n, 576 if self.family else 1152, 2),
                          dtype=torch.int16, device=self.device)
        return pcm.cpu().numpy() if fetch else pcm

    def global_active(self, local_count: int) -> int:
        """The sum of every rank's active-slot count (an all_reduce over
        the group): 0 once every rank's streams have ended."""
        on = (self.device if dist.get_backend(self.group) == "nccl"
              else torch.device("cpu"))
        count = torch.tensor([int(local_count)], dtype=torch.int64,
                             device=on)
        dist.all_reduce(count, op=dist.ReduceOp.SUM, group=self.group)
        return int(count.item())

