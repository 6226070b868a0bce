"""Scale simulation: the 100k-concurrent-stream decode step
(``BASELINE.json`` configs[4]) at its real size on one card.

    python -m pdmp3_tpu_torch.tools.scale_sim --slots 102400 --shards 8
    python -m pdmp3_tpu_torch.tools.scale_sim --slots 64 --shards 4 \\
        --device cpu

Counterpart of ``tools/scale_sim.py``, which ran the sharded program on
a virtual 8-device CPU mesh.  Here the mesh is ``--shards`` shards of
one device (``parallel.make_mesh([dev] * shards)``; a mesh may repeat a
device): real parsed granules of four stream archetypes tiled across
``--slots`` slots, the recurrent state placed shard by shard, and
``decode_granules_sharded`` run fast (K1 on every shard) for ``--steps``
steps after one warm-up step.  Every shard's PCM and state are then
held bitwise against the plain PyTorch version
(``fused_granule_step_ref``) run on the four archetypes for the same
number of steps and tiled to the shard's rows; the error names the
first slot that differs.

The batch is tiled on the device (``tiled_batch``) rather than made by
``frame_to_batches``, whose Python loop visits every slot's frame; the
CPU tests hold the two equal at small B.  Reported:
each step's time from CUDA events (the host clock on the CPU),
``state_bytes_per_slot``, ``torch.cuda.max_memory_allocated`` over the
run, and each shard's rows.  Writes ``build/torch_tools/scale_sim.json``
unless ``--out`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from . import (card, check_launches, cuda_ms, default_out, launched_since,
               launches, resolve_device, write_json)

ARCHETYPES = 4


def archetype_frames() -> list:
    """The first parsed frame of each of four stream archetypes (long,
    varied, short, mixed blocks; stereo and MS)."""
    from ..frontend import Frontend
    from ..testing import mp3gen

    fds = []
    for i in range(ARCHETYPES):
        s = mp3gen.make_stream(
            n_frames=4, seed=500 + i,
            blocks=["long", "varied", "short", "mixed"][i],
            mode=1 if i % 2 else 0, mode_extension=2 if i % 2 else 0)
        fe = Frontend()
        fe.feed(s)
        r, fd = fe.read_frame()
        if r != 0:
            raise RuntimeError(f"archetype {i}: read_frame returned {r}")
        fds.append(fd)
    return fds


def tiled_batch(small, n_slots: int):
    """The granule batch whose slot i holds `small`'s slot i % len(small):
    every tensor field repeated along the slot axis on its device."""
    k = small.ix.shape[0]
    if n_slots % k:
        raise ValueError(f"{n_slots} slots do not tile {k} archetypes")
    reps = n_slots // k
    return dataclasses.replace(small, **{
        f.name: getattr(small, f.name).repeat(
            reps, *[1] * (getattr(small, f.name).dim() - 1))
        for f in dataclasses.fields(small)
        if isinstance(getattr(small, f.name), torch.Tensor)})


def check_tiled(pcm, state, want, st, per: int) -> None:
    """Every shard's PCM and state (lists over shards of `per` rows) must
    equal the 4-slot plain result (want, st) tiled to `per` rows, bit for
    bit; raises naming the first slot that differs."""
    def tile(t):
        return t.repeat(per // ARCHETYPES, *[1] * (t.dim() - 1))

    wants = {"pcm": tile(want)}
    for name in ("store", "v_blocks", "prev_lines"):
        wants[name] = tile(getattr(st, name)).view(torch.int32)
    for i, (p, s) in enumerate(zip(pcm, state)):
        gots = {"pcm": p}
        for name in ("store", "v_blocks", "prev_lines"):
            gots[name] = getattr(s, name).view(torch.int32)
        for name, got in gots.items():
            bad = (got != wants[name]).flatten(1).any(1).nonzero()
            if bad.numel():
                raise RuntimeError(f"slot {i * per + int(bad[0])}: {name} "
                                   "differs from the plain version")


def run(n_slots: int, shards: int, steps: int, dev) -> dict:
    """The sharded fast step at `n_slots` slots over `shards` shards of
    `dev`; raises when a shard holds the wrong rows or a slot's PCM or
    state differs from the plain version's."""
    from ..models import decoder as M
    from ..ops.fused_step import fused_granule_step_ref
    from ..parallel import (decode_granules_sharded, make_mesh, place_batch,
                            place_state)

    if n_slots % (shards * ARCHETYPES):
        raise ValueError(f"{n_slots} slots: need a multiple of "
                         f"{shards * ARCHETYPES}")
    fds = archetype_frames()
    small = M.frame_to_batches(fds, dev)[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh([dev] * shards)
    batch = place_batch(tiled_batch(small, n_slots), mesh)
    state = place_state(M.init_state(n_slots, dev), mesh)
    rows = [b.ix.shape[0] for b in batch]
    if rows != [n_slots // shards] * shards:
        raise RuntimeError(f"shard rows {rows}")

    t0 = time.perf_counter()
    (pcm, state, clipped), first_ms = cuda_ms(
        dev, lambda: decode_granules_sharded(batch, state, mesh))
    first_s = time.perf_counter() - t0
    before = launches()
    step_ms = []
    for _ in range(steps):
        (pcm, state, clipped), ms = cuda_ms(
            dev, lambda: decode_granules_sharded(batch, state, mesh))
        step_ms.append(ms)
    check_launches(dev, launched_since(before), "fused_granule",
                   steps * shards, "sharded steps")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)

    # the plain version on the 4 archetypes, one step more (the warm-up)
    st = M.init_state(ARCHETYPES, dev)
    for _ in range(steps + 1):
        want, st = fused_granule_step_ref(small.ix, small.scf_l,
                                          small.scf_s, small.meta,
                                          small.active, small.gr1, st)
    check_tiled(pcm, state, want, st, n_slots // shards)
    state_bytes = sum(t.numel() * t.element_size() for s in state
                      for t in (s.store, s.v_blocks, s.prev_lines))
    return {
        "slots": n_slots, "shards": shards, "steps": steps,
        "device": str(dev), "card": card(dev),
        "first_step_ms": first_ms, "first_step_wall_s": first_s,
        "step_ms": step_ms, "step_ms_min": min(step_ms),
        "step_ms_median": float(np.median(step_ms)),
        "step_clock": "cuda events" if dev.type == "cuda" else "host",
        "granules_per_step": n_slots,
        "state_bytes_per_slot": state_bytes // n_slots,
        "state_bytes_total": state_bytes,
        "max_memory_allocated": peak,
        "shard_rows": rows, "clipped": int(clipped),
        "checked": "every slot's PCM, store, v_blocks and prev_lines "
                   "bitwise vs the plain version",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=102400)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=default_out("scale_sim.json"))
    args = ap.parse_args(argv)
    res = run(args.slots, args.shards, args.steps,
              resolve_device(args.device))
    write_json(args.out, res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
