"""Entry points of the port: the flagship step and a multi-device dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.  ``entry()``
returns the fast fused granule step (K1 on a CUDA device) with a real
batch to run it on; ``dryrun_multichip(n)`` runs one step of each pool
kind sharded over n shards of one device and holds the sharded results
to the unsharded ones.  Both run on the device they are given and fail
where it is absent; neither falls back to another.
"""
from __future__ import annotations

import torch

from . import device as _device
from .frontend import Frontend
from .models import decoder as M
from .models import l12 as L
from .ops.fused_step import fused_granule_step
from .parallel.sharding import (clipped_count, decode_granules_sharded,
                                make_mesh, place, place_batch, place_state,
                                sharded_frame_lsf_step, sharded_l12_step)
from .testing import mp3gen


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _on(device) -> torch.device:
    """``device``, after checking that a CUDA device is visible when it
    names one."""
    device = torch.device(device)
    if device.type == "cuda":
        _device.require_cuda()
    return device


def _first_frame(stream: bytes, **frontend):
    fe = Frontend(**frontend)
    fe.feed(stream)
    res, fd = fe.read_frame()
    if res != 0:
        raise RuntimeError(f"the example stream did not parse ({res})")
    return fd


def _example_batch(n_slots: int, device):
    """A real GranuleBatch (granule 0 of a generated, parsed MPEG-1 joint
    stereo frame, tiled over n_slots) and a zero state, on device."""
    fd = _first_frame(mp3gen.make_stream(n_frames=3, seed=123,
                                         blocks="varied", mode=1,
                                         mode_extension=2))
    return (M.frame_to_batches([fd] * n_slots, device)[0],
            M.init_state(n_slots, device))


def entry(device="cuda"):
    """The flagship model's forward step, the batched fast granule step
    (``fused_granule_step``: K1 on CUDA, its plain version on the CPU),
    and its arguments (batch, state) for 8 slots on ``device``.
    ``step(batch, state)`` returns (pcm int16 [8,576,2], state), the
    state updated in place."""
    device = _on(device)

    def step(batch, state):
        return fused_granule_step(batch.ix, batch.scf_l, batch.scf_s,
                                  batch.meta, batch.active, batch.gr1,
                                  state, exact=False)

    return step, _example_batch(8, device)


def _same(name: str, shards: list, whole: torch.Tensor) -> None:
    got = torch.cat([s.to(whole.device) for s in shards])
    _check(got.shape == whole.shape and torch.equal(got, whole),
           f"{name}: the sharded result differs from the unsharded one")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One step of each pool kind over a mesh of n_devices shards of
    ``device`` (4 slots a shard), each against the same step unsharded,
    bitwise: MPEG-1 through ``decode_granules_sharded`` (PCM, state and
    the clipped count), an MPEG-2 frame through
    ``sharded_frame_lsf_step`` and a Layer II frame through
    ``sharded_l12_step``; the shapes asserted.  Raises on any
    difference."""
    device = _on(device)
    mesh = make_mesh([device] * n_devices)
    B = 4 * n_devices

    batch, state = _example_batch(B, device)
    pcm, states, clipped = decode_granules_sharded(
        place_batch(batch, mesh), place_state(state, mesh), mesh)
    want, state = fused_granule_step(batch.ix, batch.scf_l, batch.scf_s,
                                     batch.meta, batch.active, batch.gr1,
                                     state)
    _check(len(pcm) == n_devices and pcm[0].shape == (4, 576, 2),
           f"MPEG-1 PCM shards {[tuple(p.shape) for p in pcm]}")
    _same("MPEG-1 PCM", pcm, want)
    for name in ("store", "v_blocks", "prev_lines"):
        _same(f"MPEG-1 {name}", [getattr(s, name) for s in states],
              getattr(state, name))
    _check(int(clipped) == int(clipped_count([want], device)),
           "the clipped counts differ")

    fd = _first_frame(mp3gen.make_stream(n_frames=3, seed=77, family=1,
                                         mode=1, mode_extension=3,
                                         stereo_extent_ch1=0.4,
                                         bitrate_index=11), lsf=True)
    _check(fd.header.family == 1, "the LSF stream is not MPEG-2")
    (lb,) = M.frame_to_batches([fd] * B, device)
    ops = [t[None] for t in (lb.ix, lb.scf_l, lb.scf_s, lb.meta, lb.is_pos,
                             lb.active)]
    lpcm, _ = sharded_frame_lsf_step(
        *[place(t, mesh, 1) for t in ops],
        place_state(M.init_state(B, device), mesh), family=1)
    lwant, _ = M.decode_frame_lsf_soa(*ops, M.init_state(B, device), 1)
    _check(lwant.shape == (B, 576, 2), f"MPEG-2 PCM {tuple(lwant.shape)}")
    _same("MPEG-2 PCM", lpcm, lwant)

    fd2 = _first_frame(mp3gen.make_l12_stream(layer=2, n_frames=3, seed=55,
                                              bitrate_index=12),
                       layers12=True)
    _check(fd2.sb_samples is not None, "the Layer II frame has no samples")
    sb, nch, act = L.batch_from_frames([fd2] * B, layer=2)
    l12_args = [torch.from_numpy(a).to(device) for a in (sb, nch, act)]
    l2pcm, _ = sharded_l12_step(
        *[place(a, mesh) for a in l12_args],
        place_state(L.init_l12_state(B, device), mesh))
    l2want, _ = L.decode_l12_frames(*l12_args, L.init_l12_state(B, device),
                                    exact=False)
    _check(l2want.shape == (B, 36 * 32, 2),
           f"Layer II PCM {tuple(l2want.shape)}")
    _same("Layer II PCM", l2pcm, l2want)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    fn, args = entry(dev)
    out, _ = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
    dryrun_multichip(4, dev)
    print(f"dryrun_multichip ok: 4 shards of {dev}")
