"""Random coded Layer I/II pool wires (``models.l12.l12_layout``) for the
tests of the device requantization and the synthesis behind it.

``coded_wire`` draws what the native packer
(``host/src/wire_l12_codes.cc``) would write for frames with random
allocations, codes and scalefactor indices, without a bitstream: per
slot-frame a class for each (ch, sb) (0, no allocation, a quarter of the
time), a joint-stereo bound past which channel 1 shares channel 0's
class and offset, scalefactor indices 0-63 (63 included, which the
requantization clamps to 62), the codes' offsets in the packer's
order (subband, then channel) within a group of as many bits as they
take, and a body of random bytes that holds the samples' 12 groups
after a random start bit; the allocations past the body's 2,000 bytes
are dropped, the last subbands first.  Mono slot-frames have no channel
1; idle ones are all zero but their meta.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import l12 as L
from ..ops import l12_requant as RQ

# Layer II classes 1..17, Layer I's 18..31 (RQ.host_tables)
CLASSES = {1: np.arange(18, 32), 2: np.arange(1, 18)}
BOUNDS = (4, 8, 12, 16, 32)
# the latest first bit of a slot-frame's samples it draws
MAX_START = 400


def coded_wire(B: int, layer: int, F: int = 1, seed: int = 0,
               mono=(), idle=()) -> torch.Tensor:
    """A packed coded wire uint8 [l12_layout(B, layer, F)['total']] (on
    the CPU) of F x B random slot-frames; `mono` slots have one channel
    and `idle` slot-frames (indices into F x B, f * B + b) are inactive.
    meta holds {nch, 48000 / 25, layer, 0}."""
    rng = np.random.default_rng(seed)
    N = F * B
    ci = RQ.host_tables()["ci"]
    cls = rng.choice(CLASSES[layer], (N, 32, 2))
    cls[rng.random((N, 32, 2)) < 0.25] = 0
    bits, grouped = ci[cls, 0], ci[cls, 1] > 0
    gbits = np.where(cls == 0, 0,
                     bits if layer == 1 else np.where(grouped, bits,
                                                      3 * bits))
    nch = np.full(N, 2)
    nch[[f * B + b for f in range(F) for b in mono]] = 1
    bound = rng.choice(BOUNDS, N)
    shared = np.arange(32)[None, :] >= bound[:, None]          # [N,32]
    one = (nch == 1)[:, None] | shared
    gbits[:, :, 1] = np.where(one, 0, gbits[:, :, 1])
    start = rng.integers(0, MAX_START + 1, N)
    # the packer's order: subband-major, channel-minor; keep the prefix
    # whose 12 groups fit the body
    flat = gbits.reshape(N, 64)
    end = np.cumsum(flat, 1)
    keep = start[:, None] + 12 * end <= 8 * RQ.BODY_BYTES
    flat = np.where(keep, flat, 0)
    off = (np.cumsum(flat, 1) - flat).reshape(N, 32, 2)
    glen = flat.sum(1)
    cls = np.where(keep.reshape(N, 32, 2), cls, 0)
    cls[:, :, 1] = np.where(nch[:, None] == 1, 0,
                            np.where(shared, cls[:, :, 0], cls[:, :, 1]))
    off[:, :, 1] = np.where(shared, off[:, :, 0], off[:, :, 1])
    off = np.where(cls == 0, 0, off)
    scf = rng.integers(0, 64, (N, 2, 32, 3))
    if layer == 1:
        scf[..., 1:] = scf[..., :1]
    scf = np.where(cls.transpose(0, 2, 1)[..., None] == 0, 0, scf)
    used = (start + 12 * glen + 7) // 8
    nbytes = np.minimum(used + rng.integers(0, 64, N), RQ.BODY_BYTES)
    body = rng.integers(0, 256, (N, RQ.BODY_BYTES), dtype=np.uint8)
    body[np.arange(RQ.BODY_BYTES)[None, :] >= nbytes[:, None]] = 0
    side = np.zeros((N, RQ.SIDE_BYTES), np.uint8)
    side[:, :RQ.SIDE_SCF] = cls.transpose(0, 2, 1).reshape(N, 64)
    side[:, RQ.SIDE_SCF:RQ.SIDE_OFF] = scf.reshape(N, 192)
    side[:, RQ.SIDE_OFF:] = off.transpose(0, 2, 1).astype(
        np.int16).reshape(N, 64).view(np.uint8)
    geom = np.stack([start, glen], 1).astype(np.int16)
    active = np.ones(N, np.int16)
    gone = list(idle)
    active[gone] = 0
    body[gone], side[gone], geom[gone] = 0, 0, 0
    buf = torch.zeros(L.l12_layout(B, layer, F)["total"], dtype=torch.uint8)
    w = L.l12_sections(buf, B, layer, F)
    w["body"].copy_(torch.from_numpy(body.reshape(F, B, -1)))
    w["side"].copy_(torch.from_numpy(side.reshape(F, B, -1)))
    w["geom"].copy_(torch.from_numpy(geom.reshape(F, B, 2)))
    meta = np.stack([nch, np.full(N, 48000 // 25), np.full(N, layer),
                     np.zeros(N)], 1).astype(np.int16)
    w["meta"].copy_(torch.from_numpy(meta.reshape(F, B, 4)))
    w["active"].view(F, B).copy_(torch.from_numpy(active.reshape(F, B)))
    return buf
