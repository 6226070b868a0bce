"""The Layer I/II requantization of a step's coded frames, on the device:
from each slot-frame's body bytes and side record (the pool's wire,
``models.l12.l12_layout``) to the f32 subband samples [F,B,2,S,32] that
the synthesis (``ops.l12_synth``, K7) reads.

The JAX package has no counterpart: its native packer requantizes on the
host and ships the samples (``pdmp3_parse_step_wire_l12``).  Here the
packer ships codes (``host/src/wire_l12_codes.cc``) and
``l12_requant`` computes, for code k of (ch, sb) in group g, at bit
``geom[0] + g * geom[1] + off[ch][sb]`` (+ k x bits, Layer II ungrouped),
what ``parse_l1`` / ``parse_l2`` (``host/src/frame.cc``) compute:

    (float)((double)scf[min(idx, 62)] * (C * (frac(code, nb) + D)))

in double precision, operation for operation, so the samples are the
host's bit for bit.  C, D, the codeword bits, the group steps and nb come
from the host library's tables by class (``pdmp3_l12_requant_tables``):
class 0 is no allocation (+0.0), 1..17 Layer II's classes, 18..31 Layer
I's allocations.  Layer II groups 3 samples a codeword (12 groups, S =
36), Layer I one (12 groups, S = 12).

Two implementations with one contract: ``l12_requant_ref``, plain
batched PyTorch, the path for CPU tensors and the reference the tests
hold the kernel to; K9, the hand-written CUDA kernel of
``csrc/l12_requant.cu``, for CUDA tensors (one launch over the F x B
slot-frames).  No fallback between them.
"""
from __future__ import annotations

import ctypes as C
import functools

import numpy as np
import torch

from .launch import check_bulk_alignment, check_operands, launch

# the wire's per-slot-frame rows (host/src/wire_l12_codes.cc)
BODY_BYTES = 2000
SIDE_BYTES = 384
SIDE_SCF, SIDE_OFF = 64, 256
CLASSES = 32
SCF_MAX = 62      # a scalefactor index above it reads entry 62


def steps(layer: int) -> int:
    """Synthesis time steps S of a Layer I (12) or II (36) frame."""
    if layer not in (1, 2):
        raise ValueError(f"layer must be 1 or 2, got {layer!r}")
    return 12 if layer == 1 else 36


@functools.lru_cache(maxsize=1)
def host_tables() -> dict:
    """The host library's tables by class: cd f64 [32,2] {C, D}, ci int32
    [32,4] {codeword bits, grouped steps, nb, 0}, scf f32 [64]."""
    from ..host import lib

    cd = np.zeros((CLASSES, 2), np.float64)
    ci = np.zeros((CLASSES, 4), np.int32)
    scf = np.zeros(64, np.float32)
    fn = lib().pdmp3_l12_requant_tables
    fn.argtypes = [C.c_void_p] * 3
    fn.restype = None
    fn(cd.ctypes.data_as(C.c_void_p), ci.ctypes.data_as(C.c_void_p),
       scf.ctypes.data_as(C.c_void_p))
    return {"cd": cd, "ci": ci, "scf": scf}


@functools.lru_cache(maxsize=None)
def device_tables(device: str) -> dict:
    """host_tables() as tensors on ``device`` (cached per device)."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in host_tables().items()}


def _check(body, side, geom, layer, out):
    """Validate the operands; returns (F, B, S) and the output."""
    S = steps(layer)
    if body.dim() != 3 or body.shape[2] != BODY_BYTES:
        raise ValueError(f"body must be uint8 [F,B,{BODY_BYTES}], got "
                         f"{tuple(body.shape)}")
    F, B = body.shape[:2]
    if out is None:
        out = torch.empty((F, B, 2, S, 32), dtype=torch.float32,
                          device=body.device)
    check_operands(body.device,
                   ("body", body, (F, B, BODY_BYTES), torch.uint8),
                   ("side", side, (F, B, SIDE_BYTES), torch.uint8),
                   ("geom", geom, (F, B, 2), torch.int16),
                   ("out", out, (F, B, 2, S, 32), torch.float32))
    return (F, B, S), out


def l12_requant(body, side, geom, layer: int, out=None):
    """The subband samples f32 [F,B,2,S,32] of a step's coded frames:
    body uint8 [F,B,2000], side uint8 [F,B,384], geom int16 [F,B,2], as
    the pool's wire holds them; into `out` when given.  CPU tensors take
    the plain version; CUDA tensors launch K9 (body and side 16-byte
    aligned)."""
    (F, B, S), out = _check(body, side, geom, layer, out)
    if body.device.type == "cpu":
        return l12_requant_ref(body, side, geom, layer, out)
    if body.device.type != "cuda":
        raise ValueError(f"no Layer I/II requantization for {body.device}")
    check_bulk_alignment(body=body, side=side)
    if F * B == 0:
        return out
    tab = device_tables(str(body.device))
    launch("l12_requant", "pdmp3_l12_requant", body.device, body.data_ptr(),
           side.data_ptr(), geom.data_ptr(), out.data_ptr(),
           tab["cd"].data_ptr(), tab["ci"].data_ptr(), tab["scf"].data_ptr(),
           F * B, S)
    return out


def _bits(body, pos, nb):
    """The nb-bit codes (nb <= 16) at bit positions pos, MSB first, of
    each row of body (uint8 [N, BODY_BYTES + 8]); pos int64 [N, ...]."""
    n = body.shape[0]
    flat = pos.reshape(n, -1)
    byte = (flat >> 3).clamp(0, BODY_BYTES + 5)
    win = torch.zeros_like(flat)
    for k in range(3):
        win = (win << 8) | torch.gather(body, 1, byte + k).long()
    shift = 24 - (flat & 7) - nb.reshape(n, -1)
    return ((win >> shift.clamp(min=0)) & ((1 << nb.reshape(n, -1)) - 1)
            ).reshape(pos.shape)


def l12_requant_ref(body, side, geom, layer: int, out=None):
    """Plain batched PyTorch version of l12_requant (same arguments): the
    bit reads, the codeword split and every double operation of parse_l1
    / parse_l2 in their order, then the rounding to f32."""
    (F, B, S), out = _check(body, side, geom, layer, out)
    N, dev = F * B, body.device
    tab = device_tables(str(dev))
    side = side.reshape(N, SIDE_BYTES)
    cls = side[:, :SIDE_SCF].long().view(N, 2, 32, 1)
    cls = torch.where(cls < CLASSES, cls, 0)    # K9 reads no other class
    scf = side[:, SIDE_SCF:SIDE_OFF].long().view(N, 2, 32, 3)
    off = side[:, SIDE_OFF:].contiguous().view(torch.int16).long()
    off = off.view(N, 2, 32, 1)
    geom = geom.reshape(N, 2).long()
    padded = torch.cat([body.reshape(N, BODY_BYTES),
                        torch.zeros((N, 8), dtype=torch.uint8, device=dev)],
                       1)
    ci = tab["ci"].long()
    bits, gsteps, nb = (ci[:, k][cls] for k in range(3))   # [N,2,32,1]
    grp = torch.arange(12, device=dev).view(1, 1, 1, 12)
    pos = geom[:, 0].view(N, 1, 1, 1) + grp * geom[:, 1].view(N, 1, 1, 1) \
        + off                                              # [N,2,32,12]
    if layer == 1:
        codes = _bits(padded, pos, nb.expand_as(pos))[..., None]
    else:
        k = torch.arange(3, device=dev)
        grouped = gsteps > 0
        at = pos[..., None] + torch.where(grouped[..., None], 0,
                                          bits[..., None] * k)
        width = bits[..., None].expand_as(at)
        raw = _bits(padded, at, width)                     # [N,2,32,12,3]
        gs = gsteps[..., None].clamp(min=1)
        split = (raw[..., :1] // gs ** k) % gs
        codes = torch.where(grouped[..., None], split, raw)
    nb = nb[..., None]
    msb = 1 << (nb - 1).clamp(min=0)
    c = codes ^ msb
    c = torch.where(c >= msb, c - (1 << nb), c)
    frac = c.double() / msb.double()
    cd = tab["cd"]
    C, D = cd[:, 0][cls][..., None], cd[:, 1][cls][..., None]
    part = (grp // 4)[..., None].expand(N, 2, 32, 12, 1)
    idx = torch.gather(scf, 3, part.reshape(N, 2, 32, 12)).clamp(max=SCF_MAX)
    scale = tab["scf"][idx].double()[..., None]
    val = (scale * (C * (frac + D))).float()
    val = torch.where(cls[..., None] == 0, torch.zeros((), device=dev), val)
    # [N,2,32,12,k] -> [N,2,12*k,32]
    val = val.permute(0, 1, 3, 4, 2).reshape(F, B, 2, S, 32)
    out.copy_(val)
    return out
