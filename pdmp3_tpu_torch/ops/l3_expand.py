"""The widening of the coded MPEG-1 Layer III wire on the device: from
each granule-channel row's 4-bit line codes and the step's escape list
(the pool's wire, ``models.decoder.codes_layout``) to the int16 lines
[2F,B,2,576] that the granule steps read.

The JAX package has no counterpart: its native packer ships int16 lines
(``pdmp3_parse_step_wire16``).  Here the packer ships a code a line
(``host/src/wire_l3_codes.cc``): line 2k in the low nibble of byte k of
the row, line 2k + 1 in the high one; a code of -7..7 is the line's
value, the code 0x8 (``ESCAPE``) marks an escape, whose value is the
row's next entry of the escape list from the row's start, in line order.
An escape outside the list reads 0.  The widened rows are the dense
packer's bit for bit.

Two implementations with one contract: ``l3_expand_ref``, plain batched
PyTorch, the path for CPU tensors and the reference the tests hold the
kernel to; K10, the hand-written CUDA kernel of ``csrc/l3_expand.cu``,
for CUDA tensors (one launch over the step's rows).  No fallback between
them.
"""
from __future__ import annotations

import torch

from .launch import check_bulk_alignment, check_operands, launch

LINES = 576
CODE_BYTES = LINES // 2
ESCAPE = 0x8


def _check(codes, starts, esc, out):
    """Validate the operands; returns the row shape and the output."""
    if codes.dim() < 1 or codes.shape[-1] != CODE_BYTES:
        raise ValueError(f"codes must be uint8 [...,{CODE_BYTES}], got "
                         f"{tuple(codes.shape)}")
    rows = tuple(codes.shape[:-1])
    if esc.dim() != 1:
        raise ValueError(f"esc must be int16 [n], got {tuple(esc.shape)}")
    if out is None:
        out = torch.empty(rows + (LINES,), dtype=torch.int16,
                          device=codes.device)
    check_operands(codes.device,
                   ("codes", codes, rows + (CODE_BYTES,), torch.uint8),
                   ("starts", starts, rows, torch.int32),
                   ("esc", esc, tuple(esc.shape), torch.int16),
                   ("out", out, rows + (LINES,), torch.int16))
    return rows, out


def l3_expand(codes, starts, esc, out=None):
    """The int16 lines [..., 576] of the coded rows: codes uint8 [...,
    288], starts int32 [...], esc int16 [n], as the pool's wire holds
    them; into `out` when given.  CPU tensors take the plain version;
    CUDA tensors launch K10 (codes 4-byte, out 16-byte aligned)."""
    rows, out = _check(codes, starts, esc, out)
    if codes.device.type == "cpu":
        return l3_expand_ref(codes, starts, esc, out)
    if codes.device.type != "cuda":
        raise ValueError(f"no line widening for {codes.device}")
    check_bulk_alignment(codes=codes, ix=out)
    n = starts.numel()
    if n == 0:
        return out
    launch("l3_expand", "pdmp3_l3_expand", codes.device, codes.data_ptr(),
           starts.data_ptr(), esc.data_ptr(), esc.numel(), out.data_ptr(), n)
    return out


def l3_expand_ref(codes, starts, esc, out=None):
    """Plain batched PyTorch version of l3_expand (same arguments): the
    nibbles in line order, their two's-complement values, and each
    escape's value from its rank among the row's escapes."""
    rows, out = _check(codes, starts, esc, out)
    n = starts.numel()
    c = codes.reshape(n, CODE_BYTES)
    nib = torch.stack([c & 0xF, c >> 4], 2).reshape(n, LINES).to(torch.int32)
    val = (nib ^ ESCAPE) - ESCAPE
    mark = nib == ESCAPE
    at = starts.reshape(n, 1).long() + torch.cumsum(mark, 1) - 1
    inside = mark & (at >= 0) & (at < esc.numel())
    got = esc[torch.where(inside, at, 0)].to(torch.int32) if esc.numel() \
        else torch.zeros_like(val)
    val = torch.where(mark, torch.where(inside, got, 0), val)
    out.copy_(val.to(torch.int16).reshape(rows + (LINES,)))
    return out
