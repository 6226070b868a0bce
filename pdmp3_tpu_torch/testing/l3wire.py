"""The coded MPEG-1 pool wire (``models.decoder.codes_layout``) and the
dense one (``soa_layout``), each from the other, for the tests and tools
that read an MPEG-1 pool's spectra.

``dense_wire`` widens a coded wire's rows with the plain version of K10
(``ops.l3_expand.l3_expand_ref``) and copies its other sections into a
dense wire, which ``models.decoder.wire_sections`` reads as before.
``coded_wire`` codes a dense wire as the native packer
(``host/src/wire_l3_codes.cc``) does: an inactive slot-frame's rows
zero, each line outside -7..7 an escape, the escape list in slot order
(then frame, granule, channel and line), each row's start the escapes
before it; the list is padded with zeros to a multiple of 8.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import decoder as M
from ..ops.l3_expand import CODE_BYTES, ESCAPE, l3_expand_ref

# the sections the two wires share
SHARED = ("scf_l", "scf_s", "meta", "active")


def _cpu(wire) -> torch.Tensor:
    return (torch.from_numpy(np.ascontiguousarray(wire))
            if isinstance(wire, np.ndarray) else wire.cpu())


def dense_wire(wire, B: int, F: int = 1) -> torch.Tensor:
    """The dense wire int16 [soa_layout(B, F)['total']] (on the CPU) of a
    coded wire (uint8, a tensor on any device or a numpy array): the
    rows widened, scf_l, scf_s, meta and active copied."""
    w = M.codes_sections(_cpu(wire), B, F)
    out = torch.zeros(M.soa_layout(B, F)["total"], dtype=torch.int16)
    d = M.wire_sections(out, B, F)
    l3_expand_ref(w["codes"], w["starts"], w["esc"], out=d["ix"])
    for name in SHARED:
        d[name].copy_(w[name])
    return out


def pool_dense_wire(pool) -> torch.Tensor:
    """dense_wire of the buffer an MPEG-1 ``StreamDecoder`` shows (the
    one last parsed or decoded)."""
    return dense_wire(pool.wire, pool.n, pool.F)


def coded_wire(wire, B: int, F: int = 1) -> torch.Tensor:
    """The coded wire uint8 [codes_layout(B, F)['fixed'] + 2 n] (on the
    CPU) of a dense wire (int16, a tensor or a numpy array), n its
    escapes rounded up to a multiple of 8."""
    d = {k: v.numpy() for k, v in M.wire_sections(_cpu(wire), B, F).items()}
    G = 2 * F
    act = np.repeat(d["active"].reshape(F, 1, B, 1) != 0, 2, 1)
    ix = np.where(act.reshape(G, B, 1, 1), d["ix"], 0).astype(np.int32)
    esc = (ix < -7) | (ix > 7)
    nib = np.where(esc, ESCAPE, ix & 0xF).astype(np.uint8)
    codes = nib[..., 0::2] | (nib[..., 1::2] << 4)
    # slot-major: [B, G, 2, 576]
    order = (1, 0, 2, 3)
    vals = ix.transpose(order)[esc.transpose(order)].astype(np.int16)
    per_row = esc.sum(-1).transpose(1, 0, 2).reshape(-1)
    starts = (np.cumsum(per_row) - per_row).reshape(B, G, 2).transpose(
        1, 0, 2)
    n = -(-len(vals) // 8) * 8
    lay = M.codes_layout(B, F)
    out = torch.zeros(lay["fixed"] + 2 * n, dtype=torch.uint8)
    w = M.codes_sections(out, B, F)
    w["codes"].copy_(torch.from_numpy(codes.reshape(G, B, 2, CODE_BYTES)))
    w["starts"].copy_(torch.from_numpy(starts.astype(np.int32)))
    w["esc"][:len(vals)].copy_(torch.from_numpy(vals))
    for name in SHARED:
        w[name].copy_(torch.from_numpy(d[name]))
    return out
