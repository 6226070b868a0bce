"""The batched, stateful Layer III granule decoder over the packed wire.

Counterpart of ``pdmp3_tpu/models/decoder.py`` for the fast MPEG-1
serving path.  One frame step decodes one frame per slot as two granule
steps (``ops.fused_step.fused_granule_step``) from the native frontend's
packed int16 wire, threading the per-slot recurrent ``DecoderState``.

State is kept in the canonical slot-major layout ([B,2,32,18],
[B,2,15,64], [B,3]) on every device: one thread block per slot reads its
slot contiguously, and checkpoints need no conversion.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fused_step import META_WORDS, fused_granule_step


@dataclass
class GranuleBatch:
    """One granule step's wire tensors for B slots.

    ix is line-ordered: the host applies the short-block reorder
    (pdmp3.c:1786-1823) while it packs the wire, so the device never
    permutes spectra."""
    ix: torch.Tensor          # int16 [B,2,576]
    scf_l: torch.Tensor       # int16 [B,2,22]
    scf_s: torch.Tensor       # int16 [B,2,39] (13 bands x 3 windows)
    meta: torch.Tensor        # int32 [B,32] PDMP3_META_* words
    active: torch.Tensor      # int32 [B]: 0 = idle slot (state frozen)
    gr1: int                  # 1 = every slot decodes granule 1


@dataclass
class DecoderState:
    """Per-slot recurrent DSP state (pdmp3.c:1755 store, :1983 v_vec).

    prev_lines carries granule 0's first three ch0 output lines into the
    granule-1 step: the reference's scalefac_s[1][1][12][w] read aliases
    their float BITS (docs/DESIGN.md §6), so +0.0, -0.0 and denormals
    there change the next granule's band-12 gain."""
    store: torch.Tensor       # f32 [B,2,32,18] overlap-add store
    v_blocks: torch.Tensor    # f32 [B,2,15,64] polyphase FIFO, oldest first
    prev_lines: torch.Tensor  # f32 [B,3] band-12 carry


def init_state(batch_size: int, device="cpu") -> DecoderState:
    return DecoderState(
        store=torch.zeros((batch_size, 2, 32, 18), dtype=torch.float32,
                          device=device),
        v_blocks=torch.zeros((batch_size, 2, 15, 64), dtype=torch.float32,
                             device=device),
        prev_lines=torch.zeros((batch_size, 3), dtype=torch.float32,
                               device=device))


def state_from_jax(store, v_blocks, prev_lines, device="cpu"
                   ) -> DecoderState:
    """DecoderState from the JAX package's canonical state (numpy arrays
    [B,2,32,18], [B,2,15,64], [B,3]), e.g. a checkpoint it saved."""
    def t(a):
        return torch.from_numpy(
            np.array(a, dtype=np.float32, order="C")).to(device)
    return DecoderState(store=t(store), v_blocks=t(v_blocks),
                        prev_lines=t(prev_lines))


def state_from_pallas(store_t, v_t, prev_lines, device="cpu"
                      ) -> DecoderState:
    """DecoderState from the JAX Pallas kernel's feature-major state
    (numpy store_t [2,18,32,B], v_t [2,15,64,B], prev_lines [B,3])."""
    return state_from_jax(np.asarray(store_t).transpose(3, 0, 2, 1),
                          np.asarray(v_t).transpose(3, 0, 1, 2),
                          prev_lines, device)


def _batch_from_meta(ix, scf_l, scf_s, meta, active, gr: int
                     ) -> GranuleBatch:
    # meta/active are widened to int32: in int16 the exponent-bitcast
    # gains ((n+127) << 23) overflow and the slot decodes to silence
    return GranuleBatch(ix=ix, scf_l=scf_l, scf_s=scf_s,
                        meta=meta.to(torch.int32).contiguous(),
                        active=active.to(torch.int32).contiguous(), gr1=gr)


def decode_frame_soa(ix2, scf_l2, scf_s2, meta2, active, state,
                     bug_compat: bool = True):
    """Decode one frame per slot (two granule steps) from the wire's
    section tensors: ix2 int16 [2,B,2,576], scf_l2 int16 [2,B,2,22],
    scf_s2 int16 [2,B,2,39], meta2 [2,B,32], active [B].
    Returns (pcm int16 [B,1152,2], state updated in place)."""
    pcms = []
    for gr in range(2):
        b = _batch_from_meta(ix2[gr], scf_l2[gr], scf_s2[gr], meta2[gr],
                             active, gr)
        pcm, state = fused_granule_step(b.ix, b.scf_l, b.scf_s, b.meta,
                                        b.active, b.gr1, state, bug_compat)
        pcms.append(pcm)
    return torch.cat(pcms, 1), state


def soa_layout(B: int, F: int = 1) -> dict:
    """Element offsets (int16 units) of the packed single-buffer wire
    covering F frames per slot (the native pdmp3_parse_step_wire16
    layout): name -> (offset, length), plus 'total'.  Each section
    starts 4-byte aligned."""
    off = {}
    pos = 0

    def sec(name, nelems):
        nonlocal pos
        off[name] = (pos, nelems)
        pos += (nelems + 1) & ~1

    sec("ix", F * 2 * B * 2 * 576)
    sec("scf_l", F * 2 * B * 2 * 22)
    sec("scf_s", F * 2 * B * 2 * 39)
    sec("meta", F * 2 * B * META_WORDS)
    sec("active", F * B)
    off["total"] = pos
    return off


def wire_sections(buf, B: int) -> dict:
    """Views of the packed one-frame wire (int16 [soa_layout(B)['total']])
    by section: ix [2,B,2,576], scf_l [2,B,2,22], scf_s [2,B,2,39],
    meta [2,B,32], active [B] (leading axis: granule)."""
    off = soa_layout(B)
    if buf.dtype != torch.int16 or tuple(buf.shape) != (off["total"],):
        raise ValueError(f"wire must be int16 [{off['total']}], got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    shapes = dict(ix=(2, B, 2, 576), scf_l=(2, B, 2, 22),
                  scf_s=(2, B, 2, 39), meta=(2, B, META_WORDS),
                  active=(B,))
    return {name: buf[off[name][0]:off[name][0] + off[name][1]].view(shape)
            for name, shape in shapes.items()}


def decode_frame_packed(buf, state, B: int, bug_compat: bool = True):
    """decode_frame_soa over the packed one-frame wire, on the decode
    device.  Returns (pcm int16 [B,1152,2], state updated in place)."""
    w = wire_sections(buf, B)
    return decode_frame_soa(w["ix"], w["scf_l"], w["scf_s"], w["meta"],
                            w["active"], state, bug_compat)
