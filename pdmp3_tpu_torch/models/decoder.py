"""The batched, stateful Layer III granule decoder.

Counterpart of ``pdmp3_tpu/models/decoder.py`` for MPEG-1 (family 0), in
fast and exact precision.  Two routes:

- serving: one frame step decodes one frame per slot as two granule
  steps (``ops.fused_step.fused_granule_step``: K1 fast, K2 exact on
  CUDA) from the native frontend's packed int16 wire
  (``decode_frame_packed``);
- per stream: ``TorchDSP`` plugs into the streaming API
  (``pdmp3_tpu.api``) and decodes parsed ``FrameData`` through
  ``frame_to_batches`` and ``decode_granules``, the split route (stage-op
  front half, then the back-half kernel K4 on CUDA).

Both thread the per-slot recurrent ``DecoderState`` and give the same
bits.

State is kept in the canonical slot-major layout ([B,2,32,18],
[B,2,15,64], [B,3]) on every device: one thread block per slot reads its
slot contiguously, and checkpoints need no conversion.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pdmp3_tpu import tables as T

from ..ops import dsp as D
from ..ops.back_half import split_granule_step
from ..ops.dsp import META_WORDS
from ..ops.fused_step import fused_granule_step


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


def decode_granules(batch: GranuleBatch, state: DecoderState,
                    exact: bool = True, bug_compat: bool = True):
    """One batched granule step on the split route
    (ops.back_half.split_granule_step): the stage-op front half, the back
    half (K4 on CUDA) and the pack.  Returns (pcm int16 [B,576,2], state
    updated in place); the same bits as the fused step."""
    return split_granule_step(batch.ix, batch.scf_l, batch.scf_s,
                              batch.meta, batch.active, batch.gr1, state,
                              bug_compat, exact)


def frame_to_batches(fds, device="cpu") -> list[GranuleBatch]:
    """One parsed MPEG-1 frame per slot (``pdmp3_tpu.frontend.FrameData``)
    as the two granule steps' wire-form batches on ``device``: ix
    reordered to line order as the native wire packs it, meta words in
    the PDMP3_META_* layout of the int16 wire (sample rate / 25), every
    slot active.  Family 0 only."""
    if any(fd.header.family != 0 or fd.sb_samples is not None
           for fd in fds):
        raise NotImplementedError(
            "only MPEG-1 Layer III frames are ported to the PyTorch "
            "backend yet")
    perm = T.layout_maps(0)["reorder"]
    B = len(fds)
    out = []
    for gr in range(2):
        ix = np.zeros((B, 2, 576), np.int16)
        scf_l = np.zeros((B, 2, 22), np.int16)
        scf_s = np.zeros((B, 2, 39), np.int16)
        meta = np.zeros((B, META_WORDS), np.int32)
        for b, fd in enumerate(fds):
            h, s = fd.header, fd.side
            m = meta[b]
            m[D.M_MS] = int(h.mode == 1 and bool(h.mode_extension & 2))
            m[D.M_IS] = int(h.mode == 1 and bool(h.mode_extension & 1))
            m[D.M_NCH] = h.nch
            m[D.M_SAMPLE_RATE] = h.sample_rate // 25
            for ch in range(h.nch):
                lay = T.layout_id(h.sampling_frequency,
                                  int(s.win_switch_flag[gr][ch]),
                                  int(s.block_type[gr][ch]),
                                  int(s.mixed_block_flag[gr][ch]))
                ix[b, ch] = fd.ix[gr][ch][perm[lay]]
                scf_l[b, ch] = fd.scalefac_l[gr][ch]
                scf_s[b, ch] = np.asarray(fd.scalefac_s[gr][ch]).reshape(39)
                for k, v in ((D.M_LAYOUT, lay),
                             (D.M_BT, s.block_type[gr][ch]),
                             (D.M_WSF, s.win_switch_flag[gr][ch]),
                             (D.M_MIXED, s.mixed_block_flag[gr][ch]),
                             (D.M_GG, s.global_gain[gr][ch]),
                             (D.M_SFS, s.scalefac_scale[gr][ch]),
                             (D.M_PRE, s.preflag[gr][ch]),
                             (D.M_C1, s.count1[gr][ch])):
                    m[k + ch] = v
                m[D.M_SBG + 3 * ch:D.M_SBG + 3 * ch + 3] = \
                    s.subblock_gain[gr][ch]

        def t(a):
            return torch.from_numpy(a).to(device)
        out.append(GranuleBatch(
            ix=t(ix), scf_l=t(scf_l), scf_s=t(scf_s), meta=t(meta),
            active=t(np.ones(B, np.int32)), gr1=gr))
    return out


def decode_frame_soa(ix2, scf_l2, scf_s2, meta2, active, state,
                     bug_compat: bool = True, exact: bool = False):
    """Decode one frame per slot (two granule steps) from the wire's
    section tensors: ix2 int16 [2,B,2,576], scf_l2 int16 [2,B,2,22],
    scf_s2 int16 [2,B,2,39], meta2 [2,B,32], active [B].
    Returns (pcm int16 [B,1152,2], state updated in place)."""
    pcms = []
    for gr in range(2):
        b = _batch_from_meta(ix2[gr], scf_l2[gr], scf_s2[gr], meta2[gr],
                             active, gr)
        pcm, state = fused_granule_step(b.ix, b.scf_l, b.scf_s, b.meta,
                                        b.active, b.gr1, state, bug_compat,
                                        exact)
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


def decode_frame_packed(buf, state, B: int, bug_compat: bool = True,
                        exact: bool = False):
    """decode_frame_soa over the packed one-frame wire, on the decode
    device.  Returns (pcm int16 [B,1152,2], state updated in place)."""
    w = wire_sections(buf, B)
    return decode_frame_soa(w["ix"], w["scf_l"], w["scf_s"], w["meta"],
                            w["active"], state, bug_compat, exact)


class TorchDSP:
    """Single-stream DSP adapter with the OracleDSP interface, so the
    streaming API (``pdmp3_tpu.api.PDMP3`` / ``decode_file``) can decode
    on the port's backend: ``decode_file(data, dsp=TorchDSP(device=...))``.
    Counterpart of the JAX package's JaxDSP; MPEG-1 Layer III only
    (Layer I/II and LSF frames raise NotImplementedError)."""

    def __init__(self, exact: bool = True, bug_compat: bool = True, *,
                 device):
        self.exact = exact
        self.bug_compat = bug_compat
        self.device = torch.device(device)
        self.state = init_state(1, self.device)

    def reset(self) -> None:
        self.state = init_state(1, self.device)

    def decode_frame(self, fd) -> np.ndarray:
        """Packed PCM words uint32 [2,576] like the reference's
        ``id->out`` (pdmp3.c:129): left in the high half."""
        out = np.zeros((2, 576), np.uint32)
        for gr, batch in enumerate(frame_to_batches([fd], self.device)):
            pcm, self.state = decode_granules(batch, self.state, self.exact,
                                              self.bug_compat)
            pcm = pcm[0].cpu().numpy().astype(np.uint16)   # [576,2]
            out[gr] = (pcm[:, 0].astype(np.uint32) << 16) | pcm[:, 1]
        return out
