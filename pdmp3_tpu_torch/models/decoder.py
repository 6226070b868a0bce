"""The batched, stateful Layer III granule decoder.

Counterpart of ``pdmp3_tpu/models/decoder.py`` for MPEG-1 (family 0) and
the LSF families (1 MPEG-2, 2 MPEG-2.5), in fast and exact precision.
Three routes:

- serving: one step decodes F frames per slot from the native
  frontend's packed int16 wire, dense (``decode_frame_packed``,
  ``decode_frame_packed_lsf``) or sparse (``decode_frame_sparse``,
  ``decode_frame_lsf_sparse``: count1-bounded 128-line blocks that the
  device re-densifies), with the fused granule step
  (``ops.fused_step.fused_granule_step``): an MPEG-1 frame as two
  granule steps (K1 fast, K2 exact on CUDA), or, fast and with
  ``_FRAME_FUSED`` set, as one frame step (``ops.frame_step``, K5 on
  CUDA); an LSF frame as one granule step (K3 on CUDA), whose wire has
  no granule axis and one more section, the intensity sidecar;
- float PCM (``float_pcm=True``: MPEG-1 serving, and every family in
  ``decode_granules``, ``decode_frame_lsf_soa`` and
  ``decode_frame_packed_lsf``): the serving routes run each granule as
  the fused step with float PCM (K1, K2, K3's float instances 9-12 on
  CUDA: one launch, no stage op); ``decode_granules`` keeps the JAX
  package's split route with raw sums (``ops.back_half.
  float_granule_step``: the stage-op front half, K4 instance 7 exact or
  8 fast, ``float_pack``), with the same bits;
- per stream: ``TorchDSP`` plugs into the port's streaming API
  (``pdmp3_tpu_torch.api``) and decodes parsed ``FrameData`` of either
  kind through ``frame_to_batches`` and ``decode_granules``, the split
  route (stage-op front half, then the back-half kernel K4 on CUDA), and
  Layer I/II frames through ``models.l12.TorchL12``.

All thread the per-slot recurrent ``DecoderState`` and give the same
bits.

State is kept in the canonical slot-major layout ([B,2,32,18],
[B,2,15,64], [B,3]) on every device: one thread block per slot reads its
slot contiguously, and checkpoints need no conversion.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import tables as T
from ..ops import dsp as D
from ..ops.back_half import float_granule_step, split_granule_step
from ..ops.dsp import META_WORDS
from ..ops.frame_step import frame_step
from ..ops.fused_step import fused_granule_step
from ..utils.trace import span

# The frame-fused opt-in, the JAX package's own: read once at import from
# PDMP3_FRAME_FUSED; set the module attribute to change it in a process.
_FRAME_FUSED = os.environ.get("PDMP3_FRAME_FUSED") == "1"


@dataclass
class GranuleBatch:
    """One granule step's wire tensors for B slots of one family.

    ix is line-ordered: the host applies the family's short-block reorder
    (pdmp3.c:1786-1823) while it packs the wire, so the device never
    permutes spectra."""
    ix: torch.Tensor          # int16 [B,2,576]
    scf_l: torch.Tensor       # int16 [B,2,22]
    scf_s: torch.Tensor       # int16 [B,2,39] (13 bands x 3 windows)
    meta: torch.Tensor        # int32 [B,32] PDMP3_META_* words
    active: torch.Tensor      # int32 [B]: 0 = idle slot (state frozen)
    gr1: int                  # 1 = every slot decodes granule 1
    family: int = 0           # 0 MPEG-1, 1 MPEG-2, 2 MPEG-2.5
    # LSF only: ch1's intensity positions ([0..21] long, [22..60] short
    # flat, 63 = illegal); iscale rides meta word 27
    is_pos: torch.Tensor | None = None   # int16 [B,64]


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


def init_state(batch_size: int, device) -> DecoderState:
    """Zero state for batch_size slots on ``device``."""
    return DecoderState(
        store=torch.zeros((batch_size, 2, 32, 18), dtype=torch.float32,
                          device=device),
        v_blocks=torch.zeros((batch_size, 2, 15, 64), dtype=torch.float32,
                             device=device),
        prev_lines=torch.zeros((batch_size, 3), dtype=torch.float32,
                               device=device))


def state_from_jax(store, v_blocks, prev_lines, device) -> DecoderState:
    """DecoderState from the JAX package's canonical state (numpy arrays
    [B,2,32,18], [B,2,15,64], [B,3]), e.g. a checkpoint it saved, on
    ``device``."""
    def t(a):
        return torch.from_numpy(
            np.array(a, dtype=np.float32, order="C")).to(device)
    return DecoderState(store=t(store), v_blocks=t(v_blocks),
                        prev_lines=t(prev_lines))


def state_from_pallas(store_t, v_t, prev_lines, device) -> DecoderState:
    """DecoderState from the JAX Pallas kernel's feature-major state
    (numpy store_t [2,18,32,B], v_t [2,15,64,B], prev_lines [B,3]), on
    ``device``."""
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
                    exact: bool = True, bug_compat: bool = True,
                    float_pcm: bool = False, family: int | None = None):
    """One batched granule step on the split route
    (ops.back_half.split_granule_step): the stage-op front half, the back
    half (K4 on CUDA) and the pack.  Returns (pcm int16 [B,576,2], state
    updated in place); the same bits as the fused step.  float_pcm=True
    returns f32 [B,576,2] in [-1, 1] instead, zeros for idle slots
    (ops.back_half.float_granule_step: K4's raw sums, dsp.float_pack), in
    every family.  The batch carries its family; ``family``, the JAX
    package's argument, must equal it when given (ValueError)."""
    if family is not None and family != batch.family:
        raise ValueError(f"family={family!r} but the batch is of family "
                         f"{batch.family!r}")
    step = float_granule_step if float_pcm else split_granule_step
    return step(batch.ix, batch.scf_l, batch.scf_s, batch.meta,
                batch.active, batch.gr1, state, bug_compat, exact,
                batch.family, batch.is_pos)


def frame_to_batches(fds, device) -> list[GranuleBatch]:
    """One parsed Layer III frame per slot
    (``pdmp3_tpu_torch.frontend.FrameData``), all of one family, as the
    frame's granule steps' wire-form batches on ``device`` (two for
    MPEG-1, one for LSF): ix reordered to line order as the native wire
    packs it, meta words in the PDMP3_META_* layout of the int16 wire
    (sample rate / 25; family and iscale for LSF), LSF frames' intensity
    sidecar from ``fd.is_eff_l``/``is_eff_s`` (illegal = 63 where the
    frame has none), every slot active."""
    if any(fd.sb_samples is not None for fd in fds):
        raise ValueError("Layer I/II frames carry subband samples, not "
                         "granules: decode them with models.l12")
    family = fds[0].header.family
    if any(fd.header.family != family for fd in fds):
        raise ValueError("mixed-family batch: route streams to "
                         "per-family pools")
    perm = T.layout_maps(family)["reorder"]
    B = len(fds)
    ip = None
    if family:
        ip = np.full((B, 64), T.LSF_IS_ILLEGAL, np.int16)
        ip[:, 61:] = 0   # pad words, zero as the native packer writes them
        for b, fd in enumerate(fds):
            if fd.is_eff_l is not None:
                ip[b, :22] = fd.is_eff_l
                ip[b, 22:61] = np.asarray(fd.is_eff_s).reshape(39)
    out = []
    for gr in range(fds[0].header.ngr):
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
            m[D.M_FAMILY] = family
            m[D.M_ISCALE] = fd.intensity_scale
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
            active=t(np.ones(B, np.int32)), gr1=gr, family=family,
            is_pos=None if ip is None else t(ip)))
    return out


def decode_frame_soa(ix2, scf_l2, scf_s2, meta2, active, state,
                     bug_compat: bool = True, exact: bool = False,
                     float_pcm: bool = False):
    """Decode one frame per slot (two granule steps) from the wire's
    section tensors: ix2 int16 [2,B,2,576], scf_l2 int16 [2,B,2,22],
    scf_s2 int16 [2,B,2,39], meta2 [2,B,32], active [B].  Fast frames
    run as one frame step (K5 on CUDA) when ``_FRAME_FUSED`` is set,
    every other frame as two granule steps (K1 / K2 on CUDA); float PCM
    as two granule steps writing float PCM (instances 9 / 10 on CUDA).
    Returns (pcm int16 [B,1152,2], or f32 [B,1152,2] in [-1, 1] with
    float_pcm; state updated in place)."""
    if _FRAME_FUSED and not exact and not float_pcm:
        act = active.to(torch.int32)
        return frame_step(ix2, scf_l2, scf_s2,
                          meta2.to(torch.int32).contiguous(),
                          torch.stack([act, act]), (0, 1), state,
                          bug_compat)
    pcms = []
    for gr in range(2):
        with span("step.widen"):
            b = _batch_from_meta(ix2[gr], scf_l2[gr], scf_s2[gr],
                                 meta2[gr], active, gr)
        with span("step.launch"):
            pcm, state = fused_granule_step(b.ix, b.scf_l, b.scf_s, b.meta,
                                            b.active, b.gr1, state,
                                            bug_compat, exact,
                                            float_pcm=float_pcm)
        pcms.append(pcm)
    return _join(pcms), state


def _packed_layout(sections) -> dict:
    """Element offsets (int16 units) of the sections [(name, length)]
    packed in order, each starting 4-byte aligned: name -> (offset,
    length), plus 'total'."""
    off, pos = {}, 0
    for name, n in sections:
        off[name] = (pos, n)
        pos += (n + 1) & ~1
    off["total"] = pos
    return off


def _section_views(buf, off: dict, shapes: dict) -> dict:
    """Views of a packed wire buffer by section, in the given shapes."""
    if buf.dtype != torch.int16 or tuple(buf.shape) != (off["total"],):
        raise ValueError(f"wire must be int16 [{off['total']}], got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    return {name: buf[off[name][0]:off[name][0] + off[name][1]].view(shape)
            for name, shape in shapes.items()}


def _active_shape(B: int, F: int) -> tuple:
    # [B] for the one-frame wire, [F,B] for F frames (the JAX package's
    # convention for the active section)
    return (B,) if F == 1 else (F, B)


def _join(pcms: list):
    if len(pcms) == 1:
        return pcms[0]
    with span("step.join"):
        return torch.cat(pcms, 1)


def soa_layout(B: int, F: int = 1) -> dict:
    """Element offsets (int16 units) of the packed single-buffer wire
    covering F frames per slot (the native pdmp3_parse_step_wire16
    layout): name -> (offset, length), plus 'total'."""
    return _packed_layout([
        ("ix", F * 2 * B * 2 * 576), ("scf_l", F * 2 * B * 2 * 22),
        ("scf_s", F * 2 * B * 2 * 39), ("meta", F * 2 * B * META_WORDS),
        ("active", F * B)])


def wire_sections(buf, B: int, F: int = 1) -> dict:
    """Views of the packed F-frame wire (int16 [soa_layout(B, F)
    ['total']]) by section: ix [F*2,B,2,576], scf_l [F*2,B,2,22], scf_s
    [F*2,B,2,39], meta [F*2,B,32] (leading axis: frame-major granule),
    active [B] for F = 1, else [F,B]."""
    return _section_views(buf, soa_layout(B, F), dict(
        ix=(F * 2, B, 2, 576), scf_l=(F * 2, B, 2, 22),
        scf_s=(F * 2, B, 2, 39), meta=(F * 2, B, META_WORDS),
        active=_active_shape(B, F)))


def _decode_frames(w: dict, state, F: int, bug_compat: bool, exact: bool,
                   float_pcm: bool = False):
    """decode_frame_soa over the F frames of MPEG-1 wire sections."""
    active = w["active"].view(F, -1)
    pcms = []
    for f in range(F):
        g = slice(2 * f, 2 * f + 2)
        pcm, state = decode_frame_soa(w["ix"][g], w["scf_l"][g],
                                      w["scf_s"][g], w["meta"][g],
                                      active[f], state, bug_compat, exact,
                                      float_pcm)
        pcms.append(pcm)
    return _join(pcms), state


def decode_frame_packed(buf, state, B: int, F: int = 1,
                        bug_compat: bool = True, exact: bool = False,
                        float_pcm: bool = False):
    """decode_frame_soa over the packed F-frame wire, on the decode
    device.  Returns (pcm int16 [B, F*1152, 2], f32 with float_pcm;
    state updated in place)."""
    return _decode_frames(wire_sections(buf, B, F), state, F, bug_compat,
                          exact, float_pcm)


# ---------------------------------------------------------------------------
# LSF pool wire (MPEG-2/2.5, 13818-3): one granule per frame, so the wire
# drops the granule axis and adds the intensity-sidecar section; the
# layout of the native packer pdmp3_parse_step_wire16_lsf (host/api.cc).
# ---------------------------------------------------------------------------

def soa_layout_lsf(B: int, F: int = 1) -> dict:
    """Element offsets (int16 units) of the packed LSF wire covering F
    one-granule frames per slot: name -> (offset, length), plus 'total'.
    Sections ix, scf_l, scf_s, meta, is_pos [F,B,64] ([0..21] long,
    [22..60] short flat, illegal = 63), active."""
    return _packed_layout([
        ("ix", F * B * 2 * 576), ("scf_l", F * B * 2 * 22),
        ("scf_s", F * B * 2 * 39), ("meta", F * B * META_WORDS),
        ("is_pos", F * B * 64), ("active", F * B)])


def wire_sections_lsf(buf, B: int, F: int = 1) -> dict:
    """Views of the packed F-frame LSF wire (int16
    [soa_layout_lsf(B, F)['total']]) by section: ix [F,B,2,576], scf_l
    [F,B,2,22], scf_s [F,B,2,39], meta [F,B,32], is_pos [F,B,64], active
    [B] for F = 1, else [F,B]."""
    return _section_views(buf, soa_layout_lsf(B, F), dict(
        ix=(F, B, 2, 576), scf_l=(F, B, 2, 22), scf_s=(F, B, 2, 39),
        meta=(F, B, META_WORDS), is_pos=(F, B, 64),
        active=_active_shape(B, F)))


def decode_frame_lsf_soa(ix, scf_l, scf_s, meta, is_pos, active, state,
                         family: int, bug_compat: bool = True,
                         exact: bool = False, float_pcm: bool = False):
    """Decode F LSF frames per slot, ONE granule step (a granule-0 step)
    each, from the wire's section tensors: ix int16 [F,B,2,576], scf_l
    int16 [F,B,2,22], scf_s int16 [F,B,2,39], meta [F,B,32], is_pos int16
    [F,B,64], active [F,B]; family 1 or 2.  Each step is the fused one
    (K3 on CUDA; with float_pcm K3's float instances 11 / 12).  Returns (pcm int16 [B, F*576, 2], or f32 in
    [-1, 1] with float_pcm; state updated in place)."""
    if family not in (1, 2):
        raise ValueError(f"LSF family must be 1 or 2, got {family!r}")
    pcms = []
    for f in range(ix.shape[0]):
        with span("step.widen"):
            b = _batch_from_meta(ix[f], scf_l[f], scf_s[f], meta[f],
                                 active[f], 0)
        with span("step.launch"):
            pcm, state = fused_granule_step(b.ix, b.scf_l, b.scf_s, b.meta,
                                            b.active, 0, state, bug_compat,
                                            exact, family, is_pos[f],
                                            float_pcm=float_pcm)
        pcms.append(pcm)
    return _join(pcms), state


def decode_frame_packed_lsf(buf, state, B: int, family: int, F: int = 1,
                            bug_compat: bool = True, exact: bool = False,
                            float_pcm: bool = False):
    """decode_frame_lsf_soa over the packed F-frame LSF wire, on the
    decode device.  Returns (pcm int16 [B, F*576, 2], f32 with float_pcm;
    state updated in place)."""
    w = wire_sections_lsf(buf, B, F)
    return decode_frame_lsf_soa(w["ix"], w["scf_l"], w["scf_s"], w["meta"],
                                w["is_pos"], w["active"].view(F, B), state,
                                family, bug_compat, exact, float_pcm)


# ---------------------------------------------------------------------------
# Sparse count1-bounded wire: every granule's lines are zero from count1 up
# (rzero, pdmp3.c:2108-2111), so the host ships only the 128-line blocks
# that cover each channel's nonzero prefix, plus a block table; the device
# re-densifies them with one gather.  The flat block region sits last, so
# the upload is the prefix that the step's blocks fill (the native packers
# pdmp3_parse_step_wire16_sparse and ..._lsf_sparse, host/api.cc).
# ---------------------------------------------------------------------------

SPARSE_BLOCK = 128          # lines per block
_BLK_WORDS = 4              # {start_lo, start_hi, n_blocks, pad}
_MAX_BLOCKS_PER_CH = 5      # ceil(576 / 128)


def sparse_worst_blocks(B: int, F: int = 1) -> int:
    """Blocks of an F-frame MPEG-1 step whose every channel is full."""
    return F * 2 * B * 2 * _MAX_BLOCKS_PER_CH


def _sparse_layout(fixed, cap_blocks: int) -> dict:
    off = _packed_layout([*fixed, ("ix_flat", cap_blocks * SPARSE_BLOCK)])
    off["fixed"] = off["ix_flat"][0]
    off["cap_blocks"] = cap_blocks
    return off


def sparse_layout(B: int, F: int = 1, cap_blocks: int | None = None) -> dict:
    """Element offsets (int16 units) of the sparse MPEG-1 wire: the fixed
    sections blk [F*2,B,2,4], scf_l, scf_s, meta, active, then the flat
    spectra ix_flat [cap_blocks,128] (default: the worst case), so
    buf[:fixed + cap*128] carries a step whose blocks fit cap."""
    if cap_blocks is None:
        cap_blocks = sparse_worst_blocks(B, F)
    return _sparse_layout([
        ("blk", F * 2 * B * 2 * _BLK_WORDS), ("scf_l", F * 2 * B * 2 * 22),
        ("scf_s", F * 2 * B * 2 * 39), ("meta", F * 2 * B * META_WORDS),
        ("active", F * B)], cap_blocks)


def sparse_layout_lsf(B: int, F: int = 1,
                      cap_blocks: int | None = None) -> dict:
    """The sparse LSF wire: one granule per frame, blk [F,B,2,4], the
    intensity sidecar, the flat spectra last (cf. sparse_layout)."""
    if cap_blocks is None:
        cap_blocks = F * B * 2 * _MAX_BLOCKS_PER_CH
    return _sparse_layout([
        ("blk", F * B * 2 * _BLK_WORDS), ("scf_l", F * B * 2 * 22),
        ("scf_s", F * B * 2 * 39), ("meta", F * B * META_WORDS),
        ("is_pos", F * B * 64), ("active", F * B)], cap_blocks)


def sparse_sections(buf, B: int, F: int = 1,
                    cap_blocks: int | None = None) -> dict:
    """Views of the sparse MPEG-1 wire (int16 [sparse_layout(B, F,
    cap_blocks)['total']]) by section: blk [F*2,B,2,4] and the others as
    wire_sections, ix_flat [cap_blocks,128]."""
    off = sparse_layout(B, F, cap_blocks)
    return _section_views(buf, off, dict(
        blk=(F * 2, B, 2, _BLK_WORDS), scf_l=(F * 2, B, 2, 22),
        scf_s=(F * 2, B, 2, 39), meta=(F * 2, B, META_WORDS),
        active=_active_shape(B, F),
        ix_flat=(off["cap_blocks"], SPARSE_BLOCK)))


def sparse_sections_lsf(buf, B: int, F: int = 1,
                        cap_blocks: int | None = None) -> dict:
    """Views of the sparse LSF wire by section: blk [F,B,2,4] and the
    others as wire_sections_lsf, ix_flat [cap_blocks,128]."""
    off = sparse_layout_lsf(B, F, cap_blocks)
    return _section_views(buf, off, dict(
        blk=(F, B, 2, _BLK_WORDS), scf_l=(F, B, 2, 22),
        scf_s=(F, B, 2, 39), meta=(F, B, META_WORDS), is_pos=(F, B, 64),
        active=_active_shape(B, F),
        ix_flat=(off["cap_blocks"], SPARSE_BLOCK)))


def densify(blk, ix_flat):
    """The dense spectra int16 [..., 576] of a sparse wire: per entry of
    the block table blk [..., 4] ({start_lo, start_hi, n_blocks, pad}),
    n_blocks 128-line rows of ix_flat from row start, zeros beyond them
    (exactly the rzero lines the dense wire carries)."""
    blk = blk.to(torch.int32)
    start = (blk[..., 1] << 16) | (blk[..., 0] & 0xFFFF)
    iota = torch.arange(_MAX_BLOCKS_PER_CH, dtype=torch.int32,
                        device=blk.device)
    mask = iota < blk[..., 2, None]
    rows = torch.where(mask, start[..., None] + iota, 0).clamp_(
        0, ix_flat.shape[0] - 1)
    vals = ix_flat[rows.long()].masked_fill_(~mask[..., None], 0)
    return vals.flatten(-2)[..., :576].contiguous()


def decode_frame_sparse(buf, state, B: int, F: int = 1,
                        cap_blocks: int | None = None,
                        bug_compat: bool = True, exact: bool = False,
                        float_pcm: bool = False):
    """decode_frame_soa over the sparse MPEG-1 wire (buf: int16
    [sparse_layout(B, F, cap_blocks)['total']]): the same PCM and state,
    bit for bit, as the dense wire.  Returns (pcm int16 [B, F*1152, 2],
    f32 with float_pcm; state updated in place)."""
    w = sparse_sections(buf, B, F, cap_blocks)
    w["ix"] = densify(w["blk"], w["ix_flat"])
    return _decode_frames(w, state, F, bug_compat, exact, float_pcm)


def decode_frame_lsf_sparse(buf, state, B: int, family: int, F: int = 1,
                            cap_blocks: int | None = None,
                            bug_compat: bool = True, exact: bool = False):
    """decode_frame_lsf_soa over the sparse LSF wire (buf: int16
    [sparse_layout_lsf(B, F, cap_blocks)['total']]), bit for bit the
    dense LSF wire's result.  Returns (pcm int16 [B, F*576, 2], state
    updated in place)."""
    w = sparse_sections_lsf(buf, B, F, cap_blocks)
    return decode_frame_lsf_soa(densify(w["blk"], w["ix_flat"]), w["scf_l"],
                                w["scf_s"], w["meta"], w["is_pos"],
                                w["active"].view(F, B), state, family,
                                bug_compat, exact)


class TorchDSP:
    """Single-stream DSP adapter with the OracleDSP interface, so the
    port's streaming API (``pdmp3_tpu_torch.api.PDMP3`` / ``decode_file``)
    can decode on the port's backend:
    ``decode_file(data, dsp=TorchDSP(device=...))``, with ``lsf=True``
    for MPEG-2/2.5 streams and ``layers12=True`` for Layer I/II ones.
    Counterpart of the JAX package's JaxDSP: Layer III frames of every
    family on the split route, Layer I/II frames through a lazily made
    ``models.l12.TorchL12``."""

    def __init__(self, exact: bool = True, bug_compat: bool = True, *,
                 device):
        self.exact = exact
        self.bug_compat = bug_compat
        self.device = torch.device(device)
        self.state = init_state(1, self.device)
        self._l12 = None   # the Layer I/II adapter, made at first use

    def reset(self) -> None:
        self.state = init_state(1, self.device)
        if self._l12 is not None:
            self._l12.reset()

    def decode_frame(self, fd) -> np.ndarray:
        """Packed PCM words uint32 [2,576] like the reference's
        ``id->out`` (pdmp3.c:129): left in the high half.  LSF frames
        fill row 0 only (one granule per frame), like OracleDSP; Layer I
        frames the first 384 words."""
        if fd.sb_samples is not None:
            if self._l12 is None:
                from .l12 import TorchL12
                self._l12 = TorchL12(self.exact, device=self.device)
            return self._l12.decode_frame(fd)
        out = np.zeros((2, 576), np.uint32)
        for gr, batch in enumerate(frame_to_batches([fd], self.device)):
            pcm, self.state = decode_granules(batch, self.state, self.exact,
                                              self.bug_compat)
            pcm = pcm[0].cpu().numpy().astype(np.uint16)   # [576,2]
            out[gr] = (pcm[:, 0].astype(np.uint32) << 16) | pcm[:, 1]
        return out
