"""The frame-fused fast step: ng granule steps of one family in one
launch, the recurrent state crossing the granules on chip.

Counterpart of ``pdmp3_tpu/ops/pallas_step.py`` ``frame_step_t`` and the
TPU kernel it launches (``_kernel_frame``, K5), with the glue of
``decode_frames_pallas`` (the L|R pack, the band-12 carry chained from a
parity-0 granule to the parity-1 granule after it, the gated
``prev_lines``).  Fast precision only, as on the TPU: exact steps stay
per granule.

``frame_step`` has two implementations with one contract:

- ``frame_step_ref``: plain PyTorch, the plain granule step
  (``fused_step.fused_granule_step_ref``) chained over the granules; the
  reference the tests and ``chip_smoke.py`` hold the kernel against, and
  the path for CPU tensors;
- the hand-written CUDA kernel of ``csrc/frame_fused.cu`` (an MPEG-1 and
  an LSF instance), launched for CUDA tensors.  There is no fallback: a
  CUDA tensor either runs the kernel or raises.

K5 runs the persistent body of K1-K3 (``launch.granule_launch_info(
device, family=f, frame=True)`` gives its grid): it bulk-copies each
granule's ix and meta and each slot's store and v_blocks, and writes
each granule's PCM back by bulk copy, so those need 16-byte aligned
addresses; scf_l, scf_s, is_pos, prev_lines and active arrive by 4-byte
copies (``launch.check_bulk_alignment``).

The operands are the wire's per-granule sections stacked on a leading
granule axis, slot-major (``[ng,B,...]``), which is how a frame of the
packed wire already lies in memory: the frame step reads them where they
are, with no transposing or stacking copy.
"""
from __future__ import annotations

import torch

from . import dsp as D
from .fused_step import check_state, fused_granule_step_ref, table_ptrs
from .launch import check_bulk_alignment, check_operands, launch


def _check(ix, scf_l, scf_s, meta, active, parities, state, family,
           is_pos) -> tuple[int, int]:
    """Validate the frame step's operands; returns (ng, B)."""
    ng, B = ix.shape[:2]
    check_operands(ix.device, ("ix", ix, (ng, B, 2, 576), torch.int16),
                   ("scf_l", scf_l, (ng, B, 2, 22), torch.int16),
                   ("scf_s", scf_s, (ng, B, 2, 39), torch.int16),
                   ("meta", meta, (ng, B, D.META_WORDS), torch.int32),
                   ("active", active, (ng, B), torch.int32))
    check_state(state, B, ix.device)
    if family not in (0, 1, 2):
        raise ValueError(f"family must be 0, 1 or 2, got {family!r}")
    parities = tuple(parities)
    if (len(parities) != ng or not 1 <= ng <= 32
            or any(p not in (0, 1) for p in parities)
            or (family and any(parities))):
        raise ValueError(f"parities must be {ng} (1..32) flags 0 or 1, all "
                         f"0 for LSF; got {parities!r}")
    if family:
        if is_pos is None:
            raise ValueError("LSF steps need the is_pos sidecar")
        check_operands(ix.device, ("is_pos", is_pos, (ng, B, 64),
                                   torch.int16))
    return ng, B


def frame_step(ix, scf_l, scf_s, meta, active, parities, state,
               bug_compat: bool = True, family: int = 0, is_pos=None):
    """ng fast granule steps for B slots of one family in one launch.

    ix int16 [ng,B,2,576] line-ordered spectra; scf_l int16 [ng,B,2,22];
    scf_s int16 [ng,B,2,39]; meta int32 [ng,B,32]; active int32 [ng,B]
    (0 = slot idle in that granule: silent PCM, state frozen); parities:
    ng flags, 1 where the granule is granule 1 of its frame (it takes
    ch1's band-12 scalefactors from the carry the granule before latched);
    state (store f32 [B,2,32,18], v_blocks f32 [B,2,15,64], prev_lines
    f32 [B,3]) is updated in place.  family 1 / 2 (LSF) needs is_pos
    int16 [ng,B,64] and all parities 0.

    Returns (pcm int16 [B, ng*576, 2], the granules' PCM in order along
    time, state).  CPU tensors take the plain version; CUDA tensors
    launch K5."""
    ng, B = _check(ix, scf_l, scf_s, meta, active, parities, state, family,
                   is_pos)
    if ix.device.type == "cpu":
        return frame_step_ref(ix, scf_l, scf_s, meta, active, parities,
                              state, bug_compat, family, is_pos)
    if ix.device.type != "cuda":
        raise ValueError(f"no frame step for {ix.device}")
    pcm = torch.empty((B, ng * 576, 2), dtype=torch.int16, device=ix.device)
    if B == 0:
        return pcm, state
    check_bulk_alignment(ix=ix, meta=meta, store=state.store,
                         v_blocks=state.v_blocks, pcm=pcm, scf_l=scf_l,
                         scf_s=scf_s, prev_lines=state.prev_lines,
                         active=active, **({"is_pos": is_pos} if family
                                           else {}))
    ptr = [None if t is None else t.data_ptr() for t in (
        ix, scf_l, scf_s, meta, active, is_pos if family else None,
        state.store, state.v_blocks, state.prev_lines, pcm)]
    bits = sum(int(p) << g for g, p in enumerate(parities))
    launch("frame_fused_lsf" if family else "frame_fused",
           "pdmp3_frame_fused", ix.device, *ptr,
           table_ptrs(ix.device, family), B, ng, bits,
           int(bool(bug_compat)), int(family != 0))
    return pcm, state


def frame_step_ref(ix, scf_l, scf_s, meta, active, parities, state,
                   bug_compat: bool = True, family: int = 0, is_pos=None):
    """Plain PyTorch version of frame_step (same arguments, same in-place
    state update): fused_granule_step_ref chained over the granules, each
    with gr1 = its parity."""
    pcms = []
    for g, gr1 in enumerate(parities):
        pcm, state = fused_granule_step_ref(
            ix[g], scf_l[g], scf_s[g], meta[g], active[g], int(gr1), state,
            bug_compat, False, family, None if is_pos is None else is_pos[g])
        pcms.append(pcm)
    return torch.cat(pcms, 1), state


def decode_frames(batches, state, parities, bug_compat: bool = True):
    """frame_step over granule batches (``models.decoder.GranuleBatch``,
    one per granule in decode order, all of one family): the counterpart
    of ``decode_frames_pallas``.  Each batch's gr1 must equal its
    granule's parity, else ValueError (a desynchronised batch would
    decode wrong band-12 gains).  Stacks the batches' operands; returns
    (pcm int16 [B, ng*576, 2], state updated in place)."""
    parities = tuple(parities)
    if len(batches) != len(parities):
        raise ValueError(f"{len(batches)} batches for {len(parities)} "
                         "parities")
    for g, (b, p) in enumerate(zip(batches, parities)):
        if b.gr1 != p:
            raise ValueError(f"granule {g}: gr1 {b.gr1} but parity {p}")
    family = batches[0].family
    if any(b.family != family for b in batches):
        raise ValueError("mixed-family granules")

    def stack(name):
        return torch.stack([getattr(b, name) for b in batches])
    return frame_step(stack("ix"), stack("scf_l"), stack("scf_s"),
                      stack("meta"), stack("active"), parities, state,
                      bug_compat, family,
                      stack("is_pos") if family else None)
