"""One batched Layer I/II synthesis step: the NWIN matrixing of a frame's
S time steps into the per-slot FIFO, the 16-tap D-window FIR, and the
quantize and L|R pack (or the float pack), for B slots of one layer.

Counterpart of the JAX package's ``pdmp3_tpu/models/l12.py``
``decode_l12_frames``, an XLA program there (no Pallas kernel).
``l12_synth_step`` has two implementations with one contract:

- ``l12_synth_step_ref``: plain batched PyTorch, ``dsp.subband_synthesis``
  followed by ``dsp.quantize`` + ``dsp.pack`` or ``dsp.float_pack``; the
  reference the tests hold the kernel against, and the path for CPU
  tensors;
- K7, the hand-written CUDA kernel of ``csrc/l12_synth.cu``, launched
  for CUDA tensors: eight persistent instances (13-20 of
  ``launch.granule_launch_info(..., layer=)``), Layer I (S = 12) or
  Layer II (S = 36), fast or exact, S16 or float PCM.  There is no
  fallback between them: a CUDA tensor either runs the kernel or raises.

The kernel computes the dots of NWIN's 33 unique rows only and writes
the 31 rows that copy or negate one of them from those dots, by the row
map that ``consts.l12_smem_image`` derives from the table (where a
negated row's dot is zero or NaN it takes the image's signed zero for a
row of +0.0 samples, else sums that row again), so it stays bitwise
equal to the plain version.  It brings each slot's sb and
FIFO rows into shared memory by bulk copies, which need 16-byte aligned sb, v_blocks and PCM
(``launch.check_bulk_alignment`` raises otherwise); it reads nch and
active where they lie, int16 or int32 at any element stride (the pool's
wire holds nch as a strided int16 view), so the wire is decoded in
place.

The FIFO (``state.v_blocks``) is updated IN PLACE for active slots and
left untouched for idle ones, by both implementations.
"""
from __future__ import annotations

import torch

from . import dsp as D
from .consts import device_consts
from .launch import check_bulk_alignment, check_operands, launch

_F32 = torch.float32
# K7's launch counter, by [float_pcm][exact] (both layers in each)
_COUNTERS = (("l12_synth", "l12_synth_exact"),
             ("l12_synth_float", "l12_synth_float_exact"))


def _check(sb, nch, active, state) -> tuple[int, int]:
    """Validate the step's operands; returns (B, S)."""
    if sb.dim() != 4 or sb.shape[2] not in (12, 36):
        raise ValueError(f"sb must be f32 [B,2,S,32] with S = 12 or 36, "
                         f"got {tuple(sb.shape)}")
    B, S = sb.shape[0], sb.shape[2]
    check_operands(sb.device, ("sb", sb, (B, 2, S, 32), _F32),
                   ("v_blocks", state.v_blocks, (B, 2, 15, 64), _F32))
    for name, t in (("nch", nch), ("active", active)):
        if tuple(t.shape) != (B,) or t.device != sb.device:
            raise ValueError(f"{name}: want [{B}] on {sb.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    return B, S


def l12_synth_step(sb, nch, active, state, exact: bool = True,
                   float_pcm: bool = False):
    """One Layer I/II frame step for B slots of one layer.

    sb f32 [B,2,S,32] requantized subband samples (S = 12 Layer I, 36
    Layer II), contiguous; nch and active int [B] (0 = idle slot: silent
    PCM, FIFO frozen); state.v_blocks f32 [B,2,15,64], updated in place.
    Returns (pcm int16 [B, S*32, 2] interleaved L/R with mono
    duplicated, or f32 in [-1, 1] with float_pcm; state).  CPU tensors
    take the plain version; CUDA tensors launch K7 (nch and active
    int16 or int32)."""
    B, S = _check(sb, nch, active, state)
    if sb.device.type == "cpu":
        return l12_synth_step_ref(sb, nch, active, state, exact, float_pcm)
    if sb.device.type != "cuda":
        raise ValueError(f"no Layer I/II synthesis step for {sb.device}")
    for name, t in (("nch", nch), ("active", active)):
        if t.dtype not in (torch.int16, torch.int32):
            raise ValueError(f"{name} must be int16 or int32 on CUDA, got "
                             f"{t.dtype}")
    pcm = torch.empty((B, S * 32, 2), device=sb.device,
                      dtype=_F32 if float_pcm else torch.int16)
    if B == 0:
        return pcm, state
    check_bulk_alignment(sb=sb, v_blocks=state.v_blocks, pcm=pcm)
    # K7's table image: the unique NWIN rows packed, synth_d, and the
    # store map of the mirrored rows (consts.l12_smem_image)
    image = device_consts(str(sb.device))["l12_smem"]
    launch(_COUNTERS[bool(float_pcm)][bool(exact)], "pdmp3_l12_synth",
           sb.device, sb.data_ptr(), nch.data_ptr(), nch.element_size(),
           nch.stride(0), active.data_ptr(), active.element_size(),
           active.stride(0), state.v_blocks.data_ptr(), pcm.data_ptr(),
           image.data_ptr(), B, S, int(bool(exact)), int(bool(float_pcm)))
    return pcm, state


def l12_synth_step_ref(sb, nch, active, state, exact: bool = True,
                       float_pcm: bool = False):
    """Plain batched PyTorch version of l12_synth_step (same arguments,
    same in-place FIFO update): every sum in the order the kernel uses
    (dsp.subband_synthesis), so K7 is held to it bit for bit."""
    x_time = sb.transpose(-1, -2)                        # [B,2,32,S]
    sums, new_v = D.subband_synthesis(x_time, state.v_blocks, exact)
    active = active.to(torch.int32)
    nch = nch.to(torch.int32)
    if float_pcm:
        pcm = D.float_pack(sums, nch, active)
    else:
        pcm = D.pack(D.quantize(sums, exact), nch, active)
    act = (active != 0)[:, None, None, None]
    state.v_blocks.copy_(torch.where(act, new_v, state.v_blocks))
    return pcm, state
