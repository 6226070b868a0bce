"""Batched Layer I/II decode: the polyphase synthesis of requantized
subband samples (the reference rejects layer != 3, pdmp3.c:1240/1312).

Counterpart of ``pdmp3_tpu/models/l12.py``.  The frontend
(``frontend.py``, the native parse) parses AND requantizes a Layer I/II
frame for the per-stream and oracle routes, so their device step is the
synthesis filterbank alone:

    sb_samples f32 [B, 2, S, 32]  ->  synthesis  ->  PCM [B, S*32, 2]

with S = 12 (Layer I) or 36 (Layer II) time steps per frame and the same
per-slot v_blocks FIFO as Layer III (``ops.dsp.subband_synthesis``
takes any S).  One layer per batch, as one family per LSF pool.  The
pools' wire carries the coded frames instead, and their step requantizes
on the device first (``decode_l12_wire``).

The JAX package runs this step as XLA ops with no Pallas kernel; here
it is ``ops.l12_synth.l12_synth_step``: K7, a hand-written CUDA kernel
(``csrc/l12_synth.cu``), on CUDA tensors, and its plain PyTorch version
on the CPU.  Exact form sums the matrixing sequentially from the first
product (``dsp._dot_seq``, no matmul, whose reduction order the library
chooses) and quantizes through float64: it is bitwise equal to the
oracle's synthesis.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.l12_requant import BODY_BYTES, SIDE_BYTES, l12_requant
from ..ops.l12_requant import steps as l12_steps
from ..ops.l12_synth import l12_synth_step
from ..utils.trace import span


@dataclass
class L12State:
    """Per-slot recurrent synthesis state (the reference's function-static
    v_vec, pdmp3.c:1983, per stream here)."""
    v_blocks: torch.Tensor    # f32 [B,2,15,64] polyphase FIFO, oldest first


def init_l12_state(batch_size: int, device) -> L12State:
    """Zero synthesis FIFO for batch_size slots on ``device``."""
    return L12State(v_blocks=torch.zeros((batch_size, 2, 15, 64),
                                         dtype=torch.float32, device=device))


def l12_state_from_jax(v_blocks, device) -> L12State:
    """L12State from the JAX package's (numpy [B,2,15,64], e.g. a
    checkpoint its L12StreamDecoder saved), on ``device``."""
    return L12State(v_blocks=torch.from_numpy(
        np.array(v_blocks, dtype=np.float32, order="C")).to(device))


def decode_l12_frames(sb_samples, nch, active, state: L12State,
                      exact: bool = True, float_pcm: bool = False):
    """One batched Layer I/II frame step.

    sb_samples f32 [B,2,S,32] requantized subband samples (S = 12 Layer
    I, 36 Layer II); nch int [B]; active int [B] (0 = idle slot: silent
    PCM, state frozen).  Returns (pcm int16 [B, S*32, 2], or f32 in
    [-1, 1] with float_pcm, and the L12State, whose FIFO is updated in
    place).  K7 on CUDA tensors (``ops.l12_synth``)."""
    return l12_synth_step(sb_samples, nch, active, state, exact, float_pcm)


def batch_from_frames(fds: list, layer: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-stream FrameData (None for a starved slot) as the step's
    (sb_samples f32 [B,2,S,32], nch int32 [B], active int32 [B])."""
    S = l12_steps(layer)
    B = len(fds)
    sb = np.zeros((B, 2, S, 32), np.float32)
    nch = np.ones(B, np.int32)
    active = np.zeros(B, np.int32)
    for b, fd in enumerate(fds):
        if fd is None or fd.sb_samples is None:
            continue
        if fd.sb_samples.shape[1] != S:
            raise ValueError(f"slot {b}: {fd.sb_samples.shape[1]} steps "
                             f"in a Layer {layer} batch (S = {S})")
        sb[b] = fd.sb_samples
        nch[b] = fd.header.nch
        active[b] = 1
    return sb, nch, active


class TorchL12:
    """Per-stream Layer I/II adapter with the OracleDSP.decode_frame
    interface: packed PCM uint32 [2, 576] per frame (Layer I fills the
    first 384 words, Layer II all 1152).  Counterpart of JaxL12."""

    def __init__(self, exact: bool = True, *, device):
        self.exact = exact
        self.device = torch.device(device)
        self.state = init_l12_state(1, self.device)

    def reset(self) -> None:
        self.state = init_l12_state(1, self.device)

    def decode_frame(self, fd) -> np.ndarray:
        if fd.sb_samples is None:
            raise ValueError("TorchL12 decodes Layer I/II frames")
        S = fd.sb_samples.shape[1]
        sb = torch.from_numpy(np.ascontiguousarray(
            fd.sb_samples[None], np.float32)).to(self.device)
        nch = torch.tensor([fd.header.nch], dtype=torch.int32,
                           device=self.device)
        act = torch.ones(1, dtype=torch.int32, device=self.device)
        pcm, self.state = decode_l12_frames(sb, nch, act, self.state,
                                            self.exact)
        pcm = pcm[0].cpu().numpy()                        # [S*32, 2]
        left = pcm[:, 0].astype(np.uint16).astype(np.uint32)
        right = pcm[:, 1].astype(np.uint16).astype(np.uint32)
        out = np.zeros(1152, np.uint32)
        out[:S * 32] = (left << 16) | right
        return out.reshape(2, 576)


# ---------------------------------------------------------------------------
# The Layer I/II pool wire (the native packer
# pdmp3_parse_step_wire_l12_codes, host/src/wire_l12_codes.cc): each
# slot-frame's coded body bytes uint8 [F,B,2000] and side record uint8
# [F,B,384] (class, scalefactor indices and code offset by (ch, sb)),
# meta int16 [F,B,4] {nch, rate / 25, layer, family}, geom int16 [F,B,2]
# {the samples' first bit, a group's bits}, active int16 [B] for F = 1,
# else [F,B].  The port packs the sections into one byte buffer, each
# 16-byte aligned, so a step is one upload; the device requantizes
# (ops.l12_requant, K9) before the synthesis.
# ---------------------------------------------------------------------------

def l12_layout(B: int, layer: int, F: int = 1) -> dict:
    """Byte offsets of the sections of the packed Layer I/II wire: name
    -> (offset, bytes), plus 'total'."""
    return dict(_layout(B, layer, F))


@functools.lru_cache(maxsize=64)
def _layout(B: int, layer: int, F: int) -> tuple:
    l12_steps(layer)
    off, pos = [], 0
    for name, n in (("body", F * B * BODY_BYTES), ("side", F * B * SIDE_BYTES),
                    ("meta", F * B * 4 * 2), ("geom", F * B * 2 * 2),
                    ("active", F * B * 2)):
        off.append((name, (pos, n)))
        pos += -(-n // 16) * 16
    return tuple(off) + (("total", pos),)


def l12_sections(buf, B: int, layer: int, F: int = 1) -> dict:
    """Views of the packed Layer I/II wire (uint8 [l12_layout(B, layer,
    F)['total']], host or device) by section: body uint8 [F,B,2000],
    side uint8 [F,B,384], meta int16 [F,B,4], geom int16 [F,B,2], active
    int16 [B] for F = 1, else [F,B]."""
    off = l12_layout(B, layer, F)
    if buf.dtype != torch.uint8 or tuple(buf.shape) != (off["total"],):
        raise ValueError(f"wire must be uint8 [{off['total']}], got "
                         f"{buf.dtype} {tuple(buf.shape)}")

    # one dtype view and a strided view a section: a step's enqueue
    # takes these views of each uploaded wire
    b16 = buf.view(torch.int16)

    def sec(name, t, shape):
        at = t.storage_offset() + off[name][0] // t.element_size()
        strides = [1] * len(shape)
        for i in range(len(shape) - 1, 0, -1):
            strides[i - 1] = strides[i] * shape[i]
        return t.as_strided(shape, strides, at)
    return {"body": sec("body", buf, (F, B, BODY_BYTES)),
            "side": sec("side", buf, (F, B, SIDE_BYTES)),
            "meta": sec("meta", b16, (F, B, 4)),
            "geom": sec("geom", b16, (F, B, 2)),
            "active": sec("active", b16, (B,) if F == 1 else (F, B))}


def decode_l12_wire(buf, state: L12State, B: int, layer: int, F: int = 1,
                    exact: bool = True, float_pcm: bool = False, sb=None):
    """The F frames of the packed Layer I/II wire: their requantization
    (``ops.l12_requant``, K9 on CUDA: one launch) into `sb` (f32
    [F,B,2,S,32], a buffer the caller keeps; made here when None) in the
    program's span ``step.requant``, then decode_l12_frames a frame, each
    call into K7 in ``step.launch`` and the frames' join (F > 1) in
    ``step.join``, as the granule steps' (``models.decoder``).  Returns
    (pcm int16 [B, F*S*32, 2], f32 with float_pcm; the new L12State)."""
    w = l12_sections(buf, B, layer, F)
    active = w["active"].view(F, B)
    with span("step.requant"):
        sb = l12_requant(w["body"], w["side"], w["geom"], layer, out=sb)
    pcms = []
    for f in range(F):
        with span("step.launch"):
            pcm, state = decode_l12_frames(sb[f], w["meta"][f, :, 0],
                                           active[f], state, exact,
                                           float_pcm)
        pcms.append(pcm)
    if F == 1:
        return pcms[0], state
    with span("step.join"):
        return torch.cat(pcms, 1), state
