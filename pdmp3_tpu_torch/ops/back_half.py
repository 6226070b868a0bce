"""The back half of a granule step, and the split granule step built on
it.

``back_half_step`` is the counterpart of ``pdmp3_tpu/ops/pallas_step.py``
``back_half_t`` and the TPU kernel it launches (``_kernel`` ->
``_back_ch``, K4): hybrid synthesis, frequency inversion, polyphase
synthesis and, in fast mode, the quantize, from post-antialias spectra.
In exact mode it returns the raw FIR sums for the caller's float64
quantize, and with ``raw=True`` in fast mode too (the float-PCM route,
``float_granule_step``, packs them as floats).  Its ``prev3`` output is the band-12 carry, x_time[0:3] of
(ch0, subband 0), which the JAX package recomputes beside its kernel
(``_prev3``).

``float_granule_step`` is the float-PCM route of the JAX package's
``decode_granules(float_pcm=True)`` (``pdmp3_tpu/models/decoder.py``),
for every family: the stage-op front half (the LSF families' gains,
intensity sidecar and full-spectrum MS included),
``back_half_step(raw=True)``, ``dsp.float_pack`` and the ``prev_lines``
latch.  ``models.decoder.decode_granules(float_pcm=True)`` takes it; the
serving routes take ``fused_step.fused_granule_step(float_pcm=True)``
(K1-K3's float instances 9-12 on the card) instead, with the same bits.

``split_granule_step`` is the split exact route of
``decode_granules_pallas`` (``pallas_step.py:1636-1666``), and in fast
mode its fast counterpart: the stage-op front half (requantize ->
stereo -> antialias), then ``back_half_step``, then (exact) the float64
quantize, the L|R pack and the ``prev_lines`` gating.  It has the same
contract as ``fused_step.fused_granule_step`` and the same result bit
for bit; it is the route of the per-stream ``models.decoder.TorchDSP``.

``back_half_step`` has two implementations: the plain PyTorch version
``back_half_step_ref`` (the stage ops of ``ops/dsp.py``), taken for CPU
tensors, and the CUDA kernel ``csrc/back_half.cu``, launched for CUDA
tensors: persistent instances 6 (fast), 7 (exact) and 8 (fast, raw
sums) of the granule body's pattern (``launch.granule_launch_info(
device, exact, back_half=True, raw=...)``), over the same back-half
stages as K1 and K2.  Its
bulk copies need 16-byte aligned xa, bt_eff, store, v_blocks and out;
``check_bulk_alignment`` raises otherwise.
"""
from __future__ import annotations

import torch

from . import dsp as D
from .fused_step import (_check, check_state, commit_state, latch_prev,
                         table_ptrs)
from .launch import check_bulk_alignment, check_operands, launch
from .rounding import qz_f64

_F32 = torch.float32


def back_half_step(xa, state, bt_eff, active, exact: bool,
                   raw: bool = False):
    """Back half for B slots.

    xa f32 [B,2,32,18] post-antialias spectra; state (store f32
    [B,2,32,18], v_blocks f32 [B,2,15,64]) is updated in place for
    active slots and read, not written, for idle ones; bt_eff int32
    [B,2,32] the effective block type of each subband (0 for the two
    long subbands of a mixed block); active int32 [B].

    Returns (out f32 [B,2,576], prev3 f32 [B,3]): out holds the raw FIR
    sums in exact mode, and in fast mode with raw (the bits fast mode
    quantizes), else the quantized samples as floats; zeros for idle
    slots; prev3 is x_time[0:3] of (ch0, subband 0) for every slot.  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (instance 7 when exact, else 8 with raw, else 6)."""
    B = xa.shape[0]
    check_operands(xa.device, ("xa", xa, (B, 2, 32, 18), _F32),
                   ("bt_eff", bt_eff, (B, 2, 32), torch.int32),
                   ("active", active, (B,), torch.int32))
    check_state(state, B, xa.device)
    if xa.device.type == "cpu":
        return back_half_step_ref(xa, state, bt_eff, active, exact, raw)
    if xa.device.type != "cuda":
        raise ValueError(f"no back half for {xa.device}")
    out = torch.empty((B, 2, 576), dtype=_F32, device=xa.device)
    prev3 = torch.empty((B, 3), dtype=_F32, device=xa.device)
    if B == 0:
        return out, prev3
    check_bulk_alignment(xa=xa, bt_eff=bt_eff, active=active,
                         store=state.store, v_blocks=state.v_blocks,
                         out=out)
    ptr = [t.data_ptr() for t in (xa, bt_eff, active, state.store,
                                  state.v_blocks, out, prev3)]
    launch("back_half_raw" if raw and not exact else "back_half",
           "pdmp3_back_half", xa.device, *ptr, table_ptrs(xa.device), B,
           int(bool(exact)), int(bool(raw)))
    return out, prev3


def back_half_step_ref(xa, state, bt_eff, active, exact: bool,
                       raw: bool = False):
    """Plain PyTorch version of back_half_step (same arguments, same
    in-place update, same summation order as the kernel)."""
    x_time, new_store = D.hybrid_synthesis(xa, state.store, bt_eff, exact)
    x_time = D.freq_invert(x_time)
    sums, new_v = D.subband_synthesis(x_time, state.v_blocks, exact)
    sums = torch.where((active != 0)[:, None, None, None], sums,
                       torch.zeros_like(sums))
    out = (sums.reshape(-1, 2, 576) if exact or raw
           else D.quantize(sums, False))
    commit_state(state, active, new_store, new_v)
    return out, x_time[:, 0, 0, 0:3].contiguous()


def _split_back_half(ix, scf_l, scf_s, meta, active, gr1, state,
                     bug_compat, exact, family, is_pos, raw):
    """The split route up to the pack: the stage-op front half and
    back_half_step.  Returns (out, prev3, nch)."""
    _check(ix, scf_l, scf_s, meta, active, gr1, state, family, is_pos)
    f = D.fields(meta)
    xa = D.front_half(ix, scf_l, scf_s, meta, gr1, state.prev_lines,
                      exact, bug_compat, family, is_pos)
    bt_eff = D.effective_block_types(f.win_switch, f.block_type, f.mixed)
    out, prev3 = back_half_step(xa, state, bt_eff, active, exact, raw)
    return out, prev3, f.nch


def split_granule_step(ix, scf_l, scf_s, meta, active, gr1: int, state,
                       bug_compat: bool = True, exact: bool = False,
                       family: int = 0, is_pos=None):
    """One granule step on the split route: the same contract (the LSF
    families included) and the same bits as
    fused_step.fused_granule_step, with the back half as its own kernel
    (K4) on CUDA tensors."""
    out, prev3, nch = _split_back_half(ix, scf_l, scf_s, meta, active, gr1,
                                       state, bug_compat, exact, family,
                                       is_pos, False)
    pcm = D.pack(qz_f64(out) if exact else out, nch, active)
    latch_prev(state, active, gr1, prev3)
    return pcm, state


def float_granule_step(ix, scf_l, scf_s, meta, active, gr1: int, state,
                       bug_compat: bool = True, exact: bool = False,
                       family: int = 0, is_pos=None):
    """One granule step with float PCM: split_granule_step's contract
    (the LSF families included), but the raw FIR sums (K4 instance 7
    exact, 8 fast, on CUDA tensors) packed by dsp.float_pack, f32
    [B,576,2] in [-1, 1], zeros for idle slots.  Every family takes it
    here; only the serving pools keep float PCM to MPEG-1, as in the JAX
    package."""
    out, prev3, nch = _split_back_half(ix, scf_l, scf_s, meta, active, gr1,
                                       state, bug_compat, exact, family,
                                       is_pos, True)
    pcm = D.float_pack(out.view(-1, 2, 18, 32), nch, active)
    latch_prev(state, active, gr1, prev3)
    return pcm, state
