"""The back half of a granule step, and the split granule step built on
it.

``back_half_step`` is the counterpart of ``pdmp3_tpu/ops/pallas_step.py``
``back_half_t`` and the TPU kernel it launches (``_kernel`` ->
``_back_ch``, K4): hybrid synthesis, frequency inversion, polyphase
synthesis and, in fast mode, the quantize, from post-antialias spectra.
In exact mode it returns the raw FIR sums for the caller's float64
quantize.  Its ``prev3`` output is the band-12 carry, x_time[0:3] of
(ch0, subband 0), which the JAX package recomputes beside its kernel
(``_prev3``).

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
tensors: persistent instances 6 (fast) and 7 (exact) of the granule
body's pattern (``fused_step.granule_launch_info(device, exact,
back_half=True)``), over the same back-half stages as K1 and K2.  Its
bulk copies need 16-byte aligned xa, bt_eff, store, v_blocks and out;
``check_bulk_alignment`` raises otherwise.
"""
from __future__ import annotations

import ctypes as C

import torch

from . import dsp as D
from .fused_step import (_check, check_bulk_alignment, check_operands,
                         check_state, commit_state, latch_prev, table_ptrs)
from .rounding import qz_f64

# Launches of the CUDA kernel since the last reset.
LAUNCHES = 0

_F32 = torch.float32


def back_half_step(xa, state, bt_eff, active, exact: bool):
    """Back half for B slots.

    xa f32 [B,2,32,18] post-antialias spectra; state (store f32
    [B,2,32,18], v_blocks f32 [B,2,15,64]) is updated in place for
    active slots and read, not written, for idle ones; bt_eff int32
    [B,2,32] the effective block type of each subband (0 for the two
    long subbands of a mixed block); active int32 [B].

    Returns (out f32 [B,2,576], prev3 f32 [B,3]): out holds the raw FIR
    sums in exact mode and the quantized samples as floats in fast mode,
    zeros for idle slots; prev3 is x_time[0:3] of (ch0, subband 0) for
    every slot.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    global LAUNCHES
    B = xa.shape[0]
    check_operands(xa.device, ("xa", xa, (B, 2, 32, 18), _F32),
                   ("bt_eff", bt_eff, (B, 2, 32), torch.int32),
                   ("active", active, (B,), torch.int32))
    check_state(state, B, xa.device)
    if xa.device.type == "cpu":
        return back_half_step_ref(xa, state, bt_eff, active, exact)
    if xa.device.type != "cuda":
        raise ValueError(f"no back half for {xa.device}")
    from . import _build

    lib = _build.load()
    out = torch.empty((B, 2, 576), dtype=_F32, device=xa.device)
    prev3 = torch.empty((B, 3), dtype=_F32, device=xa.device)
    if B == 0:
        return out, prev3
    check_bulk_alignment(xa=xa, bt_eff=bt_eff, active=active,
                         store=state.store, v_blocks=state.v_blocks,
                         out=out)
    ptr = [t.data_ptr() for t in (xa, bt_eff, active, state.store,
                                  state.v_blocks, out, prev3)]
    stream = torch.cuda.current_stream(xa.device).cuda_stream
    rc = lib.pdmp3_back_half(*ptr, table_ptrs(xa.device), B,
                             int(bool(exact)), C.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("back_half launch failed: "
                           + lib.pdmp3_cuda_error_string(rc).decode())
    LAUNCHES += 1
    return out, prev3


def back_half_step_ref(xa, state, bt_eff, active, exact: bool):
    """Plain PyTorch version of back_half_step (same arguments, same
    in-place update, same summation order as the kernel)."""
    x_time, new_store = D.hybrid_synthesis(xa, state.store, bt_eff, exact)
    x_time = D.freq_invert(x_time)
    sums, new_v = D.subband_synthesis(x_time, state.v_blocks, exact)
    sums = torch.where((active != 0)[:, None, None, None], sums,
                       torch.zeros_like(sums))
    out = sums.reshape(-1, 2, 576) if exact else D.quantize(sums, False)
    commit_state(state, active, new_store, new_v)
    return out, x_time[:, 0, 0, 0:3].contiguous()


def split_granule_step(ix, scf_l, scf_s, meta, active, gr1: int, state,
                       bug_compat: bool = True, exact: bool = False,
                       family: int = 0, is_pos=None):
    """One granule step on the split route: the same contract (the LSF
    families included) and the same bits as
    fused_step.fused_granule_step, with the back half as its own kernel
    (K4) on CUDA tensors."""
    _check(ix, scf_l, scf_s, meta, active, gr1, state, family, is_pos)
    f = D.fields(meta)
    xa = D.front_half(ix, scf_l, scf_s, meta, gr1, state.prev_lines,
                      exact, bug_compat, family, is_pos)
    bt_eff = D.effective_block_types(f.win_switch, f.block_type, f.mixed)
    out, prev3 = back_half_step(xa, state, bt_eff, active, exact)
    pcm = D.pack(qz_f64(out) if exact else out, f.nch, active)
    latch_prev(state, active, gr1, prev3)
    return pcm, state
