"""One Layer III granule step: requantize, stereo, antialias, hybrid
synthesis, frequency inversion, polyphase synthesis and quantize, for B
independent stream slots of one family at once, in fast or exact
precision.

Counterpart of ``pdmp3_tpu/ops/pallas_step.py``: the fast and fused
exact branches of ``decode_granules_pallas`` (the operand glue; for
family 0 the band-12 scalefactor substitution and, in exact mode, the
band-12 true gains; for the LSF families 1 and 2 the intensity sidecar
and iscale; the L|R pack and the ``prev_lines`` gating) together with
the TPU kernel they launch, ``_kernel_full``.

``fused_granule_step`` has two implementations with one contract:

- ``fused_granule_step_ref``: plain batched PyTorch, the stage ops of
  ``ops/dsp.py`` composed; the reference the tests hold the kernels
  against, and the path for CPU tensors;
- the hand-written CUDA kernels of ``csrc/fused_granule.cu``, launched
  for CUDA tensors: for family 0 K1 in fast mode and K2 in exact mode,
  for the LSF families K3 (its fast and exact instances); with
  ``float_pcm=True`` the same four writing float PCM (persistent
  instances 9-12: the FIR sums as ``dsp.float_pack`` makes them, no
  quantize).  There is no fallback between them: a CUDA tensor either
  runs a kernel or raises.

K1, K2 and K3 are persistent (``launch.granule_launch_info``: a grid of
the SM count times the resident blocks per SM walks the B slots) and
bring each slot's ix, meta, store and v_blocks into shared memory by
bulk copies, which need 16-byte aligned addresses; scf_l, scf_s,
prev_lines, active and K3's is_pos sidecar arrive by 4-byte copies (the
packed LSF wire puts is_pos at F x B x 2,612 bytes, 16-byte aligned only
when F x B % 4 == 0).  ``launch.check_bulk_alignment`` raises on an
operand that breaks either rule (a view at an odd element offset): there
is no slower path for it.

Both read |x|^(4/3) from the frozen 8207-entry table ``T.POW43`` (the
correctly rounded value).  The JAX fast path computes it with an
exp2/log2-seeded Newton cube root instead, because its TPU gathers
slowly; the two differ by at most 2 ulp of that factor
(tests/test_torch_consts.py), far inside the fast contract.  Exact mode
is bit-exact with the reference decoder.

The recurrent state (``store``, ``v_blocks``, ``prev_lines``) is updated
IN PLACE for active slots and left untouched for idle ones: a step reads
and writes each slot's 12 KB of state once, and an in-place update saves
allocating and copying the whole [B, ...] state every granule.
"""
from __future__ import annotations

import ctypes as C

import torch

from . import dsp as D
from .consts import device_consts
from .launch import check_bulk_alignment, check_operands, launch

_F32 = torch.float32

# the kernels' table operands: those of csrc/granule.cuh Tables in its
# order, the LSF gain pairs, then the persistent kernels' table image
TABLES = ("pow43", "cos36", "c3", "imdct_win", "win2", "nwin", "synth_d",
          "cs", "ca", "ratio_l", "ratio_r", "quarter_down", "quarter_up",
          "inv_sqrt2", "gain_quarter_true", "maps", "k0", "k1",
          "granule_smem")
# the launch counter of each K1-K3 instance, by [lsf][float_pcm][exact]
_COUNTERS = ((("fused_granule", "fused_granule_exact"),
              ("fused_granule_float", "fused_granule_float_exact")),
             (("fused_granule_lsf", "fused_granule_lsf_exact"),
              ("fused_granule_lsf_float", "fused_granule_lsf_float_exact")))


def table_ptrs(device, family: int = 0) -> C.Array:
    """Device pointers of the kernels' tables (device_consts of the
    family), as the pointer array the C entry points take."""
    c = device_consts(str(device), family)
    return (C.c_void_p * len(TABLES))(*[c[k].data_ptr() for k in TABLES])


def check_state(state, B: int, device) -> None:
    """Raise ValueError unless state holds contiguous f32 store
    [B,2,32,18], v_blocks [B,2,15,64] and prev_lines [B,3] on device."""
    check_operands(device, ("store", state.store, (B, 2, 32, 18), _F32),
                   ("v_blocks", state.v_blocks, (B, 2, 15, 64), _F32),
                   ("prev_lines", state.prev_lines, (B, 3), _F32))


def _check(ix, scf_l, scf_s, meta, active, gr1, state, family=0,
           is_pos=None) -> int:
    """Validate the step's operands; returns B."""
    B = ix.shape[0]
    check_operands(ix.device, ("ix", ix, (B, 2, 576), torch.int16),
                   ("scf_l", scf_l, (B, 2, 22), torch.int16),
                   ("scf_s", scf_s, (B, 2, 39), torch.int16),
                   ("meta", meta, (B, D.META_WORDS), torch.int32),
                   ("active", active, (B,), torch.int32))
    check_state(state, B, ix.device)
    if family not in (0, 1, 2):
        raise ValueError(f"family must be 0, 1 or 2, got {family!r}")
    if gr1 not in (0, 1) or (family and gr1):
        raise ValueError(f"gr1 must be 0 or 1 (0 for LSF), got {gr1!r}")
    if family:
        if is_pos is None:
            raise ValueError("LSF steps need the is_pos sidecar")
        check_operands(ix.device, ("is_pos", is_pos, (B, 64), torch.int16))
    return B


def fused_granule_step(ix, scf_l, scf_s, meta, active, gr1: int, state,
                       bug_compat: bool = True, exact: bool = False,
                       family: int = 0, is_pos=None,
                       float_pcm: bool = False):
    """One granule step for B slots of one family.

    ix int16 [B,2,576] line-ordered spectra (the wire's short-block
    reorder already applied); scf_l int16 [B,2,22]; scf_s int16 [B,2,39];
    meta int32 [B,32] (PDMP3_META_* words); active int32 [B] (0 = idle
    slot: silent PCM, state frozen); gr1 = 1 when every slot decodes
    granule 1 of its frame; state has store f32 [B,2,32,18], v_blocks f32
    [B,2,15,64] and prev_lines f32 [B,3], updated in place.
    bug_compat keeps the reference's short-block intensity quirk
    (pdmp3.c:2212-2213); exact selects bit-exact precision.  family 1/2
    (MPEG-2 / MPEG-2.5 LSF) selects the family's band maps and the LSF
    stereo; it needs is_pos int16 [B,64], ch1's intensity positions
    ([0..21] long, [22..60] short flat, 63 = illegal), and iscale in
    meta word 27; every LSF step is a granule-0 step (gr1 = 0), which
    latches prev_lines as the JAX package does.

    Returns (pcm int16 [B,576,2] interleaved L/R with mono duplicated,
    state); with float_pcm, pcm f32 [B,576,2] in [-1, 1] (dsp.float_pack
    of the synthesis sums; zeros for idle slots).  CPU tensors take the
    plain PyTorch version; CUDA tensors launch the kernel (family 0: K2
    when exact, else K1; LSF: K3; float_pcm: their float instances
    9-12)."""
    B = _check(ix, scf_l, scf_s, meta, active, gr1, state, family, is_pos)
    if ix.device.type == "cpu":
        return fused_granule_step_ref(ix, scf_l, scf_s, meta, active, gr1,
                                      state, bug_compat, exact, family,
                                      is_pos, float_pcm)
    if ix.device.type != "cuda":
        raise ValueError(f"no fused granule step for {ix.device}")
    pcm = torch.empty((B, 576, 2), device=ix.device,
                      dtype=_F32 if float_pcm else torch.int16)
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
    kernel = _COUNTERS[family != 0][bool(float_pcm)][bool(exact)]
    launch(kernel, "pdmp3_fused_granule", ix.device, *ptr,
           table_ptrs(ix.device, family), B, int(gr1),
           int(bool(bug_compat)), int(bool(exact)), int(family != 0),
           int(bool(float_pcm)))
    return pcm, state


def fused_granule_step_ref(ix, scf_l, scf_s, meta, active, gr1: int,
                           state, bug_compat: bool = True,
                           exact: bool = False, family: int = 0,
                           is_pos=None, float_pcm: bool = False):
    """Plain batched PyTorch version of fused_granule_step (same
    arguments, same in-place state update): the stage ops of ops/dsp.py
    composed, ending in dsp.float_pack with float_pcm, else in the
    quantize and the pack.  Every operation rounds in the order the
    kernels use, the IMDCT and polyphase sums included, so each kernel
    is held to it bit for bit on the card."""
    f = D.fields(meta)
    xa = D.front_half(ix, scf_l, scf_s, meta, gr1, state.prev_lines,
                      exact, bug_compat, family, is_pos)
    bt_eff = D.effective_block_types(f.win_switch, f.block_type, f.mixed)
    x_time, new_store = D.hybrid_synthesis(xa, state.store, bt_eff, exact)
    x_time = D.freq_invert(x_time)
    sums, new_v = D.subband_synthesis(x_time, state.v_blocks, exact)
    pcm = (D.float_pack(sums, f.nch, active) if float_pcm
           else D.pack(D.quantize(sums, exact), f.nch, active))
    commit_state(state, active, new_store, new_v)
    latch_prev(state, active, gr1, x_time[:, 0, 0, 0:3])
    return pcm, state


def commit_state(state, active, new_store, new_v) -> None:
    """Write a step's new store and v_blocks into ``state`` for active
    slots; idle slots keep theirs."""
    a4 = (active != 0)[:, None, None, None]
    state.store.copy_(torch.where(a4, new_store, state.store))
    state.v_blocks.copy_(torch.where(a4, new_v, state.v_blocks))


def latch_prev(state, active, gr1: int, prev3) -> None:
    """On granule-0 steps, latch prev3 (x_time[0:3] of ch0, subband 0)
    into state.prev_lines for active slots: the next granule's band-12
    carry."""
    if gr1 == 0:
        state.prev_lines.copy_(torch.where((active != 0)[:, None], prev3,
                                           state.prev_lines))
