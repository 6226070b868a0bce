"""One fast MPEG-1 Layer III granule step: requantize, stereo, antialias,
hybrid synthesis, frequency inversion, polyphase synthesis and quantize,
for B independent stream slots at once.

Counterpart of ``pdmp3_tpu/ops/pallas_step.py``: the fast, family-0
branch of ``decode_granules_pallas`` (the operand glue, the band-12
scalefactor substitution, the L|R pack and the ``prev_lines`` gating)
together with the TPU kernel it launches, ``_kernel_full``.

``fused_granule_step`` has two implementations with one contract:

- ``fused_granule_step_ref``: plain batched PyTorch, the reference the
  tests hold the kernel against, and the path for CPU tensors;
- the hand-written CUDA kernel ``csrc/fused_granule.cu``, launched for
  CUDA tensors.  There is no fallback between them: a CUDA tensor either
  runs the kernel or raises.

Both read |x|^(4/3) from the frozen 8207-entry table ``T.POW43`` (the
correctly rounded value).  The JAX fast path computes it with an
exp2/log2-seeded Newton cube root instead, because its TPU gathers
slowly; the two differ by at most 2 ulp of that factor
(tests/test_torch_consts.py), far inside the fast contract.

The recurrent state (``store``, ``v_blocks``, ``prev_lines``) is updated
IN PLACE for active slots and left untouched for idle ones: a step reads
and writes each slot's 12 KB of state once, and an in-place update saves
allocating and copying the whole [B, ...] state every granule.
"""
from __future__ import annotations

import ctypes as C

import torch

from .consts import (MAP_BAND_START, MAP_IOK, MAP_PRETAB, MAP_SFB_L,
                     MAP_SFB_S, MAP_SFB_S_PLAIN, MAP_SHORT, MAP_WIN,
                     POW43_MAX, device_consts)

# Launches of the CUDA kernel since the last reset (a run sets it to 0,
# drives the path, and reads it back to prove the path used the kernel).
LAUNCHES = 0

# meta words of the wire (PDMP3_META_*, pdmp3_tpu/host/include/pdmp3.h)
META_WORDS = 32
M_LAYOUT, M_BT, M_WSF, M_MIXED = 0, 2, 4, 6
M_GG, M_SFS, M_PRE, M_C1 = 8, 10, 12, 14
M_SBG, M_MS, M_IS, M_NCH = 16, 22, 23, 24

_F32 = torch.float32


def _check(ix, scf_l, scf_s, meta, active, gr1, state) -> int:
    """Validate the step's operands; returns B."""
    B = ix.shape[0]
    want = (("ix", ix, (B, 2, 576), torch.int16),
            ("scf_l", scf_l, (B, 2, 22), torch.int16),
            ("scf_s", scf_s, (B, 2, 39), torch.int16),
            ("meta", meta, (B, META_WORDS), torch.int32),
            ("active", active, (B,), torch.int32),
            ("store", state.store, (B, 2, 32, 18), _F32),
            ("v_blocks", state.v_blocks, (B, 2, 15, 64), _F32),
            ("prev_lines", state.prev_lines, (B, 3), _F32))
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != ix.device:
            raise ValueError(f"{name} is on {t.device}, ix on {ix.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if gr1 not in (0, 1):
        raise ValueError(f"gr1 must be 0 or 1, got {gr1!r}")
    return B


def fused_granule_step(ix, scf_l, scf_s, meta, active, gr1: int, state,
                       bug_compat: bool = True):
    """One granule step for B slots.

    ix int16 [B,2,576] line-ordered spectra (the wire's short-block
    reorder already applied); scf_l int16 [B,2,22]; scf_s int16 [B,2,39];
    meta int32 [B,32] (PDMP3_META_* words); active int32 [B] (0 = idle
    slot: silent PCM, state frozen); gr1 = 1 when every slot decodes
    granule 1 of its frame; state has store f32 [B,2,32,18], v_blocks f32
    [B,2,15,64] and prev_lines f32 [B,3], updated in place.
    bug_compat keeps the reference's short-block intensity quirk
    (pdmp3.c:2212-2213).

    Returns (pcm int16 [B,576,2] interleaved L/R with mono duplicated,
    state).  CPU tensors take the plain PyTorch version; CUDA tensors
    launch the kernel."""
    global LAUNCHES
    B = _check(ix, scf_l, scf_s, meta, active, gr1, state)
    if ix.device.type == "cpu":
        return fused_granule_step_ref(ix, scf_l, scf_s, meta, active, gr1,
                                      state, bug_compat)
    if ix.device.type != "cuda":
        raise ValueError(f"no fused granule step for {ix.device}")
    from . import _build

    lib = _build.load()
    c = device_consts(str(ix.device))
    pcm = torch.empty((B, 576, 2), dtype=torch.int16, device=ix.device)
    if B == 0:
        return pcm, state
    ptr = [t.data_ptr() for t in (
        ix, scf_l, scf_s, meta, active, state.store, state.v_blocks,
        state.prev_lines, pcm, c["pow43"], c["cos36"], c["c3"],
        c["imdct_win"], c["win2"], c["nwin"], c["synth_d"], c["cs"],
        c["ca"], c["ratio_l"], c["ratio_r"], c["quarter_down"],
        c["quarter_up"], c["inv_sqrt2"], c["maps"])]
    stream = torch.cuda.current_stream(ix.device).cuda_stream
    rc = lib.pdmp3_fused_granule(*ptr, B, int(gr1), int(bool(bug_compat)),
                                 C.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("fused_granule launch failed: "
                           + lib.pdmp3_cuda_error_string(rc).decode())
    LAUNCHES += 1
    return pcm, state


def _pow2i(n):
    """Exact 2^n by exponent-field construction; +0.0 outside the
    normal range [-126, 127] (pallas_step._k_pow2i)."""
    ok = (n >= -126) & (n <= 127)
    bits = torch.where(ok, (n + 127) << 23, torch.zeros_like(n))
    return bits.to(torch.int32).view(_F32)


def _dot_tree(x, w):
    """x [..., K] @ w [K, N] with each product rounded, then summed as a
    pairwise tree: neighbours (0,1), (2,3), ... are added level by level
    and an odd last term moves up unchanged.  The kernel sums in the same
    order, so the two agree bit for bit; the tree also keeps the GPU's
    dependency chains short, and on the band-12 fixture it reproduces
    the JAX CPU path's carry bits where a sequential sum does not."""
    v = [x[..., k:k + 1] * w[k] for k in range(w.shape[0])]
    while len(v) > 1:
        v = [v[i] + v[i + 1] if i + 1 < len(v) else v[i]
             for i in range(0, len(v), 2)]
    return v[0]


def fused_granule_step_ref(ix, scf_l, scf_s, meta, active, gr1: int,
                           state, bug_compat: bool = True):
    """Plain batched PyTorch version of fused_granule_step (same
    arguments, same in-place state update).  Every operation rounds in
    the order the kernel uses, the IMDCT and polyphase sums included
    (_dot_tree, not torch.matmul), so the kernel is held to it bit for
    bit on the card."""
    B = ix.shape[0]
    c = device_consts(str(ix.device))
    maps = c["maps"].long()                              # [8,9,576]
    m = meta
    lay = m[:, M_LAYOUT:M_LAYOUT + 2].clamp(0, 8).long()  # [B,2]
    one = torch.ones((), dtype=_F32, device=ix.device)

    # --- requantize (pdmp3.c:1829-1905, 2117-2152) ---
    ixi = ix.to(torch.int32)
    mag = ixi.abs().clamp(max=POW43_MAX).long()
    tmp3 = torch.where(ixi < 0, -one, one) * c["pow43"][mag]
    scfl = scf_l.to(torch.int32)
    scfs = scf_s.to(torch.int32)
    if gr1:
        # band-12 OOB read (docs/DESIGN.md §6): granule 1's ch1 short
        # band-12 scalefactors alias the float BITS of granule 0's
        # first three ch0 output lines, read as uint32
        bits = state.prev_lines.view(torch.int32).to(torch.int64) \
            & 0xFFFFFFFF
        scfs = scfs.clone()
        scfs[:, 1, 36:39] = bits.clamp(max=1024).to(torch.int32)
    short = maps[MAP_SHORT][lay] == 1                    # [B,2,576]
    scf_l_line = torch.gather(scfl, 2, maps[MAP_SFB_L][lay])
    pre = maps[MAP_PRETAB][lay] * m[:, M_PRE:M_PRE + 2, None]
    scf_s_line = torch.gather(scfs, 2, maps[MAP_SFB_S][lay])
    sbg = m[:, M_SBG:M_SBG + 6].reshape(B, 2, 3)
    sbg_line = torch.gather(sbg, 2, maps[MAP_WIN][lay])
    gg = m[:, M_GG:M_GG + 2, None]
    qpu = torch.bitwise_left_shift(torch.full_like(gg, 2),
                                   m[:, M_SFS:M_SFS + 2, None])
    q_long = qpu * (scf_l_line + pre)
    q_short = qpu * scf_s_line
    eo_long = gg - 210
    eo_short = gg - 210 - 8 * sbg_line

    def down(q):   # 2^(-q/4); >> floors and & 3 keeps 0..3 for q < 0
        return c["quarter_down"][(q & 3).long()] * _pow2i(-(q >> 2))

    def up(e):     # 2^(e/4)
        return c["quarter_up"][(e & 3).long()] * _pow2i(e >> 2)

    tmp1 = torch.where(short, down(q_short), down(q_long))
    tmp2 = torch.where(short, up(eo_short), up(eo_long))
    x = (tmp1 * tmp2) * tmp3                             # [B,2,576]

    # --- stereo (pdmp3.c:1911-1972, 2154-2220) ---
    l, r = x[:, 0], x[:, 1]
    c0 = m[:, M_C1].clamp(0, 576)
    c1r = m[:, M_C1 + 1].clamp(0, 576)
    line = torch.arange(576, device=ix.device)
    ms_mask = (m[:, M_MS, None] != 0) & \
        (line[None] < torch.minimum(c0, c1r)[:, None])
    l2 = torch.where(ms_mask, (l + r) * c["inv_sqrt2"], l)
    r2 = torch.where(ms_mask, (l - r) * c["inv_sqrt2"], r)
    # intensity follows ch0's layout and scalefactors (a reference quirk:
    # the spec puts the positions in the right channel's scalefactors)
    lay0 = lay[:, 0]
    short0 = maps[MAP_SHORT][lay0] == 1                  # [B,576]
    is_pos = torch.where(
        short0, torch.gather(scfs[:, 0], 1, maps[MAP_SFB_S_PLAIN][lay0]),
        scf_l_line[:, 0])
    imask = ((m[:, M_IS, None] != 0) & (maps[MAP_IOK][lay0] == 1)
             & (maps[MAP_BAND_START][lay0] >= c1r[:, None])
             & (is_pos != 7))
    ip = is_pos.clamp(0, 15)
    if not bug_compat:
        ip = torch.where(short0, ip.clamp(max=7), ip)
    int_l = c["ratio_l"][ip] * l2
    int_r = c["ratio_r"][ip] * l2
    if bug_compat:
        # pdmp3.c:2212-2213 assigns trunc(l) through an unsigned int: a
        # FLOOR mod 2^32 (result in [0, 2^32), -0.0 kept)
        u = torch.remainder(torch.trunc(l2), c["two32"])
        int_l = torch.where(short0, u, int_l)
        int_r = torch.where(short0, u, int_r)
    xs = torch.stack([torch.where(imask, int_l, l2),
                      torch.where(imask, int_r, r2)], 1)

    # --- antialias (pdmp3.c:1706-1732): butterfly i couples line 17-i
    # of subband sb with line i of subband sb+1, below sblim ---
    xs = xs.reshape(B, 2, 32, 18)
    bt, ws, mx = (m[:, k:k + 2] for k in (M_BT, M_WSF, M_MIXED))
    blocked = (ws == 1) & (bt == 2)
    sblim = torch.where(blocked & (mx == 0), 1,
                        torch.where(blocked & (mx == 1), 2, 32))  # [B,2]
    keep = (torch.arange(1, 32, device=ix.device)[None, None]
            < sblim[..., None])                          # [B,2,31]
    xa = xs.clone()
    for i in range(8):
        lo, up = xs[:, :, :31, 17 - i], xs[:, :, 1:, i]
        cs, ca = c["cs"][i], c["ca"][i]
        xa[:, :, :31, 17 - i] = torch.where(keep, lo * cs - up * ca, lo)
        xa[:, :, 1:, i] = torch.where(keep, up * cs + lo * ca, up)

    # --- hybrid synthesis: long IMDCT or three overlapped 12-point
    # IMDCTs, window select, overlap-add, frequency inversion
    # (pdmp3.c:1649-1700, 1738-1780) ---
    sb = torch.arange(32, device=ix.device)
    bt_eff = torch.where(((ws == 1) & (mx == 1))[..., None] & (sb < 2), 0,
                         bt[..., None]).clamp(0, 3)      # [B,2,32]
    long_out = _dot_tree(xa, c["cos36"]) * c["imdct_win"][bt_eff.long()]
    contrib = _dot_tree(xa, c["c3"]) * c["win2"].repeat(3)  # [B,2,32,36]
    c0_, c1_, c2_ = contrib.split(12, -1)
    z6 = torch.zeros_like(contrib[..., :6])
    short_out = torch.cat([z6, c0_[..., :6], c0_[..., 6:] + c1_[..., :6],
                           c1_[..., 6:] + c2_[..., :6], c2_[..., 6:], z6], -1)
    out36 = torch.where((bt_eff == 2)[..., None], short_out, long_out)
    x_time = (out36[..., :18] + state.store) * c["inv"]  # [B,2,32,18]
    new_store = out36[..., 18:]

    # --- polyphase synthesis (pdmp3.c:1983-2014): NWIN matrixing into
    # the 33-block FIFO, then the 16-tap D-window FIR ---
    nb = _dot_tree(x_time.transpose(-1, -2), c["nwin"].T)  # [B,2,18,64]
    blocks = torch.cat([state.v_blocks, nb], 2)          # [B,2,33,64]
    acc = torch.zeros((B, 2, 18, 32), dtype=_F32, device=ix.device)
    for j in range(16):
        half = 32 * (j & 1)
        acc = acc + c["synth_d"][j] * blocks[:, :, 15 - j:33 - j,
                                             half:half + 32]

    # --- quantize (pdmp3.c:2028-2031): x32767, truncate, clip; NaN and
    # values outside int32 become -32767 (cvttsd2si gives INT32_MIN) ---
    scaled = acc.reshape(B, 2, 576) * c["k32767"]
    t = torch.trunc(scaled)
    oob = torch.isnan(scaled) | (t < -2147483648.0) | (t > 2147483648.0)
    q = torch.where(oob, -32767.0, t.clamp(-32767.0, 32767.0))
    act = active != 0
    left = q[:, 0]
    right = torch.where((m[:, M_NCH] <= 1)[:, None], left, q[:, 1])
    pcm = torch.stack([left, right], -1).to(torch.int16)
    pcm = torch.where(act[:, None, None], pcm, torch.zeros_like(pcm))

    a4 = act[:, None, None, None]
    state.store.copy_(torch.where(a4, new_store, state.store))
    state.v_blocks.copy_(torch.where(a4, blocks[:, :, 18:], state.v_blocks))
    if gr1 == 0:
        # granule-0 steps latch x_time[0:3] of (ch0, sb0) for the next
        # granule's band-12 read
        state.prev_lines.copy_(torch.where(act[:, None],
                                           x_time[:, 0, 0, 0:3],
                                           state.prev_lines))
    return pcm, state
