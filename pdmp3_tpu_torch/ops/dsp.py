"""Batched Layer III DSP stages as plain PyTorch ops, in exact and fast
form, for MPEG-1 (family 0) and the LSF families (1 MPEG-2, 2 MPEG-2.5).

Counterpart of ``pdmp3_tpu/ops/dsp.py`` on the wire's line order (the
host applies the family's short-block reorder while it packs ix).  Every
stage takes tensors with leading axes ``[B, 2(ch)]`` and handles the
per-granule variety (block types, mixed blocks, stereo modes, count1
extents) with masks and index-map gathers (``consts.line_maps``), where
the JAX package expands one-hot matrix products because its TPU gathers
slowly.

Both forms read |x|^(4/3) from the frozen table ``T.POW43`` (the
correctly rounded value, which the JAX package's exact closed form is
proven to equal).  They differ where the reference's arithmetic does:

- exact: for family 0 the sentinel-63 zero gain (q >= 100) and the
  band-12 gain from the ``prev_lines`` float bits read through
  ``GAIN_QUARTER_TRUE`` (LSF has neither: its gains stay true through
  q = 124); the
  three float64 rounding points of ``ops/rounding.py``; the IMDCT and
  the polyphase matrixing summed sequentially from the first product, in
  the order ``pallas_step._back_ch_sb(exact=True)`` uses (the short IMDCT
  over the folded 18-row basis, its zero products included), which the
  JAX package holds bitwise equal to its XLA exact stages;
- fast: plain f32 gains and rounding, and pairwise-tree dots.

These plain ops are the CPU path of the granule steps
(``fused_step.fused_granule_step_ref``, ``back_half.back_half_step``)
and the versions the CUDA kernels are held to bit for bit on the card;
each kernel sums and rounds in the order written here.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from .. import tables as T
from .consts import (MAP_BAND_START, MAP_IOK, MAP_PRETAB, MAP_SFB12,
                     MAP_SFB_L, MAP_SFB_S, MAP_SFB_S_PLAIN, MAP_SHORT,
                     MAP_WIN, POW43_MAX, device_consts)
from .rounding import ms_f64, qz_f64, uq_f64

# meta words of the wire (PDMP3_META_*, pdmp3_tpu/host/include/pdmp3.h)
META_WORDS = 32
M_LAYOUT, M_BT, M_WSF, M_MIXED = 0, 2, 4, 6
M_GG, M_SFS, M_PRE, M_C1 = 8, 10, 12, 14
M_SBG, M_MS, M_IS, M_NCH = 16, 22, 23, 24
M_SAMPLE_RATE = 25   # the int16 wire carries the rate / 25
M_FAMILY, M_ISCALE = 26, 27   # LSF wire only (pdmp3_parse_step_wire16_lsf)

_F32 = torch.float32


def fields(meta: torch.Tensor) -> SimpleNamespace:
    """The side-info fields of int32 meta [B,32] as views: [B,2] per
    channel, subblock_gain [B,2,3], [B] per slot (family and iscale are
    written by the LSF packer only)."""
    B = meta.shape[0]

    def ch(k):
        return meta[:, k:k + 2]
    return SimpleNamespace(
        layout=ch(M_LAYOUT), block_type=ch(M_BT), win_switch=ch(M_WSF),
        mixed=ch(M_MIXED), global_gain=ch(M_GG), scalefac_scale=ch(M_SFS),
        preflag=ch(M_PRE), count1=ch(M_C1),
        subblock_gain=meta[:, M_SBG:M_SBG + 6].reshape(B, 2, 3),
        ms_flag=meta[:, M_MS], is_flag=meta[:, M_IS], nch=meta[:, M_NCH],
        family=meta[:, M_FAMILY], iscale=meta[:, M_ISCALE])


def _maps(dev, row: int, layout: torch.Tensor, family: int = 0
          ) -> torch.Tensor:
    """line_maps(family)[row] selected per element of layout:
    [..., 576]."""
    return device_consts(str(dev), family)["maps"][row].long()[
        layout.clamp(0, 8).long()]


def _pow2i(n):
    """Exact 2^n by exponent-field construction; +0.0 outside the
    normal range [-126, 127] (pallas_step._k_pow2i)."""
    ok = (n >= -126) & (n <= 127)
    bits = torch.where(ok, (n + 127) << 23, torch.zeros_like(n))
    return bits.to(torch.int32).view(_F32)


def band12_scalefactors(prev_lines: torch.Tensor) -> torch.Tensor:
    """int32 [B,3]: granule 1's ch1 short band-12 scalefactors, which the
    reference reads out of bounds from the float BITS of granule 0's
    first three ch0 output lines, as uint32 clamped to 1024
    (docs/DESIGN.md §6)."""
    bits = prev_lines.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits.clamp(max=1024).to(torch.int32)


def requantize(ix, scf_l, scf_s, layout, global_gain, scalefac_scale,
               preflag, subblock_gain, exact: bool, gr1: int = 0,
               prev_lines=None, family: int = 0):
    """Huffman integers to spectral floats (pdmp3.c:1829-1905, 2117-2152):
    (2^(-q/4) * 2^((gg-210-8*sbg)/4)) * sign(x)|x|^(4/3), in that
    association.

    ix [B,2,576] line-ordered; scf_l [B,2,22]; scf_s [B,2,39] (or
    [B,2,13,3]); layout/global_gain/scalefac_scale/preflag [B,2];
    subblock_gain [B,2,3].  With gr1 = 1 (every slot decodes granule 1)
    and prev_lines f32 [B,3], ch1's band-12 scalefactors are the
    band12_scalefactors() of prev_lines; in exact form those lines take
    the true gain GAIN_QUARTER_TRUE[q] (+0.0 for q >= 640), which is
    subnormal for q in 504..599.  Exact form also gives the host's
    sentinel-63 scalefactors (q >= 100) zero gain.  family 1/2 (LSF)
    reads its own band maps and has neither quirk: 5-bit intensity-
    channel scalefactors reach q = 124 with their true gains, and every
    LSF step is a granule-0 step.  Returns f32 [B,2,576]."""
    dev = ix.device
    c = device_consts(str(dev), family)
    B = ix.shape[0]
    one = torch.ones((), dtype=_F32, device=dev)
    ixi = ix.to(torch.int32)
    mag = ixi.abs().clamp(max=POW43_MAX).long()
    tmp3 = torch.where(ixi < 0, -one, one) * c["pow43"][mag]
    scfs = scf_s.reshape(B, 2, 39).to(torch.int32)
    band12 = bool(gr1) and prev_lines is not None and family == 0
    if band12:
        scf12 = band12_scalefactors(prev_lines)
        scfs = scfs.clone()
        scfs[:, 1, 36:39] = scf12
    short = _maps(dev, MAP_SHORT, layout, family) == 1   # [B,2,576]
    scf_l_line = torch.gather(scf_l.to(torch.int32), 2,
                              _maps(dev, MAP_SFB_L, layout, family))
    pre = _maps(dev, MAP_PRETAB, layout, family) * preflag[..., None]
    scf_s_line = torch.gather(scfs, 2,
                              _maps(dev, MAP_SFB_S, layout, family))
    sbg_line = torch.gather(subblock_gain.to(torch.int32), 2,
                            _maps(dev, MAP_WIN, layout, family))
    gg = global_gain[..., None].to(torch.int32)
    qpu = torch.bitwise_left_shift(torch.full_like(gg, 2),
                                   scalefac_scale[..., None])
    q_long = qpu * (scf_l_line + pre)
    q_short = qpu * scf_s_line

    def down(q):   # 2^(-q/4); >> floors and & 3 keeps 0..3 for q < 0
        return c["quarter_down"][(q & 3).long()] * _pow2i(-(q >> 2))

    def up(e):     # 2^(e/4)
        return c["quarter_up"][(e & 3).long()] * _pow2i(e >> 2)

    tmp1_long, tmp1_short = down(q_long), down(q_short)
    if exact and family == 0:
        zero = torch.zeros((), dtype=_F32, device=dev)
        tmp1_long = torch.where(q_long >= 100, zero, tmp1_long)
        tmp1_short = torch.where(q_short >= 100, zero, tmp1_short)
        if band12:
            idx = (qpu[:, 1] * scf12).long()            # [B,3]
            gqt = c["gain_quarter_true"]
            g12 = torch.where(idx < gqt.shape[0],
                              gqt[idx.clamp(max=gqt.shape[0] - 1)], zero)
            g12_line = torch.gather(g12, 1,
                                    _maps(dev, MAP_WIN, layout[:, 1]))
            m12 = _maps(dev, MAP_SFB12, layout[:, 1]) == 1
            tmp1_short = tmp1_short.clone()
            tmp1_short[:, 1] = torch.where(m12, g12_line, tmp1_short[:, 1])
    tmp1 = torch.where(short, tmp1_short, tmp1_long)
    tmp2 = torch.where(short, up(gg - 210 - 8 * sbg_line), up(gg - 210))
    return (tmp1 * tmp2) * tmp3


def stereo(x, layout, scf_l, scf_s, count1, ms_flag, is_flag,
           exact: bool, bug_compat: bool = True, family: int = 0,
           is_pos=None, iscale=None):
    """Mid/side and intensity stereo (pdmp3.c:1911-1972, 2154-2220).

    Family 0: MS butterflies the lines below min(count1); intensity
    follows ch0's layout and scalefactors (a reference quirk: the spec
    puts the positions in the right channel's scalefactors), with the
    16-wide ratios of the reference's out-of-bounds reads.  bug_compat
    keeps the short-block unsigned-assign quirk (pdmp3.c:2212-2213).

    Family 1/2 (LSF, 13818-3 §2.4.3.2; dsp.py:654-720 of the JAX
    package): MS butterflies the full spectrum; intensity positions come
    from ch1's sidecar is_pos int [B,64] ([0..21] long, [22..60] short
    flat window-major, T.LSF_IS_ILLEGAL = no position) along ch0's layout,
    and pan the RAW (pre-MS) ch0 line by the gain pair k0/k1 of the
    slot's iscale [B] row.  bug_compat has no LSF meaning.

    x f32 [B,2,576]; layout/count1 [B,2]; scf_l [B,2,22]; scf_s [B,2,39]
    (or [B,2,13,3]); ms_flag/is_flag [B].  Returns f32 [B,2,576]."""
    dev = x.device
    c = device_consts(str(dev), family)
    B = x.shape[0]
    l, r = x[:, 0], x[:, 1]
    c0 = count1[:, 0].clamp(0, 576)
    c1r = count1[:, 1].clamp(0, 576)
    line = torch.arange(576, device=dev)
    if family:
        ms_mask = (ms_flag[:, None] != 0).expand(B, 576)
    else:
        ms_mask = (ms_flag[:, None] != 0) & \
            (line[None] < torch.minimum(c0, c1r)[:, None])
    if exact:
        mid, side = ms_f64(l + r), ms_f64(l - r)
    else:
        mid, side = (l + r) * c["inv_sqrt2"], (l - r) * c["inv_sqrt2"]
    l2 = torch.where(ms_mask, mid, l)
    r2 = torch.where(ms_mask, side, r)
    lay0 = layout[:, 0]
    if family:
        return _lsf_intensity(l, l2, r2, lay0, c1r, is_flag, is_pos,
                              iscale, family)
    short0 = _maps(dev, MAP_SHORT, lay0) == 1            # [B,576]
    scfs0 = scf_s.reshape(B, 2, 39)[:, 0].to(torch.int64)
    scfl0 = scf_l[:, 0].to(torch.int64)
    is_pos = torch.where(
        short0, torch.gather(scfs0, 1, _maps(dev, MAP_SFB_S_PLAIN, lay0)),
        torch.gather(scfl0, 1, _maps(dev, MAP_SFB_L, lay0)))
    imask = ((is_flag[:, None] != 0) & (_maps(dev, MAP_IOK, lay0) == 1)
             & (_maps(dev, MAP_BAND_START, lay0) >= c1r[:, None])
             & (is_pos != 7))
    ip = is_pos.clamp(0, 15)
    if not bug_compat:
        ip = torch.where(short0, ip.clamp(max=7), ip)
    int_l = c["ratio_l"][ip] * l2
    int_r = c["ratio_r"][ip] * l2
    if bug_compat:
        # both channels become (float)(uint32)(int64)trunc(l): a FLOOR
        # mod 2^32.  The fast form keeps f32 and -0.0, as jnp.mod does
        u = uq_f64(l2) if exact else torch.remainder(torch.trunc(l2),
                                                     c["two32"])
        int_l = torch.where(short0, u, int_l)
        int_r = torch.where(short0, u, int_r)
    return torch.stack([torch.where(imask, int_l, l2),
                        torch.where(imask, int_r, r2)], 1)


def _lsf_intensity(l_raw, l2, r2, lay0, c1r, is_flag, is_pos, iscale,
                   family: int):
    """LSF intensity over the post-MS pair (l2, r2): lines of eligible
    bands at or above ch1's count1 whose position is legal become
    (k0 * l_raw, k1 * l_raw)."""
    dev = l2.device
    c = device_consts(str(dev), family)
    ip = is_pos.to(torch.int64)                          # [B,64]
    short0 = _maps(dev, MAP_SHORT, lay0, family) == 1    # [B,576]
    pos = torch.where(
        short0, torch.gather(ip, 1, 22 + _maps(dev, MAP_SFB_S_PLAIN, lay0,
                                               family)),
        torch.gather(ip, 1, _maps(dev, MAP_SFB_L, lay0, family)))
    imask = ((is_flag[:, None] != 0)
             & (_maps(dev, MAP_IOK, lay0, family) == 1)
             & (_maps(dev, MAP_BAND_START, lay0, family) >= c1r[:, None])
             & (pos != T.LSF_IS_ILLEGAL))
    row = (iscale != 0).long()[:, None]                  # [B,1]
    p = pos.clamp(0, 63)
    k0, k1 = c["k0"][row, p], c["k1"][row, p]
    return torch.stack([torch.where(imask, k0 * l_raw, l2),
                        torch.where(imask, k1 * l_raw, r2)], 1)


def antialias(x, win_switch, block_type, mixed):
    """Alias-reduction butterflies (pdmp3.c:1706-1732): butterfly i
    couples line 17-i of subband sb with line i of subband sb+1, for
    boundaries below sblim (1 for pure short blocks, 2 for mixed, 32
    otherwise).  x f32 [B,2,576] -> [B,2,32,18]."""
    B = x.shape[0]
    c = device_consts(str(x.device))
    xs = x.reshape(B, 2, 32, 18)
    blocked = (win_switch == 1) & (block_type == 2)
    sblim = torch.where(blocked & (mixed == 0), 1,
                        torch.where(blocked & (mixed == 1), 2, 32))
    keep = (torch.arange(1, 32, device=x.device)[None, None]
            < sblim[..., None])                          # [B,2,31]
    xa = xs.clone()
    for i in range(8):
        lo, up = xs[:, :, :31, 17 - i], xs[:, :, 1:, i]
        cs, ca = c["cs"][i], c["ca"][i]
        xa[:, :, :31, 17 - i] = torch.where(keep, lo * cs - up * ca, lo)
        xa[:, :, 1:, i] = torch.where(keep, up * cs + lo * ca, up)
    return xa


def effective_block_types(win_switch, block_type, mixed):
    """int32 [B,2,32]: the block type each subband is windowed with (the
    two long subbands of a mixed block use 0)."""
    sb = torch.arange(32, device=block_type.device)
    return torch.where(((win_switch == 1) & (mixed == 1))[..., None]
                       & (sb < 2), 0, block_type[..., None]).clamp(0, 3) \
        .to(torch.int32)


def _dot_tree(x, w):
    """x [..., K] @ w [K, N] with each product rounded, then summed as a
    pairwise tree: neighbours (0,1), (2,3), ... are added level by level
    and an odd last term moves up unchanged.  The fast kernels sum in the
    same order; the tree also keeps the GPU's dependency chains short,
    and on the band-12 fixture it reproduces the JAX CPU path's carry
    bits where a sequential sum does not."""
    v = [x[..., k:k + 1] * w[k] for k in range(w.shape[0])]
    while len(v) > 1:
        v = [v[i] + v[i + 1] if i + 1 < len(v) else v[i]
             for i in range(0, len(v), 2)]
    return v[0]


def _dot_seq(x, w):
    """x [..., K] @ w [K, N] summed sequentially from the first product
    (the reference's accumulation order, pallas_step._back_ch_sb exact)."""
    acc = x[..., 0:1] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + x[..., k:k + 1] * w[k]
    return acc


def hybrid_synthesis(xa, store, bt_eff, exact: bool):
    """IMDCT, window, overlap-add (pdmp3.c:1649-1700, 1752-1780): a long
    36-point IMDCT or three overlapped 12-point IMDCTs (one folded 18-row
    basis) per subband, windowed by its effective block type.

    xa f32 [B,2,32,18] post-antialias; store [B,2,32,18]; bt_eff int
    [B,2,32].  Returns (x_time [B,2,32,18] before frequency inversion,
    new_store)."""
    c = device_consts(str(xa.device))
    dot = _dot_seq if exact else _dot_tree
    long_out = dot(xa, c["cos36"]) * c["imdct_win"][bt_eff.long()]
    contrib = dot(xa, c["c3"]) * c["win2"].repeat(3)     # [B,2,32,36]
    c0, c1, c2 = contrib.split(12, -1)
    z6 = torch.zeros_like(contrib[..., :6])
    short_out = torch.cat([z6, c0[..., :6], c0[..., 6:] + c1[..., :6],
                           c1[..., 6:] + c2[..., :6], c2[..., 6:], z6], -1)
    out36 = torch.where((bt_eff == 2)[..., None], short_out, long_out)
    return out36[..., :18] + store, out36[..., 18:]


def freq_invert(x_time):
    """Negate odd samples of odd subbands (pdmp3.c:1738-1746)."""
    return x_time * device_consts(str(x_time.device))["inv"]


def subband_synthesis(x_time, v_blocks, exact: bool):
    """Polyphase synthesis (pdmp3.c:1983-2014): NWIN matrixing of the S
    time steps into the FIFO, then the 16-tap D-window FIR over the
    (15 + S)-block sliding window (15 carried + S new blocks).  S is 18
    for a Layer III granule, 12 for a Layer I frame and 36 for a Layer
    II one (``models.l12``).

    x_time f32 [B,2,32,S] (frequency-inverted for Layer III); v_blocks
    [B,2,15,64], oldest first.  Returns (sums [B,2,S,32],
    new_v_blocks)."""
    c = device_consts(str(x_time.device))
    S = x_time.shape[-1]
    dot = _dot_seq if exact else _dot_tree
    nb = dot(x_time.transpose(-1, -2), c["nwin"].T)      # [B,2,S,64]
    blocks = torch.cat([v_blocks, nb], 2)                # [B,2,15+S,64]
    acc = torch.zeros_like(nb[..., :32])
    for j in range(16):
        half = 32 * (j & 1)
        acc = acc + c["synth_d"][j] * blocks[:, :, 15 - j:15 + S - j,
                                             half:half + 32]
    return acc, blocks[:, :, S:]


def quantize(sums, exact: bool):
    """x32767, truncate toward zero, clip to +-32767; NaN and values
    outside int32 become -32767 (pdmp3.c:2028-2031).  Exact form rounds
    through f64 (rounding.qz_f64).  sums f32 [..., S, 32] -> f32
    [..., S*32] sample values."""
    s = sums.reshape(*sums.shape[:-2], -1)
    if exact:
        return qz_f64(s)
    scaled = s * device_consts(str(s.device))["k32767"]
    t = torch.trunc(scaled)
    oob = torch.isnan(scaled) | (t < -2147483648.0) | (t > 2147483648.0)
    return torch.where(oob, torch.full_like(t, -32767.0),
                       t.clamp(-32767.0, 32767.0))


def pack(q, nch, active):
    """Quantized f32 [B,2,576] -> int16 PCM [B,576,2] interleaved L/R,
    mono (nch <= 1) duplicating L, idle slots silent (pdmp3.c:2032-2041)."""
    left = q[:, 0]
    right = torch.where((nch <= 1)[:, None], left, q[:, 1])
    pcm = torch.stack([left, right], -1).to(torch.int16)
    return torch.where((active != 0)[:, None, None], pcm,
                       torch.zeros_like(pcm))


def float_pack(sums, nch, active):
    """Float PCM (the JAX package's dsp.float_pack, a serving option
    beyond the reference's S16 sink): the synthesis sums f32 [B,2,S,32]
    clipped to [-1, 1], NaN to -1, interleaved as f32 [B,S*32,2], mono
    (nch <= 1) duplicating L, idle slots silent.  trunc(pcm * 32767)
    is the S16 sample except where |sum * 32767| escapes int32, which
    S16 wraps to -32767 (cvttsd2si) and float saturates."""
    x = sums.reshape(sums.shape[0], 2, -1)
    x = torch.where(torch.isnan(x), torch.full_like(x, -1.0),
                    x.clamp(-1.0, 1.0))
    left = x[:, 0]
    right = torch.where((nch <= 1)[:, None], left, x[:, 1])
    pcm = torch.stack([left, right], -1)
    return torch.where((active != 0)[:, None, None], pcm,
                       torch.zeros_like(pcm))


def front_half(ix, scf_l, scf_s, meta, gr1: int, prev_lines,
               exact: bool, bug_compat: bool = True, family: int = 0,
               is_pos=None):
    """requantize -> stereo -> antialias for one granule step from the
    wire's operands (meta int32 [B,32]; for LSF families also the
    sidecar is_pos [B,64], iscale from meta).  Returns xa f32
    [B,2,32,18]."""
    f = fields(meta)
    x = requantize(ix, scf_l, scf_s, f.layout, f.global_gain,
                   f.scalefac_scale, f.preflag, f.subblock_gain, exact,
                   gr1, prev_lines, family)
    x = stereo(x, f.layout, scf_l, scf_s, f.count1, f.ms_flag, f.is_flag,
               exact, bug_compat, family, is_pos, f.iscale)
    return antialias(x, f.win_switch, f.block_type, f.mixed)
