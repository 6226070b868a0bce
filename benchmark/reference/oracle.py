"""NumPy float32 oracle for the Layer III DSP backend.

Frozen copy of ``pdmp3_tpu_torch/oracle.py`` for the benchmark's plain
reference: it imports nothing of the program.

Replays the reference decoder's per-granule math (pdmp3.c:1024-1060,
1649-2045, 2117-2220) with *identical float32 operation ordering*, so its
packed PCM output is bit-exact against the reference C binary.  All
per-sample operations are elementwise chains, and every accumulation in the
reference is a fixed-length sequential sum, so the oracle vectorizes across
samples while looping over the accumulation index — each np.float32 op is
one IEEE round, exactly like the compiled C (x86-64 SSE scalar math, no
FMA contraction at the reference's flags).

This module is the test oracle for the JAX/Pallas kernels and the semantic
reference for the C++ scalar DSP fallback.  It is deliberately simple, not
fast.
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .frontend import FrameData

F32 = np.float32


def _requantize(fd: FrameData, gr: int, ch: int,
                prev_gr0_ch0: np.ndarray | None = None) -> np.ndarray:
    """pdmp3.c:1829-1905, 2117-2152. Returns float32[576].

    Requantizes all 576 lines unconditionally: lines at/above count1 are
    zero (frontend zero-fill), and gain * 0^(4/3) == +0.0 matches the
    reference's untouched 0.0 bit pattern, so the count1-bounded loops and
    the full-array form produce identical bits.
    """
    s = fd.side
    fam = fd.header.family
    sfreq = fd.header.sampling_frequency
    lay = T.layout_id(sfreq, int(s.win_switch_flag[gr][ch]),
                      int(s.block_type[gr][ch]), int(s.mixed_block_flag[gr][ch]))
    maps = T.layout_maps(fam)
    sfb = maps["sfb"][lay]
    win = maps["win"][lay]
    short = maps["is_short"][lay]

    ix = fd.ix[gr][ch]
    sign = np.where(ix < 0, F32(-1.0), F32(1.0))
    mag = np.minimum(np.abs(ix), 8206)
    tmp3 = sign * T.POW43[mag]  # f32 mul (sign flip is exact)

    quarters_per_unit = 4 if s.scalefac_scale[gr][ch] else 2

    pretab22 = np.concatenate([T.PRETAB, [0]]).astype(np.int32)
    scf_l = fd.scalefac_l[gr][ch]  # [22]
    scf_s = fd.scalefac_s[gr][ch]  # [13,3]

    # long lines.  LSF intensity-channel scalefactors reach 31 (slen 5,
    # 13818-3 §2.4.3.4) so q reaches 124, inside GAIN_QUARTER_DOWN's
    # sentinel-zero region — use the true 2^(-q/4) table there (identical
    # values below q=100).
    qtab = T.GAIN_QUARTER_TRUE if fam else T.GAIN_QUARTER_DOWN
    q_long = quarters_per_unit * (scf_l[sfb] + int(s.preflag[gr][ch]) * pretab22[sfb])
    e_long = int(s.global_gain[gr][ch]) - 210
    tmp2_long = T.GAIN_GLOBAL[e_long + T.GAIN_GLOBAL_OFF]
    tmp1_long = qtab[q_long]

    # short lines (clamp sfb: long layouts carry band ids up to 21 but the
    # short gather is masked out by `short == 0` there)
    sfb_s = np.minimum(sfb, 12)
    scf_s_eff = scf_s.astype(np.int64)
    if gr == 1 and ch == 1 and prev_gr0_ch0 is not None:
        # reference OOB: scalefac_s[1][1][12][w] reads the float BITS of
        # is[0][0][w] (granule 0 channel 0, post-DSP) as an unsigned
        # scalefactor (docs/DESIGN.md §6)
        bits = prev_gr0_ch0[:3].view(np.uint32).astype(np.int64)
        scf_s_eff[12] = bits
    q_short = quarters_per_unit * scf_s_eff[sfb_s, win]
    sbg = s.subblock_gain[gr][ch]  # [3]
    e_short = int(s.global_gain[gr][ch]) - 210 - 8 * sbg[win]
    tmp2_short = T.GAIN_GLOBAL[e_short + T.GAIN_GLOBAL_OFF]
    # gains for the (possibly huge) bit-pattern scalefactors: exact
    # double pow(2, -q/4) rounded to f32 (underflows to +0.0 like the
    # reference's libm call)
    tmp1_short = np.where(
        q_short < 100,
        qtab[np.minimum(q_short, 99)],
        np.power(2.0, -0.25 * np.minimum(q_short, 6000).astype(np.float64))
        .astype(F32))

    tmp1 = np.where(short == 1, tmp1_short, tmp1_long).astype(F32)
    tmp2 = np.where(short == 1, tmp2_short,
                    np.full(576, tmp2_long, F32)).astype(F32)
    return (tmp1 * tmp2) * tmp3  # left-assoc like tmp1*tmp2*tmp3


def _reorder(fd: FrameData, gr: int, ch: int, x: np.ndarray) -> np.ndarray:
    """pdmp3.c:1786-1823 as a static permutation (zeros above count1 make
    the early-return form and the full permutation bit-identical)."""
    s = fd.side
    if not (s.win_switch_flag[gr][ch] and s.block_type[gr][ch] == 2):
        return x
    sfreq = fd.header.sampling_frequency
    lay = T.layout_id(sfreq, 1, 2, int(s.mixed_block_flag[gr][ch]))
    perm = T.layout_maps(fd.header.family)["reorder"][lay]
    return x[perm]


def _stereo(fd: FrameData, gr: int, x: np.ndarray,
            bug_compat_short_intensity: bool = False) -> None:
    """pdmp3.c:1911-1972, 2154-2220. x: float32[2,576], modified in place."""
    h, s = fd.header, fd.side
    if h.mode != 1 or h.mode_extension == 0:
        return
    raw0 = x[0].copy() if (h.family and (h.mode_extension & 0x1)) else None
    if h.mode_extension & 0x2:
        if h.family:
            # LSF: full-spectrum butterfly.  The reference's min-count1
            # extent (pdmp3.c:1920) is bug parity with no LSF target (the
            # reference rejects id=0); production decoders (libavcodec,
            # libmpg123) butterfly the whole spectrum, and real LAME
            # MPEG-2/2.5 joint-stereo streams decode audibly wrong under
            # the min-count1 extrapolation (round-5 real-encoder LSF
            # conformance).  Adjudicated in DESIGN.md §6.
            mp = 576
        else:
            # Mid/side over i < count1[gr][!!(c0 > c1)] — i.e. the
            # *smaller* count1 (pdmp3.c:1920): lines in [min, max) keep
            # the raw mid signal unscaled.
            mp = int(min(s.count1[gr][0], s.count1[gr][1]))
            mp = max(0, min(mp, 576))
        mid = x[0][:mp] + x[1][:mp]
        sid = x[0][:mp] - x[1][:mp]
        x[0][:mp] = (mid.astype(np.float64) * T.INV_SQRT2).astype(F32)
        x[1][:mp] = (sid.astype(np.float64) * T.INV_SQRT2).astype(F32)
    if h.mode_extension & 0x1:
        if h.family:
            # intensity pans the RAW ch0 (mid) carrier — with the
            # full-spectrum MS above, the post-MS value would be
            # mid/sqrt(2) on intensity bands (libavcodec processes the
            # intensity region before MS; same result, raw carrier)
            _intensity_lsf(fd, x, raw0)
            return
        sfreq = h.sampling_frequency
        c1r = int(s.count1[gr][1])

        def intensity_long(sfb: int) -> None:
            is_pos = int(fd.scalefac_l[gr][0][sfb])
            if is_pos == 7:
                return
            lo = int(T.SFB_LONG[sfreq][sfb])
            hi = int(T.SFB_LONG[sfreq][sfb + 1])
            if is_pos == 6:
                rl, rr = F32(1.0), F32(0.0)
            else:
                # 16-wide tables: 8..15 replay the reference's OOB
                # is_ratios read (probed rodata, tables.IS_RATIO_OOB_BITS)
                rl_t, rr_t = T.intensity_ratio_tables()
                rl, rr = F32(rl_t[is_pos]), F32(rr_t[is_pos])
            seg = x[0][lo:hi].copy()
            x[0][lo:hi] = rl * seg
            x[1][lo:hi] = rr * seg

        def intensity_short(sfb: int) -> None:
            wl = int(T.SFB_SHORT[sfreq][sfb + 1] - T.SFB_SHORT[sfreq][sfb])
            for w in range(3):
                is_pos = int(fd.scalefac_s[gr][0][sfb][w])
                if is_pos == 7:
                    continue
                lo = int(T.SFB_SHORT[sfreq][sfb]) * 3 + wl * w
                hi = lo + wl
                seg = x[0][lo:hi].copy()
                if bug_compat_short_intensity:
                    # pdmp3.c:2212-2213 transcription bug: assignment chain
                    # through *unsigned* ratio vars; left == right ==
                    # (float)(unsigned)seg (x86 trunc-to-u32 via i64).
                    u = np.trunc(seg.astype(np.float64)).astype(np.int64) \
                        .astype(np.uint32).astype(F32)
                    x[0][lo:hi] = u
                    x[1][lo:hi] = u
                else:
                    # spec-correct math, mirroring the long-block form
                    # (shared f32 ratio tables — same values the JAX and
                    # native spec-intensity modes use)
                    rl_t, rr_t = T.intensity_ratio_tables()
                    p = min(is_pos, 7)
                    x[0][lo:hi] = rl_t[p] * seg
                    x[1][lo:hi] = rr_t[p] * seg

        if s.win_switch_flag[gr][0] and s.block_type[gr][0] == 2:
            if s.mixed_block_flag[gr][0]:
                for sfb in range(8):
                    if T.SFB_LONG[sfreq][sfb] >= c1r:
                        intensity_long(sfb)
                for sfb in range(3, 12):
                    if T.SFB_SHORT[sfreq][sfb] * 3 >= c1r:
                        intensity_short(sfb)
            else:
                for sfb in range(12):
                    if T.SFB_SHORT[sfreq][sfb] * 3 >= c1r:
                        intensity_short(sfb)
        else:
            for sfb in range(21):
                if T.SFB_LONG[sfreq][sfb] >= c1r:
                    intensity_long(sfb)


def _intensity_lsf(fd: FrameData, x: np.ndarray,
                   raw0: np.ndarray | None = None) -> None:
    """LSF intensity stereo (13818-3 §2.4.3.2).  Spec-derived — the
    reference rejects LSF streams, so there is no bug parity here; this
    is the semantic contract the JAX and native paths must match.

    Positions come from ch1's transmitted scalefactors (frontend sidecar
    fd.is_eff_l/s, illegal values pre-mapped to tables.LSF_IS_ILLEGAL).
    Gains: io = 2^(-(intensity_scale+1)/4); odd p -> (io^((p+1)/2), 1),
    even p -> (1, io^(p/2)).  Bands whose position is illegal, and the
    untransmitted tail regions (long sfb21 / short band 12), pass
    through untouched — the same convention as the MPEG-1 path's
    is_pos==7 bands.  Band iteration follows ch0's block layout; a band
    is intensity-processed when it starts at or above ch1's count1
    (rzero), mirroring the MPEG-1 path."""
    h, s = fd.header, fd.side
    fam, sfreq = h.family, h.sampling_frequency
    longs = T.SFB_LONG_FAM[fam][sfreq]
    shorts = T.SFB_SHORT_FAM[fam][sfreq]
    k0t, k1t = T.lsf_intensity_tables()
    isc = int(fd.intensity_scale)
    c1r = int(s.count1[0][1])
    carrier = x[0] if raw0 is None else raw0

    def ilong(sfb: int) -> None:
        p = int(fd.is_eff_l[sfb])
        if p == T.LSF_IS_ILLEGAL:
            return
        lo, hi = int(longs[sfb]), int(longs[sfb + 1])
        seg = carrier[lo:hi].copy()
        x[0][lo:hi] = F32(k0t[isc][p]) * seg
        x[1][lo:hi] = F32(k1t[isc][p]) * seg

    def ishort(sfb: int) -> None:
        wl = int(shorts[sfb + 1] - shorts[sfb])
        for w in range(3):
            p = int(fd.is_eff_s[sfb][w])
            if p == T.LSF_IS_ILLEGAL:
                continue
            lo = int(shorts[sfb]) * 3 + wl * w
            hi = lo + wl
            seg = carrier[lo:hi].copy()
            x[0][lo:hi] = F32(k0t[isc][p]) * seg
            x[1][lo:hi] = F32(k1t[isc][p]) * seg

    if s.win_switch_flag[0][0] and s.block_type[0][0] == 2:
        if s.mixed_block_flag[0][0]:
            for sfb in range(int(T.SWITCH_SFB_L[fam])):
                if longs[sfb] >= c1r:
                    ilong(sfb)
            for sfb in range(T.SWITCH_SFB_S, 12):
                if shorts[sfb] * 3 >= c1r:
                    ishort(sfb)
        else:
            for sfb in range(12):
                if shorts[sfb] * 3 >= c1r:
                    ishort(sfb)
    else:
        for sfb in range(21):
            if longs[sfb] >= c1r:
                ilong(sfb)


def _antialias(fd: FrameData, gr: int, ch: int, x: np.ndarray) -> None:
    """pdmp3.c:1706-1732. In place on float32[576]."""
    s = fd.side
    if (s.win_switch_flag[gr][ch] and s.block_type[gr][ch] == 2
            and not s.mixed_block_flag[gr][ch]):
        return
    sblim = 2 if (s.win_switch_flag[gr][ch] and s.block_type[gr][ch] == 2
                  and s.mixed_block_flag[gr][ch]) else 32
    cs, ca = T.ANTIALIAS_CS, T.ANTIALIAS_CA
    for sb in range(1, sblim):
        for i in range(8):
            li = 18 * sb - 1 - i
            ui = 18 * sb + i
            lb = x[li] * cs[i] - x[ui] * ca[i]
            ub = x[ui] * cs[i] + x[li] * ca[i]
            x[li] = lb
            x[ui] = ub


def _imdct_win(inp: np.ndarray, block_type: int) -> np.ndarray:
    """pdmp3.c:1649-1700. inp: float32[18] -> float32[36]."""
    out = np.zeros(36, F32)
    if block_type == 2:
        win = T.IMDCT_WIN[2]
        for i3 in range(3):
            acc = np.zeros(12, F32)
            for m in range(6):
                acc = acc + inp[i3 + 3 * m] * T.COS_N12[m]
            out[6 * i3 + 6:6 * i3 + 18] = out[6 * i3 + 6:6 * i3 + 18] \
                + acc * win[:12]
    else:
        acc = np.zeros(36, F32)
        for m in range(18):
            acc = acc + inp[m] * T.COS_N36[m]
        out = acc * T.IMDCT_WIN[block_type]
    return out


class OracleDSP:
    """Per-stream DSP state + granule pipeline (bit-exact vs reference)."""

    def __init__(self, bug_compat_short_intensity: bool = True):
        self.store = np.zeros((2, 32, 18), F32)
        self.v_vec = np.zeros((2, 1024), F32)
        self.bug_compat = bug_compat_short_intensity

    def reset(self) -> None:
        self.store[:] = 0
        self.v_vec[:] = 0

    def decode_frame(self, fd: FrameData) -> np.ndarray:
        """Full Decode_L3 (pdmp3.c:1024-1060) -> packed PCM uint32[2,576].

        Layer I/II frames (fd.sb_samples set) skip the Layer III chain:
        the frontend already requantized the subband samples, so the DSP
        is the polyphase synthesis filterbank alone (same v_vec state,
        same quantize/pack semantics)."""
        nch = fd.header.nch
        out = np.zeros((2, 576), np.uint32)
        if fd.sb_samples is not None:
            nparts = fd.sb_samples.shape[1]
            for ch in range(nch):
                for p in range(nparts):
                    self._synth_step(ch, nch, fd.sb_samples[ch, p],
                                     out[p // 18], p % 18)
            return out
        prev = None
        for gr in range(fd.header.ngr):   # LSF frames: one granule
            x = np.zeros((2, 576), F32)
            for ch in range(nch):
                xr = _requantize(fd, gr, ch, prev_gr0_ch0=prev)
                x[ch] = _reorder(fd, gr, ch, xr)
            _stereo(fd, gr, x, self.bug_compat)
            for ch in range(nch):
                _antialias(fd, gr, ch, x[ch])
                self._hybrid_synthesis(fd, gr, ch, x[ch])
                self._freq_inversion(x[ch])
                self._subband_synthesis(fd, gr, ch, x[ch], out[gr])
            prev = x[0].copy()  # is[0][0] as gr1's requantizer sees it
        return out

    def _hybrid_synthesis(self, fd: FrameData, gr: int, ch: int,
                          x: np.ndarray) -> None:
        """pdmp3.c:1752-1780 with per-stream store state."""
        s = fd.side
        for sb in range(32):
            if (s.win_switch_flag[gr][ch] and s.mixed_block_flag[gr][ch]
                    and sb < 2):
                bt = 0
            else:
                bt = int(s.block_type[gr][ch])
            raw = _imdct_win(x[sb * 18:sb * 18 + 18], bt)
            x[sb * 18:sb * 18 + 18] = raw[:18] + self.store[ch][sb]
            self.store[ch][sb] = raw[18:]

    @staticmethod
    def _freq_inversion(x: np.ndarray) -> None:
        """pdmp3.c:1738-1746."""
        for sb in range(1, 32, 2):
            x[sb * 18 + 1:sb * 18 + 18:2] = -x[sb * 18 + 1:sb * 18 + 18:2]

    def _subband_synthesis(self, fd: FrameData, gr: int, ch: int,
                           x: np.ndarray, outdata: np.ndarray) -> None:
        """pdmp3.c:1978-2045 with per-stream v_vec state."""
        nch = fd.header.nch
        for ss in range(18):
            s_vec = x[ss::18].astype(F32)  # 32 subband samples
            self._synth_step(ch, nch, s_vec, outdata, ss)

    def _synth_step(self, ch: int, nch: int, s_vec: np.ndarray,
                    outdata: np.ndarray, ss: int) -> None:
        """One 32-sample synthesis step (pdmp3.c:2006-2042): v_vec FIFO
        shift, 64x32 cosine matrix, D-window FIR, S16 quantize/pack.
        Shared by Layer III (18 steps per granule) and Layer I/II (12/36
        steps per frame, subband samples direct from the frontend)."""
        v = self.v_vec[ch]
        v[64:] = v[:-64].copy()
        acc = np.zeros(64, F32)
        for j in range(32):
            acc = acc + T.SYNTH_NWIN[:, j] * s_vec[j]
        v[:64] = acc
        vv = v.reshape(8, 128)
        u = np.empty((8, 64), F32)
        u[:, :32] = vv[:, :32]
        u[:, 32:] = vv[:, 96:128]
        u = (u.reshape(512) * T.SYNTH_D).reshape(16, 32)
        acc = np.zeros(32, F32)
        for j in range(16):
            acc = acc + u[j]
        # (int32_t)(sum*32767.0) (pdmp3.c:2028): cvttsd2si semantics —
        # NaN or out-of-int32-range converts to INT32_MIN, which the
        # clip then maps to -32767 (full-scale overdrive wraps negative)
        t = np.trunc(acc.astype(np.float64) * 32767.0)
        with np.errstate(invalid="ignore"):
            oob = ~((t >= -2147483648.0) & (t <= 2147483647.0))
        samp = np.where(oob, -2147483648.0, t).astype(np.int64)
        samp = np.clip(samp, -32767, 32767).astype(np.int64) & 0xFFFF
        samp = samp.astype(np.uint32)
        o = slice(32 * ss, 32 * ss + 32)
        if ch == 0:
            if nch == 1:
                outdata[o] = (samp << 16) | samp
            else:
                outdata[o] = samp << 16
        else:
            outdata[o] = outdata[o] | samp
