"""MPEG-1 Layer III constant tables and derived lookup maps.

Frozen copy of ``pdmp3_tpu_torch/tables.py`` for the benchmark's plain
reference: it imports nothing of the program.

Data provenance: ISO/IEC 11172-3 specification constants.  Float tables whose
exact bit patterns matter for PCM parity with the reference decoder
(technosaurus/PDMP3) are extracted from the reference's frozen data by
``tools/extract_tables.py`` into ``_data/tables.npz`` (see that tool for the
reference file/line provenance of each block).  Small integer spec tables
(bitrates, sample rates, scalefactor band edges: pdmp3.c:517-533, 873-892,
2123) are transcribed here directly.

Beyond the raw constants, this module derives the *batched-decode* lookup
maps that make the TPU formulation possible: per-(samplerate, block-layout)
scalefactor-band index maps over the 576 frequency lines, short-block
reorder permutations, and the Huffman LUT decoder tables used by the host
frontend.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "_data", "tables.npz")

# ---------------------------------------------------------------------------
# Small spec tables (ISO 11172-3; cf. pdmp3.c:517-533, 873-892, 2123)
# ---------------------------------------------------------------------------

BITRATES = np.array([  # layer 1..3 x bitrate_index 0..14, bits/s
    [0, 32000, 64000, 96000, 128000, 160000, 192000, 224000,
     256000, 288000, 320000, 352000, 384000, 416000, 448000],
    [0, 32000, 48000, 56000, 64000, 80000, 96000, 112000,
     128000, 160000, 192000, 224000, 256000, 320000, 384000],
    [0, 32000, 40000, 48000, 56000, 64000, 80000, 96000,
     112000, 128000, 160000, 192000, 224000, 256000, 320000],
], np.int64)

SAMPLE_RATES = np.array([44100, 48000, 32000], np.int64)

# scalefac_compress -> (slen1, slen2)
SCALEFAC_SIZES = np.array([
    [0, 0], [0, 1], [0, 2], [0, 3], [3, 0], [1, 1], [1, 2], [1, 3],
    [2, 1], [2, 2], [2, 3], [3, 1], [3, 2], [3, 3], [4, 2], [4, 3],
], np.int32)

# Scalefactor band edges per sample-rate index: long[23], short[14]
SFB_LONG = np.array([
    [0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134,
     162, 196, 238, 288, 342, 418, 576],
    [0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128,
     156, 190, 230, 276, 330, 384, 576],
    [0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156,
     194, 240, 296, 364, 448, 550, 576],
], np.int32)

SFB_SHORT = np.array([
    [0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192],
    [0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192],
    [0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192],
], np.int32)

PRETAB = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2],
                  np.int32)

INV_SQRT2 = 0.70710678118654752440  # double, as the reference's C_PI sibling

# Streaming API status codes (libmpg123 subset, pdmp3.c:114-121)
OK = 0
ERR = -1
NEED_MORE = -10
NEW_FORMAT = -11
NO_SPACE = 7
ENC_SIGNED_16 = 0x080 | 0x040 | 0x10

INBUF_SIZE = 4 * 4096


# ---------------------------------------------------------------------------
# Extracted float/huffman data
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _npz():
    return np.load(_DATA)


def _arr(name: str) -> np.ndarray:
    a = _npz()[name]
    a.setflags(write=False)
    return a


ANTIALIAS_CS = _arr("antialias_cs")      # [8] f32
ANTIALIAS_CA = _arr("antialias_ca")      # [8] f32
IS_RATIOS = _arr("is_ratios")            # [6] f32
IMDCT_WIN = _arr("imdct_win")            # [4,36] f32
COS_N12 = _arr("cos_n12")                # [6,12] f32  (m, p)
COS_N36 = _arr("cos_n36")                # [18,36] f32 (m, p)
SYNTH_D = _arr("synth_d")                # [512] f32
SYNTH_NWIN = _arr("synth_nwin")          # [64,32] f32
POW43 = _arr("pow43")                    # [8207] f32: i^(4/3)
GAIN_QUARTER_DOWN = _arr("gain_quarter_down")  # [256] f32: 2^(-q/4)
GAIN_GLOBAL = _arr("gain_global")        # [312] f32: 2^((e-266)/4)
GAIN_GLOBAL_OFF = 266

# True 2^(-q/4) in double, rounded to f32 (the reference's live libm pow
# at pdmp3.c:2144) — unlike GAIN_QUARTER_DOWN, entries >= 100 are NOT
# repurposed as sentinel zeros.  640 entries cover every nonzero f32
# result: 2^(-600/4) = 2^-150 already rounds to +0.0 (half the minimum
# denormal, ties-to-even), and q >= 640 gives 2^-160 < that.  Used by the
# batched requantizer's exact band-12 OOB path (scalefactor read from
# float bits, docs/DESIGN.md §6), where q can be any uint32 bit pattern.
GAIN_QUARTER_TRUE = np.power(
    2.0, -0.25 * np.arange(640, dtype=np.float64)).astype(np.float32)
GAIN_QUARTER_TRUE.setflags(write=False)


# ---------------------------------------------------------------------------
# Huffman codebooks & LUT decoders
# ---------------------------------------------------------------------------

class HuffTable:
    """Canonical codebook + one-shot LUT decoder for one Layer III table."""

    __slots__ = ("num", "linbits", "entries", "maxlen", "lut", "ref_broken")

    def __init__(self, num: int, linbits: int, entries: np.ndarray,
                 ref_broken: bool = False):
        self.num = num
        self.linbits = int(linbits)
        self.entries = entries  # [n,4]: code, len, x, y
        # Reference-parity quirk: the reference's table directory points
        # table 33 into the middle of table 24's tree (pdmp3.c:569,
        # offset +2261 instead of +2773), hitting a 0-bit leaf with payload
        # (x=2, y=3).  Every count1table_select==1 quad therefore decodes
        # as (v,w,x,y)=(0,0,1,1) consuming only the two sign bits.  When
        # ref_broken is set the decoder must emulate that instead of using
        # the real tree stored in `entries`.
        self.ref_broken = ref_broken
        if len(entries) == 0:
            self.maxlen = 0
            self.lut = None
            return
        self.maxlen = int(entries[:, 1].max())
        # Single-level LUT over maxlen bits: value = (len<<8)|(x<<4)|y.
        # Layer III max code length is 19 bits -> at most 512K entries for
        # table 13/15 class; fine for host memory, and the C++ frontend uses
        # a two-level variant generated from the same codebook.
        lut = np.zeros(1 << self.maxlen, np.uint32)
        for code, length, x, y in entries:
            shift = self.maxlen - length
            lo = code << shift
            hi = lo + (1 << shift)
            lut[lo:hi] = (length << 8) | (x << 4) | y
        assert (lut != 0).all() or self.maxlen == 0 or (
            (lut == 0).sum() == 0), f"incomplete table {num}"
        self.lut = lut

    def decode(self, peek: int):
        """peek: next maxlen bits (MSB-first). Returns (length, x, y)."""
        v = int(self.lut[peek])
        return v >> 8, (v >> 4) & 0xF, v & 0xF


@functools.lru_cache(maxsize=1)
def huffman_tables() -> list[HuffTable]:
    rows = _npz()["huff_rows"]          # [N,5] table, code, len, x, y
    offsets = _npz()["huff_offsets"]
    linbits = _npz()["huff_linbits"]
    out = []
    for t in range(34):
        ent = rows[offsets[t]:offsets[t + 1], 1:5]
        out.append(HuffTable(t, int(linbits[t]), ent, ref_broken=(t == 33)))
    return out


# ---------------------------------------------------------------------------
# Derived per-layout maps for batched (TPU) execution.
#
# A "layout" identifies how the 576 frequency lines of one granule-channel
# map onto scalefactor bands/windows:
#   layout = sfreq * 3 + {0: long, 1: short, 2: mixed}
# (block_type in {0,1,3} => long layout; block_type 2 => short or mixed).
# ---------------------------------------------------------------------------

N_LAYOUTS = 9
LONG, SHORT, MIXED = 0, 1, 2


def layout_id(sfreq: int, win_switch: int, block_type: int, mixed: int) -> int:
    if win_switch and block_type == 2:
        return sfreq * 3 + (MIXED if mixed else SHORT)
    return sfreq * 3 + LONG


@functools.lru_cache(maxsize=None)
def layout_maps(family: int = 0):
    """Per-layout [9, 576] int32 maps used by the batched requantize/stereo
    kernels, plus the short-block reorder permutation.  family selects the
    sample-rate generation's band-edge tables (0 = MPEG-1; 1/2 = LSF, same
    layout-id space, different edges and a switch point of 6 long bands
    for mixed blocks instead of 8 — SWITCH_SFB_L).

    Returns dict of arrays, each [N_LAYOUTS, 576] unless noted:
      sfb:        scalefactor band index of each line (long band 0-21 for
                  long regions incl. the untransmitted sfb21 region; short
                  band 0-12 for short regions)
      win:        window index 0-2 for short regions, 0 for long regions
      sbgain_win: same as win (alias kept for clarity)
      is_short:   1 where the line belongs to a short-block region
      reorder:    permutation p with  is_reordered[i] = is_raw[p[i]]
                  (identity for long layouts)
    """
    sfb_map = np.zeros((N_LAYOUTS, 576), np.int32)
    win_map = np.zeros((N_LAYOUTS, 576), np.int32)
    short_map = np.zeros((N_LAYOUTS, 576), np.int32)
    reorder = np.tile(np.arange(576, dtype=np.int32), (N_LAYOUTS, 1))
    switch_l = SWITCH_SFB_L[family]

    for sf in range(3):
        louts = SFB_LONG_FAM[family][sf]
        shrts = SFB_SHORT_FAM[family][sf]
        # the mixed long/short regions tile 576 without gap or overlap in
        # every family: long sfbs 0..switch_l-1 end exactly where short
        # sfb 3 starts (incl. the 8 kHz 72-line case)
        assert louts[switch_l] == 3 * shrts[SWITCH_SFB_S]

        # long layout: sfb index per line (sfb 21 = untransmitted region)
        lay = sf * 3 + LONG
        for b in range(22):
            sfb_map[lay, louts[b]:louts[b + 1]] = b

        for kind in (SHORT, MIXED):
            lay = sf * 3 + kind
            start_sfb = SWITCH_SFB_S if kind == MIXED else 0
            if kind == MIXED:
                # leading long region: bands 0..switch_l-1
                for b in range(switch_l):
                    sfb_map[lay, louts[b]:louts[b + 1]] = b
            # short bands cover [3*shrts[start_sfb], 576) in groups of
            # 3 windows x win_len
            i = 3 * shrts[start_sfb]
            for b in range(start_sfb, 13):
                wl = shrts[b + 1] - shrts[b]
                for w in range(3):
                    sfb_map[lay, i:i + wl] = b
                    win_map[lay, i:i + wl] = w
                    short_map[lay, i:i + wl] = 1
                    i += wl
            assert i == 576
            # reorder permutation (pdmp3.c:1786-1823): within band b,
            # reordered[3*s[b] + 3*j + w] = raw[3*s[b] + w*wl + j]
            base0 = 3 * shrts[start_sfb]
            for b in range(start_sfb, 12):
                s0 = 3 * shrts[b]
                wl = shrts[b + 1] - shrts[b]
                for w in range(3):
                    for j in range(wl):
                        reorder[lay, s0 + 3 * j + w] = s0 + w * wl + j
            # band 12 region [3*s[12], 576) is reordered with wl = s[13]-s[12]
            s0 = 3 * shrts[12]
            wl = shrts[13] - shrts[12]
            for w in range(3):
                for j in range(wl):
                    reorder[lay, s0 + 3 * j + w] = s0 + w * wl + j
            del base0

    return {
        "sfb": sfb_map,
        "win": win_map,
        "is_short": short_map,
        "reorder": reorder,
    }


@functools.lru_cache(maxsize=None)
def stereo_maps(family: int = 0):
    """Per-layout [9,576] maps for the batched intensity-stereo kernel:

      band_start:   first frequency line of the line's scalefactor band
                    (short bands: 3*s[sfb], the value compared against
                    count1 of the right channel, pdmp3.c:1946-1965)
      intensity_ok: 1 where the reference's band loops can reach this line
                    (long sfb 0-20 only; short sfb 0-11; mixed long +
                    short 3-11 — the sfb21/band-12 regions are never
                    intensity processed); the LSF families keep the same
                    eligibility bounds (spec-mode, docs/DESIGN.md)
    """
    maps = layout_maps(family)
    band_start = np.zeros((N_LAYOUTS, 576), np.int32)
    ok = np.zeros((N_LAYOUTS, 576), np.int32)
    for sf in range(3):
        for kind in (LONG, SHORT, MIXED):
            lay = sf * 3 + kind
            sfb = maps["sfb"][lay]
            short = maps["is_short"][lay]
            for i in range(576):
                b = sfb[i]
                if short[i]:
                    band_start[lay, i] = 3 * SFB_SHORT_FAM[family][sf][b]
                    ok[lay, i] = 1 if b < 12 else 0
                else:
                    band_start[lay, i] = SFB_LONG_FAM[family][sf][b]
                    ok[lay, i] = 1 if b < 21 else 0
    return {"band_start": band_start, "intensity_ok": ok}


# ---------------------------------------------------------------------------
# MPEG-2 / MPEG-2.5 low-sampling-frequency (LSF) extension (ISO 13818-3).
#
# The reference decoder REJECTS id==0 headers outright (pdmp3.c:1295), so
# everything in this section is spec-derived capability beyond the
# reference; there is no bug-parity target and no external oracle in this
# image — correctness rests on 3-way in-tree agreement (frontend.py /
# host frontend / JAX) plus the spec-vector tests in tests/test_lsf.py.
#
# A "family" selects the sample-rate generation:
#   0 = MPEG-1   (44.1 / 48 / 32 kHz, 2 granules per frame)
#   1 = MPEG-2   (22.05 / 24 / 16 kHz, 1 granule per frame)
#   2 = MPEG-2.5 (11.025 / 12 / 8 kHz, 1 granule per frame)
# Layout ids stay 0..8 *within* a family (sfreq*3 + kind); every derived
# map below takes a family argument so each family compiles its own
# device program with [9,576] constants — folding all 27 layouts into one
# table set would tax the hot requantize expansions 3x (docs/ROADMAP.md).
# ---------------------------------------------------------------------------

N_FAMILIES = 3

SAMPLE_RATES_FAM = np.array([
    [44100, 48000, 32000],
    [22050, 24000, 16000],
    [11025, 12000, 8000],
], np.int64)

# Layer III LSF bitrates (13818-3 Table B.2; shared by MPEG-2 and 2.5)
BITRATES_LSF = np.array(
    [0, 8000, 16000, 24000, 32000, 40000, 48000, 56000, 64000,
     80000, 96000, 112000, 128000, 144000, 160000], np.int64)

# Scalefactor band edges per LSF sample rate (13818-3 Table B.8):
# long[23] / short[14].  22.05, 16, 11.025 and 12 kHz share the long
# table; 16/11.025/12 share the short table; 8 kHz carries the famous
# 2-line tail bands.
_SFB_L_22 = [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168,
             200, 238, 284, 336, 396, 464, 522, 576]
# 24 kHz band 17/18 edge: the ecosystem is split on this single entry
# (ISO 13818-3 Table B.8 discrepancy).  libmpg123 + LAME (dist10
# lineage) use 332; libavcodec uses 330.  Round-5 edge census (high-
# power single-line probes over EVERY LSF band edge, both families,
# all rates) found this to be the ONLY disputed point.  We follow the
# ENCODER: real LAME 24 kHz granules place region2 at longs[18]=332 and
# only fit their part2_3_length under 332 (source-correlation referee:
# mpg123 0.876 vs ffmpeg 0.74) — so 24 kHz conformance anchors against
# libmpg123, not libavcodec (tests/test_real_encoder.py).
_SFB_L_24 = [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162,
             194, 232, 278, 332, 394, 464, 540, 576]
_SFB_L_8 = [0, 12, 24, 36, 48, 60, 72, 88, 108, 132, 160, 192, 232, 280,
            336, 400, 476, 566, 568, 570, 572, 574, 576]
_SFB_S_22 = [0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192]
_SFB_S_24 = [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192]
_SFB_S_16 = [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192]
_SFB_S_8 = [0, 8, 16, 24, 36, 52, 72, 96, 124, 160, 162, 164, 166, 192]

SFB_LONG_FAM = np.array([
    SFB_LONG,
    [_SFB_L_22, _SFB_L_24, _SFB_L_22],
    [_SFB_L_22, _SFB_L_22, _SFB_L_8],
], np.int32)         # [family, sfreq, 23]

SFB_SHORT_FAM = np.array([
    SFB_SHORT,
    [_SFB_S_22, _SFB_S_24, _SFB_S_16],
    [_SFB_S_16, _SFB_S_16, _SFB_S_8],
], np.int32)         # [family, sfreq, 14]

# Scalefactor-count partitions for the LSF scalefac_compress derivation
# (13818-3 §2.4.3.4): [block_number, block_class, partition] where
# block_class is 0 long / 1 short / 2 mixed.  Rows 0-2 serve the normal
# derivation, rows 3-5 the intensity-channel variant.
NR_OF_SFB = np.array([
    [[6, 5, 5, 5], [9, 9, 9, 9], [6, 9, 9, 9]],
    [[6, 5, 7, 3], [9, 9, 12, 6], [6, 9, 12, 6]],
    [[11, 10, 0, 0], [18, 18, 0, 0], [15, 18, 0, 0]],
    [[7, 7, 7, 0], [12, 12, 12, 0], [6, 15, 12, 0]],
    [[6, 6, 6, 3], [12, 9, 9, 6], [6, 12, 9, 6]],
    [[8, 8, 5, 0], [15, 12, 9, 0], [6, 18, 9, 0]],
], np.int32)

# LSF mixed blocks switch from long to short scalefactor bands at long
# sfb 6 (MPEG-1: 8) — the nr_of_sfb mixed rows all start with 6.
SWITCH_SFB_L = (8, 6, 6)      # per family
SWITCH_SFB_S = 3

# "No intensity position" sentinel on the wire: the host maps each band
# whose transmitted is_pos equals the all-ones illegal value
# ((1<<slen)-1, 13818-3 §2.4.3.4.3) to this, and the device skips it.
LSF_IS_ILLEGAL = 63


def lsf_slen(scalefac_compress: int, intensity_ch: bool
             ) -> tuple[tuple[int, int, int, int], int, int, int]:
    """LSF scalefactor field-width derivation (13818-3 §2.4.3.4).

    Returns (slen[4], block_number, preflag, intensity_scale).  For the
    intensity channel (ch1 of an intensity-stereo frame) the 9-bit field
    is split: bit 0 is intensity_scale, bits 1.. select the variant rows.
    """
    sc = int(scalefac_compress)
    if not intensity_ch:
        if sc < 400:
            sl = ((sc >> 4) // 5, (sc >> 4) % 5, (sc % 16) >> 2, sc % 4)
            return sl, 0, 0, 0
        if sc < 500:
            s2 = sc - 400
            return ((s2 >> 2) // 5, (s2 >> 2) % 5, s2 % 4, 0), 1, 0, 0
        s2 = sc - 500
        return (s2 // 3, s2 % 3, 0, 0), 2, 1, 0
    iscale = sc & 1
    si = sc >> 1
    if si < 180:
        return (si // 36, (si % 36) // 6, si % 6, 0), 3, 0, iscale
    if si < 244:
        s2 = si - 180
        return ((s2 % 64) >> 4, (s2 % 16) >> 2, s2 % 4, 0), 4, 0, iscale
    s2 = si - 244
    return (s2 // 3, s2 % 3, 0, 0), 5, 0, iscale


@functools.lru_cache(maxsize=8)
def lsf_intensity_tables():
    """LSF intensity-stereo gain pairs (13818-3 §2.4.3.2): k0/k1 [2, 64]
    float32 indexed [intensity_scale, is_pos] with
    io = 2^(-(intensity_scale+1)/4):

        is_pos odd : (k0, k1) = (io^((is_pos+1)/2), 1)
        is_pos even: (k0, k1) = (1, io^(is_pos/2))

    Index LSF_IS_ILLEGAL (and anything >= 32) returns (1, 1); callers
    must additionally *skip* the band (pass-through, not re-scale) —
    the sentinel rows only make masked gathers safe."""
    k0 = np.ones((2, 64), np.float64)
    k1 = np.ones((2, 64), np.float64)
    for iscale in range(2):
        io = 2.0 ** (-0.25 * (iscale + 1))
        for p in range(32):
            if p & 1:
                k0[iscale, p] = io ** ((p + 1) >> 1)
            else:
                k1[iscale, p] = io ** (p >> 1)
    return k0.astype(np.float32), k1.astype(np.float32)


# MPEG-2 Layer I bitrates (13818-3 Table B.2; Layers II and III share
# BITRATES_LSF above)
BITRATES_LSF_L1 = np.array(
    [0, 32000, 48000, 56000, 64000, 80000, 96000, 112000, 128000,
     144000, 160000, 176000, 192000, 224000, 256000], np.int64)


def lsf_frame_size(bitrate_index: int, sfreq: int, family: int,
                   padding: int, layer: int = 3) -> int:
    """LSF Layer III frames carry ONE 576-sample granule: size =
    72 * bitrate / rate + padding (vs MPEG-1's 144 factor).  LSF
    Layer II keeps the full 1152-sample frame (144 factor); Layer I
    is handled by Header.frame_size directly."""
    factor = 144 if layer == 2 else 72
    return (factor * int(BITRATES_LSF[bitrate_index])
            // int(SAMPLE_RATES_FAM[family][sfreq]) + padding)


# What the reference reads for is_pos 8..15: Stereo_Process_Intensity_Long
# indexes is_ratios[6] with any scalefactor but 7 (pdmp3.c:2163-2172), and
# hostile-but-parseable streams put 8..15 there.  In the reference
# binary's rodata the array is followed by 8 bytes of alignment padding
# and then ca[8] (probed from the built binary by
# testing/golden.probe_is_ratio_oob; locked by
# test_is_ratio_oob_matches_reference_binary).  Frozen bit patterns:
IS_RATIO_OOB_BITS = np.array(
    [0x00000000, 0x00000000,              # padding after is_ratios[6]
     0xBF03B603, 0xBEF186DB, 0xBEA072F3, 0xBE3A4767,   # = ca[0..3]
     0xBDC1B003, 0xBD27CBF7, 0xBC68A2EC, 0xBB727BB3],  # = ca[4..7]
    np.uint32)


@functools.lru_cache(maxsize=1)
def intensity_ratio_tables():
    """is_pos -> (ratio_l, ratio_r) as float32, computed with the exact op
    order of the reference (pdmp3.c:2167-2172): index 6 is the hard-left
    special case, index 7 is 'no intensity' (masked by the caller);
    8..15 replay the reference's out-of-bounds is_ratios read (the
    probed rodata values above) through the same ratio formula."""
    ext = np.concatenate([np.asarray(IS_RATIOS, np.float32),
                          IS_RATIO_OOB_BITS.view(np.float32)])
    rl = np.zeros(16, np.float32)
    rr = np.zeros(16, np.float32)
    one = np.float32(1.0)
    for p in range(16):
        if p in (6, 7):
            continue
        r = ext[p]
        rl[p] = np.float32(r / (one + r))
        rr[p] = np.float32(one / (one + r))
    rl[6], rr[6] = 1.0, 0.0
    return rl, rr


@functools.lru_cache(maxsize=1)
def freq_inversion_sign() -> np.ndarray:
    """[32,18] float32: -1 at (odd subband, odd sample), else +1
    (pdmp3.c:1738-1746)."""
    s = np.ones((32, 18), np.float32)
    s[1::2, 1::2] = -1.0
    return s


# ---- Layer I/II (beyond-reference: the reference hard-errors on
# layer != 3, pdmp3.c:1240/1312; constants from ISO 11172-3 §2.4.3.2-3
# and tables B.1-B.4, spec-derived — no reference code to mirror) ----

# Layer II quantization classes (11172-3 table B.4): steps -> (codeword
# bits, grouped, C, D).  Grouped classes pack 3 samples per codeword;
# the dequant map is s'' = C * (s''' + D) with s''' the MSB-inverted
# two's-complement fraction of the (per-sample) code.
L2_CLASSES = {
    3:     (5,  True,  4 / 3,         1 / 2),
    5:     (7,  True,  8 / 5,         1 / 2),
    7:     (3,  False, 8 / 7,         1 / 4),
    9:     (10, True,  16 / 9,        1 / 2),
    15:    (4,  False, 16 / 15,       1 / 8),
    31:    (5,  False, 32 / 31,       1 / 16),
    63:    (6,  False, 64 / 63,       1 / 32),
    127:   (7,  False, 128 / 127,     1 / 64),
    255:   (8,  False, 256 / 255,     1 / 128),
    511:   (9,  False, 512 / 511,     1 / 256),
    1023:  (10, False, 1024 / 1023,   1 / 512),
    2047:  (11, False, 2048 / 2047,   1 / 1024),
    4095:  (12, False, 4096 / 4095,   1 / 2048),
    8191:  (13, False, 8192 / 8191,   1 / 4096),
    16383: (14, False, 16384 / 16383, 1 / 8192),
    32767: (15, False, 32768 / 32767, 1 / 16384),
    65535: (16, False, 65536 / 65535, 1 / 32768),
}

# Allocation tables B.2a-d: per-subband (nbal, steps per nonzero index).
_STEPS_A_LOW = (3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
                16383, 32767, 65535)
_STEPS_A_MID = (3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
                8191, 65535)
_STEPS_A_HI = (3, 5, 7, 9, 15, 31, 65535)
_STEPS_A_TOP = (3, 5, 65535)
_STEPS_CD_LOW = (3, 5, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
                 8191, 16383, 32767)
_STEPS_CD_HI = (3, 5, 9, 15, 31, 63, 127)
_STEPS_LSF_LOW = (3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
                  8191, 16383)
_STEPS_LSF_MID = (3, 5, 9, 15, 31, 63, 127)
_STEPS_LSF_TOP = (3, 5, 9)

L2_ALLOC_A = ([(4, _STEPS_A_LOW)] * 3 + [(4, _STEPS_A_MID)] * 8
              + [(3, _STEPS_A_HI)] * 12 + [(2, _STEPS_A_TOP)] * 4)
L2_ALLOC_B = ([(4, _STEPS_A_LOW)] * 3 + [(4, _STEPS_A_MID)] * 8
              + [(3, _STEPS_A_HI)] * 12 + [(2, _STEPS_A_TOP)] * 7)
L2_ALLOC_C = [(4, _STEPS_CD_LOW)] * 2 + [(3, _STEPS_CD_HI)] * 6
L2_ALLOC_D = [(4, _STEPS_CD_LOW)] * 2 + [(3, _STEPS_CD_HI)] * 10
# 13818-3 table B.1 (LSF Layer II, all bitrates/rates)
L2_ALLOC_LSF = ([(4, _STEPS_LSF_LOW)] * 4 + [(3, _STEPS_LSF_MID)] * 7
                + [(2, _STEPS_LSF_TOP)] * 19)

# Layer I/II scalefactors (11172-3 table B.1): 2 * 2^(-i/3), i = 0..62.
SCF_L12 = (2.0 * np.exp2(-np.arange(63) / 3.0)).astype(np.float32)


def l2_alloc_table(bitrate_index: int, sfreq: int, nch: int,
                   family: int = 0) -> list:
    """Select the Layer II allocation table (11172-3 §2.4.2.1: by
    per-channel bitrate and sampling frequency; 13818-3: LSF streams
    always use table B.1)."""
    if family:
        return L2_ALLOC_LSF
    freq = int(SAMPLE_RATES[sfreq])
    kbps = int(BITRATES[1][bitrate_index]) // 1000 // nch
    if bitrate_index == 0:      # free format: highest-rate table
        return L2_ALLOC_A if freq == 48000 else L2_ALLOC_B
    if (freq == 48000 and kbps >= 56) or (56 <= kbps <= 80):
        return L2_ALLOC_A
    if freq != 48000 and kbps >= 96:
        return L2_ALLOC_B
    if freq != 32000 and kbps <= 48:
        return L2_ALLOC_C
    return L2_ALLOC_D


def l1_steps(alloc: int) -> int:
    """Layer I: 4-bit allocation index -> quantization steps
    (11172-3 §2.4.2.1: nb = alloc + 1 bits, 2^nb - 1 levels; the code
    is read ungrouped with the Layer II dequant map)."""
    return (1 << (alloc + 1)) - 1


def l12_bound(mode: int, mode_extension: int, sblimit: int) -> int:
    """First subband of the joint-stereo (intensity) region
    (11172-3 §2.4.2.1): bound = (mode_extension + 1) * 4 in joint
    mode, else all subbands are independent."""
    if mode != 1:
        return sblimit
    return min((mode_extension + 1) * 4, sblimit)


def crc16_mpeg(data: bytes, crc: int = 0xFFFF) -> int:
    """ISO 11172-3 §2.4.3.1 CRC-16: poly 0x8005 MSB-first, init 0xFFFF,
    computed over header bytes 2-3 + the protected audio-data bytes
    (Layer III: the whole side info).  The reference reads and DISCARDS
    the CRC bytes (pdmp3.c:1206-1210); this law is validated against
    libavcodec's AV_EF_CRCCHECK in tests/test_crc.py."""
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005 if crc & 0x8000 else crc << 1) \
                & 0xFFFF
    return crc


def crc16_mpeg_bits(data: bytes, nbits: int, crc: int = 0xFFFF) -> int:
    """crc16_mpeg over the first ``nbits`` bits of ``data`` (MSB-first).

    Layer I/II protected regions (allocation + Layer II scfsi) are not
    byte-aligned in general — the CRC runs over exact bits."""
    nbytes, rem = nbits >> 3, nbits & 7
    crc = crc16_mpeg(data[:nbytes], crc)
    if rem:
        b = data[nbytes]
        for i in range(7, 7 - rem, -1):
            bit = (b >> i) & 1
            if ((crc >> 15) & 1) ^ bit:
                crc = ((crc << 1) ^ 0x8005) & 0xFFFF
            else:
                crc = (crc << 1) & 0xFFFF
    return crc


def l12_protected_bits(layer: int, nch: int, bound: int,
                       alloc_widths, body: bytes) -> int:
    """Bit extent of the CRC-protected region of a Layer I/II frame
    body (11172-3 §2.4.3.1).  Layer I: FIXED 128/256 bits (4·32·nch) —
    for joint stereo that runs past the actual allocation into the
    scalefactor bits, but it is what both the standard's fixed-length
    definition and libavcodec's checker use (pinned empirically:
    ffmpeg rejects the bound-aware 4·(bound·2+(32-bound)) extent).
    Layer II: dynamic — bit allocation + scfsi, whose presence depends
    on the allocation values, so those fields are pre-scanned here.
    ``alloc_widths`` lists nbal per subband (len == sblimit)."""
    if layer == 1:
        return min(4 * 32 * nch, 8 * len(body))
    pos = 0
    nz = 0
    end = 8 * len(body)

    def get(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            if pos < end:               # truncated body: read zeros
                v = (v << 1) | ((body[pos >> 3] >> (7 - (pos & 7))) & 1)
            else:
                v <<= 1
            pos += 1
        return v

    for sb, nbal in enumerate(alloc_widths):
        if sb < bound:
            for _ in range(nch):
                nz += 1 if get(nbal) else 0
        else:
            nz += nch if get(nbal) else 0
    return min(pos + 2 * nz, end)
