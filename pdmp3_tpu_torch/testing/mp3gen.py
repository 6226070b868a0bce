"""Synthetic MPEG-1 Layer III bitstream generator.

Generates *valid* Layer III streams with precise control over every coding
feature — block types (long/short/mixed), stereo modes (LR / MS / intensity /
both), scfsi sharing, bit-reservoir placement (main_data_begin chains),
stuffing bits, CRC frames, padding, all three sample rates and any bitrate —
so the conformance suite can cover the full format matrix without an
external encoder.  The output is not meaningful audio; it is a
coverage-directed bitstream whose decode is compared 1:1 between the
reference C decoder and pdmp3_tpu.

The generator is also careful to stay inside the reference decoder's
*defined* behavior: it never emits big_values/count1 extents that drive the
reference into its out-of-bounds scalefactor reads (long lines past
sfb-band 21 / short past band 12, cf. pdmp3.c:1896-1902 with a 21-entry
scalefac array), and it only enables short-block intensity stereo on request
(the reference's Stereo_Process_Intensity_Short has a transcription bug,
pdmp3.c:2212-2213).
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np

from .. import tables as T


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int) -> None:
        assert 0 <= value < (1 << n), (value, n)
        for k in range(n - 1, -1, -1):
            self.bits.append((value >> k) & 1)

    def nbits(self) -> int:
        return len(self.bits)

    def to_bytes(self, pad_to_byte: bool = True) -> bytes:
        bits = self.bits
        out = bytearray()
        for i in range(0, len(bits) - 7, 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        rem = len(bits) % 8
        if rem and pad_to_byte:
            b = 0
            for j in range(rem):
                b = (b << 1) | bits[len(bits) - rem + j]
            b <<= 8 - rem
            out.append(b)
        return bytes(out)


def _encode_maps():
    """Per-table dict (x, y) -> (code, len) from the canonical codebooks."""
    maps = []
    for tab in T.huffman_tables():
        m = {}
        for code, length, x, y in tab.entries:
            m[(int(x), int(y))] = (int(code), int(length))
        maps.append(m)
    return maps


_ENC = None


def _enc():
    global _ENC
    if _ENC is None:
        _ENC = _encode_maps()
    return _ENC


@dataclasses.dataclass
class GranuleSpec:
    """One granule-channel's coding parameters + spectrum."""
    block_type: int = 0          # 0 long, 1 start, 2 short, 3 stop
    win_switch: int = 0
    mixed: int = 0
    global_gain: int = 160
    scalefac_compress: int = 5
    scalefac_scale: int = 0
    preflag: int = 0
    subblock_gain: tuple = (0, 0, 0)
    table_select: tuple = (1, 2, 5)   # per region (2 used if win_switch)
    region0_count: int = 4
    region1_count: int = 3
    count1table_select: int = 0
    scalefac_l: np.ndarray | None = None   # [21]
    scalefac_s: np.ndarray | None = None   # [12,3]
    values: np.ndarray | None = None       # int spectrum [576]
    big_values: int = 0
    n_quads: int = 0
    stuffing_bits: int = 0
    # LSF only (13818-3): flat scalefactors in transmission order, and
    # the partition widths they were drawn under (scalefac_compress is
    # 9-bit; preflag is derived, not transmitted)
    lsf_flat: list | None = None
    lsf_slen: tuple | None = None
    lsf_counts: tuple | None = None


def _table_max(table_num: int) -> int:
    """Largest |value| encodable by a big-values table."""
    tab = T.huffman_tables()[table_num]
    if tab.maxlen == 0:
        return 0
    mx = int(tab.entries[:, 2].max())
    if tab.linbits:
        return 15 + (1 << tab.linbits) - 1
    return mx


def make_granule(rng: random.Random, *, sfreq: int, block: str = "long",
                 stereo_extent: float = 1.0, amp: int = 6,
                 stuffing: int = 0, scalefac_scale: int | None = None,
                 preflag: int | None = None,
                 intensity_pos: int | None = None,
                 max_lines: int = 576, family: int = 0,
                 intensity_ch: bool = False,
                 rzero_on_sfb: bool = False) -> GranuleSpec:
    """Build a random-but-valid granule spec.

    block: "long" | "start" | "stop" | "short" | "mixed"
    stereo_extent: fraction of the allowed spectrum extent that carries
      nonzero big_values (use < 1.0 on ch1 to trigger intensity bands).
    intensity_pos: if given, fill scalefactors with this is_pos value
      (0..15, clamped to the slen field width; 8..15 reach the
      reference's OOB is_ratios regime on long blocks).
    """
    g = GranuleSpec()
    g.block_type = {"long": 0, "start": 1, "stop": 3,
                    "short": 2, "mixed": 2}[block]
    g.win_switch = 1 if block in ("start", "stop", "short", "mixed") else 0
    g.mixed = 1 if block == "mixed" else 0
    g.global_gain = rng.randrange(120, 200)
    if family:
        # LSF: every 9-bit scalefac_compress value is decodable; preflag
        # is derived (blocknumber 2 <=> sc >= 500 on a normal channel)
        g.scalefac_compress = rng.randrange(512)
    else:
        g.scalefac_compress = rng.randrange(16)
    g.scalefac_scale = rng.randrange(2) if scalefac_scale is None else scalefac_scale
    g.preflag = (rng.randrange(2) if preflag is None else preflag) \
        if not g.win_switch else rng.randrange(2)
    g.count1table_select = rng.randrange(2)

    # stay clear of the reference's OOB scalefac region (see module doc)
    if g.win_switch and g.block_type == 2:
        limit = 3 * int(T.SFB_SHORT_FAM[family][sfreq][12])
    else:
        limit = int(T.SFB_LONG_FAM[family][sfreq][21])
    limit -= 8 + 4 * stuffing  # headroom for stuffing-driven extra quads

    if g.win_switch:
        g.subblock_gain = tuple(rng.randrange(3) for _ in range(3))
        # region counts implicit (pdmp3.c:1181-1185)
        if g.block_type == 2 and not g.mixed:
            g.region0_count, g.region1_count = 8, 12
        else:
            g.region0_count, g.region1_count = 7, 13
        tsel = [rng.choice([1, 2, 3, 5, 6, 7, 8, 16, 24]) for _ in range(2)]
        g.table_select = (tsel[0], tsel[1], 0)
    else:
        g.region0_count = rng.randrange(0, 10)
        g.region1_count = rng.randrange(0, min(8, 20 - g.region0_count))
        g.table_select = tuple(
            rng.choice([1, 2, 3, 5, 6, 7, 8, 10, 13, 15, 16, 24])
            for _ in range(3))

    # scalefactors
    def sf(nbits):
        if intensity_pos is not None:
            return min(intensity_pos, (1 << nbits) - 1) if nbits else 0
        return rng.randrange(1 << nbits) if nbits else 0

    if family:
        # LSF partitioned scalefactors (13818-3 §2.4.3.4), transmission
        # order; also distributed into scalefac_l/s in band order so the
        # decoder-side arrays can be compared directly
        slen, _bn, g.preflag, _isc = T.lsf_slen(g.scalefac_compress,
                                                intensity_ch)
        bclass = (2 if g.mixed else 1) \
            if (g.win_switch and g.block_type == 2) else 0
        counts = tuple(int(c) for c in T.NR_OF_SFB[_bn][bclass])
        flat = []
        for p in range(4):
            flat += [sf(int(slen[p])) for _ in range(counts[p])]
        g.lsf_flat, g.lsf_slen, g.lsf_counts = flat, tuple(slen), counts
        g.scalefac_l = np.zeros(21, np.int32)
        g.scalefac_s = np.zeros((12, 3), np.int32)
        k = 0
        if bclass == 0:
            g.scalefac_l[:21] = flat
        else:
            if bclass == 2:
                nl = int(T.SWITCH_SFB_L[family])
                g.scalefac_l[:nl] = flat[:nl]
                k = nl
            for b in range(T.SWITCH_SFB_S if bclass == 2 else 0, 12):
                for w in range(3):
                    g.scalefac_s[b][w] = flat[k]
                    k += 1
    else:
        slen1, slen2 = (int(v) for v in T.SCALEFAC_SIZES[g.scalefac_compress])
        g.scalefac_l = np.array(
            [sf(slen1 if b < 11 else slen2) for b in range(21)], np.int32)
        g.scalefac_s = np.array(
            [[sf(slen1 if b < 6 else slen2) for _ in range(3)]
             for b in range(12)], np.int32)

    # spectrum: big_values pairs then count1 quads then rzero
    extent = max(2, min(int(limit * stereo_extent), max_lines)) & ~1
    if rzero_on_sfb:
        # Pin the rzero start to a scalefactor-band edge with a nonzero
        # final quad.  The reference bounds intensity by count1 (the
        # Huffman rzero cursor, pdmp3.c:1944); a conformant decoder
        # (libavcodec) scans the actual zero samples — the two extents
        # only provably coincide when rzero begins exactly on a band
        # boundary and the last coded line is nonzero.  Band edges are
        # all even, so the `& ~1` above is preserved.
        if g.win_switch and g.block_type == 2 and not g.mixed:
            edges = [3 * int(e) for e in T.SFB_SHORT_FAM[family][sfreq][:13]]
        else:
            edges = [int(e) for e in T.SFB_LONG_FAM[family][sfreq][:22]]
        extent = max([e for e in edges if 6 <= e <= extent] or [8])
        q = rng.randrange(1, max(2, (extent - 2) // 4 + 1))
        big2 = extent - 4 * q
        while big2 < 2:
            q -= 1
            big2 = extent - 4 * q
        g.big_values = big2 // 2
        g.n_quads = q
    else:
        big2 = rng.randrange(2, extent + 1) & ~1
        g.big_values = big2 // 2
        max_quads = (extent - big2) // 4
        g.n_quads = rng.randrange(0, max_quads + 1) if max_quads > 0 else 0
    g.stuffing_bits = stuffing

    vals = np.zeros(576, np.int64)
    for i in range(big2):
        # region-respecting magnitude caps
        if g.win_switch and g.block_type == 2:
            region = 0 if i < 3 * int(T.SFB_SHORT_FAM[family][sfreq][3]) \
                else 1
        else:
            longs = T.SFB_LONG_FAM[family][sfreq]
            r1 = int(longs[g.region0_count + 1])
            r2 = int(longs[g.region0_count + g.region1_count + 2])
            region = 0 if i < r1 else (1 if i < r2 else 2)
        cap = min(_table_max(g.table_select[region]), amp)
        v = rng.randrange(0, cap + 1) if cap else 0
        vals[i] = -v if (v and rng.random() < 0.5) else v
    if g.count1table_select == 1:
        # broken-table-33 quads: always (0, 0, ±1, ±1)
        for q in range(g.n_quads):
            i = big2 + 4 * q
            vals[i + 2] = -1 if rng.random() < 0.5 else 1
            vals[i + 3] = -1 if rng.random() < 0.5 else 1
    else:
        for i in range(big2, big2 + 4 * g.n_quads):
            v = rng.randrange(0, 2)
            vals[i] = -v if (v and rng.random() < 0.5) else v
    if rzero_on_sfb and vals[extent - 1] == 0:
        vals[extent - 1] = -1 if rng.random() < 0.5 else 1
    g.values = vals
    return g


def _write_scalefacs(bw: BitWriter, g: GranuleSpec, gr: int,
                     scfsi: np.ndarray, g0: GranuleSpec | None) -> None:
    slen1, slen2 = (int(v) for v in T.SCALEFAC_SIZES[g.scalefac_compress])
    if g.win_switch and g.block_type == 2:
        if g.mixed:
            for b in range(8):
                bw.put(int(g.scalefac_l[b]), slen1)
            for b in range(3, 12):
                nb = slen1 if b < 6 else slen2
                for w in range(3):
                    bw.put(int(g.scalefac_s[b][w]), nb)
        else:
            for b in range(12):
                nb = slen1 if b < 6 else slen2
                for w in range(3):
                    bw.put(int(g.scalefac_s[b][w]), nb)
    else:
        groups = ((0, 6, slen1), (6, 11, slen1), (11, 16, slen2), (16, 21, slen2))
        for gi, (lo, hi, sl) in enumerate(groups):
            if gr == 1 and scfsi[gi]:
                # shared with granule 0: nothing transmitted; decoder copies
                g.scalefac_l[lo:hi] = g0.scalefac_l[lo:hi]
            else:
                for b in range(lo, hi):
                    bw.put(int(g.scalefac_l[b]), sl)


def _write_huffman(bw: BitWriter, g: GranuleSpec, sfreq: int,
                   family: int = 0) -> None:
    enc = _enc()
    tabs = T.huffman_tables()
    big2 = g.big_values * 2
    if g.win_switch and g.block_type == 2:
        # first 3 short bands x 3 windows (= 36 everywhere except the
        # MPEG-2.5 8 kHz table's 8-wide bands: 72); matches the decoder
        # convention pinned vs libmpg123/libavcodec in frontend.py
        r1, r2 = 3 * int(T.SFB_SHORT_FAM[family][sfreq][3]), 576
    else:
        longs = T.SFB_LONG_FAM[family][sfreq]
        r1 = int(longs[g.region0_count + 1])
        r2 = int(longs[g.region0_count + g.region1_count + 2])
    for i in range(0, big2, 2):
        tnum = g.table_select[0 if i < r1 else (1 if i < r2 else 2)]
        tab, emap = tabs[tnum], enc[tnum]
        x, y = int(g.values[i]), int(g.values[i + 1])
        ax, ay = abs(x), abs(y)
        cx = min(ax, 15) if tab.linbits else ax
        cy = min(ay, 15) if tab.linbits else ay
        code, length = emap[(cx, cy)]
        bw.put(code, length)
        if tab.linbits and cx == 15:
            bw.put(ax - 15, tab.linbits)
        if ax > 0:
            bw.put(1 if x < 0 else 0, 1)
        if tab.linbits and cy == 15:
            bw.put(ay - 15, tab.linbits)
        if ay > 0:
            bw.put(1 if y < 0 else 0, 1)
    # count1 quads (LSF streams always use the real ISO table B — the
    # decoders' broken-table-33 emulation is MPEG-1-only bug parity)
    if g.count1table_select == 1 and (getattr(g, "count1_spec", False)
                                      or family):
        # true ISO table B: every quad is a 4-bit code + sign bits
        emap = enc[33]
        for q in range(g.n_quads):
            i = big2 + 4 * q
            v4 = [int(g.values[i + k]) for k in range(4)]
            key = 0
            for k in range(4):
                key = (key << 1) | (1 if v4[k] != 0 else 0)
            code, length = emap[(0, key)]
            bw.put(code, length)
            for k in range(4):
                if v4[k] != 0:
                    bw.put(1 if v4[k] < 0 else 0, 1)
        return
    if g.count1table_select == 1:
        # Encode for the reference's broken table-33 path (stale pointer,
        # pdmp3.c:569): each quad is (0,0,±1,±1) = just two sign bits.
        for q in range(g.n_quads):
            i = big2 + 4 * q
            assert (g.values[i] == 0 and g.values[i + 1] == 0
                    and abs(g.values[i + 2]) == 1
                    and abs(g.values[i + 3]) == 1)
            bw.put(1 if g.values[i + 2] < 0 else 0, 1)
            bw.put(1 if g.values[i + 3] < 0 else 0, 1)
        return
    emap = enc[32]
    for q in range(g.n_quads):
        i = big2 + 4 * q
        v4 = [int(g.values[i + k]) for k in range(4)]
        key = 0
        for k in range(4):
            key = (key << 1) | (1 if v4[k] != 0 else 0)
        code, length = emap[(0, key)]
        bw.put(code, length)
        for k in range(4):
            if v4[k] != 0:
                bw.put(1 if v4[k] < 0 else 0, 1)


@dataclasses.dataclass
class FrameSpec:
    bitrate_index: int = 9        # 128 kbps
    sampling_frequency: int = 0   # 44.1 kHz
    padding: int = 0
    protection: bool = False      # True => CRC bytes present
    mode: int = 0                 # 0 stereo, 1 joint, 2 dual, 3 mono
    mode_extension: int = 0
    granules: list = None         # [gr][ch] GranuleSpec
    scfsi: np.ndarray = None      # [2][4]
    family: int = 0               # 0 MPEG-1, 1 MPEG-2, 2 MPEG-2.5
    free_size: int = 0            # free format (bitrate_index 0): frame
                                  # size excl. padding, constant per stream

    @property
    def ngr(self) -> int:
        return 1 if self.family else 2


def _write_scalefacs_lsf(bw: BitWriter, g: GranuleSpec) -> None:
    """Write the flat LSF scalefactors under their partition widths."""
    k = 0
    for p in range(4):
        w = int(g.lsf_slen[p])
        for _ in range(int(g.lsf_counts[p])):
            if w:
                bw.put(int(g.lsf_flat[k]), w)
            k += 1


def build_frame_main_data(fs: FrameSpec) -> tuple[bytes, list]:
    """Encode scalefacs+huffman(+stuffing) for all granules.

    Returns (main_data_bytes, part2_3_lengths[gr][ch]).
    """
    nch = 1 if fs.mode == 3 else 2
    bw = BitWriter()
    p23 = [[0, 0], [0, 0]]
    for gr in range(fs.ngr):
        for ch in range(nch):
            g = fs.granules[gr][ch]
            start = bw.nbits()
            if fs.family:
                _write_scalefacs_lsf(bw, g)
            else:
                g0 = fs.granules[0][ch]
                _write_scalefacs(bw, g, gr, fs.scfsi[ch], g0)
            _write_huffman(bw, g, fs.sampling_frequency, fs.family)
            for _ in range(g.stuffing_bits):
                bw.put(0, 1)
            p23[gr][ch] = bw.nbits() - start
            # p23_trim: declare FEWER bits than were written, so the
            # decoder's Huffman read legitimately runs into the bit
            # budget mid-symbol — real encoders (LAME) emit such
            # granules and rely on the decoder stopping at the budget
            # (the overrun-handling semantics probed in round 5)
            p23[gr][ch] -= int(getattr(g, "p23_trim", 0))
            assert p23[gr][ch] < 4096, "part2_3_length overflow"
    return bw.to_bytes(), p23


def build_side_info(fs: FrameSpec, main_data_begin: int, p23) -> bytes:
    nch = 1 if fs.mode == 3 else 2
    if fs.family:
        return _build_side_info_lsf(fs, main_data_begin, p23, nch)
    bw = BitWriter()
    bw.put(main_data_begin, 9)
    bw.put(0, 5 if nch == 1 else 3)
    for ch in range(nch):
        for b in range(4):
            bw.put(int(fs.scfsi[ch][b]), 1)
    for gr in range(2):
        for ch in range(nch):
            g = fs.granules[gr][ch]
            bw.put(p23[gr][ch], 12)
            bw.put(g.big_values, 9)
            bw.put(g.global_gain, 8)
            bw.put(g.scalefac_compress, 4)
            bw.put(g.win_switch, 1)
            if g.win_switch:
                bw.put(g.block_type, 2)
                bw.put(g.mixed, 1)
                for r in range(2):
                    bw.put(g.table_select[r], 5)
                for w in range(3):
                    bw.put(g.subblock_gain[w], 3)
            else:
                for r in range(3):
                    bw.put(g.table_select[r], 5)
                bw.put(g.region0_count, 4)
                bw.put(g.region1_count, 3)
            bw.put(g.preflag, 1)
            bw.put(g.scalefac_scale, 1)
            bw.put(g.count1table_select, 1)
    out = bw.to_bytes()
    want = 17 if nch == 1 else 32
    assert len(out) == want, (len(out), want)
    return out


def _build_side_info_lsf(fs: FrameSpec, main_data_begin: int, p23,
                         nch: int) -> bytes:
    """LSF side info (13818-3 §2.4.1.7): 8-bit main_data_begin, 1/2
    private bits, no scfsi, ONE granule, 9-bit scalefac_compress, no
    preflag bit.  9 bytes mono / 17 stereo."""
    bw = BitWriter()
    bw.put(main_data_begin, 8)
    bw.put(0, 1 if nch == 1 else 2)
    for ch in range(nch):
        g = fs.granules[0][ch]
        bw.put(p23[0][ch], 12)
        bw.put(g.big_values, 9)
        bw.put(g.global_gain, 8)
        bw.put(g.scalefac_compress, 9)
        bw.put(g.win_switch, 1)
        if g.win_switch:
            bw.put(g.block_type, 2)
            bw.put(g.mixed, 1)
            for r in range(2):
                bw.put(g.table_select[r], 5)
            for w in range(3):
                bw.put(g.subblock_gain[w], 3)
        else:
            for r in range(3):
                bw.put(g.table_select[r], 5)
            bw.put(g.region0_count, 4)
            bw.put(g.region1_count, 3)
        bw.put(g.scalefac_scale, 1)
        bw.put(g.count1table_select, 1)
    out = bw.to_bytes()
    want = 9 if nch == 1 else 17
    assert len(out) == want, (len(out), want)
    return out


def build_header(fs: FrameSpec) -> bytes:
    ver = (3, 2, 0)[fs.family]   # header bits 20:19 (MPEG-2.5 clears 20)
    hdr = (0x7FF << 21) | (ver << 19) | (1 << 17) \
        | ((0 if fs.protection else 1) << 16) \
        | (fs.bitrate_index << 12) | (fs.sampling_frequency << 10) \
        | (fs.padding << 9) | (fs.mode << 6) | (fs.mode_extension << 4)
    return hdr.to_bytes(4, "big")


def frame_capacity(fs: FrameSpec) -> int:
    nch = 1 if fs.mode == 3 else 2
    if fs.bitrate_index == 0:  # free format: caller-chosen constant size
        assert fs.free_size > 0
        framesize = fs.free_size + fs.padding
        cap = framesize - ((9 if fs.family else 17) if nch == 1
                           else (17 if fs.family else 32)) - 4
        if fs.protection:
            cap -= 2
        return cap
    if fs.family:
        framesize = T.lsf_frame_size(fs.bitrate_index,
                                     fs.sampling_frequency, fs.family,
                                     fs.padding)
        cap = framesize - (9 if nch == 1 else 17) - 4
    else:
        framesize = (144 * int(T.BITRATES[2][fs.bitrate_index])
                     // int(T.SAMPLE_RATES[fs.sampling_frequency])
                     + fs.padding)
        cap = framesize - (17 if nch == 1 else 32) - 4
    if fs.protection:
        cap -= 2
    return cap


def assemble_stream(frames: list[FrameSpec], *, rng: random.Random,
                    use_reservoir: bool = True,
                    leading_garbage: int = 0) -> bytes:
    """Pack frames + main-data blobs into a stream with reservoir chaining."""
    blobs, p23s, caps = [], [], []
    resv = 255 if frames[0].family else 511   # main_data_begin field width
    for fs in frames:
        blob, p23 = build_frame_main_data(fs)
        blobs.append(blob)
        p23s.append(p23)
        caps.append(frame_capacity(fs))
        assert len(blob) <= caps[-1] + resv, "blob cannot fit even with reservoir"

    # Place blob i at stream offset pos_i within the concatenated main-data
    # space: S_i - 511 <= pos_i <= S_i, pos_i >= pos_{i-1} + len_{i-1},
    # pos_i + len_i <= S_i + C_i.  begin_i = S_i - pos_i.
    S = 0
    pos_prev_end = 0
    positions = []
    for i, fs in enumerate(frames):
        lo = max(pos_prev_end, S - resv, 0)
        hi = min(S, S + caps[i] - len(blobs[i]))
        assert lo <= hi, f"frame {i}: reservoir infeasible (lo={lo},hi={hi})"
        if use_reservoir and i > 0:
            pos = rng.randrange(lo, hi + 1)
        else:
            pos = hi  # begin as small as possible (0 for frame 0 when it fits)
        if i == 0:
            pos = 0 if lo == 0 else lo  # frame 0 must have begin == 0...
            assert S - pos == 0
        positions.append(pos)
        pos_prev_end = pos + len(blobs[i])
        S += caps[i]

    total_main = S
    M = bytearray(rng.randrange(256) for _ in range(total_main))  # ancillary
    for pos, blob in zip(positions, blobs):
        M[pos:pos + len(blob)] = blob

    out = bytearray()
    if leading_garbage:
        g = bytearray(rng.randrange(256) for _ in range(leading_garbage))
        # avoid accidental sync words in garbage
        for k in range(len(g)):
            if g[k] == 0xFF:
                g[k] = 0x7F
        out += g
    S = 0
    for i, fs in enumerate(frames):
        begin = S - positions[i]
        hdr = build_header(fs)
        side = build_side_info(fs, begin, p23s[i])
        out += hdr
        if fs.protection:
            # real ISO CRC-16 over header bits 16-31 + side info
            # (11172-3 §2.4.3.1; law pinned against libavcodec's
            # AV_EF_CRCCHECK in tests/test_crc.py).  The reference
            # discards these bytes unchecked (pdmp3.c:1206-1210), so
            # valid CRCs are reference-parity-neutral.
            out += T.crc16_mpeg(hdr[2:4] + side).to_bytes(2, "big")
        out += side
        out += M[S:S + caps[i]]
        S += caps[i]
    return bytes(out)


def make_stream(*, n_frames: int = 20, seed: int = 0,
                sfreq: int = 0, bitrate_index: int = 9, mode: int = 0,
                mode_extension: int = 0, blocks: str = "long",
                use_reservoir: bool = False, protection: bool = False,
                vary_padding: bool = False, stuffing: int = 0,
                stereo_extent_ch1: float = 1.0,
                ch1_rzero_on_sfb: bool = False,
                intensity_pos: bool | int = False,
                scfsi: bool = False, leading_garbage: int = 0,
                amp: int = 6, vbr: bool = False,
                family: int = 0, free_format_size: int = 0,
                spec_conformant: bool = False,
                specs_out: list | None = None) -> bytes:
    """Convenience builder for one homogeneous test stream.

    family 1/2 emits MPEG-2 / MPEG-2.5 LSF frames (one granule each;
    intensity positions ride ch1's scalefactors — intensity_pos is
    ignored there, ch1 values are already drawn over the full field
    width so legal and "illegal" positions both occur).

    spec_conformant: encode count1table_select==1 quads with the REAL
    ISO table B codewords instead of the reference's broken-table-33
    convention — required when the stream is decoded by an external
    conformant decoder (tools/av_oracle.c cross-validation)."""
    rng = random.Random(seed)
    # intensity_pos True draws is_pos < 8 (the defined range); an int N
    # draws is_pos < N (N=16 reaches the reference's OOB is_ratios
    # regime on long blocks, tables.IS_RATIO_OOB_BITS)
    ipos_max = (intensity_pos
                if isinstance(intensity_pos, int)
                and not isinstance(intensity_pos, bool) else 8)
    block_cycle = {"long": ["long"], "short": ["short"], "mixed": ["mixed"],
                   "varied": ["long", "start", "short", "short", "stop",
                              "long", "mixed", "long"]}[blocks]
    frames = []
    nch = 1 if mode == 3 else 2
    for f in range(n_frames):
        blk = block_cycle[f % len(block_cycle)]
        # Fit the blob to the frame's byte budget: a frame may only borrow
        # reservoir space that previous frames actually left behind, so we
        # regenerate with a shrinking spectrum until it fits conservatively.
        budget = None
        ngr = 1 if family else 2
        for attempt in range(12):
            max_lines = max(8, 200 >> attempt)
            grans = []
            scf = np.zeros((2, 4), np.int32)
            if scfsi and blk == "long" and not family:
                scf[:, :] = [[rng.randrange(2) for _ in range(4)]
                             for _ in range(2)]
            for gr in range(ngr):
                row = []
                for ch in range(nch):
                    row.append(make_granule(
                        rng, sfreq=sfreq, block=blk,
                        stereo_extent=stereo_extent_ch1 if ch == 1 else 1.0,
                        amp=amp, stuffing=stuffing, max_lines=max_lines,
                        family=family,
                        rzero_on_sfb=bool(ch1_rzero_on_sfb and ch == 1),
                        intensity_ch=bool(family and ch == 1 and mode == 1
                                          and (mode_extension & 1)),
                        intensity_pos=(rng.randrange(ipos_max)
                                       if (intensity_pos and ch == 0
                                           and not family)
                                       else None)))
                    if spec_conformant:
                        row[-1].count1_spec = True
                row += [row[0]] * (2 - len(row))
                grans.append(row)
            if any(grans[g][c].win_switch and grans[g][c].block_type == 2
                   for g in range(ngr) for c in range(nch)):
                scf[:] = 0
            fs = FrameSpec(
                bitrate_index=(0 if free_format_size else
                               rng.choice([5, 7, 9, 11, 12, 14]) if vbr
                               else bitrate_index),
                sampling_frequency=sfreq,
                padding=(f % 2 if vary_padding else 0), protection=protection,
                mode=mode, mode_extension=mode_extension,
                granules=grans, scfsi=scf, family=family,
                free_size=free_format_size)
            blob, _ = build_frame_main_data(fs)
            slack = 200 if (use_reservoir and f > 0) else 0
            budget = frame_capacity(fs) + slack
            if len(blob) <= budget:
                break
        else:
            raise RuntimeError("could not fit frame into bit budget")
        frames.append(fs)
    if specs_out is not None:
        specs_out.extend(frames)   # ground truth for round-trip tests
    return assemble_stream(frames, rng=rng, use_reservoir=use_reservoir,
                           leading_garbage=leading_garbage)


# ---- Layer I/II stream generator (beyond-reference: the reference
# rejects layer != 3; frames per ISO 11172-3 §2.4.1.5-6 and 13818-3
# table B.1 for LSF Layer II) ----

def _l12_nsf(scfsi: int) -> int:
    """Scalefactors transmitted per (ch, sb) for a Layer II scfsi code."""
    return (3, 2, 1, 2)[scfsi]


def make_l12_frame(rng: random.Random, *, layer: int, bitrate_index: int,
                   sfreq: int, mode: int, mode_extension: int,
                   family: int = 0, padding: int = 0,
                   alloc_bias: int = 2, protection: bool = False) -> bytes:
    """Build one random-but-valid Layer I/II frame.

    protection=True inserts a valid ISO CRC-16 (bit-granular protected
    region: Layer I = allocation, Layer II = allocation + scfsi —
    11172-3 §2.4.3.1; law validated against libavcodec in
    tests/test_crc.py).

    Allocations are drawn with a small-index bias then decremented at
    random until the frame's bit budget fits; the remainder is zero
    ancillary data.  alloc_bias: number of extra low-biased draws
    (min of N uniform draws) — higher = sparser spectra."""
    nch = 1 if mode == 3 else 2
    if layer == 1:
        br = T.BITRATES_LSF_L1 if family else T.BITRATES[0]
        rate = int(T.SAMPLE_RATES_FAM[family][sfreq])
        frame_size = 4 * (12 * int(br[bitrate_index]) // rate + padding)
        sblimit, bound = 32, T.l12_bound(mode, mode_extension, 32)
        nbal_of = [4] * 32
    else:
        if family:
            rate = int(T.SAMPLE_RATES_FAM[family][sfreq])
            frame_size = (144 * int(T.BITRATES_LSF[bitrate_index]) // rate
                          + padding)
        else:
            frame_size = (144 * int(T.BITRATES[1][bitrate_index])
                          // int(T.SAMPLE_RATES[sfreq]) + padding)
        table = T.l2_alloc_table(bitrate_index, sfreq, nch, family)
        sblimit = len(table)
        bound = T.l12_bound(mode, mode_extension, sblimit)
        nbal_of = [t[0] for t in table]
    budget = (frame_size - 4 - (2 if protection else 0)) * 8

    alloc = np.zeros((2, 32), np.int64)
    for sb in range(sblimit):
        hi = (1 << nbal_of[sb]) - (1 if layer == 1 else 0)  # L1: no 15
        for ch in range(nch if sb < bound else 1):
            a = min(rng.randrange(hi) for _ in range(1 + alloc_bias))
            alloc[ch][sb] = a
        if sb >= bound:
            alloc[1][sb] = alloc[0][sb]
    scfsi = np.zeros((2, 32), np.int64)
    if layer == 2:
        for sb in range(sblimit):
            for ch in range(nch):
                scfsi[ch][sb] = rng.randrange(4)

    def cost() -> int:
        bits = 0
        for sb in range(sblimit):
            bits += nbal_of[sb] * (nch if sb < bound else 1)
            for ch in range(nch):
                if alloc[ch][sb]:
                    if layer == 1:
                        bits += 6
                    else:
                        bits += 2 + 6 * _l12_nsf(int(scfsi[ch][sb]))
            nuser = nch if sb < bound else 1
            for ch in range(nuser):
                a = int(alloc[ch][sb])
                if not a:
                    continue
                if layer == 1:
                    bits += 12 * (a + 1)
                else:
                    cb, grouped, _, _ = T.L2_CLASSES[table[sb][1][a - 1]]
                    bits += 12 * (cb if grouped else 3 * cb)
        return bits

    while cost() > budget:
        nz = [(ch, sb) for ch in range(nch) for sb in range(sblimit)
              if alloc[ch][sb]]
        if not nz:
            break
        ch, sb = rng.choice(nz)
        alloc[ch][sb] -= 1
        if sb >= bound:
            alloc[0][sb] = alloc[1][sb] = alloc[ch][sb]
    assert cost() <= budget, "frame cannot fit even with zero allocation"

    bw = BitWriter()
    ver = (3, 2, 0)[family]
    hdr = (0x7FF << 21) | (ver << 19) | ((4 - layer) << 17) \
        | ((0 if protection else 1) << 16) \
        | (bitrate_index << 12) | (sfreq << 10) | (padding << 9) \
        | (mode << 6) | (mode_extension << 4)
    hdr_bytes = hdr.to_bytes(4, "big")
    for sb in range(sblimit):
        for ch in range(nch if sb < bound else 1):
            bw.put(int(alloc[ch][sb]), nbal_of[sb])
    # Layer I: FIXED 128/256-bit protected region (4*32*nch) — ISO's
    # fixed-length definition and ffmpeg's checker, NOT the bound-aware
    # allocation extent (tables.l12_protected_bits)
    protected_nbits = 4 * 32 * nch
    if layer == 1:
        for sb in range(sblimit):
            for ch in range(nch):
                if alloc[ch][sb]:
                    bw.put(rng.randrange(63), 6)
        for s in range(12):
            for sb in range(32):
                for ch in range(nch if sb < bound else 1):
                    a = int(alloc[ch][sb])
                    if a:
                        nb = a + 1
                        # all-ones is not a valid Layer I code
                        bw.put(rng.randrange((1 << nb) - 1), nb)
    else:
        for sb in range(sblimit):
            for ch in range(nch):
                if alloc[ch][sb]:
                    bw.put(int(scfsi[ch][sb]), 2)
        protected_nbits = bw.nbits()   # Layer II: allocation + scfsi
        for sb in range(sblimit):
            for ch in range(nch):
                if alloc[ch][sb]:
                    for _ in range(_l12_nsf(int(scfsi[ch][sb]))):
                        bw.put(rng.randrange(63), 6)
        for gr in range(12):
            for sb in range(sblimit):
                for ch in range(nch if sb < bound else 1):
                    a = int(alloc[ch][sb])
                    if not a:
                        continue
                    steps = table[sb][1][a - 1]
                    cb, grouped, _, _ = T.L2_CLASSES[steps]
                    if grouped:
                        bw.put(rng.randrange(steps ** 3), cb)
                    else:
                        for _ in range(3):
                            bw.put(rng.randrange(steps), cb)
    body = bw.to_bytes()
    out = bytearray(hdr_bytes)
    if protection:
        pad_body = body + b"\x00" * (frame_size - 6 - len(body))
        crc = T.crc16_mpeg_bits(pad_body, protected_nbits,
                                T.crc16_mpeg(hdr_bytes[2:4]))
        out += crc.to_bytes(2, "big")
    out += body
    assert len(out) <= frame_size, (len(out), frame_size)
    return bytes(out) + b"\x00" * (frame_size - len(out))


def make_l12_stream(*, layer: int = 2, n_frames: int = 12, seed: int = 0,
                    sfreq: int = 0, bitrate_index: int = 12, mode: int = 0,
                    mode_extension: int = 0, family: int = 0,
                    alloc_bias: int = 2, protection: bool = False) -> bytes:
    """Concatenate independent Layer I/II frames (no reservoir exists
    in Layers I/II, so frames are self-contained)."""
    rng = random.Random(seed)
    return b"".join(
        make_l12_frame(rng, layer=layer, bitrate_index=bitrate_index,
                       sfreq=sfreq, mode=mode,
                       mode_extension=mode_extension, family=family,
                       alloc_bias=alloc_bias, protection=protection)
        for _ in range(n_frames))


# ---------------------------------------------------------------------------
# VBR metadata tag frames (Xing/Info + LAME extension, Fraunhofer VBRI)
# ---------------------------------------------------------------------------

def _crc16_lame(buf: bytes, crc: int = 0) -> int:
    """CRC-16/ARC (poly 0x8005 reflected, init 0) — LAME's tag CRC."""
    for byte in buf:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0xA001 if crc & 1 else 0)
    return crc


def make_xing_frame(*, sfreq: int = 0, bitrate_index: int = 9,
                    mode: int = 0, n_frames: int = 0, n_bytes: int = 0,
                    toc: bytes | None = None, quality: int = 50,
                    cbr: bool = False, lame: bool = True,
                    encoder: bytes = b"LAME3.100",
                    encoder_delay: int = 576, encoder_padding: int = 1152,
                    vbr_method: int = 3, lowpass_hz: int = 19500,
                    mp3_gain: int = 0, music_length: int = 0,
                    music_crc: int = 0) -> bytes:
    """Build a silent Layer III frame carrying a Xing/Info + LAME tag.

    The tag sits where main data would: a zeroed side info (every
    part2_3_length = 0) decodes as 1152 samples of silence in any
    decoder — exactly the frame LAME emits.  The tag CRC is computed
    LAME-style over the frame bytes preceding the CRC field.
    """
    fs = FrameSpec(bitrate_index=bitrate_index, sampling_frequency=sfreq,
                   mode=mode)
    nch = 1 if mode == 3 else 2
    side = 17 if nch == 1 else 32
    frame_size = (144 * int(T.BITRATES[2][bitrate_index])
                  // int(T.SAMPLE_RATES[sfreq]))
    buf = bytearray(build_header(fs))
    buf += b"\x00" * side
    buf += b"Info" if cbr else b"Xing"
    buf += (0xF).to_bytes(4, "big")           # frames|bytes|toc|quality
    buf += n_frames.to_bytes(4, "big")
    buf += n_bytes.to_bytes(4, "big")
    if toc is None:
        toc = bytes(min(i * 256 // 100, 255) for i in range(100))
    assert len(toc) == 100
    buf += toc
    buf += quality.to_bytes(4, "big")
    if lame:
        buf += encoder[:9].ljust(9, b"\x00")
        buf += bytes([(0 << 4) | (vbr_method & 0xF)])     # revision 0
        buf += bytes([min(lowpass_hz // 100, 255)])
        buf += b"\x00" * 4                                # peak (unset)
        buf += b"\x00" * 2 + b"\x00" * 2                  # replay gains
        buf += b"\x00"                                    # flags + ATH
        buf += b"\x00"                                    # ABR bitrate
        buf += bytes([encoder_delay >> 4,
                      ((encoder_delay & 0xF) << 4) | (encoder_padding >> 8),
                      encoder_padding & 0xFF])
        buf += b"\x00"                                    # misc
        buf += bytes([mp3_gain & 0xFF])
        buf += b"\x00\x00"                                # preset/surround
        buf += music_length.to_bytes(4, "big")
        buf += music_crc.to_bytes(2, "big")
        buf += _crc16_lame(bytes(buf)).to_bytes(2, "big")
    assert len(buf) <= frame_size, (len(buf), frame_size)
    return bytes(buf) + b"\x00" * (frame_size - len(buf))


def make_vbri_frame(*, sfreq: int = 0, bitrate_index: int = 9,
                    mode: int = 0, n_frames: int = 0, n_bytes: int = 0,
                    quality: int = 80, delay: int = 4608,
                    toc_entries: list | None = None,
                    entry_frames: int = 4) -> bytes:
    """Fraunhofer VBRI tag frame: magic at header+36, per-interval byte
    table (``toc_entries``: bytes spanned by each ``entry_frames``-frame
    interval)."""
    fs = FrameSpec(bitrate_index=bitrate_index, sampling_frequency=sfreq,
                   mode=mode)
    frame_size = (144 * int(T.BITRATES[2][bitrate_index])
                  // int(T.SAMPLE_RATES[sfreq]))
    buf = bytearray(build_header(fs))
    buf += b"\x00" * 32
    buf += b"VBRI"
    entries = toc_entries or []
    buf += (1).to_bytes(2, "big")             # version
    buf += delay.to_bytes(2, "big")
    buf += quality.to_bytes(2, "big")
    buf += n_bytes.to_bytes(4, "big")
    buf += n_frames.to_bytes(4, "big")
    buf += len(entries).to_bytes(2, "big")
    buf += (1).to_bytes(2, "big")             # scale
    buf += (2).to_bytes(2, "big")             # bytes per entry
    buf += entry_frames.to_bytes(2, "big")
    for e in entries:
        buf += int(e).to_bytes(2, "big")
    assert len(buf) <= frame_size, (len(buf), frame_size)
    return bytes(buf) + b"\x00" * (frame_size - len(buf))


def make_tagged_stream(*, tag: str = "xing", encoder_delay: int = 576,
                       encoder_padding: int = 1152, cbr: bool = False,
                       id3_bytes: int = 0, **make_stream_kw):
    """A mp3gen stream with an accurate metadata tag frame prepended
    (frame count, byte count, TOC measured from the generated frames),
    optionally behind an ID3v2 tag.  Returns (stream, n_audio_frames).
    """
    make_stream_kw.setdefault("n_frames", 20)
    sfreq = make_stream_kw.get("sfreq", 0)
    bi = make_stream_kw.get("bitrate_index", 9)
    mode = make_stream_kw.get("mode", 0)
    audio = make_stream(**make_stream_kw)
    n_frames = make_stream_kw["n_frames"]
    tag_size = (144 * int(T.BITRATES[2][bi]) // int(T.SAMPLE_RATES[sfreq]))
    total = tag_size + len(audio)
    if tag == "xing":
        # TOC: percent-of-duration -> scaled byte offset (whole file)
        toc = bytes(min(int((i / 100.0) * len(audio) + tag_size)
                        * 256 // total, 255) for i in range(100))
        tf = make_xing_frame(sfreq=sfreq, bitrate_index=bi, mode=mode,
                             n_frames=n_frames, n_bytes=total, toc=toc,
                             cbr=cbr, encoder_delay=encoder_delay,
                             encoder_padding=encoder_padding,
                             music_length=len(audio),
                             music_crc=_crc16_lame(audio))
    elif tag == "vbri":
        tf = make_vbri_frame(sfreq=sfreq, bitrate_index=bi, mode=mode,
                             n_frames=n_frames, n_bytes=total)
    else:
        raise ValueError(tag)
    head = b""
    if id3_bytes:
        size = id3_bytes
        head = b"ID3\x04\x00\x00" + bytes(
            [(size >> 21) & 0x7F, (size >> 14) & 0x7F,
             (size >> 7) & 0x7F, size & 0x7F]) + b"\x00" * size
    return head + tf + audio, n_frames
