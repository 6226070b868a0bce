"""Pure-Python bitstream frontend for MPEG-1 Layer III.

Frozen copy of ``pdmp3_tpu_torch/frontend.py`` for the benchmark's plain
reference: it imports nothing of the program.

This is the *semantic reference* for the native C++ frontend
(``pdmp3_tpu/host``): it reproduces, state-transition for state-transition,
the reference decoder's frame machinery — input ring buffer
(pdmp3.c:1062-1086, 1464-1474), byte-aligned sync search with rollback
(pdmp3.c:1252-1340), side-info parse incl. the implicit region counts for
switched blocks (pdmp3.c:1129-1200), the bit-reservoir protocol with its
skip-frame NEED_MORE path (pdmp3.c:1096-1122), scalefactor decode with scfsi
sharing (pdmp3.c:1376-1435), and Huffman decode with overrun rollback and
stuffing-bit skip (pdmp3.c:2051-2115).

Output of a successful frame parse is a :class:`FrameData` carrying the dense
per-granule tensors that cross the host->TPU boundary: integer frequency
lines ``ix[gr][ch][576]`` plus side-info/scalefactor arrays.  Everything
below that boundary is the DSP backend's job (oracle / JAX).

The Huffman decode here uses the LUT codebooks from :mod:`pdmp3_tpu_torch.tables`
(multi-bit table steps), not a bit-serial tree walk; consumption semantics
are identical because the code trees are complete and prefix-free.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import tables as T

C_EOF = 0xFFFFFFFF


@dataclass
class SideInfo:
    main_data_begin: int = 0
    private_bits: int = 0
    scfsi: np.ndarray = field(default_factory=lambda: np.zeros((2, 4), np.int32))
    part2_3_length: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    big_values: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    global_gain: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    scalefac_compress: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    win_switch_flag: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    block_type: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    mixed_block_flag: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    table_select: np.ndarray = field(default_factory=lambda: np.zeros((2, 2, 3), np.int32))
    subblock_gain: np.ndarray = field(default_factory=lambda: np.zeros((2, 2, 3), np.int32))
    region0_count: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    region1_count: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    preflag: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    scalefac_scale: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    count1table_select: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))
    count1: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.int32))


@dataclass
class Header:
    id: int = 0
    layer: int = 0
    protection_bit: int = 0
    bitrate_index: int = 0
    sampling_frequency: int = 0
    padding_bit: int = 0
    private_bit: int = 0
    mode: int = 0
    mode_extension: int = 0
    copyright: int = 0
    original_or_copy: int = 0
    emphasis: int = 0
    # 0 = MPEG-1, 1 = MPEG-2, 2 = MPEG-2.5 (LSF extension; the reference
    # rejects id==0, pdmp3.c:1295 — families 1/2 exist only behind
    # Frontend(lsf=True))
    family: int = 0
    # measured free-format frame size excl. padding (bitrate_index == 0,
    # reachable only behind Frontend(free_format=True); the reference
    # rejects free format, pdmp3.c:1299)
    free_size: int = 0

    @property
    def nch(self) -> int:
        return 1 if self.mode == 3 else 2

    @property
    def lsf(self) -> bool:
        return self.family != 0

    @property
    def ngr(self) -> int:
        """Granules per frame: LSF frames carry ONE 576-sample granule."""
        return 1 if self.family else 2

    @property
    def sample_rate(self) -> int:
        # a rejected header can leave sampling_frequency == 3 here; the
        # reference's getformat reads its table out of bounds for that
        # (pdmp3.c:2530, layout-dependent garbage) — guard instead
        return int(T.SAMPLE_RATES_FAM[self.family]
                   [min(self.sampling_frequency, 2)])

    @property
    def pcm_samples(self) -> int:
        """PCM samples per channel carried by one frame."""
        if self.layer == 1:
            return 384
        if self.layer == 2:
            return 1152   # LSF halves Layer III frames only (13818-3)
        return 576 if self.family else 1152

    def frame_size(self) -> int:
        if self.bitrate_index == 0:  # free format: measured size
            return self.free_size + self.padding_bit
        if self.layer == 1:
            # 11172-3 §2.4.3.1: slots are 4 bytes in Layer I
            br = (T.BITRATES_LSF_L1 if self.family else T.BITRATES[0])
            return 4 * (12 * int(br[self.bitrate_index])
                        // int(T.SAMPLE_RATES_FAM[self.family]
                               [min(self.sampling_frequency, 2)])
                        + self.padding_bit)
        if self.family:
            return T.lsf_frame_size(self.bitrate_index,
                                    self.sampling_frequency, self.family,
                                    self.padding_bit, self.layer)
        return (144 * int(T.BITRATES[self.layer - 1][self.bitrate_index])
                // int(T.SAMPLE_RATES[self.sampling_frequency])
                + self.padding_bit)


@dataclass
class FrameData:
    header: Header
    side: SideInfo
    scalefac_l: np.ndarray  # [2,2,22] int32 (index 21 = sfb21-region policy)
    scalefac_s: np.ndarray  # [2,2,13,3] int32 (index 12 = policy)
    ix: np.ndarray          # [2,2,576] int32 Huffman-decoded lines
    # LSF intensity-stereo sidecar (None for MPEG-1): ch1's transmitted
    # is_pos per band with the per-partition illegal value ((1<<slen)-1,
    # 13818-3 §2.4.3.4.3) already mapped to tables.LSF_IS_ILLEGAL, plus
    # intensity_scale (scalefac_compress bit 0 of ch1)
    is_eff_l: np.ndarray | None = None   # [22] int32
    is_eff_s: np.ndarray | None = None   # [13,3] int32
    intensity_scale: int = 0
    # Layer I/II (beyond-reference, header.layer < 3): requantized,
    # scaled subband samples [2ch, nparts, 32] f32 with nparts = 12
    # (Layer I) or 36 (Layer II); the DSP is polyphase synthesis only.
    # When set, side/scalefac/ix above are unused placeholder zeros.
    sb_samples: np.ndarray | None = None


class _BitReader:
    """Bounded MSB-first bit reader over one Layer I/II frame's bytes.

    Reads past the end return 0 and set `overflow` — a frame whose
    side data overruns its own byte budget is malformed and rejected
    by the caller (no reference semantics to mirror; layer != 3 is
    beyond-reference)."""

    __slots__ = ("data", "pos", "nbits", "overflow")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = 8 * len(data)
        self.overflow = False

    def get(self, nb: int) -> int:
        if nb == 0:
            return 0
        end = self.pos + nb
        if end > self.nbits:
            self.overflow = True
            self.pos = end
            return 0
        first = self.pos >> 3
        last = (end - 1) >> 3
        chunk = int.from_bytes(self.data[first:last + 1], "big")
        shift = 8 * (last + 1) - end
        self.pos = end
        return (chunk >> shift) & ((1 << nb) - 1)


class Frontend:
    """Streaming MP3 frame parser with reference-identical state machine.

    count1_table_b_spec: decode count1table_select=1 quads with the REAL
    ISO table B tree instead of emulating the reference's stale-pointer
    bug (see tables.HuffTable.ref_broken).  Default off for bit parity.

    lsf: also accept MPEG-2 / MPEG-2.5 (13818-3 low-sampling-frequency)
    streams — 11-bit sync, 9/17-byte one-granule side info, the 9-bit
    scalefac_compress partition derivation.  Default OFF: the reference
    rejects id==0 (pdmp3.c:1295), and accepting the shorter sync word
    would change resync behavior on hostile MPEG-1 streams, breaking the
    bit-parity differentials.  MPEG-1 frames parse identically either
    way; only sync acceptance differs.
    """

    def __init__(self, count1_table_b_spec: bool = False,
                 lsf: bool = False, free_format: bool = False,
                 id3: bool = False, layers12: bool = False,
                 crc_check: bool = False):
        self.count1_table_b_spec = count1_table_b_spec
        self.lsf = lsf
        # crc_check: actually verify the ISO 11172-3 §2.4.3.1 CRC-16 of
        # protected frames (the reference reads and DISCARDS the two CRC
        # bytes, pdmp3.c:1206-1210).  A failing Layer III frame is
        # skipped whole — its main data never enters the reservoir, so a
        # following frame that reaches back simply takes the standard
        # underflow NEED_MORE path.  Default OFF for bit-parity
        # differentials.
        self.crc_check = crc_check
        # layers12: also decode Layer I/II frames (the reference rejects
        # layer != 3, pdmp3.c:1240/1312).  Default OFF: accepting more
        # layers changes resync behavior on hostile streams, breaking
        # the bit-parity differentials.
        self.layers12 = layers12
        # id3: skip ID3v2 tags explicitly.  The reference's sync scan
        # absorbs tags that fit the buffered window, but a tag larger
        # than the 16 KiB ring (typical with cover art) starves the scan
        # and the bounded resync kills the stream (pdmp3.c:1322-1340).
        # Default OFF for bit-parity differentials.
        self.id3 = id3
        self.id3_remaining = 0   # unskipped tag bytes (can exceed ring)
        # free_format: accept bitrate_index == 0 (ISO 11172-3 free
        # format; the reference rejects it, pdmp3.c:1299) and deduce the
        # constant frame size from the sync spacing.  Default OFF for
        # bit-parity differentials.
        self.free_format = free_format
        self.free_size = 0   # measured size (excl. padding), 0 = unknown
        self.inbuf = bytearray(T.INBUF_SIZE)
        self.istart = 0
        self.iend = 0
        self.processed = 0
        # bit reservoir: one uint32 word per byte, like the reference
        # (pdmp3.c:137) so EOF floods reproduce identically
        self.main_vec = np.zeros(2 * 1024, np.uint32)
        self.main_byte = 0   # byte cursor into main_vec
        self.main_idx = 0    # bit index 0-7
        self.main_top = 0
        self.side_vec = np.zeros(32 + 48, np.uint32)
        self.side_byte = 0
        self.side_idx = 0
        self.header = Header()
        self.side = SideInfo()
        self.new_header = 0
        # Scalefactor arrays persist across frames like the reference's
        # g_main_data (pdmp3.c:96-101, never cleared by open_feed): stale
        # entries are read back via scfsi copies and via the sfb21-slot
        # alias below.  Zero-init matches the reference CLI's fresh
        # (mmap-zeroed) first allocation.
        self.scalefac_l = np.zeros((2, 2, 22), np.int32)
        self.scalefac_s = np.zeros((2, 2, 13, 3), np.int32)

    # ---- input ring buffer (pdmp3.c:1062-1086, 2391-2423) ----

    def inbuf_filled(self) -> int:
        if self.istart <= self.iend:
            return self.iend - self.istart
        return T.INBUF_SIZE - self.istart + self.iend

    def inbuf_free(self) -> int:
        if self.iend < self.istart:
            return self.istart - self.iend
        return T.INBUF_SIZE - self.iend + self.istart

    def feed(self, data: bytes) -> int:
        if not data:
            return T.ERR
        size = len(data)
        if size > self.inbuf_free():
            return T.NO_SPACE
        if self.iend < self.istart:
            self.inbuf[self.iend:self.iend + size] = data
            self.iend += size
        else:
            first = min(size, T.INBUF_SIZE - self.iend)
            self.inbuf[self.iend:self.iend + first] = data[:first]
            self.iend += first
            rest = size - first
            if rest:
                self.inbuf[0:rest] = data[first:]
                self.iend = rest
        return T.OK

    def get_byte(self) -> int:
        if self.istart == self.iend:
            return C_EOF
        v = self.inbuf[self.istart]
        self.istart += 1
        if self.istart == T.INBUF_SIZE:
            self.istart = 0
            # a feed that exactly reached the buffer end parks iend at
            # INBUF_SIZE; with istart wrapped the ring is exactly empty,
            # but the parked iend would read as ghost-full and the sync
            # scan could never hit EOF again (a latent defect in the
            # reference itself, Get_Byte pdmp3.c:1464-1474) — normalize
            if self.iend == T.INBUF_SIZE:
                self.iend = 0
        self.processed += 1
        return v

    # ---- bit readers over reservoir / side info ----

    def get_main_bit(self) -> int:
        w = int(self.main_vec[self.main_byte])
        bit = (w >> (7 - self.main_idx)) & 1
        self.main_idx += 1
        self.main_byte += self.main_idx >> 3
        self.main_idx &= 7
        return bit

    def get_main_bits(self, n: int) -> int:
        if n == 0:
            return 0
        b = self.main_byte
        w = ((int(self.main_vec[b]) << 24) | (int(self.main_vec[b + 1]) << 16)
             | (int(self.main_vec[b + 2]) << 8) | int(self.main_vec[b + 3]))
        w = (w << self.main_idx) & 0xFFFFFFFF
        w >>= 32 - n
        self.main_idx += n
        self.main_byte += self.main_idx >> 3
        self.main_idx &= 7
        return w

    def main_pos(self) -> int:
        return self.main_byte * 8 + self.main_idx

    def set_main_pos(self, bitpos: int) -> None:
        self.main_byte = bitpos >> 3
        self.main_idx = bitpos & 7

    def get_side_bits(self, n: int) -> int:
        b = self.side_byte
        w = ((int(self.side_vec[b]) << 24) | (int(self.side_vec[b + 1]) << 16)
             | (int(self.side_vec[b + 2]) << 8) | int(self.side_vec[b + 3]))
        w = (w << self.side_idx) & 0xFFFFFFFF
        w >>= 32 - n
        self.side_idx += n
        self.side_byte += self.side_idx >> 3
        self.side_idx &= 7
        return w

    # ---- header sync & parse (pdmp3.c:1252-1340) ----

    def _read_header(self) -> int:
        b = [self.get_byte() for _ in range(4)]
        if C_EOF in b:
            return T.ERR
        hdr = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
        # lsf mode scans for the 11-bit sync (MPEG-2.5 clears sync bit 0,
        # 13818-3 extension framing); reference-parity mode keeps the
        # 12-bit scan of pdmp3.c:1272
        sync = 0xFFE00000 if self.lsf else 0xFFF00000
        while (hdr & sync) != sync:
            nb = self.get_byte()
            if nb == C_EOF:
                return T.ERR
            hdr = ((hdr << 8) & 0xFFFFFF00) | nb
        h = self.header
        self._hdr_raw16 = hdr & 0xFFFF   # header bits 16-31, CRC-protected
        ver = (hdr >> 19) & 3        # 0=2.5, 1=reserved, 2=MPEG-2, 3=MPEG-1
        h.id = (hdr >> 19) & 1
        h.layer = (hdr >> 17) & 3
        h.protection_bit = (hdr >> 16) & 1
        h.bitrate_index = (hdr >> 12) & 0xF
        h.sampling_frequency = (hdr >> 10) & 3
        h.padding_bit = (hdr >> 9) & 1
        h.private_bit = (hdr >> 8) & 1
        h.mode = (hdr >> 6) & 3
        h.mode_extension = (hdr >> 4) & 3
        h.copyright = (hdr >> 3) & 1
        h.original_or_copy = (hdr >> 2) & 1
        h.emphasis = hdr & 3
        h.family = {3: 0, 2: 1, 0: 2}.get(ver, -1)
        if not self.lsf and h.id != 1:
            return T.ERR
        bad_bitrate = (h.bitrate_index == 15
                       or (h.bitrate_index == 0 and not self.free_format))
        if h.family < 0 or bad_bitrate \
                or h.sampling_frequency == 3 or h.layer == 0:
            return T.ERR
        h.layer = 4 - h.layer
        h.free_size = self.free_size if h.bitrate_index == 0 else 0
        if not self.new_header:
            self.new_header = 1
        return T.OK

    def search_header(self) -> int:
        pos = self.processed
        mark = self.istart
        res = T.NEED_MORE
        cnt = 0
        while self.inbuf_filled() > 4:
            res = self._read_header()
            if res == T.OK and (self.header.layer == 3
                                or (self.layers12
                                    and self.header.layer in (1, 2))):
                break
            mark += 1
            if mark == T.INBUF_SIZE:
                mark = 0
            self.istart = mark
            self.processed = pos
            cnt += 1
            if cnt > 2 * 576:
                return T.ERR
        return res

    # ---- side info (pdmp3.c:1129-1200) ----

    def _read_side_info(self) -> int:
        h = self.header
        nch = h.nch
        framesize = h.frame_size()
        if framesize > 2000:
            return T.ERR
        if h.family:
            sideinfo_size = 9 if nch == 1 else 17
        else:
            sideinfo_size = 17 if nch == 1 else 32
        # Load side-info bytes.  Quirk parity: on input underrun the
        # reference stores the bytes it got, keeps the *stale* bit cursor,
        # and parses on regardless (Get_Sideinfo's early return skips the
        # cursor reset and Read_Audio_L3 ignores it, pdmp3.c:1576-1586,1233).
        eof = False
        for i in range(sideinfo_size):
            v = self.get_byte()
            if v == C_EOF:
                eof = True
                break
            self.side_vec[i] = v
        if not eof:
            self.side_byte = 0
            self.side_idx = 0
        s = self.side
        if h.family:
            return self._read_side_info_lsf()
        s.main_data_begin = self.get_side_bits(9)
        s.private_bits = self.get_side_bits(5 if nch == 1 else 3)
        for ch in range(nch):
            for b in range(4):
                s.scfsi[ch][b] = self.get_side_bits(1)
        for gr in range(2):
            for ch in range(nch):
                s.part2_3_length[gr][ch] = self.get_side_bits(12)
                s.big_values[gr][ch] = self.get_side_bits(9)
                s.global_gain[gr][ch] = self.get_side_bits(8)
                s.scalefac_compress[gr][ch] = self.get_side_bits(4)
                s.win_switch_flag[gr][ch] = self.get_side_bits(1)
                if s.win_switch_flag[gr][ch]:
                    s.block_type[gr][ch] = self.get_side_bits(2)
                    s.mixed_block_flag[gr][ch] = self.get_side_bits(1)
                    for r in range(2):
                        s.table_select[gr][ch][r] = self.get_side_bits(5)
                    for w in range(3):
                        s.subblock_gain[gr][ch][w] = self.get_side_bits(3)
                    # implicit region counts ("the standard is wrong on
                    # this", pdmp3.c:1181-1185)
                    if s.block_type[gr][ch] == 2 and not s.mixed_block_flag[gr][ch]:
                        s.region0_count[gr][ch] = 8
                    else:
                        s.region0_count[gr][ch] = 7
                    s.region1_count[gr][ch] = 20 - s.region0_count[gr][ch]
                else:
                    for r in range(3):
                        s.table_select[gr][ch][r] = self.get_side_bits(5)
                    s.region0_count[gr][ch] = self.get_side_bits(4)
                    s.region1_count[gr][ch] = self.get_side_bits(3)
                    s.block_type[gr][ch] = 0
                s.preflag[gr][ch] = self.get_side_bits(1)
                s.scalefac_scale[gr][ch] = self.get_side_bits(1)
                s.count1table_select[gr][ch] = self.get_side_bits(1)
        return T.OK

    def _read_side_info_lsf(self) -> int:
        """LSF side info (13818-3 §2.4.1.7): 8-bit main_data_begin, no
        scfsi, ONE granule, 9-bit scalefac_compress, no preflag bit
        (computed from scalefac_compress during scalefactor decode)."""
        s, nch = self.side, self.header.nch
        s.main_data_begin = self.get_side_bits(8)
        s.private_bits = self.get_side_bits(1 if nch == 1 else 2)
        s.scfsi[:] = 0
        gr = 0
        for ch in range(nch):
            s.part2_3_length[gr][ch] = self.get_side_bits(12)
            s.big_values[gr][ch] = self.get_side_bits(9)
            s.global_gain[gr][ch] = self.get_side_bits(8)
            s.scalefac_compress[gr][ch] = self.get_side_bits(9)
            s.win_switch_flag[gr][ch] = self.get_side_bits(1)
            if s.win_switch_flag[gr][ch]:
                s.block_type[gr][ch] = self.get_side_bits(2)
                s.mixed_block_flag[gr][ch] = self.get_side_bits(1)
                for r in range(2):
                    s.table_select[gr][ch][r] = self.get_side_bits(5)
                for w in range(3):
                    s.subblock_gain[gr][ch][w] = self.get_side_bits(3)
                # implicit region counts, same rule as MPEG-1
                if s.block_type[gr][ch] == 2 and not s.mixed_block_flag[gr][ch]:
                    s.region0_count[gr][ch] = 8
                else:
                    s.region0_count[gr][ch] = 7
                s.region1_count[gr][ch] = 20 - s.region0_count[gr][ch]
            else:
                for r in range(3):
                    s.table_select[gr][ch][r] = self.get_side_bits(5)
                s.region0_count[gr][ch] = self.get_side_bits(4)
                s.region1_count[gr][ch] = self.get_side_bits(3)
                s.block_type[gr][ch] = 0
                s.mixed_block_flag[gr][ch] = 0
            s.preflag[gr][ch] = 0   # derived in _read_scalefacs_lsf
            s.scalefac_scale[gr][ch] = self.get_side_bits(1)
            s.count1table_select[gr][ch] = self.get_side_bits(1)
        return T.OK

    # ---- ID3v2 tag skipping (id3.org v2.3/2.4 header; capability
    # beyond the reference, which chokes on tags > ~1.1 KB) ----

    def skip_id3(self) -> None:
        """Consume any ID3v2 tag at the read cursor.  Incremental: tags
        larger than the ring drain across NEED_MORE round trips via
        id3_remaining.  Must be called OUTSIDE the frame-level cursor
        rollback (api.read does, before its snapshot)."""
        while True:
            if self.id3_remaining:
                n = min(self.id3_remaining, self.inbuf_filled())
                for _ in range(n):
                    self.get_byte()
                self.id3_remaining -= n
                if self.id3_remaining:
                    return        # tag continues past the buffered data
            if self.inbuf_filled() < 10:
                return
            hdr = [self.inbuf[(self.istart + k) % T.INBUF_SIZE]
                   for k in range(10)]
            if bytes(hdr[:3]) != b"ID3" or hdr[3] == 0xFF                     or any(b & 0x80 for b in hdr[6:10]):
                return            # not a (valid) tag header
            size = (hdr[6] << 21) | (hdr[7] << 14) | (hdr[8] << 7) | hdr[9]
            self.id3_remaining = 10 + size + (10 if hdr[5] & 0x10 else 0)

    # ---- free-format frame-size measurement (ISO 11172-3 §2.4.2.3:
    # bitrate_index 0 = "free format", constant frame size the decoder
    # deduces; the reference rejects it, pdmp3.c:1299) ----

    def _peek4(self, off: int) -> int | None:
        """Header word at `off` bytes past the read cursor, without
        consuming (None when beyond the buffered fill)."""
        if off + 4 > self.inbuf_filled():
            return None
        w = 0
        for k in range(4):
            w = (w << 8) | self.inbuf[(self.istart + off + k)
                                      % T.INBUF_SIZE]
        return w

    # compare sync + version + layer + bitrate_index + sampling_frequency
    _FREE_MASK = (0x7FF << 21) | (3 << 19) | (3 << 17) | (0xF << 12) \
        | (3 << 10)

    def _measure_free_size(self) -> int:
        """Deduce the free-format frame size from the sync spacing.

        Called with the cursor just past the 4 header bytes of the first
        free-format frame.  Scans the buffered input (non-consuming) for
        the next header whose sync/version/layer/bitrate/sfreq match;
        false syncs inside main data are screened by chain-verifying a
        third header at the same spacing when enough data is buffered.
        Sets free_size (excl. this frame's padding).  Returns OK /
        NEED_MORE (sync not yet in buffer) / ERR (no valid spacing
        within the 2000-byte framesize guard)."""
        h = self.header
        ver = (3, 2, 0)[h.family]
        want = ((0x7FF << 21) | (ver << 19) | ((4 - h.layer) << 17)
                | (h.sampling_frequency << 10))
        hi = 2000 - 4  # framesize > 2000 is rejected anyway
        filled = self.inbuf_filled()
        for o in range(9, hi + 1):
            w = self._peek4(o)
            if w is None:
                return T.NEED_MORE
            if (w & self._FREE_MASK) != want:
                continue
            # chain-verify: a third compatible header one frame later
            # (distance adjusted for the candidate's padding delta)
            size0 = o + 4                      # this frame's size
            base = size0 - h.padding_bit
            pad1 = (w >> 9) & 1
            w2 = self._peek4(o + base + pad1)
            if w2 is not None and (w2 & self._FREE_MASK) != want:
                continue                       # false sync in main data
            if w2 is None and filled < o + base + pad1 + 4 \
                    and o + base + pad1 + 4 <= T.INBUF_SIZE - 1:
                # can't verify yet and more data could still arrive
                return T.NEED_MORE
            if base <= (9 if h.family else 17) + 4:
                return T.ERR                   # no room for side info
            self.free_size = base
            return T.OK
        return T.ERR

    # ---- bit reservoir (pdmp3.c:1096-1122) ----

    def _get_main_data(self, size: int, begin: int) -> int:
        if begin > self.main_top:
            # underflow: buffer this frame's bytes, skip decode
            self._get_bytes_into(self.main_vec, self.main_top, size)
            self.main_byte = 0
            self.main_idx = 0
            self.main_top += size
            return T.NEED_MORE
        top = self.main_top
        self.main_vec[:begin] = self.main_vec[top - begin:top]
        self._get_bytes_into(self.main_vec, begin, size)
        self.main_byte = 0
        self.main_idx = 0
        self.main_top = begin + size
        return T.OK

    def _get_bytes_into(self, vec, off: int, n: int) -> int:
        """Get_Bytes parity (pdmp3.c:1076-1086): stop storing at EOF,
        leaving any stale tail bytes in place."""
        avail = min(n, self.inbuf_filled())
        for i in range(avail):
            vec[off + i] = self.get_byte()
        return T.OK if avail == n else C_EOF

    # ---- scalefactors + Huffman (pdmp3.c:1346-1442, 2051-2115) ----

    def _read_main(self, scalefac_l, scalefac_s, ix) -> int:
        h, s = self.header, self.side
        nch = h.nch
        framesize = h.frame_size()
        if framesize > 2000:
            return T.ERR
        if h.family:
            sideinfo_size = 9 if nch == 1 else 17
        else:
            sideinfo_size = 17 if nch == 1 else 32
        main_data_size = framesize - sideinfo_size - 4
        if h.protection_bit == 0:
            main_data_size -= 2
        res = self._get_main_data(main_data_size, s.main_data_begin)
        if res != T.OK:
            return res
        if h.family:
            # LSF: one granule, 13818-3 scalefactor partitions; arrays are
            # reused across frames so clear everything including granule 1
            # and the untransmitted policy slots (sfb21 / short band 12
            # stay scalefactor 0 — the spec default, no reference quirk
            # to emulate since the reference rejects LSF streams)
            scalefac_l[:] = 0
            scalefac_s[:] = 0
            self._lsf_is_l = None
            self._lsf_is_s = None
            self._lsf_iscale = 0
            for ch in range(nch):
                part_2_start = self.main_pos()
                self._read_scalefacs_lsf(ch, scalefac_l, scalefac_s)
                self._read_huffman(part_2_start, 0, ch, ix)
            return T.OK
        for gr in range(2):
            for ch in range(nch):
                part_2_start = self.main_pos()
                slen1, slen2 = T.SCALEFAC_SIZES[s.scalefac_compress[gr][ch]]
                slen1, slen2 = int(slen1), int(slen2)
                if s.win_switch_flag[gr][ch] and s.block_type[gr][ch] == 2:
                    if s.mixed_block_flag[gr][ch]:
                        for sfb in range(8):
                            scalefac_l[gr][ch][sfb] = self.get_main_bits(slen1)
                        for sfb in range(3, 12):
                            nbits = slen1 if sfb < 6 else slen2
                            for w in range(3):
                                scalefac_s[gr][ch][sfb][w] = self.get_main_bits(nbits)
                    else:
                        for sfb in range(12):
                            nbits = slen1 if sfb < 6 else slen2
                            for w in range(3):
                                scalefac_s[gr][ch][sfb][w] = self.get_main_bits(nbits)
                else:
                    for grp, (lo, hi, sl) in enumerate(
                            ((0, 6, slen1), (6, 11, slen1),
                             (11, 16, slen2), (16, 21, slen2))):
                        if s.scfsi[ch][grp] == 0 or gr == 0:
                            for sfb in range(lo, hi):
                                scalefac_l[gr][ch][sfb] = self.get_main_bits(sl)
                        elif s.scfsi[ch][grp] == 1 and gr == 1:
                            scalefac_l[1][ch][lo:hi] = scalefac_l[0][ch][lo:hi]
                self._read_huffman(part_2_start, gr, ch, ix)
        return T.OK

    def _read_scalefacs_lsf(self, ch: int,
                            scalefac_l, scalefac_s) -> None:
        """LSF scalefactor decode (13818-3 §2.4.3.4, dist10's
        III_get_LSF_scale_factors partitioning).

        The channel's raw transmitted values land in scalefac_l/s exactly
        like MPEG-1 (the requantizer treats them identically; preflag is
        derived, not transmitted).  For the intensity channel (ch1 when
        mode==joint-stereo with intensity on) the same values double as
        intensity positions: the per-partition all-ones value is the
        "no intensity" sentinel, which we map to tables.LSF_IS_ILLEGAL in
        a separate sidecar so the raw requantizer inputs stay intact.
        slen==0 partitions transmit nothing and yield position 0 (legal,
        k0=k1=1) — the minimp3/spec reading, not libmad's vacuous-truth
        "all bits set" one.  Untransmitted bands (beyond the partition
        sums: long sfb21, short band 12) are scalefactor 0 / position 0.
        """
        h, s = self.header, self.side
        intensity_ch = bool(ch == 1 and h.mode == 1
                            and (h.mode_extension & 1))
        sc = int(s.scalefac_compress[0][ch])
        slen, _blocknum, preflag, iscale = T.lsf_slen(sc, intensity_ch)
        s.preflag[0][ch] = preflag
        short = s.win_switch_flag[0][ch] and s.block_type[0][ch] == 2
        mixed = bool(short and s.mixed_block_flag[0][ch])
        bclass = 2 if mixed else (1 if short else 0)
        counts = T.NR_OF_SFB[_blocknum][bclass]
        raw: list[int] = []
        pos: list[int] = []
        for p in range(4):
            w = int(slen[p])
            for _ in range(int(counts[p])):
                v = self.get_main_bits(w) if w else 0
                raw.append(v)
                pos.append(T.LSF_IS_ILLEGAL
                           if (w and v == (1 << w) - 1) else v)
        if intensity_ch:
            self._lsf_iscale = iscale
            is_l = np.zeros(22, np.int32)
            is_s = np.zeros((13, 3), np.int32)
        k = 0
        if bclass == 0:
            for sfb in range(21):
                scalefac_l[0][ch][sfb] = raw[k]
                if intensity_ch:
                    is_l[sfb] = pos[k]
                k += 1
        else:
            if mixed:
                for sfb in range(T.SWITCH_SFB_L[h.family]):
                    scalefac_l[0][ch][sfb] = raw[k]
                    if intensity_ch:
                        is_l[sfb] = pos[k]
                    k += 1
            for sfb in range(T.SWITCH_SFB_S if mixed else 0, 12):
                for w in range(3):
                    scalefac_s[0][ch][sfb][w] = raw[k]
                    if intensity_ch:
                        is_s[sfb][w] = pos[k]
                    k += 1
        if intensity_ch:
            self._lsf_is_l = is_l
            self._lsf_is_s = is_s

    def _read_huffman(self, part_2_start: int, gr: int, ch: int, ix) -> None:
        s = self.side
        line = ix[gr][ch]
        if s.part2_3_length[gr][ch] == 0:
            line[:] = 0
            # reference quirk (pdmp3.c:2057-2060): the early return never
            # sets count1, so the PREVIOUS frame's value persists in the
            # handle and keeps driving the MS extent — found by the
            # round-5 diversified real-encoder soak (LAME VBR emits
            # silent p23==0 channels; seed 801224).  LSF is spec-sane:
            # a silent channel's rzero starts at 0.
            if self.header.family:
                s.count1[gr][ch] = 0
            return
        bit_pos_end = part_2_start + int(s.part2_3_length[gr][ch]) - 1
        if s.win_switch_flag[gr][ch] and s.block_type[gr][ch] == 2:
            # region0 = first 3 short scalefactor bands x 3 windows.
            # All MPEG-1 rates have 4-wide leading short bands, so the
            # reference hardcodes 36 (pdmp3.c:2064); MPEG-2.5 8 kHz has
            # 8-wide bands (3*24 = 72).  Verified empirically vs BOTH
            # libmpg123 and libavcodec (round 5 single-line probes);
            # they disagree with each other on 8 kHz MIXED blocks
            # (ffmpeg 72 / mpg123 108) — we follow ffmpeg, our LSF
            # anchor (DESIGN.md §6).
            h = self.header
            region_1_start = 3 * int(
                T.SFB_SHORT_FAM[h.family][h.sampling_frequency][3])
            region_2_start = 576
        else:
            h = self.header
            sfreq = h.sampling_frequency
            longs = T.SFB_LONG_FAM[h.family][sfreq]
            region_1_start = int(longs[s.region0_count[gr][ch] + 1])
            # hostile side info can push this index past l[22] (region
            # counts are raw 4+3 bit fields: 15+7+2 = 24); the
            # reference's struct layout aliases .l[23+k] onto .s[k]
            # (pdmp3.c:108-112, 2074-2076) — emulate the alias (found by
            # tools/fuzz.py as a native OOB / python IndexError).  LSF
            # has no reference to mirror: clamp to the 576 end instead.
            r2i = int(s.region0_count[gr][ch] + s.region1_count[gr][ch] + 2)
            if h.family:
                region_2_start = int(longs[min(r2i, 22)])
            else:
                region_2_start = int(longs[r2i] if r2i <= 22
                                     else T.SFB_SHORT[sfreq][r2i - 23])
        tabs = T.huffman_tables()
        big = int(s.big_values[gr][ch]) * 2
        is_pos = 0
        while is_pos < big:
            if is_pos < region_1_start:
                tnum = int(s.table_select[gr][ch][0])
            elif is_pos < region_2_start:
                tnum = int(s.table_select[gr][ch][1])
            else:
                tnum = int(s.table_select[gr][ch][2])
            x, y = self._huff_pair(tabs[tnum])
            if is_pos >= 576:  # malformed stream: reference would OOB-write
                is_pos += 2
                continue
            line[is_pos] = x
            if is_pos + 1 < 576:
                line[is_pos + 1] = y
            is_pos += 2
        tnum = int(s.count1table_select[gr][ch]) + 32
        is_pos = big
        while is_pos <= 572 and self.main_pos() <= bit_pos_end:
            v, w, x, y = self._huff_quad(tabs[tnum])
            line[is_pos] = v
            is_pos += 1
            if is_pos >= 576:
                break
            line[is_pos] = w
            is_pos += 1
            if is_pos >= 576:
                break
            line[is_pos] = x
            is_pos += 1
            if is_pos >= 576:
                break
            line[is_pos] = y
            is_pos += 1
        if self.main_pos() > bit_pos_end + 1:
            is_pos -= 4
        s.count1[gr][ch] = is_pos
        line[max(is_pos, 0):576] = 0
        self.set_main_pos(bit_pos_end + 1)

    def _peek_decode(self, tab) -> tuple[int, int]:
        """Decode one codeword via the LUT, consuming exactly its length.

        The peek must replicate a sequence of Get_Main_Bit calls
        (pdmp3.c:1489-1497), which read only the LOW BYTE of each reservoir
        word — unlike Get_Main_Bits' OR-flood window — so that parity holds
        even when EOF words (0xFFFFFFFF) sit in the reservoir."""
        b, i = self.main_byte, self.main_idx
        vec = self.main_vec
        nbytes = (i + tab.maxlen + 7) >> 3
        window = 0
        for k in range(nbytes):
            window = (window << 8) | (int(vec[b + k]) & 0xFF)
        peek = (window >> (nbytes * 8 - i - tab.maxlen)) & ((1 << tab.maxlen) - 1)
        length, x, y = tab.decode(peek)
        self.main_idx += length
        self.main_byte += self.main_idx >> 3
        self.main_idx &= 7
        return x, y

    def _huff_pair(self, tab) -> tuple[int, int]:
        if tab.maxlen == 0:
            return 0, 0
        x, y = self._peek_decode(tab)
        if tab.linbits and x == 15:
            x += self.get_main_bits(tab.linbits)
        if x > 0 and self.get_main_bit():
            x = -x
        if tab.linbits and y == 15:
            y += self.get_main_bits(tab.linbits)
        if y > 0 and self.get_main_bit():
            y = -y
        return x, y

    def _huff_quad(self, tab) -> tuple[int, int, int, int]:
        # LSF frames always use the REAL ISO table B: the broken-table-33
        # emulation is reference bug parity, and the reference rejects
        # id=0 (pdmp3.c:1295).  Real MPEG-2/2.5 encoders (LAME) select
        # table B — spec decode is the only one matching production
        # decoders (round-5 real-encoder LSF conformance; anchored vs
        # libmpg123 + libavcodec).
        if tab.ref_broken and not (self.count1_table_b_spec
                                   or self.header.family):
            q = 3  # reference's stale table-33 pointer: 0-bit leaf (2,3)
        else:
            _, q = self._peek_decode(tab)
        v, w, x, y = (q >> 3) & 1, (q >> 2) & 1, (q >> 1) & 1, q & 1
        if v and self.get_main_bit():
            v = -v
        if w and self.get_main_bit():
            w = -w
        if x and self.get_main_bit():
            x = -x
        if y and self.get_main_bit():
            y = -y
        return v, w, x, y

    # ---- Layer I/II frame decode (beyond-reference; ISO 11172-3
    # §2.4.1.5-6, §2.4.2.1-2 and 13818-3 table B.1 for LSF Layer II;
    # the reference rejects layer != 3, pdmp3.c:1240/1312) ----

    def _read_frame_l12(self, crc_read: int = -1
                        ) -> tuple[int, "FrameData | None"]:
        """Parse + requantize one Layer I/II frame into sb_samples.

        Layer I/II carry no bit reservoir: the frame's sample data sits
        between this header and the next, so it is consumed here in one
        bounded read.  EOF mid-frame returns NEED_MORE (the caller rolls
        the input cursor back, restoring the header bytes).
        crc_read >= 0 (crc_check mode): verify before parsing; a
        failing frame's body is already consumed, so decoding simply
        restarts at the next header."""
        h = self.header
        nbytes = h.frame_size() - 4 - (2 if h.protection_bit == 0 else 0)
        if nbytes <= 0:
            return T.ERR, None
        data = bytearray(nbytes)
        for i in range(nbytes):
            v = self.get_byte()
            if v == C_EOF:
                return T.NEED_MORE, None
            data[i] = v
        if crc_read >= 0:
            if h.layer == 1:
                widths, bound = [4] * 32, 0   # bound unused for Layer I
            else:
                table = T.l2_alloc_table(h.bitrate_index,
                                         h.sampling_frequency, h.nch,
                                         h.family)
                widths = [t[0] for t in table]
                bound = T.l12_bound(h.mode, h.mode_extension, len(table))
            nbits = T.l12_protected_bits(h.layer, h.nch, bound, widths,
                                         bytes(data))
            crc = T.crc16_mpeg_bits(
                bytes(data), nbits,
                T.crc16_mpeg(bytes([(self._hdr_raw16 >> 8) & 0xFF,
                                    self._hdr_raw16 & 0xFF])))
            if crc != crc_read:
                return self.read_frame()
        br = _BitReader(bytes(data))
        sb = self._parse_l1(br) if h.layer == 1 else self._parse_l2(br)
        if sb is None or br.overflow:
            return T.ERR, None
        import copy
        return T.OK, FrameData(
            copy.deepcopy(h), SideInfo(),
            np.zeros((2, 2, 22), np.int32),
            np.zeros((2, 2, 13, 3), np.int32),
            np.zeros((2, 2, 576), np.int32), sb_samples=sb)

    @staticmethod
    def _l12_frac(code: int, nb: int) -> float:
        """MSB-inverted two's-complement fraction of an nb-bit code
        (11172-3 §2.4.3.2/.3: s''')."""
        msb = 1 << (nb - 1)
        c = code ^ msb
        if c >= msb:
            c -= 1 << nb
        return c / msb

    def _parse_l1(self, br: "_BitReader") -> np.ndarray | None:
        h = self.header
        nch = h.nch
        bound = T.l12_bound(h.mode, h.mode_extension, 32)
        alloc = np.zeros((2, 32), np.int32)
        for sb in range(32):
            if sb < bound:
                for ch in range(nch):
                    alloc[ch][sb] = br.get(4)
            else:
                alloc[0][sb] = alloc[1][sb] = br.get(4)
        if (alloc == 15).any():
            return None     # forbidden allocation index
        scf = np.zeros((2, 32), np.int32)
        for sb in range(32):
            for ch in range(nch):
                if alloc[ch][sb]:
                    scf[ch][sb] = br.get(6)
        out = np.zeros((2, 12, 32), np.float32)
        scale = T.SCF_L12
        for s in range(12):
            for sb in range(32):
                shared = sb >= bound
                for ch in range(1 if shared else nch):
                    a = int(alloc[ch][sb])
                    if not a:
                        continue
                    nb = a + 1
                    code = br.get(nb)
                    spp = ((1 << nb) / ((1 << nb) - 1)) \
                        * (self._l12_frac(code, nb) + 2.0 ** (1 - nb))
                    for cch in range(nch if shared else ch + 1):
                        if shared or cch == ch:
                            out[cch][s][sb] = np.float32(
                                float(scale[min(scf[cch][sb], 62)]) * spp)
        return out

    def _parse_l2(self, br: "_BitReader") -> np.ndarray | None:
        h = self.header
        nch = h.nch
        table = T.l2_alloc_table(h.bitrate_index, h.sampling_frequency,
                                 nch, h.family)
        sblimit = len(table)
        bound = T.l12_bound(h.mode, h.mode_extension, sblimit)
        alloc = np.zeros((2, 32), np.int32)
        for sb in range(sblimit):
            nbal = table[sb][0]
            if sb < bound:
                for ch in range(nch):
                    alloc[ch][sb] = br.get(nbal)
            else:
                alloc[0][sb] = alloc[1][sb] = br.get(nbal)
        scfsi = np.zeros((2, 32), np.int32)
        for sb in range(sblimit):
            for ch in range(nch):
                if alloc[ch][sb]:
                    scfsi[ch][sb] = br.get(2)
        scf = np.zeros((2, 32, 3), np.int32)
        for sb in range(sblimit):
            for ch in range(nch):
                if alloc[ch][sb]:
                    si = int(scfsi[ch][sb])
                    if si == 0:
                        a, b, c = br.get(6), br.get(6), br.get(6)
                    elif si == 1:
                        a = br.get(6)
                        b, c = a, br.get(6)
                    elif si == 2:
                        a = br.get(6)
                        b = c = a
                    else:
                        a = br.get(6)
                        b = br.get(6)
                        c = b
                    scf[ch][sb] = (a, b, c)
        out = np.zeros((2, 36, 32), np.float32)
        scale = T.SCF_L12
        for gr in range(12):
            part = gr >> 2
            for sb in range(sblimit):
                shared = sb >= bound
                for ch in range(1 if shared else nch):
                    a = int(alloc[ch][sb])
                    if not a:
                        continue
                    steps = table[sb][1][a - 1]
                    bits, grouped, cc, dd = T.L2_CLASSES[steps]
                    if grouped:
                        nb = {3: 2, 5: 3, 9: 4}[steps]
                        c = br.get(bits)
                        codes = (c % steps, (c // steps) % steps,
                                 (c // (steps * steps)) % steps)
                    else:
                        nb = bits
                        codes = (br.get(bits), br.get(bits), br.get(bits))
                    for k in range(3):
                        spp = cc * (self._l12_frac(codes[k], nb) + dd)
                        for cch in range(nch if shared else ch + 1):
                            if shared or cch == ch:
                                out[cch][3 * gr + k][sb] = np.float32(
                                    float(scale[min(scf[cch][sb][part], 62)])
                                    * spp)
        return out

    # ---- frame loop (pdmp3.c:1217-1244) ----

    def read_frame(self) -> tuple[int, FrameData | None]:
        """Search header + parse one frame. Returns (status, FrameData|None).

        On any non-OK status the caller is expected to roll back the input
        cursor (as pdmp3_read does, pdmp3.c:2459-2462).
        """
        res = self.search_header()
        if res != T.OK:
            return (T.ERR if res == T.ERR else res), None
        if self.header.bitrate_index == 0 and self.free_size == 0:
            res = self._measure_free_size()
            if res != T.OK:
                # caller rolls the input cursor back (pdmp3.c:2459-2462),
                # so the consumed header bytes are restored for resume
                return res, None
            self.header.free_size = self.free_size
        crc_read = -1
        if self.header.protection_bit == 0:
            # CRC bytes read and (by default) discarded; EOF here is
            # silently ignored because the reference's Read_CRC returns
            # FALSE==PDMP3_OK on EOF (pdmp3.c:1206-1210, 1231).
            c1 = self.get_byte()
            c2 = self.get_byte()
            if self.crc_check and C_EOF not in (c1, c2):
                crc_read = (c1 << 8) | c2
        if self.header.layer != 3:
            if self.layers12 and self.header.layer in (1, 2):
                return self._read_frame_l12(crc_read)
            return T.ERR, None
        res = self._read_side_info()
        if res != T.OK:
            return T.ERR, None
        if crc_read >= 0:
            # ISO CRC-16 over header bits 16-31 + the side-info bytes
            # (tables.crc16_mpeg).  On mismatch the frame is skipped
            # whole: its (corrupt) main data never enters the reservoir,
            # and decoding resumes at the next frame.  Layer I/II CRC
            # (different protected-bit extent) stays discard-only.
            size = (9 if self.header.nch == 1 else 17) if self.header.family \
                else (17 if self.header.nch == 1 else 32)
            prot = bytes([(self._hdr_raw16 >> 8) & 0xFF,
                          self._hdr_raw16 & 0xFF]) \
                + bytes(int(v) & 0xFF for v in self.side_vec[:size])
            if T.crc16_mpeg(prot) != crc_read:
                skip = self.header.frame_size() - 4 - 2 - size
                for _ in range(skip):
                    if self.get_byte() == C_EOF:
                        # partial frame buffered: the caller rolls the
                        # cursor back and retries once fed more
                        return T.NEED_MORE, None
                # bounded by the frames the 16 KiB ring can hold
                return self.read_frame()
        scalefac_l = self.scalefac_l
        scalefac_s = self.scalefac_s
        ix = np.zeros((2, 2, 576), np.int32)
        res = self._read_main(scalefac_l, scalefac_s, ix)
        if res != T.OK:
            return res, None
        import copy
        if self.header.family:
            # LSF: no alias quirks to emulate (reference rejects id==0);
            # policy slots already zeroed by _read_main
            return T.OK, FrameData(
                copy.deepcopy(self.header), copy.deepcopy(self.side),
                scalefac_l.copy(), scalefac_s.copy(), ix,
                is_eff_l=self._lsf_is_l, is_eff_s=self._lsf_is_s,
                intensity_scale=self._lsf_iscale)
        # sfb21-region policy slot: the reference's requantizer reads
        # scalefac_l[gr][ch][21] out of bounds when count1 exceeds band 21
        # (pdmp3.c:1896-1902); by struct layout that aliases the NEXT
        # granule-channel's scalefac 0 (and scalefac_s[0][0][0][0] for the
        # last one), with pretab[21] == 0.0 in the reference binary.
        flat = [scalefac_l[0][0], scalefac_l[0][1], scalefac_l[1][0],
                scalefac_l[1][1]]
        for k in range(3):
            flat[k][21] = flat[k + 1][0]
        scalefac_l[1][1][21] = scalefac_s[0][0][0][0]
        # same aliasing for the short band-12 slot: scalefac_s[g][c][12][w]
        # reads the next granule-channel's [0][w]; the last aliases float
        # bits of is[0][0] (unbounded, left at policy 0 — see DESIGN.md §6)
        flats = [scalefac_s[0][0], scalefac_s[0][1], scalefac_s[1][0]]
        nxt = [scalefac_s[0][1], scalefac_s[1][0], scalefac_s[1][1]]
        for k in range(3):
            flats[k][12] = nxt[k][0]
        # the last granule-channel's band-12 slot aliases float BITS of
        # is[0][0] — a huge unsigned scalefactor whose gain underflows to
        # +0.0; sentinel 63 maps to the zeroed gain-table region
        scalefac_s[1][1][12][:] = 63
        import copy
        side = copy.deepcopy(self.side)
        header = copy.deepcopy(self.header)
        return T.OK, FrameData(header, side, scalefac_l.copy(),
                               scalefac_s.copy(), ix)

    def reset(self) -> None:
        """pdmp3_open_feed semantics (pdmp3.c:2369-2384)."""
        self.istart = self.iend = 0
        self.processed = 0
        self.new_header = 0
        self.main_top = 0
        self.free_size = 0
        self.id3_remaining = 0
