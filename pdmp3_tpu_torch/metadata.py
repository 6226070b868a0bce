"""Stream metadata, duration, gapless trim, and sample-accurate seeking.

Host-side control plane (pure Python, no hot-path impact): parses the
VBR metadata headers real-world MP3 files carry — Xing/Info (frame
count, byte count, 100-entry seek TOC, quality), the LAME extension
(encoder string, VBR method, encoder delay/padding for gapless
playback, music/tag CRCs), and Fraunhofer VBRI — none of which the
reference decoder reads at all (it decodes a tag frame as 1152 samples
of silence, /root/reference/pdmp3.c has no "Xing" string).  On top of
the parsed index it provides:

- :func:`parse_stream_info` — one-call probe: format, duration,
  VBR/CBR, gapless bounds.
- :class:`FrameIndex` — exact per-frame byte offsets by header walk,
  with reservoir-aware preroll for seeking.
- :func:`decode_file_seek` — decode an arbitrary ``[t0, t1)`` window
  bit-exactly equal to the same window of a full-file decode.  Three
  mechanisms make a mid-stream join exact against ANY conforming
  decoder (including the reference binary): (1) two injection frames
  that *transmit* the historical persistent-scalefactor arrays (the
  reference keeps ``g_main_data.scalefac_*`` for the handle's life;
  silent granules and the sfb21/short-band-12 requantizer overreads
  read values that can originate arbitrarily far back — found by
  seeking real LAME VBR streams, tests/test_real_encoder.py); (2) a
  reservoir primer whose payload ends with the REAL trailing main-data
  bytes before the join, so every joined frame decodes its true bits;
  (3) a frame of IMDCT-overlap/synthesis-ring warm-up.
- :func:`decode_file_gapless` — LAME delay/padding trim: drops the
  encoder delay + the 529-sample decoder latency up front and the
  encoder padding at the tail, yielding exactly the track's original
  sample count.
- :func:`parse_tags` — song metadata from every tag container a real
  file carries (leading ID3v2.2/2.3/2.4 text frames, trailing
  ID3v1/v1.1, APEv1/v2, Lyrics3 v1/v2), merged into one
  :class:`TagInfo` with mpg123_id3()-style fields; trailing-tag bytes
  are excluded from duration estimates and the frame index.

Layer III only for the VBR headers (Xing/VBRI are Layer III
conventions); the header walk and duration estimate also handle the
Layer I/II and MPEG-2/2.5 LSF extensions.

Design choice: this module is deliberately Python — stream metadata is
parsed once per file on the host; the native C++ frontend stays the
reference-parity bitstream engine (a tag frame decodes to silence
there, exactly like the reference).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from . import tables as T

#: Samples a conforming Layer III decoder is late by (256-sample IMDCT
#: half-window + 241 polyphase + ... = 529; the constant LAME's gapless
#: delay/padding accounting is defined against).
DECODER_DELAY = 529

_SYNC_MASK = 0xFFE0  # 11-bit sync (accepts MPEG-2.5's cleared bit)


@dataclass
class MPEGHeader:
    """Decoded 4-byte frame header (bit layout: ISO 11172-3 §2.4.1.3)."""
    family: int            # 0 = MPEG-1, 1 = MPEG-2, 2 = MPEG-2.5
    layer: int             # 1..3
    protection_bit: int
    bitrate_index: int
    sampling_frequency: int
    padding_bit: int
    mode: int
    mode_extension: int

    @property
    def nch(self) -> int:
        return 1 if self.mode == 3 else 2

    @property
    def sample_rate(self) -> int:
        return int(T.SAMPLE_RATES_FAM[self.family][self.sampling_frequency])

    @property
    def bitrate(self) -> int:
        """Nominal bits/s (0 for free format)."""
        if self.bitrate_index == 0:
            return 0
        if self.family == 0:
            return int(T.BITRATES[self.layer - 1][self.bitrate_index])
        if self.layer == 1:
            return int(T.BITRATES_LSF_L1[self.bitrate_index])
        return int(T.BITRATES_LSF[self.bitrate_index])

    @property
    def samples_per_frame(self) -> int:
        if self.layer == 1:
            return 384
        if self.layer == 2:
            return 1152
        return 576 if self.family else 1152

    @property
    def side_info_size(self) -> int:
        """Layer III side-info bytes (frontend.py:408-415)."""
        if self.layer != 3:
            return 0
        if self.family:
            return 9 if self.nch == 1 else 17
        return 17 if self.nch == 1 else 32

    def frame_size(self) -> int:
        """Whole-frame bytes incl. header (0 = free format: measure)."""
        if self.bitrate_index == 0:
            return 0
        rate = self.sample_rate
        if self.layer == 1:
            return 4 * (12 * self.bitrate // rate + self.padding_bit)
        factor = self.samples_per_frame // 8
        return factor * self.bitrate // rate + self.padding_bit


def parse_header(data: bytes, off: int) -> MPEGHeader | None:
    """Decode the 4 bytes at ``off`` as a frame header; None if invalid.

    Accepts all three MPEG families and all three layers (a metadata
    probe should describe the stream, not enforce a decode profile —
    profile gating happens in the decoders)."""
    if off + 4 > len(data):
        return None
    b0, b1, b2, b3 = data[off:off + 4]
    if b0 != 0xFF or ((b0 << 8) | b1) & _SYNC_MASK != _SYNC_MASK:
        return None
    ver = (b1 >> 3) & 3
    family = {3: 0, 2: 1, 0: 2}.get(ver)
    layer_bits = (b1 >> 1) & 3
    if family is None or layer_bits == 0:
        return None
    h = MPEGHeader(
        family=family,
        layer=4 - layer_bits,
        protection_bit=b1 & 1,
        bitrate_index=(b2 >> 4) & 0xF,
        sampling_frequency=(b2 >> 2) & 3,
        padding_bit=(b2 >> 1) & 1,
        mode=(b3 >> 6) & 3,
        mode_extension=(b3 >> 4) & 3,
    )
    if h.bitrate_index in (0, 15) or h.sampling_frequency == 3:
        return None              # free format needs a measured size; skip
    return h


def skip_id3v2(data: bytes, off: int = 0) -> int:
    """Return the offset past any ID3v2 tag(s) at ``off``."""
    while off + 10 <= len(data) and data[off:off + 3] == b"ID3" \
            and data[off + 3] != 0xFF \
            and not any(b & 0x80 for b in data[off + 6:off + 10]):
        size = ((data[off + 6] << 21) | (data[off + 7] << 14)
                | (data[off + 8] << 7) | data[off + 9])
        off += 10 + size + (10 if data[off + 5] & 0x10 else 0)
    return off


def find_first_frame(data: bytes, off: int = 0) -> tuple[int, MPEGHeader] | None:
    """Scan for the first frame header that chains to a second valid
    header (the standard false-sync filter), skipping ID3v2 tags."""
    off = skip_id3v2(data, off)
    end = len(data)
    while off + 4 <= end:
        h = parse_header(data, off)
        if h is not None:
            nxt = off + h.frame_size()
            if nxt + 4 > end:     # stream too short to confirm: accept
                return off, h
            h2 = parse_header(data, nxt)
            if h2 is not None and h2.layer == h.layer \
                    and h2.family == h.family \
                    and h2.sampling_frequency == h.sampling_frequency:
                return off, h
        off += 1
    return None


# ---------------------------------------------------------------------------
# Xing/Info + LAME extension, VBRI
# ---------------------------------------------------------------------------

_XING_FRAMES = 1
_XING_BYTES = 2
_XING_TOC = 4
_XING_QUALITY = 8


def crc16_lame(buf: bytes, crc: int = 0) -> int:
    """CRC-16/ARC (poly 0x8005 reflected, init 0) — the checksum LAME's
    tag writer uses for both the music CRC and the tag CRC (validated
    against libavformat's writer, tests/test_metadata.py)."""
    for byte in buf:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0xA001 if crc & 1 else 0)
    return crc


@dataclass
class LameInfo:
    """LAME tag extension (the 36 bytes after the Xing TOC/quality)."""
    encoder: str = ""
    revision: int = 0
    vbr_method: int = 0
    lowpass_hz: int = 0
    encoder_delay: int = 0     # samples the encoder prepended
    encoder_padding: int = 0   # samples the encoder appended
    mp3_gain: int = 0
    music_length: int = 0      # stream bytes; writers differ on whether
    #                            the tag frame counts (Lavf: whole file)
    music_crc: int = 0
    tag_crc: int = 0
    tag_crc_ok: bool = False


@dataclass
class StreamInfo:
    """Everything :func:`parse_stream_info` learns about a stream."""
    # container / framing
    id3v2_bytes: int = 0
    first_frame_offset: int = 0     # tag frame if one exists
    first_audio_offset: int = 0     # first PCM-bearing frame
    # format (from the first header)
    family: int = 0                 # 0 = MPEG-1, 1 = MPEG-2, 2 = MPEG-2.5
    layer: int = 0
    sample_rate: int = 0
    channels: int = 0
    mode: int = 0
    samples_per_frame: int = 0
    nominal_bitrate: int = 0        # bits/s from the first audio header
    # VBR metadata
    vbr_header: str | None = None   # "xing" | "info" | "vbri" | None
    is_cbr_tag: bool = False        # magic was "Info" (CBR assertion)
    frame_count: int | None = None  # audio frames (excl. the tag frame)
    byte_count: int | None = None
    toc: bytes | None = None        # Xing: 100 bytes; VBRI: raw table
    quality: int | None = None
    lame: LameInfo | None = None
    # VBRI specifics
    vbri_version: int | None = None
    vbri_delay: int | None = None
    # container tags (:func:`parse_tags`): bytes of trailing
    # ID3v1/APEv2/Lyrics3 stack, and the merged song metadata
    trailing_tag_bytes: int = 0
    tags: TagInfo | None = None

    @property
    def has_gapless_info(self) -> bool:
        return self.lame is not None and (self.lame.encoder_delay
                                          or self.lame.encoder_padding)

    @property
    def total_samples(self) -> int | None:
        """Per-channel PCM samples a gapless decode yields (None when
        the stream carries no frame count)."""
        if self.frame_count is None:
            return None
        n = self.frame_count * self.samples_per_frame
        if self.lame is not None:
            n -= self.lame.encoder_delay + self.lame.encoder_padding
        return max(n, 0)

    @property
    def duration_seconds(self) -> float | None:
        n = self.total_samples
        if n is None or not self.sample_rate:
            return None
        return n / self.sample_rate

    def estimate_duration(self, stream_bytes: int) -> float | None:
        """CBR fallback when no VBR header is present: audio bytes
        (container tags excluded) over the nominal byte rate."""
        if self.duration_seconds is not None:
            return self.duration_seconds
        if not self.nominal_bitrate:
            return None
        audio = (stream_bytes - self.first_audio_offset
                 - self.trailing_tag_bytes)
        return 8.0 * max(audio, 0) / self.nominal_bitrate


def _parse_xing(data: bytes, off: int, h: MPEGHeader,
                info: StreamInfo) -> bool:
    """Parse a Xing/Info header in the frame at ``off``; True on hit."""
    pos = off + 4 + (2 if h.protection_bit == 0 else 0) + h.side_info_size
    magic = data[pos:pos + 4]
    if magic not in (b"Xing", b"Info"):
        return False
    frame_end = min(off + h.frame_size(), len(data))  # truncated tag: degrade
    info.vbr_header = "info" if magic == b"Info" else "xing"
    info.is_cbr_tag = magic == b"Info"
    pos += 4
    if pos + 4 > frame_end:
        return True
    flags = struct.unpack_from(">I", data, pos)[0]
    pos += 4
    if flags & _XING_FRAMES and pos + 4 <= frame_end:
        info.frame_count = struct.unpack_from(">I", data, pos)[0]
        pos += 4
    if flags & _XING_BYTES and pos + 4 <= frame_end:
        info.byte_count = struct.unpack_from(">I", data, pos)[0]
        pos += 4
    if flags & _XING_TOC and pos + 100 <= frame_end:
        info.toc = bytes(data[pos:pos + 100])
        pos += 100
    if flags & _XING_QUALITY and pos + 4 <= frame_end:
        info.quality = struct.unpack_from(">I", data, pos)[0]
        pos += 4
    # LAME extension: encoder string onward (LAME writes all four Xing
    # fields, so this sits at magic+120; we follow the actual cursor)
    if pos + 36 > frame_end:
        return True
    enc = data[pos:pos + 9]
    if not any(32 <= c < 127 for c in enc):
        return True               # no printable encoder string: no tag
    lm = LameInfo()
    lm.encoder = enc.decode("latin-1").rstrip("\x00 ")
    lm.revision = data[pos + 9] >> 4
    lm.vbr_method = data[pos + 9] & 0xF
    lm.lowpass_hz = data[pos + 10] * 100
    d0, d1, d2 = data[pos + 21:pos + 24]
    lm.encoder_delay = (d0 << 4) | (d1 >> 4)
    lm.encoder_padding = ((d1 & 0xF) << 8) | d2
    lm.mp3_gain = data[pos + 25]
    lm.music_length = struct.unpack_from(">I", data, pos + 28)[0]
    lm.music_crc = struct.unpack_from(">H", data, pos + 32)[0]
    lm.tag_crc = struct.unpack_from(">H", data, pos + 34)[0]
    # tag CRC covers the frame bytes before the CRC field (190 of them
    # in the canonical MPEG-1-stereo all-flags layout; LAME CRCs up to
    # the field position, so the general rule is [frame, field))
    crc_field = pos + 34
    lm.tag_crc_ok = crc16_lame(data[off:crc_field]) == lm.tag_crc
    info.lame = lm
    return True


def _parse_vbri(data: bytes, off: int, h: MPEGHeader,
                info: StreamInfo) -> bool:
    """Fraunhofer VBRI header: fixed 32-byte gap after the header."""
    pos = off + 4 + 32
    if data[pos:pos + 4] != b"VBRI" or pos + 30 > len(data):
        return False
    info.vbr_header = "vbri"
    (info.vbri_version, info.vbri_delay, q, nbytes, nframes,
     n_ent, scale, ent_bytes, ent_frames) = struct.unpack_from(
        ">HHHIIHHHH", data, pos + 4)
    info.quality = q
    info.byte_count = nbytes
    info.frame_count = nframes
    tab = pos + 26
    info.toc = bytes(data[tab:tab + n_ent * ent_bytes])
    return True


def parse_stream_info(data: bytes) -> StreamInfo | None:
    """Probe a stream: format, VBR metadata, gapless bounds.

    Returns None when no frame sync is found.  Never raises on
    truncated/garbage tag payloads — fields stay at their defaults.
    """
    hit = find_first_frame(data)
    if hit is None:
        return None
    off, h = hit
    info = StreamInfo(
        id3v2_bytes=skip_id3v2(data),
        first_frame_offset=off,
        first_audio_offset=off,
        family=h.family,
        layer=h.layer,
        sample_rate=h.sample_rate,
        channels=h.nch,
        mode=h.mode,
        samples_per_frame=h.samples_per_frame,
        nominal_bitrate=h.bitrate,
    )
    info.trailing_tag_bytes, info.tags = parse_tags(data)
    if h.layer == 3 and (_parse_xing(data, off, h, info)
                         or _parse_vbri(data, off, h, info)):
        info.first_audio_offset = off + h.frame_size()
        nxt = find_first_frame(data, info.first_audio_offset)
        if nxt is not None:
            info.first_audio_offset = nxt[0]
            info.nominal_bitrate = nxt[1].bitrate
    return info


# ---------------------------------------------------------------------------
# Frame index + seeking
# ---------------------------------------------------------------------------

@dataclass
class FrameIndex:
    """Exact per-frame byte offsets (header walk from the first audio
    frame; the VBR tag frame, if any, is excluded)."""
    info: StreamInfo
    offsets: list[int] = field(default_factory=list)
    # main-data capacity per frame (frame bytes minus header/CRC/side
    # info) — the reservoir-reach input for preroll computation
    capacities: list[int] = field(default_factory=list)

    @property
    def n_frames(self) -> int:
        return len(self.offsets)

    @property
    def samples_per_frame(self) -> int:
        return self.info.samples_per_frame

    def frame_for_sample(self, sample: int) -> int:
        return min(max(sample, 0) // self.samples_per_frame,
                   max(self.n_frames - 1, 0))

    def preroll_start(self, frame: int, min_frames: int = 2,
                      max_frames: int = 16) -> int:
        """First frame to decode so that ``frame`` comes out bit-exact:
        walk back until the skipped frames' main-data capacity covers
        the bit reservoir's maximum reach (511 bytes, 9-bit
        main_data_begin) AND at least ``min_frames`` are prerolled (one
        for the IMDCT-overlap + synthesis-ring warm-up, one so the
        warm-up frame itself has its reservoir)."""
        g = frame
        need = 511
        while g > 0 and (frame - g < min_frames or need > 0) \
                and frame - g < max_frames:
            g -= 1
            need -= self.capacities[g]
        return g

    def toc_byte_for_time(self, t: float, stream_bytes: int) -> int | None:
        """Approximate byte offset from the Xing TOC (what a player uses
        when it has no index; the exact path is the frame walk)."""
        info = self.info
        if info.toc is None or info.vbr_header == "vbri" \
                or info.duration_seconds in (None, 0):
            return None
        frac = min(max(t / info.duration_seconds, 0.0), 1.0) * 100.0
        i = min(int(frac), 99)
        a = info.toc[i]
        b = info.toc[i + 1] if i + 1 < 100 else 256
        fa = a + (b - a) * (frac - i)
        total = info.byte_count or stream_bytes
        return info.first_frame_offset + int(fa / 256.0 * total)


def build_frame_index(data: bytes, info: StreamInfo | None = None) -> FrameIndex:
    """Walk every frame header from the first audio frame."""
    if info is None:
        info = parse_stream_info(data)
        if info is None:
            raise ValueError("no MPEG frame sync found")
    idx = FrameIndex(info=info)
    off = info.first_audio_offset
    # trailing container tags are not audio: keep a false sync inside a
    # tag payload (APE values are arbitrary bytes) out of the index
    end = len(data) - info.trailing_tag_bytes
    while off + 4 <= end:
        h = parse_header(data, off)
        if h is None or h.layer != info.layer or h.family != info.family \
                or h.sample_rate != info.sample_rate:
            # lost sync (or trailing tag): rescan for the next real frame
            nxt = find_first_frame(data, off)
            if nxt is None or nxt[0] <= off:
                break
            off = nxt[0]
            continue
        size = h.frame_size()
        if size <= 4 or off + size > end:
            break                  # truncated tail frame: stop the index
        idx.offsets.append(off)
        idx.capacities.append(size - 4
                              - (2 if h.protection_bit == 0 else 0)
                              - h.side_info_size)
        off += size
    return idx


def _primer_frames(h: MPEGHeader, tail: bytes = b"") -> tuple[bytes, int]:
    """Silent Layer III frames that prime the bit reservoir for a
    mid-stream join.

    A decoder fed a slice whose first frame has ``main_data_begin > 0``
    starves: the reference buffers the frame and reports NEED_MORE
    forever (Get_Main_Data, /root/reference/pdmp3.c:1101-1110 — real
    streams never hit this because encoders emit frame 0 with
    main_data_begin == 0).  Prepending high-bitrate frames with zeroed
    side info (every part2_3_length == 0 → they decode as silence)
    fills main_data_top past the reservoir's maximum reach so every
    following frame decodes.

    ``tail`` places real stream bytes at the END of the last primer's
    main-data region — exactly where the next frame's
    ``main_data_begin`` window looks — so a join at frame ``g`` can
    hand the decoder the true reservoir contents (the trailing
    main-data bytes of the frames before ``g``) and every frame from
    ``g`` on decodes its real bits, not zero-padded garbage.

    Returns (frames, count) — each primer emits one frame of PCM that
    the caller must drop.
    """
    ver = (3, 2, 0)[h.family]
    # largest bitrate whose frame stays <= 1152 bytes: frames at/above
    # 1440 bytes (e.g. 320 kbps @ 32 kHz) are the reference's
    # feed-cadence-dependent read-gate regime (DESIGN.md §6) — a primer
    # must never poke that
    if h.family == 0:
        need = 511                       # 9-bit main_data_begin
        sizes = {i: 144 * int(T.BITRATES[2][i]) // h.sample_rate
                 for i in range(14, 0, -1)}
    else:
        need = 255                       # LSF: 8-bit main_data_begin
        sizes = {i: 72 * int(T.BITRATES_LSF[i]) // h.sample_rate
                 for i in range(14, 0, -1)}
    bi, size = next((i, s) for i, s in sizes.items() if s <= 1152)
    hdr = ((0x7FF << 21) | (ver << 19) | (1 << 17) | (1 << 16)
           | (bi << 12) | (h.sampling_frequency << 10) | (h.mode << 6))
    capacity = size - 4 - h.side_info_size
    tail = tail[-capacity:]
    frame = hdr.to_bytes(4, "big") + b"\x00" * (size - 4)
    count = -(-need // capacity)
    if not tail:
        return frame * count, count
    last = (hdr.to_bytes(4, "big") + b"\x00" * h.side_info_size
            + b"\x00" * (capacity - len(tail)) + tail)
    return frame * (count - 1) + last, count


def _reservoir_tail_bytes(data: bytes, index: FrameIndex, g: int) -> bytes:
    """The trailing main-data bytes preceding frame ``g`` — the exact
    contents the bit reservoir holds when a full decode reaches ``g``
    (up to the 511/255-byte ``main_data_begin`` reach).  Concatenates
    each prior frame's payload after header/CRC/side info, newest
    last."""
    need = 511 if index.info.family == 0 else 255
    chunks = []
    total = 0
    i = g - 1
    while i >= 0 and total < need:
        off = index.offsets[i]
        h = parse_header(data, off)
        if h is None:
            break
        start = off + 4 + (2 if h.protection_bit == 0 else 0) \
            + h.side_info_size
        end = off + h.frame_size()
        chunk = bytes(data[start:end])
        chunks.append(chunk)
        total += len(chunk)
        i -= 1
    chunks.reverse()
    b = b"".join(chunks)
    return b[-need:]


class _Bits:
    """MSB-first bit packer for the injection-frame writer."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, v: int, nb: int) -> None:
        self.acc = (self.acc << nb) | (int(v) & ((1 << nb) - 1))
        self.n += nb
        while self.n >= 8:
            self.n -= 8
            self.buf.append((self.acc >> self.n) & 0xFF)

    def pad_to(self, nbytes: int) -> bytes:
        if self.n:
            self.buf.append((self.acc << (8 - self.n)) & 0xFF)
            self.n = 0
        self.buf.extend(b"\x00" * (nbytes - len(self.buf)))
        return bytes(self.buf)


def _scalefac_state_at(data: bytes, index: FrameIndex,
                       upto: int) -> tuple | None:
    """The decoder's persistent scalefactor arrays after parsing frames
    ``0..upto-1``.

    The reference keeps ``g_main_data.scalefac_{l,s}`` for the life of
    the handle (pdmp3.c:96-101); granules with ``part2_3_length == 0``
    leave them stale, and the sfb21 / short-band-12 requantizer
    overreads alias them across granule-channels (pdmp3.c:1896-1902) —
    so the values that requantize a mid-stream frame can originate
    arbitrarily far back (e.g. the last short-block frame).  Seeking
    bit-exactly therefore needs the *state*, not just a byte preroll;
    this walks it with the pure-Python frontend (side info + scalefactor
    + Huffman cursor only — no DSP)."""
    from . import tables as TT
    from .frontend import Frontend
    fe = Frontend()
    if upto <= 0 or index.n_frames == 0:
        # state before any frame = the fresh handle's zero arrays —
        # still worth injecting: a serving slot re-used for a new
        # stream keeps its PREVIOUS stream's arrays across open_feed
        # (reference parity, pdmp3.c:2369-2384)
        return fe.scalefac_l.copy(), fe.scalefac_s.copy()
    end = index.offsets[upto - 1] + (
        index.offsets[upto] - index.offsets[upto - 1]
        if upto < index.n_frames else len(data) - index.offsets[upto - 1])
    pos = index.info.first_audio_offset
    done = 0
    while done < upto:
        # never feed the full free count: an exact fill parks
        # iend == istart, which the ring convention reads as EMPTY —
        # silent loss of the whole buffer (reference parity,
        # Get_Inbuf_Free pdmp3.c:1066-1068; same defect family as the
        # ghost-full livelock, DESIGN.md §6)
        if fe.inbuf_free() > 1 and pos < end:
            n = min(fe.inbuf_free() - 1, end - pos)
            fe.feed(bytes(data[pos:pos + n]))
            pos += n
        mark = (fe.processed, fe.istart)
        res, _ = fe.read_frame()
        if res == TT.OK:
            done += 1
            continue
        fe.processed, fe.istart = mark
        if pos >= end:
            break
    return fe.scalefac_l.copy(), fe.scalefac_s.copy()


def _state_inject_frames(h: MPEGHeader, sf_l, sf_s) -> bytes:
    """Two silent MPEG-1 Layer III frames that *transmit* the given
    scalefactor arrays, reconstructing the decoder's persistent
    scalefactor state in ANY conforming decoder (including the
    reference binary) at a mid-stream join.

    Frame 1 is all-short granules carrying ``sf_s`` (12 sfb × 3
    windows, scalefac_compress 15 → slen 4/3 — the widest fields, so
    every historically-readable value is representable); frame 2 is
    all-long carrying ``sf_l`` (21 sfb).  Each granule's
    part2_3_length covers exactly the scalefactor bits: big_values is
    0 and the bit cursor lands on part2_3 end, so the Huffman stage
    reads nothing, count1 comes out 0, and the granule decodes as
    silence — only the array writes remain.  MPEG-1 only (the LSF path
    re-reads its arrays fresh every frame, frontend.py _read_main)."""
    nch = h.nch
    ver = 3
    sizes = {i: 144 * int(T.BITRATES[2][i]) // h.sample_rate
             for i in range(14, 0, -1)}
    bi, size = next((i, s) for i, s in sizes.items() if s <= 1152)
    hdr = ((0x7FF << 21) | (ver << 19) | (1 << 17) | (1 << 16)
           | (bi << 12) | (h.sampling_frequency << 10) | (h.mode << 6))
    hdr_bytes = hdr.to_bytes(4, "big")
    main_size = size - 4 - (17 if nch == 1 else 32)

    def frame(short: bool) -> bytes:
        p23 = 126 if short else 74      # 3*(6*4+6*3) / (11*4+10*3)
        side = _Bits()
        side.put(0, 9)                  # main_data_begin = 0
        side.put(0, 5 if nch == 1 else 3)
        for _ in range(nch):
            side.put(0, 4)              # scfsi: transmit everything
        for _gr in range(2):
            for _ch in range(nch):
                side.put(p23, 12)
                side.put(0, 9)          # big_values
                side.put(0, 8)          # global_gain
                side.put(15, 4)         # scalefac_compress → slen (4,3)
                if short:
                    side.put(1, 1)      # window_switching
                    side.put(2, 2)      # block_type = short
                    side.put(0, 1)      # not mixed
                    side.put(0, 10)     # table_select ×2
                    side.put(0, 9)      # subblock_gain ×3
                else:
                    side.put(0, 1)
                    side.put(0, 15)     # table_select ×3
                    side.put(0, 4)      # region0_count
                    side.put(0, 3)      # region1_count
                side.put(0, 3)          # preflag, scalefac_scale, c1ts
        main = _Bits()
        for gr in range(2):
            for ch in range(nch):
                if short:
                    for sfb in range(12):
                        for w in range(3):
                            main.put(int(sf_s[gr][ch][sfb][w]),
                                     4 if sfb < 6 else 3)
                else:
                    for sfb in range(21):
                        main.put(int(sf_l[gr][ch][sfb]),
                                 4 if sfb < 11 else 3)
        return (hdr_bytes + side.pad_to(17 if nch == 1 else 32)
                + main.pad_to(main_size))

    return frame(short=True) + frame(short=False)


def _default_decode(data: bytes, lsf: bool = False) -> bytes:
    from .host import PROFILE_LSF, native_decode_file
    return native_decode_file(data, profile=PROFILE_LSF if lsf else 0)


@dataclass
class SeekPlan:
    """Everything needed to decode a ``[start_s, start_s+duration_s)``
    window through ANY decode surface (one-shot file decode or a
    serving-pool slot): feed ``payload``, then keep the emitted PCM
    after dropping the first ``drop_samples`` per-channel samples,
    up to ``take_samples``."""
    info: StreamInfo
    payload: bytes          # primer frames + preroll slice of the stream
    drop_samples: int       # warm-up PCM to discard (front-anchored)
    take_samples: int       # window length actually available


def plan_seek(data: bytes, start_s: float,
              duration_s: float | None = None, *,
              index: FrameIndex | None = None) -> SeekPlan | None:
    """Build the byte slice + accounting for a mid-stream window.

    Decoding starts ``preroll_start`` frames early so the bit reservoir
    and the decoder's carried state (IMDCT overlap, synthesis ring)
    converge; the slice is extended past the window because the decoder
    holds tail frames back at its 1152-byte read gate (reference
    parity, pdmp3.c:2445), and silent primer frames are prepended so a
    join whose first frame has main_data_begin > 0 does not starve the
    reservoir forever (pdmp3.c:1101-1110).  Returns None for an empty
    window.
    """
    if index is None:
        index = build_frame_index(data)
    info = index.info
    spf, rate = info.samples_per_frame, info.sample_rate
    start_sample = int(round(start_s * rate))
    end_sample = index.n_frames * spf if duration_s is None else \
        min(start_sample + int(round(duration_s * rate)),
            index.n_frames * spf)
    if start_sample >= index.n_frames * spf or end_sample <= start_sample:
        return None
    f0 = index.frame_for_sample(start_sample)
    f1 = index.frame_for_sample(max(end_sample - 1, 0))
    g = index.preroll_start(f0)
    lo = index.offsets[g]
    # extra tail bytes so f1 clears the 1152-byte read-gate holdback
    # (byte-based: low-bitrate frames are far smaller than the gate);
    # at the stream tail the full decode holds those frames back too,
    # so a short window there matches the full decode's truncation
    end_f1 = index.offsets[f1 + 1] if f1 + 1 < index.n_frames else len(data)
    k = f1 + 1
    while k < index.n_frames and index.offsets[k] - end_f1 < 2048:
        k += 1
    hi = index.offsets[k] if k < index.n_frames else len(data)
    lead, primers = (b"", 0)
    if info.layer == 3:
        h0 = parse_header(data, lo)
        if h0 is not None:
            # persistent-scalefactor state injection (MPEG-1 only; the
            # LSF frontend re-reads its arrays fresh every frame): the
            # requantizer's sfb21/short-band-12 policy slots and silent
            # granules read values that can originate arbitrarily far
            # before the preroll window — replay them via two silent
            # frames that transmit the historical arrays
            if info.family == 0:
                # unconditional (zeros when g == 0): a serving slot
                # re-used for a new stream keeps the previous stream's
                # arrays across open_feed, so a join must always set
                # the state explicitly
                st = _scalefac_state_at(data, index, g)
                if st is not None:
                    lead = _state_inject_frames(h0, *st)
                    primers = 2
            # reservoir priming with the REAL trailing main-data bytes
            # before frame g (not zeros): every frame from g on then
            # reads its true bits, so warm-up frames can't write
            # garbage back into the scalefactor state
            tail = _reservoir_tail_bytes(data, index, g) if g > 0 else b""
            pf, pc = _primer_frames(h0, tail=tail)
            lead += pf
            primers += pc
    return SeekPlan(
        info=info,
        payload=lead + bytes(data[lo:hi]),
        drop_samples=primers * spf + (start_sample - g * spf),
        take_samples=end_sample - start_sample)


def decode_file_seek(data: bytes, start_s: float,
                     duration_s: float | None = None, *,
                     decode=None, index: FrameIndex | None = None,
                     ) -> tuple[bytes, StreamInfo]:
    """Decode only the ``[start_s, start_s + duration_s)`` window.

    Bit-exact vs the same window of a full-file decode (see
    :func:`plan_seek` for the mechanism).  Accounting is front-anchored:
    the decoder emits exactly one output frame per parsed frame, even
    reservoir-starved warm-up frames — they come out as noise and are
    dropped here.  ``decode`` is a ``bytes -> S16LE bytes`` callable
    (default: the native decoder).
    """
    if index is None:
        index = build_frame_index(data)
    info = index.info
    plan = plan_seek(data, start_s, duration_s, index=index)
    if plan is None:
        return b"", info
    if decode is None:
        dec = lambda b: _default_decode(b, lsf=info.family != 0)  # noqa: E731
    else:
        dec = decode
    pcm = dec(plan.payload)
    frame_bytes = 2 * info.channels
    emitted = len(pcm) // frame_bytes
    drop = plan.drop_samples
    take = min(plan.take_samples, max(emitted - drop, 0))
    return pcm[drop * frame_bytes:(drop + take) * frame_bytes], info


def gapless_bounds(info: StreamInfo) -> tuple[int, int | None]:
    """(front_skip_samples, keep_samples) for a gapless decode of the
    full stream: the encoder delay plus the 529-sample decoder latency
    up front, the encoder padding off the tail."""
    if info.lame is None:
        return 0, info.total_samples
    skip = info.lame.encoder_delay + DECODER_DELAY
    return skip, info.total_samples


def decode_file_gapless(data: bytes, *, decode=None,
                        index: FrameIndex | None = None,
                        ) -> tuple[bytes, StreamInfo]:
    """Full-file decode with LAME gapless trim applied.

    The tag frame is excluded from the decode (it would add 1152
    samples of silence); the LAME delay/padding and the 529-sample
    decoder latency are trimmed so the output is exactly the encoder's
    input length.  Streams without a LAME tag decode untrimmed.

    When the keep-length is known, silent primer frames are appended so
    the stream's last frames clear the decoder's 1152-byte read gate
    (reference parity, pdmp3.c:2445, which otherwise holds the tail
    back forever at EOF); their silence lands past ``keep`` and is
    trimmed.  Untagged streams stay identical to a plain full decode,
    tail holdback included.
    """
    if index is None:
        index = build_frame_index(data)
    info = index.info
    if decode is None:
        dec = lambda b: _default_decode(b, lsf=info.family != 0)  # noqa: E731
    else:
        dec = decode
    skip_, keep_ = gapless_bounds(info)
    tail = b""
    if keep_ is not None and info.layer == 3:
        h0 = parse_header(data, info.first_audio_offset)
        if h0 is not None:
            tail = _primer_frames(h0)[0]
            while len(tail) < 2 * 1152:   # clear the gate even when the
                tail += tail              # real tail frames are tiny

    pcm = dec(bytes(data[info.first_audio_offset:]) + tail)
    frame_bytes = 2 * info.channels
    if skip_:
        pcm = pcm[skip_ * frame_bytes:]
    if keep_ is not None:
        pcm = pcm[:keep_ * frame_bytes]
    return pcm, info


# ---------------------------------------------------------------------------
# Container tags: ID3v1, ID3v2 text frames, APEv2, Lyrics3
# ---------------------------------------------------------------------------
# The reference decoder has no tag support at all: leading tags hit the
# sync re-search (/root/reference/pdmp3.c:1322-1340) and trailing tags
# sit in the ring buffer as junk at EOF.  The decode surfaces here keep
# exactly that behavior (a tag byte region that happens to contain a
# chaining false sync decodes the same way the reference would decode
# it); tags are parsed only on this host-side control plane, like the
# rest of this module.  The field mapping follows what libmpg123
# exposes through mpg123_id3() so a reference-API user migrating for
# metadata finds the same surface.

#: ID3v1 genre names 0..79 (ID3v1 spec appendix A; indices >= 80 are
#: Winamp extensions and render as "(nnn)").
ID3V1_GENRES = (
    "Blues", "Classic Rock", "Country", "Dance", "Disco", "Funk",
    "Grunge", "Hip-Hop", "Jazz", "Metal", "New Age", "Oldies", "Other",
    "Pop", "R&B", "Rap", "Reggae", "Rock", "Techno", "Industrial",
    "Alternative", "Ska", "Death Metal", "Pranks", "Soundtrack",
    "Euro-Techno", "Ambient", "Trip-Hop", "Vocal", "Jazz+Funk",
    "Fusion", "Trance", "Classical", "Instrumental", "Acid", "House",
    "Game", "Sound Clip", "Gospel", "Noise", "AlternRock", "Bass",
    "Soul", "Punk", "Space", "Meditative", "Instrumental Pop",
    "Instrumental Rock", "Ethnic", "Gothic", "Darkwave",
    "Techno-Industrial", "Electronic", "Pop-Folk", "Eurodance",
    "Dream", "Southern Rock", "Comedy", "Cult", "Gangsta", "Top 40",
    "Christian Rap", "Pop/Funk", "Jungle", "Native American",
    "Cabaret", "New Wave", "Psychadelic", "Rave", "Showtunes",
    "Trailer", "Lo-Fi", "Tribal", "Acid Punk", "Acid Jazz", "Polka",
    "Retro", "Musical", "Rock & Roll", "Hard Rock",
)


def genre_name(idx: int) -> str:
    return ID3V1_GENRES[idx] if 0 <= idx < len(ID3V1_GENRES) \
        else f"({idx})"


@dataclass
class TagInfo:
    """Merged song metadata from every tag container on the stream.

    Precedence when containers disagree (most expressive wins):
    ID3v2 > APEv2 > ID3v1; ``sources`` records which were present in
    the order they were merged (lowest precedence first).
    """
    title: str = ""
    artist: str = ""
    album: str = ""
    year: str = ""
    comment: str = ""
    track: int | None = None
    genre: str = ""
    sources: tuple[str, ...] = ()
    #: raw ID3v2 frames: id -> decoded text (text/COMM frames only)
    id3v2: dict = field(default_factory=dict)
    #: raw APEv2 items: key -> UTF-8 text value
    ape: dict = field(default_factory=dict)

    def _merge_fields(self, **kw) -> None:
        for k, v in kw.items():
            if v not in ("", None):
                setattr(self, k, v)


def _latin1z(b: bytes) -> str:
    return b.split(b"\x00", 1)[0].decode("latin-1").strip()


def parse_id3v1(data: bytes) -> TagInfo | None:
    """The 128-byte "TAG" block at end of file (ID3v1 / v1.1)."""
    if len(data) < 128 or data[-128:-125] != b"TAG":
        return None
    t = data[-128:]
    tag = TagInfo(sources=("id3v1",))
    tag.title = _latin1z(t[3:33])
    tag.artist = _latin1z(t[33:63])
    tag.album = _latin1z(t[63:93])
    tag.year = _latin1z(t[93:97])
    if t[125] == 0 and t[126] != 0:          # ID3v1.1: track in byte 126
        tag.comment = _latin1z(t[97:125])
        tag.track = t[126]
    else:
        tag.comment = _latin1z(t[97:127])
    if t[127] != 255:
        tag.genre = genre_name(t[127])
    return tag


def _parse_apev2(data: bytes, end: int) -> tuple[int, TagInfo] | None:
    """APEv2 tag ending at ``end``; returns (start_offset, tag).

    Footer = 8B "APETAGEX", u32le version, u32le size (items + footer,
    excl. header), u32le item count, u32le flags, 8B reserved.  Bit 31
    of the footer flags says a matching 32-byte header precedes the
    items.  Items: u32le value size, u32le flags, ASCII key, NUL,
    value; only UTF-8 text items (flag bits 2:1 == 0) are collected.
    """
    f = end - 32
    if f < 0 or data[f:f + 8] != b"APETAGEX":
        return None
    version, size, count, flags = struct.unpack_from("<IIII", data, f + 8)
    if version not in (1000, 2000) or size < 32 or size > end:
        return None
    if flags & 0x20000000:
        # flag bit 29 set: the 32 bytes at ``end`` claim to be a tag
        # HEADER, not a footer — a stray header block (e.g. a tag
        # truncated right after its header) must not strip ``size``
        # bytes of audio from the accounting
        return None
    start = end - size
    if flags & 0x80000000:                    # header present
        if start < 32 or data[start - 32:start - 24] != b"APETAGEX":
            return None
        start -= 32
    if start < 0:
        return None
    tag = TagInfo(sources=("ape",))
    pos = end - size                          # first item
    for _ in range(min(count, 1024)):
        if pos + 8 > f:
            break
        vsize, iflags = struct.unpack_from("<II", data, pos)
        pos += 8
        knul = data.find(b"\x00", pos, f)
        if knul < 0 or knul + 1 + vsize > f:
            break
        key = data[pos:knul].decode("latin-1")
        if (iflags >> 1) & 3 == 0:            # UTF-8 text item
            try:
                tag.ape[key] = data[knul + 1:knul + 1 + vsize].decode(
                    "utf-8").strip("\x00").strip()
            except UnicodeDecodeError:
                pass
        pos = knul + 1 + vsize
    low = {k.lower(): v for k, v in tag.ape.items()}
    trk = low.get("track", "").split("/", 1)[0]
    tag._merge_fields(
        title=low.get("title", ""), artist=low.get("artist", ""),
        album=low.get("album", ""), year=low.get("year", ""),
        comment=low.get("comment", ""), genre=low.get("genre", ""),
        track=int(trk) if trk.isdigit() else None)
    return start, tag


def _parse_lyrics3(data: bytes, end: int) -> int | None:
    """Lyrics3 v1/v2 block ending at ``end``; returns its start offset."""
    sig = data[end - 9:end]
    if sig == b"LYRICS200":                   # v2: 6-digit size precedes
        if end < 15:
            return None
        szs = data[end - 15:end - 9]
        if not szs.isdigit():
            return None
        start = end - 15 - int(szs)
        if start < 0 or data[start:start + 11] != b"LYRICSBEGIN":
            return None
        return start
    if sig == b"LYRICSEND":                   # v1: scan back (max 5100)
        lo = max(end - 9 - 5100, 0)
        idx = data.rfind(b"LYRICSBEGIN", lo, end - 9)
        return idx if idx >= 0 else None
    return None


def trailing_tags(data: bytes) -> tuple[int, TagInfo | None]:
    """Strip every trailing tag stack (APEv2 / Lyrics3 / ID3v1, in any
    of the layouts taggers emit) off the end of ``data``.

    Returns (tag_bytes, merged TagInfo or None).  ID3v1 merges first
    (lowest precedence), then APEv2 on top.
    """
    end = len(data)
    id3v1 = ape = v2app = None
    while True:
        if end >= 128 and data[end - 128:end - 125] == b"TAG":
            got = parse_id3v1(data[:end])
            if got is not None:
                id3v1, end = got, end - 128
                continue
        hit = _parse_apev2(data, end)
        if hit is not None:
            start, ape_tag = hit
            ape, end = ape_tag, start
            continue
        lyr = _parse_lyrics3(data, end)
        if lyr is not None:
            end = lyr
            continue
        # ID3v2.4 appended tag: footer "3DI" mirrors the header, so the
        # tag spans [end - 20 - size, end)
        if end >= 20 and data[end - 10:end - 7] == b"3DI" \
                and data[end - 7] == 4:
            size = _syncsafe(data[end - 4:end])
            start = end - 20 - size
            if start >= 0 and data[start:start + 3] == b"ID3":
                got = parse_id3v2_frames(data, start)
                if got is not None:
                    v2app, end = got, start
                    continue
        break
    tags = None
    for t in (id3v1, ape, v2app):
        if t is None:
            continue
        if tags is None:
            tags = t
        else:
            tags._merge_fields(title=t.title, artist=t.artist,
                               album=t.album, year=t.year,
                               comment=t.comment, track=t.track,
                               genre=t.genre)
            tags.ape.update(t.ape)
            tags.id3v2.update(t.id3v2)
            tags.sources = tags.sources + t.sources
    return len(data) - end, tags


_ID3V2_TEXT_MAP = {                          # v2.3/v2.4 ids -> TagInfo field
    "TIT2": "title", "TPE1": "artist", "TALB": "album",
    "TYER": "year", "TDRC": "year", "TRCK": "track", "TCON": "genre",
}
_ID3V22_IDS = {                              # v2.2 3-char -> v2.3 4-char
    "TT2": "TIT2", "TP1": "TPE1", "TAL": "TALB", "TYE": "TYER",
    "TRK": "TRCK", "TCO": "TCON", "COM": "COMM", "TXX": "TXXX",
}
_ID3V2_ENCODINGS = ("latin-1", "utf-16", "utf-16-be", "utf-8")


def _id3v2_text(payload: bytes) -> str:
    """Decode an encoding-prefixed ID3v2 text payload."""
    if not payload:
        return ""
    enc = _ID3V2_ENCODINGS[payload[0]] if payload[0] < 4 else "latin-1"
    try:
        txt = payload[1:].decode(enc)
    except UnicodeDecodeError:
        return ""
    return txt.split("\x00", 1)[0].strip()


def _deunsync(b: bytes) -> bytes:
    return b.replace(b"\xff\x00", b"\xff")


def _syncsafe(b: bytes) -> int:
    return (b[0] << 21) | (b[1] << 14) | (b[2] << 7) | b[3]


def parse_id3v2_frames(data: bytes, off: int = 0) -> TagInfo | None:
    """Parse the text frames of an ID3v2.2/2.3/2.4 tag at ``off``.

    Only text-bearing frames are collected (T*** text-information
    frames and COMM comments) — binary frames (APIC art, GEOB, ...) and
    TXXX user text are skipped structurally.  Unknown flags/compression
    on a frame skip that frame, never the tag.
    """
    if data[off:off + 3] != b"ID3" or off + 10 > len(data):
        return None
    major = data[off + 3]
    if major not in (2, 3, 4) or data[off + 4] == 0xFF:
        return None
    flags = data[off + 5]
    size = _syncsafe(data[off + 6:off + 10])
    body = bytes(data[off + 10:off + 10 + size])
    if off + 10 + size > len(data):
        return None
    if flags & 0x80 and major < 4:            # whole-tag unsync (2.2/2.3)
        body = _deunsync(body)
    if major == 2 and flags & 0x40:
        # ID3v2.2 bit 6 means "compression" with no defined scheme —
        # the spec says a parser encountering it must ignore the whole
        # tag (it is NOT a v2.3-style extended-header bit)
        return None
    if flags & 0x40:                          # extended header
        if major == 4:
            ehs = _syncsafe(body[:4]) if len(body) >= 4 else size
        else:
            ehs = 4 + struct.unpack_from(">I", body, 0)[0] \
                if len(body) >= 4 else size
        body = body[ehs:]
    tag = TagInfo(sources=(f"id3v2.{major}",))
    idlen, szlen, fllen = (3, 3, 0) if major == 2 else (4, 4, 2)
    pos = 0
    while pos + idlen + szlen + fllen <= len(body):
        fid = body[pos:pos + idlen]
        if not fid.strip(b"\x00"):            # padding reached
            break
        try:
            name = fid.decode("latin-1")
        except UnicodeDecodeError:
            break
        if major == 2:
            fsz = (body[pos + 3] << 16) | (body[pos + 4] << 8) | body[pos + 5]
            fflags = 0
            name = _ID3V22_IDS.get(name, name)
        else:
            raw = body[pos + 4:pos + 8]
            fsz = _syncsafe(raw) if major == 4 else \
                struct.unpack_from(">I", raw)[0]
            fflags = struct.unpack_from(">H", body, pos + 8)[0]
        pos += idlen + szlen + fllen
        payload = body[pos:pos + fsz]
        pos += fsz
        if len(payload) < fsz:
            break
        if major == 4 and fflags & 0x02:      # per-frame unsync
            payload = _deunsync(payload)
        if major == 4 and fflags & 0x01:      # data-length indicator
            payload = payload[4:]
        # grouping identity: a 1-byte group ID precedes the payload
        # (v2.4 format-flag 0x40, v2.3 second-flag-byte 0x20)
        if fflags & (0x0040 if major == 4 else 0x0020):
            payload = payload[1:]
        # compression/encryption format flags: v2.4 0x0008|0x0004,
        # v2.3 0x0080|0x0040 (second flag byte)
        if fflags & (0x000C if major == 4 else 0x00C0):
            continue                          # compressed/encrypted: skip
        if name == "COMM" and len(payload) >= 4:
            # enc byte + 3-char language + description NUL(s) + text;
            # skip the description honoring the encoding's NUL width
            enc, rest = payload[0], payload[4:]
            if enc in (1, 2):                 # UTF-16: 2-byte NUL, even
                cut = rest.find(b"\x00\x00")  # offsets only
                while cut > 0 and cut % 2:
                    cut = rest.find(b"\x00\x00", cut + 1)
                text = rest[cut + 2:] if cut >= 0 else b""
            else:
                cut = rest.find(b"\x00")
                text = rest[cut + 1:] if cut >= 0 else b""
            txt = _id3v2_text(bytes([enc]) + text) if cut >= 0 else ""
            if txt:
                tag.id3v2.setdefault("COMM", txt)
                tag.comment = tag.comment or txt
        elif name.startswith("T") and name != "TXXX":
            txt = _id3v2_text(payload)
            if txt:
                tag.id3v2[name] = txt
                fieldname = _ID3V2_TEXT_MAP.get(name)
                if fieldname == "track":
                    head = txt.split("/", 1)[0]
                    if head.isdigit():
                        tag.track = int(head)
                elif fieldname == "genre":
                    g = txt
                    if g.startswith("(") and g.rstrip(")").lstrip(
                            "(").isdigit():
                        g = genre_name(int(g.strip("()")))
                    elif g.startswith("(") and ")" in g \
                            and g[1:g.index(")")].isdigit():
                        # v2.3 refinement form "(nn)Custom": the text
                        # refines the numeric genre (mpg123 mapping)
                        num, _, refine = g[1:].partition(")")
                        g = refine or genre_name(int(num))
                    elif g.isdigit():         # v2.4 numeric-string form
                        g = genre_name(int(g))
                    tag.genre = g
                elif fieldname:
                    setattr(tag, fieldname, txt)
    return tag


def parse_tags(data: bytes) -> tuple[int, TagInfo | None]:
    """All tags on a stream: leading ID3v2 + the trailing stack.

    Returns (trailing_tag_bytes, merged TagInfo or None); precedence
    ID3v2 > APEv2 > ID3v1 per field.
    """
    trailing, tags = trailing_tags(data)
    v2 = parse_id3v2_frames(data) if data[:3] == b"ID3" else None
    if v2 is not None:
        if tags is None:
            tags = v2
        else:
            tags._merge_fields(title=v2.title, artist=v2.artist,
                               album=v2.album, year=v2.year,
                               comment=v2.comment, track=v2.track,
                               genre=v2.genre)
            tags.id3v2.update(v2.id3v2)
            tags.sources = tags.sources + v2.sources
    return trailing, tags
