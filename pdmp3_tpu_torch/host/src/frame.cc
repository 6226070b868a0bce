// Streaming MPEG-1 Layer III frame parser (native).
//
// State machine and quirk set mirror the reference decoder exactly (cited
// per method); the Huffman stage uses two-level LUT decoding (multi-bit
// table steps) instead of the reference's bit-serial tree walk — identical
// consumption because the code trees are complete and prefix-free.
#include <cmath>
#include <cstdio>
#include <cstdlib>

#include "internal.h"

namespace pdmp3host {

int InRing::feed(const uint8_t *data, size_t size) {
  // all-or-nothing admission (pdmp3.c:2391-2423)
  if (!data || !size) return PDMP3_ERR;
  if (size > free_space()) return PDMP3_NO_SPACE;
  if (iend < istart) {
    std::memcpy(buf + iend, data, size);
    iend += (unsigned)size;
  } else {
    size_t first = kInbufSize - iend;
    if (first > size) first = size;
    std::memcpy(buf + iend, data, first);
    iend += (unsigned)first;
    size_t rest = size - first;
    if (rest) {
      std::memcpy(buf, data + first, rest);
      iend = (unsigned)rest;
    }
  }
  return PDMP3_OK;
}

void FrameParser::reset() {
  // pdmp3_open_feed (pdmp3.c:2369-2384)
  in.istart = in.iend = 0;
  in.processed = 0;
  new_header = 0;
  res.top = 0;
  free_size = 0;
  id3_remaining = 0;
}

void FrameParser::skip_id3() {
  // Consume any ID3v2 tag at the read cursor (id3.org header: "ID3",
  // version != 0xFF, 4 syncsafe size bytes; footer flag 0x10 adds 10).
  // Incremental across NEED_MORE: id3_remaining persists in the handle.
  // Must run OUTSIDE the frame-level cursor rollback (pdmp3_read /
  // pdmp3_parse_frame call it before their snapshots).
  for (;;) {
    if (id3_remaining) {
      unsigned n = in.filled();
      if (n > id3_remaining) n = id3_remaining;
      in.discard(n);
      id3_remaining -= n;
      if (id3_remaining) return;  // tag continues past buffered data
    }
    if (in.filled() < 10) return;
    uint8_t hdr[10];
    for (unsigned k = 0; k < 10; k++)
      hdr[k] = in.buf[(in.istart + k) % kInbufSize];
    if (hdr[0] != 'I' || hdr[1] != 'D' || hdr[2] != '3' ||
        hdr[3] == 0xFF ||
        ((hdr[6] | hdr[7] | hdr[8] | hdr[9]) & 0x80))
      return;
    unsigned size = ((unsigned)hdr[6] << 21) | ((unsigned)hdr[7] << 14) |
                    ((unsigned)hdr[8] << 7) | hdr[9];
    id3_remaining = 10 + size + ((hdr[5] & 0x10) ? 10 : 0);
  }
}

int FrameParser::read_header() {
  // byte-aligned sync scan + header field validation (pdmp3.c:1252-1320).
  // LSF mode scans for the 11-bit sync (MPEG-2.5 clears sync bit 0,
  // 13818-3 extension framing); default mode keeps the reference's
  // 12-bit scan so resync behavior on hostile streams stays bit-parity.
  uint32_t b1 = in.get_byte(), b2 = in.get_byte(), b3 = in.get_byte(),
           b4 = in.get_byte();
  if (b1 == kEof || b2 == kEof || b3 == kEof || b4 == kEof)
    return PDMP3_ERR;
  uint32_t h = (b1 << 24) | (b2 << 16) | (b3 << 8) | b4;
  uint32_t sync = lsf_enabled() ? 0xFFE00000u : 0xFFF00000u;
  while ((h & sync) != sync) {
    uint32_t nb = in.get_byte();
    if (nb == kEof) return PDMP3_ERR;
    h = ((h << 8) & 0xFFFFFF00u) | nb;
  }
  int ver = (h >> 19) & 3;  // 0 = MPEG-2.5, 1 = reserved, 2 = 2, 3 = 1
  hdr.raw16 = (uint16_t)(h & 0xFFFF);  // CRC-protected header half
  hdr.id = (h >> 19) & 1;
  hdr.layer = (h >> 17) & 3;
  hdr.protection_bit = (h >> 16) & 1;
  hdr.bitrate_index = (h >> 12) & 0xF;
  hdr.sampling_frequency = (h >> 10) & 3;
  hdr.padding_bit = (h >> 9) & 1;
  hdr.private_bit = (h >> 8) & 1;
  hdr.mode = (h >> 6) & 3;
  hdr.mode_extension = (h >> 4) & 3;
  hdr.copyright = (h >> 3) & 1;
  hdr.original = (h >> 2) & 1;
  hdr.emphasis = h & 3;
  hdr.family = ver == 3 ? 0 : (ver == 2 ? 1 : (ver == 0 ? 2 : -1));
  if (!lsf_enabled() && hdr.id != 1) return PDMP3_ERR;
  bool bad_bitrate =
      hdr.bitrate_index == 15 ||
      (hdr.bitrate_index == 0 && !free_enabled());
  if (hdr.family < 0 || bad_bitrate ||
      hdr.sampling_frequency == 3 || hdr.layer == 0)
    return PDMP3_ERR;
  hdr.layer = 4 - hdr.layer;
  hdr.free_size = hdr.bitrate_index == 0 ? (int)free_size : 0;
  if (!new_header) new_header = 1;
  return PDMP3_OK;
}

int FrameParser::measure_free_size() {
  // Deduce the free-format frame size from the sync spacing (ISO
  // 11172-3 §2.4.2.3; the reference rejects free format, pdmp3.c:1299).
  // Called with the cursor just past the first free-format header's 4
  // bytes; scans the buffered input non-consuming.  A candidate must
  // match sync/version/layer/bitrate/sfreq, and is chain-verified
  // against a third header one frame later when enough data is buffered
  // (screens false syncs inside main data).  Mirrors
  // frontend._measure_free_size.
  static const uint32_t kMask = (0x7FFu << 21) | (3u << 19) | (3u << 17) |
                                (0xFu << 12) | (3u << 10);
  int ver = hdr.family == 0 ? 3 : (hdr.family == 1 ? 2 : 0);
  uint32_t want = (0x7FFu << 21) | ((uint32_t)ver << 19) |
                  ((uint32_t)(4 - hdr.layer) << 17) |
                  ((uint32_t)hdr.sampling_frequency << 10);
  unsigned filled = in.filled();
  for (unsigned o = 9; o <= 2000 - 4; o++) {
    uint32_t w = in.peek4(o);
    if (w == kEof) return PDMP3_NEED_MORE;
    if ((w & kMask) != want) continue;
    unsigned size0 = o + 4;
    unsigned base = size0 - (unsigned)hdr.padding_bit;
    unsigned pad1 = (w >> 9) & 1u;
    uint32_t w2 = in.peek4(o + base + pad1);
    if (w2 != kEof && (w2 & kMask) != want) continue;  // false sync
    if (w2 == kEof && filled < o + base + pad1 + 4 &&
        o + base + pad1 + 4 <= kInbufSize - 1)
      return PDMP3_NEED_MORE;  // cannot verify yet, more data can come
    unsigned min_side = (hdr.family ? 9u : 17u) + 4u;
    if (base <= min_side) return PDMP3_ERR;
    free_size = base;
    return PDMP3_OK;
  }
  return PDMP3_ERR;
}

int FrameParser::search_header() {
  // resync one byte at a time with rollback, bounded retry
  // (pdmp3.c:1322-1340)
  size_t pos = in.processed;
  unsigned mark = in.istart;
  int r = PDMP3_NEED_MORE;
  int cnt = 0;
  while (in.filled() > 4) {
    r = read_header();
    if (r == PDMP3_OK &&
        (hdr.layer == 3 || (l12_enabled() && hdr.layer != 0)))
      break;
    if (++mark == kInbufSize) mark = 0;
    in.istart = mark;
    in.processed = pos;
    if (++cnt > 2 * 576) return PDMP3_ERR;
  }
  return r;
}

int FrameParser::read_side_info() {
  // (pdmp3.c:1129-1200); on input underrun keeps the stale bit cursor and
  // parses on, matching Get_Sideinfo's early return (pdmp3.c:1576-1586)
  int nch = hdr.nch();
  long framesize = hdr.frame_size();
  if (framesize > 2000) return PDMP3_ERR;
  int size = hdr.family ? (nch == 1 ? 9 : 17) : (nch == 1 ? 17 : 32);
  bool eof = false;
  for (int i = 0; i < size; i++) {
    uint32_t v = in.get_byte();
    if (v == kEof) {
      eof = true;
      break;
    }
    side.bytes[i] = (uint8_t)v;
  }
  if (!eof) {
    side.byte_pos = 0;
    side.bit_idx = 0;
  }
  if (hdr.family) return read_side_info_lsf(nch);
  // register-resident cursor over the (80-byte, padded) side buffer;
  // per-granule-channel reads (≤59 bits) refill at most twice
  uint64_t rwin = 0;
  unsigned rpos = side.byte_pos * 8 + side.bit_idx, ravail = 0;
  auto take = [&](unsigned n) -> unsigned {
    if (ravail < n) {
      uint64_t w;
      std::memcpy(&w, side.bytes + (rpos >> 3), 8);
      rwin = __builtin_bswap64(w) << (rpos & 7);
      ravail = 64 - (rpos & 7);
    }
    unsigned v = (unsigned)(rwin >> (64 - n));
    rwin <<= n;
    rpos += n;
    ravail -= n;
    return v;
  };
  si.main_data_begin = take(9);
  take(nch == 1 ? 5 : 3);  // private bits, discarded
  for (int ch = 0; ch < nch; ch++)
    for (int b = 0; b < 4; b++) si.scfsi[ch][b] = take(1);
  for (int gr = 0; gr < 2; gr++) {
    for (int ch = 0; ch < nch; ch++) {
      si.part2_3_length[gr][ch] = take(12);
      si.big_values[gr][ch] = take(9);
      si.global_gain[gr][ch] = take(8);
      si.scalefac_compress[gr][ch] = take(4);
      si.win_switch[gr][ch] = take(1);
      if (si.win_switch[gr][ch]) {
        si.block_type[gr][ch] = take(2);
        si.mixed[gr][ch] = take(1);
        for (int r = 0; r < 2; r++)
          si.table_select[gr][ch][r] = take(5);
        for (int w = 0; w < 3; w++)
          si.subblock_gain[gr][ch][w] = take(3);
        // implicit region counts (pdmp3.c:1181-1185)
        si.region0_count[gr][ch] =
            (si.block_type[gr][ch] == 2 && !si.mixed[gr][ch]) ? 8 : 7;
        si.region1_count[gr][ch] = 20 - si.region0_count[gr][ch];
      } else {
        for (int r = 0; r < 3; r++)
          si.table_select[gr][ch][r] = take(5);
        si.region0_count[gr][ch] = take(4);
        si.region1_count[gr][ch] = take(3);
        si.block_type[gr][ch] = 0;
        si.mixed[gr][ch] = 0;
      }
      si.preflag[gr][ch] = take(1);
      si.scalefac_scale[gr][ch] = take(1);
      si.count1table_select[gr][ch] = take(1);
    }
  }
  side.byte_pos = rpos >> 3;
  side.bit_idx = rpos & 7;
  return PDMP3_OK;
}

int FrameParser::read_side_info_lsf(int nch) {
  // LSF side info (13818-3 §2.4.1.7; cf. frontend._read_side_info_lsf):
  // 8-bit main_data_begin, no scfsi, ONE granule, 9-bit
  // scalefac_compress, no preflag bit (derived during scalefactor
  // decode).  Caller has loaded the side bytes and reset the cursor.
  uint64_t rwin = 0;
  unsigned rpos = side.byte_pos * 8 + side.bit_idx, ravail = 0;
  auto take = [&](unsigned n) -> unsigned {
    if (ravail < n) {
      uint64_t w;
      std::memcpy(&w, side.bytes + (rpos >> 3), 8);
      rwin = __builtin_bswap64(w) << (rpos & 7);
      ravail = 64 - (rpos & 7);
    }
    unsigned v = (unsigned)(rwin >> (64 - n));
    rwin <<= n;
    rpos += n;
    ravail -= n;
    return v;
  };
  si.main_data_begin = take(8);
  take(nch == 1 ? 1 : 2);  // private bits, discarded
  for (int ch = 0; ch < nch; ch++)
    for (int b = 0; b < 4; b++) si.scfsi[ch][b] = 0;
  int gr = 0;
  for (int ch = 0; ch < nch; ch++) {
    si.part2_3_length[gr][ch] = take(12);
    si.big_values[gr][ch] = take(9);
    si.global_gain[gr][ch] = take(8);
    si.scalefac_compress[gr][ch] = take(9);
    si.win_switch[gr][ch] = take(1);
    if (si.win_switch[gr][ch]) {
      si.block_type[gr][ch] = take(2);
      si.mixed[gr][ch] = take(1);
      for (int r = 0; r < 2; r++) si.table_select[gr][ch][r] = take(5);
      for (int w = 0; w < 3; w++) si.subblock_gain[gr][ch][w] = take(3);
      // implicit region counts, same rule as MPEG-1 (pdmp3.c:1181-1185)
      si.region0_count[gr][ch] =
          (si.block_type[gr][ch] == 2 && !si.mixed[gr][ch]) ? 8 : 7;
      si.region1_count[gr][ch] = 20 - si.region0_count[gr][ch];
    } else {
      for (int r = 0; r < 3; r++) si.table_select[gr][ch][r] = take(5);
      si.region0_count[gr][ch] = take(4);
      si.region1_count[gr][ch] = take(3);
      si.block_type[gr][ch] = 0;
      si.mixed[gr][ch] = 0;
    }
    si.preflag[gr][ch] = 0;  // derived in read_scalefactors_lsf
    si.scalefac_scale[gr][ch] = take(1);
    si.count1table_select[gr][ch] = take(1);
  }
  side.byte_pos = rpos >> 3;
  side.bit_idx = rpos & 7;
  return PDMP3_OK;
}

void FrameParser::read_scalefactors_lsf(int ch) {
  // LSF scalefactor decode (13818-3 §2.4.3.4; cf.
  // frontend._read_scalefacs_lsf): 4-partition slen derivation from the
  // 9-bit scalefac_compress (intensity-channel variant for ch1 of an
  // intensity frame), raw values into scf_*_state, and the intensity
  // sidecar with the per-partition all-ones value mapped to
  // kLsfIsIllegal.  slen==0 partitions transmit nothing -> position 0.
  bool intensity_ch =
      ch == 1 && hdr.mode == 1 && (hdr.mode_extension & 1);
  int sc = (int)si.scalefac_compress[0][ch];
  int slen[4] = {0, 0, 0, 0};
  int blocknum, preflag = 0, iscale = 0;
  if (!intensity_ch) {
    if (sc < 400) {
      slen[0] = (sc >> 4) / 5;
      slen[1] = (sc >> 4) % 5;
      slen[2] = (sc % 16) >> 2;
      slen[3] = sc % 4;
      blocknum = 0;
    } else if (sc < 500) {
      int s2 = sc - 400;
      slen[0] = (s2 >> 2) / 5;
      slen[1] = (s2 >> 2) % 5;
      slen[2] = s2 % 4;
      blocknum = 1;
    } else {
      int s2 = sc - 500;
      slen[0] = s2 / 3;
      slen[1] = s2 % 3;
      blocknum = 2;
      preflag = 1;
    }
  } else {
    iscale = sc & 1;
    int s2 = sc >> 1;
    if (s2 < 180) {
      slen[0] = s2 / 36;
      slen[1] = (s2 % 36) / 6;
      slen[2] = s2 % 6;
      blocknum = 3;
    } else if (s2 < 244) {
      int s3 = s2 - 180;
      slen[0] = (s3 % 64) >> 4;
      slen[1] = (s3 % 16) >> 2;
      slen[2] = s3 % 4;
      blocknum = 4;
    } else {
      int s3 = s2 - 244;
      slen[0] = s3 / 3;
      slen[1] = s3 % 3;
      blocknum = 5;
    }
  }
  si.preflag[0][ch] = (unsigned)preflag;
  bool short_blk = si.win_switch[0][ch] && si.block_type[0][ch] == 2;
  bool mixed = short_blk && si.mixed[0][ch];
  int bclass = mixed ? 2 : (short_blk ? 1 : 0);
  const int *counts = kNrOfSfb[blocknum][bclass];
  int raw[54];
  int16_t pos[54];
  int nraw = 0;
  uint64_t rwin = 0;
  unsigned rpos = res.pos(), ravail = 0;
  auto take = [&](unsigned n) -> unsigned {
    if (n == 0) return 0;
    if (ravail < n) {
      uint64_t w;
      std::memcpy(&w, res.bytes + (rpos >> 3), 8);
      rwin = __builtin_bswap64(w) << (rpos & 7);
      ravail = 64 - (rpos & 7);
    }
    unsigned v = (unsigned)(rwin >> (64 - n));
    rwin <<= n;
    rpos += n;
    ravail -= n;
    return v;
  };
  for (int p = 0; p < 4; p++) {
    int w = slen[p];
    for (int k = 0; k < counts[p]; k++) {
      int v = w ? (int)take((unsigned)w) : 0;
      raw[nraw] = v;
      pos[nraw] =
          (w && v == (1 << w) - 1) ? (int16_t)kLsfIsIllegal : (int16_t)v;
      nraw++;
    }
  }
  res.set_pos(rpos);
  if (intensity_ch) {
    // frontend parity: the sidecar defaults to 0 for in-layout bands
    // (untransmitted tail slots are masked out by intensity_ok anyway)
    lsf_iscale = iscale;
    std::memset(lsf_is_l, 0, sizeof lsf_is_l);
    std::memset(lsf_is_s, 0, sizeof lsf_is_s);
  }
  int k = 0;
  if (bclass == 0) {
    for (int sfb = 0; sfb < 21; sfb++, k++) {
      scf_l_state[0][ch][sfb] = (uint8_t)raw[k];
      if (intensity_ch) lsf_is_l[sfb] = pos[k];
    }
  } else {
    if (mixed) {
      for (int sfb = 0; sfb < kSwitchSfbL[hdr.family]; sfb++, k++) {
        scf_l_state[0][ch][sfb] = (uint8_t)raw[k];
        if (intensity_ch) lsf_is_l[sfb] = pos[k];
      }
    }
    for (int sfb = mixed ? 3 : 0; sfb < 12; sfb++) {
      for (int w = 0; w < 3; w++, k++) {
        scf_s_state[0][ch][sfb][w] = (uint8_t)raw[k];
        if (intensity_ch) lsf_is_s[sfb][w] = pos[k];
      }
    }
  }
}

int FrameParser::get_main_data(unsigned size, unsigned begin) {
  // bit-reservoir assembly with underflow skip (pdmp3.c:1096-1122);
  // Get_Bytes parity: stop storing at EOF, leaving stale tail bytes
  auto fill = [&](unsigned off, unsigned n) {
    // bulk ring copy; short reads leave the stale tail (Get_Bytes parity)
    in.get_bytes(res.bytes + off, n);
  };
  if (begin > res.top) {
    fill(res.top, size);
    res.set_pos(0);
    res.top += size;
    return PDMP3_NEED_MORE;
  }
  std::memmove(res.bytes, res.bytes + res.top - begin, begin);
  fill(begin, size);
  res.set_pos(0);
  res.top = begin + size;
  return PDMP3_OK;
}

void FrameParser::read_scalefactors(int gr, int ch, pdmp3_granules *g) {
  (void)g;
  // incl. scfsi long-block sharing (pdmp3.c:1376-1435).  Reads go
  // through a register-resident 64-bit window (same scheme as
  // read_huffman): groups of ≤18 reads × ≤4 bits refill at most twice.
  int slen1 = kScalefacSizes[si.scalefac_compress[gr][ch]][0];
  int slen2 = kScalefacSizes[si.scalefac_compress[gr][ch]][1];
  uint64_t rwin = 0;
  unsigned rpos = res.pos(), ravail = 0;
  auto take = [&](unsigned n) -> unsigned {
    if (n == 0) return 0;
    if (ravail < n) {
      uint64_t w;
      std::memcpy(&w, res.bytes + (rpos >> 3), 8);
      rwin = __builtin_bswap64(w) << (rpos & 7);
      ravail = 64 - (rpos & 7);
    }
    unsigned v = (unsigned)(rwin >> (64 - n));
    rwin <<= n;
    rpos += n;
    ravail -= n;
    return v;
  };
  if (si.win_switch[gr][ch] && si.block_type[gr][ch] == 2) {
    if (si.mixed[gr][ch]) {
      for (int b = 0; b < 8; b++)
        scf_l_state[gr][ch][b] = (uint8_t)take(slen1);
      for (int b = 3; b < 12; b++) {
        int nb = b < 6 ? slen1 : slen2;
        for (int w = 0; w < 3; w++)
          scf_s_state[gr][ch][b][w] = (uint8_t)take(nb);
      }
    } else {
      for (int b = 0; b < 12; b++) {
        int nb = b < 6 ? slen1 : slen2;
        for (int w = 0; w < 3; w++)
          scf_s_state[gr][ch][b][w] = (uint8_t)take(nb);
      }
    }
  } else {
    static const int grp[4][3] = {
        {0, 6, 0}, {6, 11, 0}, {11, 16, 1}, {16, 21, 1}};
    for (int gi = 0; gi < 4; gi++) {
      int lo = grp[gi][0], hi = grp[gi][1];
      int sl = grp[gi][2] ? slen2 : slen1;
      if (si.scfsi[ch][gi] == 0 || gr == 0) {
        for (int b = lo; b < hi; b++)
          scf_l_state[gr][ch][b] = (uint8_t)take(sl);
      } else if (si.scfsi[ch][gi] == 1 && gr == 1) {
        for (int b = lo; b < hi; b++)
          scf_l_state[1][ch][b] = scf_l_state[0][ch][b];
      }
    }
  }
  res.set_pos(rpos);
}

// LUT Huffman decode of one (x,y) pair; consumes exactly the code length.
static inline void huff_pair(Reservoir &res, int tnum, int32_t *x,
                             int32_t *y) {
  // (slow/reference path; the hot loops use the fused sign tables below)
  int maxlen = kHuffMaxlen[tnum];
  if (maxlen == 0) {  // empty tables 0/4/14 (pdmp3.c:1599-1602)
    *x = *y = 0;
    return;
  }
  uint32_t peek = res.peek_bits((unsigned)maxlen);
  int take = maxlen - PDMP3_HUFF_PRIMARY_BITS;
  uint32_t p9 = take > 0 ? (peek >> take)
                         : (peek << (PDMP3_HUFF_PRIMARY_BITS - maxlen));
  uint16_t e = kHuffPrimary[tnum][p9];
  unsigned len, payload;
  if (e & 0x8000u) {
    int d = e & 0x7FFF;
    int ext = kHuffEscExt[d];
    uint32_t b2 = (peek >> (take - ext)) & ((1u << ext) - 1u);
    uint16_t e2 = kHuffSecondary[kHuffEscOff[d] + (int)b2];
    len = e2 >> 8;
    payload = e2 & 0xFF;
  } else {
    len = e >> 8;
    payload = e & 0xFF;
  }
  res.advance(len);
  *x = (payload >> 4) & 0xF;
  *y = payload & 0xF;
}

// ---- fused code+sign lookup tables ----
//
// A Huffman (x,y) pair costs codeword + up to 2 sign bits; both sign
// branches are data-random (≈50% mispredict each).  For every codeword
// where code + signs fit in 11 bits — the overwhelming majority, since
// frequent codes are short by construction — one 2048-entry lookup
// yields the *signed* values and the total bit advance, making the pair
// decode branch-free.  Longer codes and linbits escapes take the
// two-level huff_pair path.  Count1 table A (6-bit codes + 4 signs
// ≤ 10 bits) resolves every quad in one 1024-entry lookup whose four
// signed int16 values store as a single 8-byte copy.
//
// Built once at startup by running the existing decoder over every
// 11-bit pattern (twice, with 0/1 padding, keeping only entries whose
// decode never looks past the index) — derived from, and therefore
// bit-identical to, the reference-parity decode path.
#ifdef PDMP3_PARSE_STATS
extern "C" {
unsigned long long pdmp3_stat_pairs = 0, pdmp3_stat_slow = 0,
                   pdmp3_stat_quads = 0;
unsigned long long pdmp3_cyc_regions = 0, pdmp3_cyc_count1 = 0,
                   pdmp3_cyc_zfill = 0, pdmp3_cyc_scf = 0,
                   pdmp3_cyc_maindata = 0, pdmp3_cyc_header = 0,
                   pdmp3_cyc_sideinfo = 0, pdmp3_cyc_pack = 0,
                   pdmp3_cyc_frame = 0;
}
#define PDMP3_STAT(x) (x)++
#define PDMP3_TSC(dst, expr) do { \
    unsigned long long t0_ = __builtin_ia32_rdtsc(); \
    expr; \
    dst += __builtin_ia32_rdtsc() - t0_; \
  } while (0)
#else
#define PDMP3_STAT(x) ((void)0)
#define PDMP3_TSC(dst, expr) expr
#endif

namespace {

constexpr uint32_t kSlowEntry = 0x80000000u;

struct FastTables {
  // [table][11-bit peek] -> adv<<16 | (int8)x<<8 | (int8)y, or kSlowEntry
  uint32_t pair[34][2048];
  int16_t quad_val[1024][4];  // [10-bit peek] -> signed (v,w,x,y)
  uint8_t quad_adv[1024];
};

const FastTables &fast_tables() {
  static const FastTables ft = [] {
    FastTables t;
    for (int tn = 0; tn < 34; tn++) {
      int lb = kHuffLinbits[tn];
      for (uint32_t idx = 0; idx < 2048; idx++) {
        t.pair[tn][idx] = kSlowEntry;
        if (kHuffMaxlen[tn] == 0 || tn >= 32) continue;
        uint32_t enc[2];
        bool ok = true;
        for (int fill = 0; fill < 2 && ok; fill++) {
          uint32_t word = idx << 21;
          if (fill) word |= (1u << 21) - 1u;
          Reservoir r{};
          for (int b = 0; b < 4; b++) r.bytes[b] = (uint8_t)(word >> (24 - 8 * b));
          std::memset(r.bytes + 4, fill ? 0xFF : 0x00, 8);
          int32_t x, y;
          huff_pair(r, tn, &x, &y);
          int len = (int)r.pos();
          int tot = len + (x > 0) + (y > 0);
          if ((lb && (x == 15 || y == 15)) || tot > 11) {
            ok = false;
            break;
          }
          if (x > 0 && ((word >> (31 - len)) & 1)) x = -x;
          if (y > 0 && ((word >> (31 - len - (x != 0))) & 1)) y = -y;
          enc[fill] = ((uint32_t)tot << 16) |
                      ((uint32_t)(uint8_t)(int8_t)x << 8) |
                      (uint8_t)(int8_t)y;
        }
        if (ok && enc[0] == enc[1]) t.pair[tn][idx] = enc[0];
      }
    }
    for (uint32_t idx = 0; idx < 1024; idx++) {
      uint16_t e = kHuffPrimary[32][idx >> 1];  // codes ≤ 6 bits
      int len = e >> 8;
      uint32_t q = e & 0xF;
      int32_t v[4] = {(int32_t)((q >> 3) & 1), (int32_t)((q >> 2) & 1),
                      (int32_t)((q >> 1) & 1), (int32_t)(q & 1)};
      int adv = len;
      for (int k = 0; k < 4; k++)
        if (v[k]) {
          if ((idx >> (9 - adv)) & 1) v[k] = -v[k];
          adv++;
        }
      for (int k = 0; k < 4; k++) t.quad_val[idx][k] = (int16_t)v[k];
      t.quad_adv[idx] = (uint8_t)adv;
    }
    return t;
  }();
  return ft;
}

// Slow-path (x,y) decode from a freshly refilled ≥57-bit window: covers
// the worst case 19-bit code + 2×(13 linbits + sign) = 47 bits.
struct PairDec {
  int32_t x, y;
  unsigned adv;
};

static inline PairDec decode_pair_slow(uint64_t rwin, int tnum, int lb) {
  uint32_t p9 = (uint32_t)(rwin >> (64 - PDMP3_HUFF_PRIMARY_BITS));
  uint16_t pe = kHuffPrimary[tnum][p9];
  unsigned len, payload;
  if (pe & 0x8000u) {
    int d2 = pe & 0x7FFF;
    int ext = kHuffEscExt[d2];
    uint32_t b2 =
        (uint32_t)((rwin << PDMP3_HUFF_PRIMARY_BITS) >> (64 - ext));
    uint16_t e2 = kHuffSecondary[kHuffEscOff[d2] + (int)b2];
    len = e2 >> 8;
    payload = e2 & 0xFF;
  } else {
    len = pe >> 8;
    payload = pe & 0xFF;
  }
  int32_t x = (payload >> 4) & 0xF;
  int32_t y = payload & 0xF;
  unsigned adv = len;
  if (lb && x == 15) {
    x += (int32_t)((rwin << adv) >> (64 - lb));
    adv += (unsigned)lb;
  }
  if (x > 0) {
    if ((rwin >> (63 - adv)) & 1) x = -x;
    adv++;
  }
  if (lb && y == 15) {
    y += (int32_t)((rwin << adv) >> (64 - lb));
    adv += (unsigned)lb;
  }
  if (y > 0) {
    if ((rwin >> (63 - adv)) & 1) y = -y;
    adv++;
  }
  return {x, y, adv};
}

// ---- interleaved two-slice Huffman decode ----
//
// The four granule-channel main_data slices are bit-independent: each
// starts exactly part2_3_length bits after the previous one
// (pdmp3.c:2113 always resumes at bit_pos_end+1), so the start positions
// are known from the side info alone.  A single slice decode is a serial
// dependency chain (window → table → shift → window…, ~17 cycles/symbol
// measured); stepping two slices in lockstep overlaps the two chains in
// the out-of-order core.  Decode order across slices is irrelevant —
// every store targets the slice's own line buffer.
struct HuffSlice {
  int16_t *line = nullptr;
  const uint8_t *bytes = nullptr;  // reservoir storage
  int *count1_out = nullptr;
  uint64_t win = 0;
  unsigned pos = 0, avail = 0, bit_end = 0;
  int is_pos = 0, big = 0;
  int run = 0, nruns = 0;
  int run_start[3] = {}, run_end[3] = {};
  int16_t run_tnum[3] = {}, run_lb[3] = {};
  const uint32_t *fast = nullptr;
  int tnum = 0, lb = 0, cur_end = 0;
  bool in_count1 = false, table_b = false, spec_b = false, done = false;

  inline void refill() {
    uint64_t w;
    std::memcpy(&w, bytes + (pos >> 3), 8);
    win = __builtin_bswap64(w) << (pos & 7);
    avail = 64 - (pos & 7);
  }

  inline void enter_run(const FastTables &ft) {
    while (run < nruns && is_pos >= run_end[run]) run++;
    if (run < nruns) {
      if (is_pos < run_start[run]) is_pos = run_start[run];
      cur_end = run_end[run];
      tnum = run_tnum[run];
      lb = run_lb[run];
      fast = ft.pair[tnum];
    } else {
      in_count1 = true;
      is_pos = big;
    }
  }

  // ends/tnums as computed by FrameParser::region_bounds; empty-table
  // regions consume no bits, so their zero fill happens here at init
  void init(int16_t *ln, const uint8_t *resbytes, int *c1_out,
            unsigned start_pos, unsigned bitend, int big_, bool tb,
            bool spec, const int ends[3], const int tnums[3],
            const FastTables &ft) {
    line = ln;
    bytes = resbytes;
    count1_out = c1_out;
    pos = start_pos;
    bit_end = bitend;
    big = big_;
    table_b = tb;
    spec_b = spec;
    int prev = 0;
    for (int r = 0; r < 3; r++) {
      int e = ends[r];
      if (e <= prev) continue;
      int tn = tnums[r];
      if (kHuffMaxlen[tn] == 0) {
        std::memset(ln + prev, 0, (size_t)(e - prev) * sizeof(int16_t));
      } else {
        run_start[nruns] = prev;
        run_end[nruns] = e;
        run_tnum[nruns] = (int16_t)tn;
        run_lb[nruns] = (int16_t)kHuffLinbits[tn];
        nruns++;
      }
      prev = e;
    }
    refill();
    enter_run(ft);
  }

  inline void finish() {
    if (pos > bit_end + 1) is_pos -= 4;  // Huffman overrun rollback
    *count1_out = is_pos;
    int zlo = is_pos < 0 ? 0 : is_pos;
    if (zlo < 576)
      std::memset(line + zlo, 0, (size_t)(576 - zlo) * sizeof(int16_t));
    done = true;
  }

  // decode one symbol (pair or quad); returns done
  inline bool step(const FastTables &ft) {
    if (!in_count1) {
      if (avail < 11) refill();
      uint32_t e = fast[(uint32_t)(win >> 53)];
      PDMP3_STAT(pdmp3_stat_pairs);
      if (__builtin_expect(!(e & kSlowEntry), 1)) {
        unsigned adv = (e >> 16) & 31u;
        win <<= adv;
        pos += adv;
        avail -= adv;
        line[is_pos] = (int16_t)(int8_t)(e >> 8);
        line[is_pos + 1] = (int16_t)(int8_t)(e & 0xFF);
      } else {
        PDMP3_STAT(pdmp3_stat_slow);
        refill();
        PairDec p = decode_pair_slow(win, tnum, lb);
        win <<= p.adv;
        pos += p.adv;
        avail -= p.adv;
        line[is_pos] = (int16_t)p.x;
        line[is_pos + 1] = (int16_t)p.y;
      }
      is_pos += 2;
      if (is_pos >= cur_end) enter_run(ft);
      return false;
    }
    if (is_pos > 572 || pos > bit_end) {
      finish();
      return true;
    }
    if (!table_b) {
      if (avail < 10) refill();
      uint32_t idx = (uint32_t)(win >> 54);
      PDMP3_STAT(pdmp3_stat_quads);
      std::memcpy(line + is_pos, ft.quad_val[idx], 8);
      unsigned adv = ft.quad_adv[idx];
      win <<= adv;
      pos += adv;
      avail -= adv;
    } else if (spec_b) {
      // spec profile: real ISO count1 table B (4-bit code, one's
      // complement) + sign bits
      if (avail < 8) refill();
      uint32_t q = 15u - (uint32_t)(win >> 60);
      int32_t v = (q >> 3) & 1, w = (q >> 2) & 1, x = (q >> 1) & 1,
              y = q & 1;
      unsigned adv = 4;
      if (v) { if ((win >> (63 - adv)) & 1) v = -v; adv++; }
      if (w) { if ((win >> (63 - adv)) & 1) w = -w; adv++; }
      if (x) { if ((win >> (63 - adv)) & 1) x = -x; adv++; }
      if (y) { if ((win >> (63 - adv)) & 1) y = -y; adv++; }
      win <<= adv;
      pos += adv;
      avail -= adv;
      line[is_pos] = (int16_t)v;
      line[is_pos + 1] = (int16_t)w;
      line[is_pos + 2] = (int16_t)x;
      line[is_pos + 3] = (int16_t)y;
    } else {
      // reference's stale table-33 pointer: every quad (0,0,±1,±1),
      // two sign bits (pdmp3.c:569, 1627-1635)
      if (avail < 2) refill();
      line[is_pos] = 0;
      line[is_pos + 1] = 0;
      line[is_pos + 2] = (win >> 63) & 1 ? -1 : 1;
      line[is_pos + 3] = (win >> 62) & 1 ? -1 : 1;
      win <<= 2;
      pos += 2;
      avail -= 2;
    }
    is_pos += 4;
    return false;
  }
};

static void decode_two(HuffSlice &a, HuffSlice &b, const FastTables &ft) {
  // Lockstep over the big-values runs with every hot field hoisted into
  // locals so the two serial decode chains actually overlap (a
  // struct-field version measured no better than serial — the per-step
  // field traffic re-serialized it).  Region ends are always even (sfb
  // edges and 2·big_values), so counted pair runs hit boundaries
  // exactly.
  while (!a.in_count1 && !b.in_count1) {
    int rem_a = a.cur_end - a.is_pos, rem_b = b.cur_end - b.is_pos;
    int n = (rem_a < rem_b ? rem_a : rem_b) >> 1;
    uint64_t wa = a.win, wb = b.win;
    unsigned pa = a.pos, pb = b.pos, va = a.avail, vb = b.avail;
    int ia = a.is_pos, ib = b.is_pos;
    const uint32_t *fa = a.fast, *fb = b.fast;
    int16_t *la = a.line, *lb = b.line;
    for (int k = 0; k < n; k++) {
      PDMP3_STAT(pdmp3_stat_pairs);
      PDMP3_STAT(pdmp3_stat_pairs);
      if (va < 11) {
        uint64_t w;
        std::memcpy(&w, a.bytes + (pa >> 3), 8);
        wa = __builtin_bswap64(w) << (pa & 7);
        va = 64 - (pa & 7);
      }
      uint32_t ea = fa[(uint32_t)(wa >> 53)];
      if (vb < 11) {
        uint64_t w;
        std::memcpy(&w, b.bytes + (pb >> 3), 8);
        wb = __builtin_bswap64(w) << (pb & 7);
        vb = 64 - (pb & 7);
      }
      uint32_t eb = fb[(uint32_t)(wb >> 53)];
      if (__builtin_expect(!(ea & kSlowEntry), 1)) {
        unsigned adv = (ea >> 16) & 31u;
        wa <<= adv;
        pa += adv;
        va -= adv;
        la[ia] = (int16_t)(int8_t)(ea >> 8);
        la[ia + 1] = (int16_t)(int8_t)(ea & 0xFF);
      } else {
        PDMP3_STAT(pdmp3_stat_slow);
        uint64_t w;
        std::memcpy(&w, a.bytes + (pa >> 3), 8);
        wa = __builtin_bswap64(w) << (pa & 7);
        va = 64 - (pa & 7);
        PairDec p = decode_pair_slow(wa, a.tnum, a.lb);
        wa <<= p.adv;
        pa += p.adv;
        va -= p.adv;
        la[ia] = (int16_t)p.x;
        la[ia + 1] = (int16_t)p.y;
      }
      ia += 2;
      if (__builtin_expect(!(eb & kSlowEntry), 1)) {
        unsigned adv = (eb >> 16) & 31u;
        wb <<= adv;
        pb += adv;
        vb -= adv;
        lb[ib] = (int16_t)(int8_t)(eb >> 8);
        lb[ib + 1] = (int16_t)(int8_t)(eb & 0xFF);
      } else {
        PDMP3_STAT(pdmp3_stat_slow);
        uint64_t w;
        std::memcpy(&w, b.bytes + (pb >> 3), 8);
        wb = __builtin_bswap64(w) << (pb & 7);
        vb = 64 - (pb & 7);
        PairDec p = decode_pair_slow(wb, b.tnum, b.lb);
        wb <<= p.adv;
        pb += p.adv;
        vb -= p.adv;
        lb[ib] = (int16_t)p.x;
        lb[ib + 1] = (int16_t)p.y;
      }
      ib += 2;
    }
    a.win = wa;
    a.pos = pa;
    a.avail = va;
    a.is_pos = ia;
    b.win = wb;
    b.pos = pb;
    b.avail = vb;
    b.is_pos = ib;
    if (ia >= a.cur_end) a.enter_run(ft);
    if (ib >= b.cur_end) b.enter_run(ft);
  }
  // lockstep count1 (table A for both — the common case)
  if (a.in_count1 && b.in_count1 && !a.table_b && !b.table_b) {
    uint64_t wa = a.win, wb = b.win;
    unsigned pa = a.pos, pb = b.pos, va = a.avail, vb = b.avail;
    int ia = a.is_pos, ib = b.is_pos;
    int16_t *la = a.line, *lb = b.line;
    while (ia <= 572 && pa <= a.bit_end && ib <= 572 && pb <= b.bit_end) {
      PDMP3_STAT(pdmp3_stat_quads);
      PDMP3_STAT(pdmp3_stat_quads);
      if (va < 10) {
        uint64_t w;
        std::memcpy(&w, a.bytes + (pa >> 3), 8);
        wa = __builtin_bswap64(w) << (pa & 7);
        va = 64 - (pa & 7);
      }
      uint32_t xa = (uint32_t)(wa >> 54);
      if (vb < 10) {
        uint64_t w;
        std::memcpy(&w, b.bytes + (pb >> 3), 8);
        wb = __builtin_bswap64(w) << (pb & 7);
        vb = 64 - (pb & 7);
      }
      uint32_t xb = (uint32_t)(wb >> 54);
      std::memcpy(la + ia, ft.quad_val[xa], 8);
      unsigned adv_a = ft.quad_adv[xa];
      wa <<= adv_a;
      pa += adv_a;
      va -= adv_a;
      ia += 4;
      std::memcpy(lb + ib, ft.quad_val[xb], 8);
      unsigned adv_b = ft.quad_adv[xb];
      wb <<= adv_b;
      pb += adv_b;
      vb -= adv_b;
      ib += 4;
    }
    a.win = wa;
    a.pos = pa;
    a.avail = va;
    a.is_pos = ia;
    b.win = wb;
    b.pos = pb;
    b.avail = vb;
    b.is_pos = ib;
  }
  // drain whatever remains serially
  while (!a.done) a.step(ft);
  while (!b.done) b.step(ft);
}

}  // namespace

void FrameParser::region_bounds(int gr, int ch, int ends[3],
                                int tnums[3]) const {
  // big-values region boundaries (pdmp3.c:2064-2076)
  int region_1_start, region_2_start;
  if (si.win_switch[gr][ch] && si.block_type[gr][ch] == 2) {
    // Short/mixed blocks: region0 spans the first 3 short scalefactor
    // bands x 3 windows.  Every MPEG-1 rate's first three short bands
    // are 4 lines wide, so the reference hardcodes 36 (pdmp3.c:2064) —
    // but MPEG-2.5 8 kHz has 8-wide bands (3*24 = 72).  Determined
    // empirically against BOTH libmpg123 and libavcodec (single-line
    // probe streams, round 5): both use 3*s[3] for pure short blocks;
    // for 8 kHz MIXED blocks they disagree with each other (ffmpeg 72,
    // mpg123 108) and we follow ffmpeg, our LSF anchor (DESIGN.md §6).
    region_1_start = 3 * kSfbShortFam[hdr.family][hdr.sampling_frequency][3];
    region_2_start = 576;
  } else {
    int sf = hdr.sampling_frequency;
    const int *longs = kSfbLongFam[hdr.family][sf];
    region_1_start = longs[si.region0_count[gr][ch] + 1];
    // hostile side info can push this index past l[22] (region counts
    // are raw 4+3 bit fields: 15+7+2 = 24); the reference's struct
    // layout aliases .l[23+k] onto .s[k] (pdmp3.c:108-112, 2074-2076).
    // Emulate the alias instead of overflowing our separate tables
    // (found by tools/fuzz.py, ASan global-buffer-overflow).  LSF has
    // no reference layout to mirror: clamp to the 576 end instead
    // (frontend._read_huffman parity).
    int r2i =
        (int)(si.region0_count[gr][ch] + si.region1_count[gr][ch] + 2);
    if (hdr.family)
      region_2_start = longs[r2i <= 22 ? r2i : 22];
    else
      region_2_start =
          r2i <= 22 ? kSfbLong[sf][r2i] : kSfbShort[sf][r2i - 23];
  }
  int big = (int)si.big_values[gr][ch] * 2;
  int e0 = region_1_start < 0 ? 0 : region_1_start;
  if (e0 > big) e0 = big;
  int e1 = region_2_start < e0 ? e0 : region_2_start;
  if (e1 > big) e1 = big;
  ends[0] = e0;
  ends[1] = e1;
  ends[2] = big;
  for (int r = 0; r < 3; r++) tnums[r] = (int)si.table_select[gr][ch][r];
}

void FrameParser::read_huffman(unsigned part_2_start, int gr, int ch,
                               pdmp3_granules *g, int16_t *line) {
  // (pdmp3.c:2051-2115) incl. overrun rollback + stuffing-bit skip
  if (!line) line = g->ix[gr][ch];
  if (si.part2_3_length[gr][ch] == 0) {
    std::memset(line, 0, 576 * sizeof(int16_t));
    // reference quirk (pdmp3.c:2057-2060): the early return never sets
    // count1, so the PREVIOUS frame's value persists in the handle and
    // keeps driving the MS-stereo extent (min count1) — found by the
    // round-5 diversified real-encoder soak (LAME VBR emits silent
    // p23==0 channels; seed 801224).  LSF has no reference to mirror:
    // a silent channel's rzero starts at 0 there (spec-sane).
    if (hdr.family) si.count1[gr][ch] = 0;
    return;
  }
  unsigned bit_pos_end = part_2_start + si.part2_3_length[gr][ch] - 1;
  int big = (int)si.big_values[gr][ch] * 2;
  // The table only changes at the two region boundaries: decode each
  // region as one run with the table pointers hoisted out of the loop.
  int ends[3], tnums[3];
  region_bounds(gr, ch, ends, tnums);
  bool guarded = big > 576;  // only corrupt streams; keep stores checked
  const FastTables &ft = fast_tables();
  // Register-resident bit cursor: the per-symbol serial chain is
  // load→bswap→shift→table→advance (~25 cycles measured when the window
  // reloads every pair); keeping the window in a register turns the
  // common step into table→shift (the reload every ~4 pairs overlaps).
  // `rpos` is the absolute bit position, `rwin` holds the next bits at
  // the MSB, `ravail` how many of them are valid.
  uint64_t rwin = 0;
  unsigned rpos = res.pos(), ravail = 0;
  auto refill = [&] {
    uint64_t w;
    std::memcpy(&w, res.bytes + (rpos >> 3), 8);
    rwin = __builtin_bswap64(w) << (rpos & 7);
    ravail = 64 - (rpos & 7);
  };
  refill();
  int is_pos = 0;
  for (int r = 0; r < 3; r++) {
    int end = ends[r], tnum = tnums[r];
    int lb = kHuffLinbits[tnum];
    int maxlen = kHuffMaxlen[tnum];
    if (maxlen == 0 && !guarded) {
      // empty tables 0/4/14: every pair is (0,0), zero bits consumed
      std::memset(line + is_pos, 0,
                  (size_t)(end - is_pos) * sizeof(int16_t));
      is_pos = end;
    } else if (!guarded) {
      const uint32_t *fast = ft.pair[tnum];
      for (; is_pos < end; is_pos += 2) {
        if (ravail < 11) refill();
        uint32_t e = fast[(uint32_t)(rwin >> 53)];
        PDMP3_STAT(pdmp3_stat_pairs);
        if (__builtin_expect(!(e & kSlowEntry), 1)) {
          // fused path: one lookup = codeword + both signs, branch-free
          unsigned adv = (e >> 16) & 31u;
          rwin <<= adv;
          rpos += adv;
          ravail -= adv;
          line[is_pos] = (int16_t)(int8_t)(e >> 8);
          line[is_pos + 1] = (int16_t)(int8_t)(e & 0xFF);
        } else {
          PDMP3_STAT(pdmp3_stat_slow);
          // long codeword or linbits escape — decoded from a fresh
          // refill (≥57 bits covers the worst case)
          refill();
          PairDec p = decode_pair_slow(rwin, tnum, lb);
          rwin <<= p.adv;
          rpos += p.adv;
          ravail -= p.adv;
          line[is_pos] = (int16_t)p.x;
          line[is_pos + 1] = (int16_t)p.y;
        }
      }
    } else {
      for (; is_pos < end; is_pos += 2) {
        int32_t x, y;
        huff_pair(res, tnum, &x, &y);
        if (lb && x == 15) x += (int32_t)res.get_bits(lb);
        if (x > 0 && res.get_bit()) x = -x;
        if (lb && y == 15) y += (int32_t)res.get_bits(lb);
        if (y > 0 && res.get_bit()) y = -y;
        if (is_pos < 576) line[is_pos] = (int16_t)x;
        if (is_pos + 1 < 576) line[is_pos + 1] = (int16_t)y;
      }
    }
  }
  bool table_b = si.count1table_select[gr][ch] != 0;
  is_pos = big;
  if (!table_b) {
    // table A: one 10-bit lookup per quad (code + 4 signs ≤ 10 bits),
    // four signed int16 values stored as a single 8-byte copy.  big is
    // even, so is_pos stays even and the ≤572 gate keeps all four
    // stores in-bounds (the reference's per-value 576 breaks are
    // unreachable from an even start, pdmp3.c:2090-2103).
    if (guarded) {
      rpos = res.pos();
      refill();
    }
    while (is_pos <= 572 && rpos <= bit_pos_end) {
      if (ravail < 10) refill();
      uint32_t idx = (uint32_t)(rwin >> 54);
      PDMP3_STAT(pdmp3_stat_quads);
      std::memcpy(line + is_pos, ft.quad_val[idx], 8);
      unsigned adv = ft.quad_adv[idx];
      rwin <<= adv;
      rpos += adv;
      ravail -= adv;
      is_pos += 4;
    }
    res.set_pos(rpos);
  } else {
    if (!guarded) res.set_pos(rpos);
  }
  while (table_b && is_pos <= 572 && res.pos() <= bit_pos_end) {
    int32_t v, w, x, y;
    // LSF frames always use the REAL table B: the broken-table-33
    // emulation is reference bug parity, and the reference rejects
    // id=0 outright (pdmp3.c:1295) — real MPEG-2/2.5 encoders (LAME)
    // DO select table B, so the spec decode is the only one that
    // matches production decoders (found by round-5 real-encoder LSF
    // conformance; libmpg123 + libavcodec both anchor it)
    if ((profile & PDMP3_PROFILE_COUNT1B_SPEC) || hdr.family) {
      // spec profile: the REAL ISO count1 table B — every code is 4 bits,
      // quad value = one's complement of the code — plus sign bits
      uint32_t q = 15u - res.get_bits(4);
      v = (q >> 3) & 1;
      w = (q >> 2) & 1;
      x = (q >> 1) & 1;
      y = q & 1;
      if (v && res.get_bit()) v = -v;
      if (w && res.get_bit()) w = -w;
      if (x && res.get_bit()) x = -x;
      if (y && res.get_bit()) y = -y;
    } else {
      // reference's stale table-33 pointer hits a 0-bit leaf (x=2,y=3):
      // every quad is (0,0,±1,±1), two sign bits (pdmp3.c:569, 1627-1635)
      v = 0;
      w = 0;
      x = res.get_bit() ? -1 : 1;
      y = res.get_bit() ? -1 : 1;
    }
    line[is_pos++] = (int16_t)v;
    if (is_pos >= 576) break;
    line[is_pos++] = (int16_t)w;
    if (is_pos >= 576) break;
    line[is_pos++] = (int16_t)x;
    if (is_pos >= 576) break;
    line[is_pos++] = (int16_t)y;
  }
  if (res.pos() > bit_pos_end + 1) is_pos -= 4;
  si.count1[gr][ch] = is_pos;
  int zlo = is_pos < 0 ? 0 : is_pos;
  if (zlo < 576)
    PDMP3_TSC(pdmp3_cyc_zfill,
              std::memset(line + zlo, 0,
                          (size_t)(576 - zlo) * sizeof(int16_t)));
  res.set_pos(bit_pos_end + 1);
}

int FrameParser::read_main(pdmp3_granules *g,
                           int16_t *const (*wire_dst)[2]) {
  // (pdmp3.c:1346-1442)
  int nch = hdr.nch();
  long framesize = hdr.frame_size();
  if (framesize > 2000) return PDMP3_ERR;
  long sideinfo_size =
      hdr.family ? (nch == 1 ? 9 : 17) : (nch == 1 ? 17 : 32);
  long main_data_size = framesize - sideinfo_size - 4;
  if (hdr.protection_bit == 0) main_data_size -= 2;
  int r;
  PDMP3_TSC(pdmp3_cyc_maindata,
            r = get_main_data((unsigned)main_data_size,
                              si.main_data_begin));
  if (r != PDMP3_OK) return r;
  // Granule-channel slices are decoded pairwise-interleaved (HuffSlice):
  // slice starts derive from part2_3_length alone, so after reading each
  // slice's scalefactors sequentially (scfsi copies need granule 0's
  // values first) the Huffman decodes are fully independent.  Corrupt
  // slices (big_values > 288) fall back to the serial bounds-checked
  // read_huffman path.
  const FastTables &ft = fast_tables();
  HuffSlice slices[2];
  int n_ready = 0;
  unsigned start = res.pos();  // 0 after get_main_data
  if (hdr.family) {
    // LSF: one granule, no scfsi — arrays are reused across frames, so
    // clear everything including granule 1 and the untransmitted policy
    // slots (spec default 0; the reference has no LSF quirks to mirror).
    // The intensity sidecar defaults to "no intensity" (illegal) and is
    // overwritten by read_scalefactors_lsf for the intensity channel.
    std::memset(scf_l_state, 0, sizeof scf_l_state);
    std::memset(scf_s_state, 0, sizeof scf_s_state);
    lsf_iscale = 0;
    for (int b = 0; b < 22; b++) lsf_is_l[b] = kLsfIsIllegal;
    for (int b = 0; b < 13; b++)
      for (int w = 0; w < 3; w++) lsf_is_s[b][w] = kLsfIsIllegal;
  }
  for (int gr = 0; gr < hdr.ngr(); gr++) {
    for (int ch = 0; ch < nch; ch++) {
      unsigned part_2_start = start;
      res.set_pos(start);
      PDMP3_TSC(pdmp3_cyc_scf, hdr.family
                                   ? read_scalefactors_lsf(ch)
                                   : read_scalefactors(gr, ch, g));
      // long-block channels may decode straight into the caller's wire
      bool short_blk =
          si.win_switch[gr][ch] && si.block_type[gr][ch] == 2;
      int16_t *line = (wire_dst && !short_blk) ? wire_dst[gr][ch]
                                               : g->ix[gr][ch];
      unsigned p23 = si.part2_3_length[gr][ch];
      if (p23 == 0) {
        // reference quirk: with no main-data bits the cursor is left
        // where the (garbage) scalefactor reads ended (pdmp3.c:2057),
        // and count1 is NEVER SET — the previous frame's value stays
        // in the handle and drives the MS extent (see read_huffman)
        std::memset(line, 0, 576 * sizeof(int16_t));
        if (hdr.family) si.count1[gr][ch] = 0;
        start = res.pos();
        continue;
      }
      unsigned hstart = res.pos();
      start = part_2_start + p23;
      int big = (int)si.big_values[gr][ch] * 2;
      if (big > 576) {
        PDMP3_TSC(pdmp3_cyc_regions,
                  read_huffman(part_2_start, gr, ch, g, line));
        continue;
      }
      int ends[3], tnums[3];
      region_bounds(gr, ch, ends, tnums);
      slices[n_ready].init(
          line, res.bytes, &si.count1[gr][ch], hstart,
          part_2_start + p23 - 1, big,
          si.count1table_select[gr][ch] != 0,
          // LSF: always the real ISO table B (see read_huffman)
          (profile & PDMP3_PROFILE_COUNT1B_SPEC) != 0 || hdr.family != 0,
          ends, tnums, ft);
      if (++n_ready == 2) {
        PDMP3_TSC(pdmp3_cyc_regions, decode_two(slices[0], slices[1], ft));
        slices[0] = HuffSlice();
        slices[1] = HuffSlice();
        n_ready = 0;
      }
    }
  }
  if (n_ready) {
    PDMP3_TSC(pdmp3_cyc_regions,
              while (!slices[0].step(ft)) {});
    slices[0] = HuffSlice();
  }
  res.set_pos(start);
  if (!hdr.family) {
    // sfb21 alias slots (pdmp3.c:1896-1902 OOB read emulation): by
    // struct layout scalefac_l[gr][ch][21] aliases the next
    // granule-channel's scalefac 0; the last aliases
    // scalefac_s[0][0][0][0]; pretab[21] is 0.0 in the reference
    // binary's rodata.  MPEG-1 only — the reference rejects LSF, so LSF
    // policy slots stay the spec-default 0 (zeroed above).
    scf_l_state[0][0][21] = scf_l_state[0][1][0];
    scf_l_state[0][1][21] = scf_l_state[1][0][0];
    scf_l_state[1][0][21] = scf_l_state[1][1][0];
    scf_l_state[1][1][21] = scf_s_state[0][0][0][0];
    for (int w = 0; w < 3; w++) {  // short band-12 slot, same aliasing
      scf_s_state[0][0][12][w] = scf_s_state[0][1][0][w];
      scf_s_state[0][1][12][w] = scf_s_state[1][0][0][w];
      scf_s_state[1][0][12][w] = scf_s_state[1][1][0][w];
      // last granule-channel aliases float bits of is[0][0]: gain
      // underflows to +0.0 — sentinel 63 hits the zeroed gain region
      scf_s_state[1][1][12][w] = 63;
    }
  }
  std::memcpy(g->scf_l, scf_l_state, sizeof scf_l_state);
  std::memcpy(g->scf_s, scf_s_state, sizeof scf_s_state);
  return PDMP3_OK;
}

// ---- Layer I/II frame decode (PDMP3_PROFILE_L12; beyond-reference —
// the reference rejects layer != 3, pdmp3.c:1240/1312).  Bit-parse per
// ISO 11172-3 §2.4.1.5-6/§2.4.2.1-2 (13818-3 table B.1 for LSF Layer
// II), requantize to float subband samples.  Mirrors
// frontend._parse_l1/_parse_l2 operation-for-operation (double
// arithmetic, final float rounding) so native and Python frontends are
// bitwise identical. ----

namespace {

// Bounded MSB-first bit reader over one frame's bytes (mirrors
// frontend._BitReader: reads past the end return 0 and set overflow —
// the frame is then rejected).  data must have >= 8 bytes of padding
// past nbits/8 for the 64-bit window loads.
struct L12BitReader {
  const uint8_t *data;
  unsigned pos = 0, nbits;
  bool overflow = false;
  L12BitReader(const uint8_t *d, unsigned nbytes)
      : data(d), nbits(8 * nbytes) {}
  unsigned get(unsigned nb) {
    if (nb == 0) return 0;
    unsigned end = pos + nb;
    if (end > nbits) {
      overflow = true;
      pos = end;
      return 0;
    }
    uint64_t w;
    std::memcpy(&w, data + (pos >> 3), 8);
    w = __builtin_bswap64(w) << (pos & 7);
    pos = end;
    return (unsigned)(w >> (64 - nb));
  }
};

// MSB-inverted two's-complement fraction of an nb-bit code (11172-3
// §2.4.3.2/.3: s'''; frontend._l12_frac)
inline double l12_frac(unsigned code, int nb) {
  int msb = 1 << (nb - 1);
  int c = (int)(code ^ (unsigned)msb);
  if (c >= msb) c -= 1 << nb;
  return (double)c / (double)msb;
}

// first subband of the joint-stereo (intensity) region (11172-3
// §2.4.2.1; tables.l12_bound)
inline int l12_bound(int mode, int mode_ext, int sblimit) {
  if (mode != 1) return sblimit;
  int b = (mode_ext + 1) * 4;
  return b < sblimit ? b : sblimit;
}

// Layer II allocation table index 0..4 = B.2a/b/c/d/LSF-B.1
// (tables.l2_alloc_table selection rules)
inline int l2_table_index(const FrameHeader &h) {
  if (h.family) return 4;
  long freq = kSampleRates[h.sampling_frequency];
  long kbps = kBitratesL2[h.bitrate_index] / 1000 / h.nch();
  if (h.bitrate_index == 0)  // free format: highest-rate table
    return freq == 48000 ? 0 : 1;
  if ((freq == 48000 && kbps >= 56) || (kbps >= 56 && kbps <= 80)) return 0;
  if (freq != 48000 && kbps >= 96) return 1;
  if (freq != 32000 && kbps <= 48) return 2;
  return 3;
}

inline float scf_l12(int scf) { return kScfL12[scf > 62 ? 62 : scf]; }

int parse_l1(const FrameHeader &h, L12BitReader &br, pdmp3_granules *g) {
  // frontend._parse_l1 (11172-3 §2.4.1.5, §2.4.2.1)
  int nch = h.nch();
  int bound = l12_bound(h.mode, h.mode_extension, 32);
  int alloc[2][32] = {};
  for (int sb = 0; sb < 32; sb++) {
    if (sb < bound) {
      for (int ch = 0; ch < nch; ch++) alloc[ch][sb] = (int)br.get(4);
    } else {
      alloc[0][sb] = alloc[1][sb] = (int)br.get(4);
    }
  }
  for (int ch = 0; ch < 2; ch++)
    for (int sb = 0; sb < 32; sb++)
      if (alloc[ch][sb] == 15) return PDMP3_ERR;  // forbidden index
  int scf[2][32] = {};
  for (int sb = 0; sb < 32; sb++)
    for (int ch = 0; ch < nch; ch++)
      if (alloc[ch][sb]) scf[ch][sb] = (int)br.get(6);
  for (int s = 0; s < 12; s++)
    for (int sb = 0; sb < 32; sb++) {
      bool shared = sb >= bound;
      for (int ch = 0; ch < (shared ? 1 : nch); ch++) {
        int a = alloc[ch][sb];
        if (!a) continue;
        int nb = a + 1;
        unsigned code = br.get((unsigned)nb);
        double spp = ((double)(1 << nb) / (double)((1 << nb) - 1)) *
                     (l12_frac(code, nb) + std::ldexp(1.0, 1 - nb));
        for (int cch = 0; cch < nch; cch++)
          if (shared || cch == ch)
            g->sb_samples[cch][s][sb] =
                (float)((double)scf_l12(scf[cch][sb]) * spp);
      }
    }
  return PDMP3_OK;
}

int parse_l2(const FrameHeader &h, L12BitReader &br, pdmp3_granules *g) {
  // frontend._parse_l2 (11172-3 §2.4.1.6, §2.4.2.2; 13818-3 B.1)
  int nch = h.nch();
  int tsel = l2_table_index(h);
  int sblimit = kL2Sblimit[tsel];
  int bound = l12_bound(h.mode, h.mode_extension, sblimit);
  int alloc[2][32] = {};
  for (int sb = 0; sb < sblimit; sb++) {
    unsigned nbal = (unsigned)kL2Nbal[tsel][sb];
    if (sb < bound) {
      for (int ch = 0; ch < nch; ch++) alloc[ch][sb] = (int)br.get(nbal);
    } else {
      alloc[0][sb] = alloc[1][sb] = (int)br.get(nbal);
    }
  }
  int scfsi[2][32] = {};
  for (int sb = 0; sb < sblimit; sb++)
    for (int ch = 0; ch < nch; ch++)
      if (alloc[ch][sb]) scfsi[ch][sb] = (int)br.get(2);
  int scf[2][32][3] = {};
  for (int sb = 0; sb < sblimit; sb++)
    for (int ch = 0; ch < nch; ch++) {
      if (!alloc[ch][sb]) continue;
      int a, b, c;
      switch (scfsi[ch][sb]) {
        case 0:
          a = (int)br.get(6);
          b = (int)br.get(6);
          c = (int)br.get(6);
          break;
        case 1:
          a = (int)br.get(6);
          b = a;
          c = (int)br.get(6);
          break;
        case 2:
          a = (int)br.get(6);
          b = c = a;
          break;
        default:
          a = (int)br.get(6);
          b = (int)br.get(6);
          c = b;
          break;
      }
      scf[ch][sb][0] = a;
      scf[ch][sb][1] = b;
      scf[ch][sb][2] = c;
    }
  for (int grp = 0; grp < 12; grp++) {
    int part = grp >> 2;
    for (int sb = 0; sb < sblimit; sb++) {
      bool shared = sb >= bound;
      for (int ch = 0; ch < (shared ? 1 : nch); ch++) {
        int a = alloc[ch][sb];
        if (!a) continue;
        int ci = kL2Cls[tsel][sb][a - 1];
        unsigned bits = (unsigned)kL2ClsBits[ci];
        int gsteps = kL2ClsGroupSteps[ci];
        int nb = kL2ClsNb[ci];
        unsigned codes[3];
        if (gsteps) {  // grouped: 3 samples per codeword
          unsigned c = br.get(bits);
          unsigned gs = (unsigned)gsteps;
          codes[0] = c % gs;
          codes[1] = (c / gs) % gs;
          codes[2] = (c / (gs * gs)) % gs;
        } else {
          codes[0] = br.get(bits);
          codes[1] = br.get(bits);
          codes[2] = br.get(bits);
        }
        for (int k = 0; k < 3; k++) {
          double spp = kL2ClsC[ci] * (l12_frac(codes[k], nb) + kL2ClsD[ci]);
          for (int cch = 0; cch < nch; cch++)
            if (shared || cch == ch)
              g->sb_samples[cch][3 * grp + k][sb] =
                  (float)((double)scf_l12(scf[cch][sb][part]) * spp);
        }
      }
    }
  }
  return PDMP3_OK;
}

}  // namespace

static uint16_t crc16_mpeg(const uint8_t *data, size_t n, uint16_t crc);

static uint16_t crc16_mpeg_bits(const uint8_t *data, long nbits,
                                uint16_t crc) {
  // crc16_mpeg over the first nbits bits (MSB-first) — Layer I/II
  // protected regions are not byte-aligned in general
  long nbytes = nbits >> 3, rem = nbits & 7;
  crc = crc16_mpeg(data, (size_t)nbytes, crc);
  for (int i = 0; i < rem; i++) {
    unsigned bit = (data[nbytes] >> (7 - i)) & 1;
    crc = (uint16_t)((((crc >> 15) & 1) ^ bit) ? (crc << 1) ^ 0x8005
                                               : crc << 1);
  }
  return crc;
}

static long l12_protected_bits(const FrameHeader &h, const uint8_t *body,
                               long nbytes) {
  // tables.l12_protected_bits: Layer I = FIXED 4*32*nch bits (ISO's
  // fixed-length definition; libavcodec-pinned — NOT the bound-aware
  // allocation extent); Layer II = bit allocation + scfsi, pre-scanned
  long end = 8 * nbytes;
  if (h.layer == 1) {
    long n = 4 * 32 * h.nch();
    return n < end ? n : end;
  }
  int tsel = l2_table_index(h);
  int sblimit = kL2Sblimit[tsel];
  int bound = l12_bound(h.mode, h.mode_extension, sblimit);
  int nch = h.nch();
  long pos = 0, nz = 0;
  auto get = [&](unsigned n) -> unsigned {
    unsigned v = 0;
    for (unsigned i = 0; i < n; i++) {
      v <<= 1;
      if (pos < end) v |= (unsigned)((body[pos >> 3] >> (7 - (pos & 7))) & 1);
      pos++;
    }
    return v;
  };
  for (int sb = 0; sb < sblimit; sb++) {
    unsigned nbal = (unsigned)kL2Nbal[tsel][sb];
    if (sb < bound) {
      for (int ch = 0; ch < nch; ch++)
        if (get(nbal)) nz++;
    } else if (get(nbal)) {
      nz += nch;
    }
  }
  long n = pos + 2 * nz;
  return n < end ? n : end;
}

int FrameParser::parse_frame_l12(pdmp3_granules *g, int32_t crc_read) {
  // frontend._read_frame_l12: the frame body (no bit reservoir in
  // Layers I/II) is consumed in one bounded read; short input returns
  // NEED_MORE and the CALLER rolls the input cursor back (pdmp3_read /
  // pdmp3_parse_frame), restoring the header bytes for resume.
  long nbytes = hdr.frame_size() - 4 - (hdr.protection_bit == 0 ? 2 : 0);
  if (nbytes <= 0 || nbytes > 2000) return PDMP3_ERR;
  if (in.filled() < (unsigned)nbytes) return PDMP3_NEED_MORE;
  uint8_t body[2000 + 8];
  in.get_bytes(body, (unsigned)nbytes);
  std::memset(body + nbytes, 0, 8);  // window-load padding
  if (crc_read >= 0) {
    uint8_t h2[2] = {(uint8_t)(hdr.raw16 >> 8), (uint8_t)hdr.raw16};
    uint16_t crc = crc16_mpeg_bits(body, l12_protected_bits(hdr, body,
                                                            nbytes),
                                   crc16_mpeg(h2, 2, 0xFFFF));
    // body already consumed: the caller restarts at the next header
    if ((int32_t)crc != crc_read) return kCrcSkip;
  }
  L12BitReader br(body, (unsigned)nbytes);
  int nparts = hdr.layer == 1 ? 12 : 36;
  std::memset(g->sb_samples[0], 0, (size_t)nparts * 32 * sizeof(float));
  std::memset(g->sb_samples[1], 0, (size_t)nparts * 32 * sizeof(float));
  int r = hdr.layer == 1 ? parse_l1(hdr, br, g) : parse_l2(hdr, br, g);
  if (r != PDMP3_OK || br.overflow) return PDMP3_ERR;
  g->layer = hdr.layer;
  g->nparts = nparts;
  g->nch = hdr.nch();
  g->sample_rate =
      (int32_t)kSampleRatesFam[hdr.family][hdr.sampling_frequency];
  g->family = hdr.family;
  g->ms_flag = g->is_flag = 0;
  return PDMP3_OK;
}

static uint16_t crc16_mpeg(const uint8_t *data, size_t n,
                           uint16_t crc = 0xFFFF) {
  // ISO 11172-3 §2.4.3.1: poly 0x8005 MSB-first, init 0xFFFF (law
  // validated against libavcodec's AV_EF_CRCCHECK, tests/test_crc.py)
  for (size_t i = 0; i < n; i++) {
    crc = (uint16_t)(crc ^ ((uint16_t)data[i] << 8));
    for (int k = 0; k < 8; k++)
      crc = (uint16_t)((crc & 0x8000) ? (crc << 1) ^ 0x8005 : crc << 1);
  }
  return crc;
}

int FrameParser::parse_frame(pdmp3_granules *g,
                             int16_t *const (*wire_dst)[2]) {
  // Read_Frame (pdmp3.c:1217-1244); caller rolls back on non-OK.  The
  // loop restarts at the next header when PDMP3_PROFILE_CRC skips a
  // corrupt frame (bounded by the frames the 16 KiB ring holds).
restart:
  int r;
  PDMP3_TSC(pdmp3_cyc_header, r = search_header());
  if (r != PDMP3_OK) return r == PDMP3_ERR ? PDMP3_ERR : r;
  if (hdr.bitrate_index == 0 && free_size == 0) {
    r = measure_free_size();
    // caller rolls the input cursor back on non-OK (pdmp3_read /
    // pdmp3_parse_frame), restoring the consumed header bytes
    if (r != PDMP3_OK) return r;
    hdr.free_size = (int)free_size;
  }
  int32_t crc_read = -1;
  if (hdr.protection_bit == 0) {
    // CRC read and (by default) discarded; EOF silently ignored
    // (Read_CRC returns FALSE==PDMP3_OK on EOF, pdmp3.c:1206-1210)
    uint32_t c1 = in.get_byte();
    uint32_t c2 = in.get_byte();
    if (crc_enabled() && c1 != kEof && c2 != kEof)
      crc_read = (int32_t)((c1 << 8) | c2);
  }
  if (hdr.layer != 3) {
    if (l12_enabled() && (hdr.layer == 1 || hdr.layer == 2)) {
      r = parse_frame_l12(g, crc_read);
      if (r == kCrcSkip) goto restart;  // corrupt body already consumed
      return r;
    }
    return PDMP3_ERR;
  }
  g->layer = 3;
  g->nparts = 0;
  // read_huffman writes every parsed channel's 576 lines (decode +
  // rzero fill) and read_main overwrites the scalefactor arrays, so only
  // the meta tail needs zeroing here — plus the unparsed channel's lines
  // for mono, which the SoA wire packers copy verbatim.  sb_samples
  // (Layer I/II only, past `layer`) is deliberately left stale.
  std::memset(g->scf_l, 0,
              offsetof(pdmp3_granules, layer) -
                  offsetof(pdmp3_granules, scf_l[0][0][0]));
  if (hdr.mode == 3) {
    std::memset(g->ix[0][1], 0, sizeof g->ix[0][1]);
    std::memset(g->ix[1][1], 0, sizeof g->ix[1][1]);
  }
  if (hdr.family)  // LSF frames carry ONE granule: granule 1 stays zero
    std::memset(g->ix[1], 0, sizeof g->ix[1]);
  PDMP3_TSC(pdmp3_cyc_sideinfo, r = read_side_info());
  if (r != PDMP3_OK) return PDMP3_ERR;
  if (crc_read >= 0) {
    int size = hdr.family ? (hdr.nch() == 1 ? 9 : 17)
                          : (hdr.nch() == 1 ? 17 : 32);
    uint8_t h2[2] = {(uint8_t)(hdr.raw16 >> 8), (uint8_t)hdr.raw16};
    uint16_t crc = crc16_mpeg(side.bytes, (size_t)size,
                              crc16_mpeg(h2, 2));
    if ((int32_t)crc != crc_read) {
      // skip the corrupt frame whole: its main data never enters the
      // reservoir; a following frame reaching back takes the standard
      // underflow NEED_MORE path (pdmp3.c:1101-1110 semantics)
      long skip = hdr.frame_size() - 4 - 2 - size;
      for (long i = 0; i < skip; i++)
        if (in.get_byte() == kEof) return PDMP3_NEED_MORE;
      goto restart;
    }
  }
  r = read_main(g, wire_dst);
  if (r != PDMP3_OK) return r;
  // fill granule tensor metadata
  g->nch = hdr.nch();
  g->sample_rate =
      (int32_t)kSampleRatesFam[hdr.family][hdr.sampling_frequency];
  g->ms_flag = (hdr.mode == 1 && (hdr.mode_extension & 2)) ? 1 : 0;
  g->is_flag = (hdr.mode == 1 && (hdr.mode_extension & 1)) ? 1 : 0;
  g->family = hdr.family;
  if (hdr.family) {
    g->iscale = lsf_iscale;
    std::memcpy(g->is_pos_l, lsf_is_l, sizeof lsf_is_l);
    std::memcpy(g->is_pos_s, lsf_is_s, sizeof lsf_is_s);
  }
  for (int gr = 0; gr < hdr.ngr(); gr++)
    for (int ch = 0; ch < hdr.nch(); ch++) {
      g->layout[gr][ch] =
          layout_id(hdr.sampling_frequency, (int)si.win_switch[gr][ch],
                    (int)si.block_type[gr][ch], (int)si.mixed[gr][ch]);
      g->block_type[gr][ch] = (int32_t)si.block_type[gr][ch];
      g->win_switch[gr][ch] = (int32_t)si.win_switch[gr][ch];
      g->mixed[gr][ch] = (int32_t)si.mixed[gr][ch];
      g->global_gain[gr][ch] = (int32_t)si.global_gain[gr][ch];
      g->scalefac_scale[gr][ch] = (int32_t)si.scalefac_scale[gr][ch];
      g->preflag[gr][ch] = (int32_t)si.preflag[gr][ch];
      for (int w = 0; w < 3; w++)
        g->subblock_gain[gr][ch][w] = (int32_t)si.subblock_gain[gr][ch][w];
      g->count1[gr][ch] = si.count1[gr][ch];
    }
  if (debug_dump_level() >= 1) dump_frame_state(*this, *g);
  return PDMP3_OK;
}

int debug_dump_level() {
  static const int level = [] {
    const char *e = std::getenv("PDMP3_DEBUG_DUMPS");
    return e && *e ? std::atoi(e) : 0;
  }();
  return level;
}

void dump_frame_state(const FrameParser &fp, const pdmp3_granules &g) {
  // format: utils/dumps.py dump_frame (reference dmp_* equivalents)
  const FrameHeader &h = fp.hdr;
  const SideInfo &s = fp.si;
  std::fprintf(stderr,
               "rate %d,sfreq %d,pad %d,mod %d,modext %d,emph %d\n",
               h.bitrate_index, h.sampling_frequency, h.padding_bit,
               h.mode, h.mode_extension, h.emphasis);
  std::fprintf(stderr, "main_data_begin %u\n", s.main_data_begin);
  int nch = h.nch();
  for (int ch = 0; ch < nch; ch++) {
    std::fprintf(stderr, "scfsi %u %u %u %u\n", s.scfsi[ch][0],
                 s.scfsi[ch][1], s.scfsi[ch][2], s.scfsi[ch][3]);
    for (int gr = 0; gr < 2; gr++) {
      std::fprintf(
          stderr,
          "p23l %u,bv %u,gg %u,scfc %u,wsf %u,bt %u,mbf %u,"
          "ts [%u, %u, %u],sbg [%u, %u, %u],r0c %u,r1c %u,pf %u,"
          "scfs %u,c1ts %u,count1 %d\n",
          s.part2_3_length[gr][ch], s.big_values[gr][ch],
          s.global_gain[gr][ch], s.scalefac_compress[gr][ch],
          s.win_switch[gr][ch], s.block_type[gr][ch], s.mixed[gr][ch],
          s.table_select[gr][ch][0], s.table_select[gr][ch][1],
          s.table_select[gr][ch][2], s.subblock_gain[gr][ch][0],
          s.subblock_gain[gr][ch][1], s.subblock_gain[gr][ch][2],
          s.region0_count[gr][ch], s.region1_count[gr][ch],
          s.preflag[gr][ch], s.scalefac_scale[gr][ch],
          s.count1table_select[gr][ch], s.count1[gr][ch]);
    }
  }
  for (int gr = 0; gr < h.ngr(); gr++) {
    for (int ch = 0; ch < nch; ch++) {
      bool short_blk = s.win_switch[gr][ch] && s.block_type[gr][ch] == 2;
      if (short_blk) {
        int lo = s.mixed[gr][ch] ? 3 : 0;
        if (s.mixed[gr][ch]) {
          std::fprintf(stderr, "scfl ");
          for (int b = 0; b < 8; b++)
            std::fprintf(stderr, "%u%s", g.scf_l[gr][ch][b],
                         b == 7 ? "\n" : ",");
        }
        for (int b = lo; b < 12; b++) {
          std::fprintf(stderr, "scfs%d ", b);
          for (int w = 0; w < 3; w++)
            std::fprintf(stderr, "%u%s", g.scf_s[gr][ch][b][w],
                         w == 2 ? "\n" : ",");
        }
      } else {
        std::fprintf(stderr, "scfl ");
        for (int b = 0; b < 21; b++)
          std::fprintf(stderr, "%u%s", g.scf_l[gr][ch][b],
                       b == 20 ? "\n" : ",");
      }
      std::fprintf(stderr, "HUFFMAN\n");
      for (int i = 0; i < 576; i++)
        std::fprintf(stderr, "%d: %d\n", i, (int)g.ix[gr][ch][i]);
    }
  }
}

void dump_samples(const float *x, int stage) {
  // reference dmp_samples fixed-point format (pdmp3.c:953-964)
  std::fprintf(stderr, "SAMPLES%d\n", stage);
  for (int i = 0; i < 576; i++) {
    double v = std::nearbyint((double)x[i] * 32768.0);
    if (v > 32767.0) v = 32767.0;
    if (v < -32768.0) v = -32768.0;
    std::fprintf(stderr, "%d: %d\n", i, (int)v);
  }
}

}  // namespace pdmp3host
