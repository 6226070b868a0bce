// Layer I/II pool wire of coded frames (the port's L12StreamDecoder).
//
// The packer pdmp3_parse_step_wire_l12 (api.cc) requantizes every frame
// on the host and ships f32 subband samples, 9,216 B a Layer II
// slot-frame.  This one ships what they are computed from: the frame's
// body bytes after the header and CRC in a fixed 2,000-byte row (the
// largest body parse_frame_l12 accepts), and per (ch, sb) the allocation
// class, the bit offset of its codes within a group and its three
// scalefactor indices; the card requantizes (K9,
// pdmp3_tpu_torch/csrc/l12_requant.cu) with the same double operations
// as parse_l1 / parse_l2, so the samples are the host's bit for bit.
//
// Per slot-frame (models/l12.py l12_layout):
//   body   [F][n_slots][2000] uint8: bytes past the frame's body are 0
//   side   [F][n_slots][384] uint8: cls [2][32] (0 no allocation, 1..17
//          Layer II class + 1, 18..31 Layer I allocation + 17), scf
//          [2][32][3] (Layer I: its one index three times), off int16
//          [2][32] at byte 256
//   meta   [F][n_slots][4] int16 {nch, sample_rate / 25, layer, family}
//   geom   [F][n_slots][2] int16 {sample section's first bit, a group's
//          bits}: code k of (ch, sb) in group g starts at
//          geom[0] + g * geom[1] + off[ch][sb] (+ k x bits, Layer II
//          ungrouped)
//   active [F][n_slots] int16
// Joint-stereo subbands at or above the bound give ch 1 ch 0's class and
// offset (one code for both) and ch 1's own scalefactors.  An inactive
// slot-frame's body, side and geom rows are zero; its meta row is left
// as it was (the pool keeps the last step's, as for the f32 wire).
//
// The frame route is parse_frame's, through FrameParser's public
// members: header search, free format, the CRC bytes, the body read
// (NEED_MORE on short input, the caller rolls back), the CRC check
// (a corrupt frame's body is consumed and the search restarts), the
// forbidden Layer I allocation and a body too short for its codes (ERR,
// rolled back).  A frame of the other Layer I/II layer is parsed as far
// and skipped; a Layer III frame goes through parse_frame itself from
// its header on.  Nothing here requantizes.

#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

#include "internal.h"

using namespace pdmp3host;

namespace {

constexpr long kBodyBytes = 2000;  // models/l12.py L12_BODY_BYTES
constexpr int kSideBytes = 384;    // models/l12.py L12_SIDE_BYTES
constexpr int kSideScf = 64, kSideOff = 256;
constexpr int kClassL1 = 17;       // Layer I allocation a: class 17 + a
constexpr int kClasses = 32;
constexpr int kWrongLayer = 1;     // a frame of another layer, consumed

// MSB-first reader over a frame body padded with 8 zero bytes; a read
// past the end returns 0 and sets overflow (frame.cc L12BitReader)
struct BodyBits {
  const uint8_t *data;
  long pos = 0, nbits;
  bool overflow = false;
  BodyBits(const uint8_t *d, long nbytes) : data(d), nbits(8 * nbytes) {}
  unsigned get(unsigned nb) {
    if (nb == 0) return 0;
    long end = pos + (long)nb;
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

// frame.cc's l12_bound, l2_table_index, crc16_mpeg, crc16_mpeg_bits and
// l12_protected_bits, which it keeps to itself
int l12_bound(int mode, int mode_ext, int sblimit) {
  if (mode != 1) return sblimit;
  int b = (mode_ext + 1) * 4;
  return b < sblimit ? b : sblimit;
}

int l2_table_index(const FrameHeader &h) {
  if (h.family) return 4;
  long freq = kSampleRates[h.sampling_frequency];
  long kbps = kBitratesL2[h.bitrate_index] / 1000 / h.nch();
  if (h.bitrate_index == 0) return freq == 48000 ? 0 : 1;
  if ((freq == 48000 && kbps >= 56) || (kbps >= 56 && kbps <= 80)) return 0;
  if (freq != 48000 && kbps >= 96) return 1;
  if (freq != 32000 && kbps <= 48) return 2;
  return 3;
}

uint16_t crc16_mpeg(const uint8_t *data, size_t n, uint16_t crc) {
  for (size_t i = 0; i < n; i++) {
    crc = (uint16_t)(crc ^ ((uint16_t)data[i] << 8));
    for (int k = 0; k < 8; k++)
      crc = (uint16_t)((crc & 0x8000) ? (crc << 1) ^ 0x8005 : crc << 1);
  }
  return crc;
}

uint16_t crc16_mpeg_bits(const uint8_t *data, long nbits, uint16_t crc) {
  long nbytes = nbits >> 3, rem = nbits & 7;
  crc = crc16_mpeg(data, (size_t)nbytes, crc);
  for (int i = 0; i < rem; i++) {
    unsigned bit = (data[nbytes] >> (7 - i)) & 1;
    crc = (uint16_t)((((crc >> 15) & 1) ^ bit) ? (crc << 1) ^ 0x8005
                                               : crc << 1);
  }
  return crc;
}

long l12_protected_bits(const FrameHeader &h, const uint8_t *body,
                        long nbytes) {
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

// The frame's allocations and scalefactors, read in parse_l1 /
// parse_l2's order, as the side record and geom; PDMP3_ERR where
// parse_frame_l12 fails (a forbidden Layer I allocation, a body that
// ends before its last code).
int code_side(const FrameHeader &h, const uint8_t *body, long nbytes,
              uint8_t *side, int16_t *geom) {
  BodyBits br(body, nbytes);
  const int nch = h.nch();
  int alloc[2][32] = {};
  int cls[2][32] = {}, off[2][32] = {}, scf[2][32][3] = {};
  int sblimit = 32, bound, glen = 0;
  long start;
  if (h.layer == 1) {
    bound = l12_bound(h.mode, h.mode_extension, 32);
    for (int sb = 0; sb < 32; sb++) {
      if (sb < bound) {
        for (int ch = 0; ch < nch; ch++) alloc[ch][sb] = (int)br.get(4);
      } else {
        alloc[0][sb] = alloc[1][sb] = (int)br.get(4);
      }
    }
    for (int ch = 0; ch < 2; ch++)
      for (int sb = 0; sb < 32; sb++)
        if (alloc[ch][sb] == 15) return PDMP3_ERR;
    for (int sb = 0; sb < 32; sb++)
      for (int ch = 0; ch < nch; ch++)
        if (alloc[ch][sb])
          scf[ch][sb][0] = scf[ch][sb][1] = scf[ch][sb][2] = (int)br.get(6);
    start = br.pos;
    for (int sb = 0; sb < 32; sb++) {
      bool shared = sb >= bound;
      for (int ch = 0; ch < (shared ? 1 : nch); ch++) {
        int a = alloc[ch][sb];
        if (!a) continue;
        cls[ch][sb] = kClassL1 + a;
        off[ch][sb] = glen;
        glen += a + 1;
      }
    }
  } else {
    const int tsel = l2_table_index(h);
    sblimit = kL2Sblimit[tsel];
    bound = l12_bound(h.mode, h.mode_extension, sblimit);
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
    for (int sb = 0; sb < sblimit; sb++)
      for (int ch = 0; ch < nch; ch++) {
        if (!alloc[ch][sb]) continue;
        int *s = scf[ch][sb];
        switch (scfsi[ch][sb]) {
          case 0:
            s[0] = (int)br.get(6);
            s[1] = (int)br.get(6);
            s[2] = (int)br.get(6);
            break;
          case 1:
            s[0] = s[1] = (int)br.get(6);
            s[2] = (int)br.get(6);
            break;
          case 2:
            s[0] = s[1] = s[2] = (int)br.get(6);
            break;
          default:
            s[0] = (int)br.get(6);
            s[1] = s[2] = (int)br.get(6);
            break;
        }
      }
    start = br.pos;
    for (int sb = 0; sb < sblimit; sb++) {
      bool shared = sb >= bound;
      for (int ch = 0; ch < (shared ? 1 : nch); ch++) {
        int a = alloc[ch][sb];
        if (!a) continue;
        int ci = kL2Cls[tsel][sb][a - 1];
        cls[ch][sb] = ci + 1;
        off[ch][sb] = glen;
        glen += kL2ClsGroupSteps[ci] ? kL2ClsBits[ci] : 3 * kL2ClsBits[ci];
      }
    }
  }
  if (br.overflow || start + 12L * glen > br.nbits) return PDMP3_ERR;
  // a shared subband's one code serves both channels
  for (int sb = bound; sb < sblimit && nch == 2; sb++) {
    cls[1][sb] = cls[0][sb];
    off[1][sb] = off[0][sb];
  }
  int16_t off16[2][32];
  for (int ch = 0; ch < 2; ch++)
    for (int sb = 0; sb < 32; sb++) {
      side[ch * 32 + sb] = (uint8_t)cls[ch][sb];
      for (int p = 0; p < 3; p++)
        side[kSideScf + (ch * 32 + sb) * 3 + p] = (uint8_t)scf[ch][sb][p];
      off16[ch][sb] = (int16_t)off[ch][sb];
    }
  std::memcpy(side + kSideOff, off16, sizeof off16);
  geom[0] = (int16_t)start;
  geom[1] = (int16_t)glen;
  return PDMP3_OK;
}

// One frame of handle fp for a pool of `layer`: PDMP3_OK with the
// slot-frame's body, side and geom rows written; kWrongLayer for a frame
// of another layer, consumed as parse_frame consumes it (rows not
// written); else parse_frame's status, and the caller rolls back.
int parse_codes(FrameParser &fp, pdmp3_granules *g, int layer,
                uint8_t *body_row, uint8_t *side, int16_t *geom) {
  for (;;) {
    const size_t pos = fp.in.processed;
    const unsigned mark = fp.in.istart;
    int r = fp.search_header();
    if (r != PDMP3_OK) return r;
    FrameHeader &h = fp.hdr;
    if (h.layer == 3 || !fp.l12_enabled()) {
      // parse_frame's own route from this header on
      fp.in.processed = pos;
      fp.in.istart = mark;
      r = fp.parse_frame(g);
      return r == PDMP3_OK ? kWrongLayer : r;
    }
    if (h.bitrate_index == 0 && fp.free_size == 0) {
      r = fp.measure_free_size();
      if (r != PDMP3_OK) return r;
      h.free_size = (int)fp.free_size;
    }
    int32_t crc_read = -1;
    if (h.protection_bit == 0) {
      uint32_t c1 = fp.in.get_byte();
      uint32_t c2 = fp.in.get_byte();
      if (fp.crc_enabled() && c1 != kEof && c2 != kEof)
        crc_read = (int32_t)((c1 << 8) | c2);
    }
    const long nbytes = h.frame_size() - 4 - (h.protection_bit == 0 ? 2 : 0);
    if (nbytes <= 0 || nbytes > kBodyBytes) return PDMP3_ERR;
    if (fp.in.filled() < (unsigned)nbytes) return PDMP3_NEED_MORE;
    uint8_t body[kBodyBytes + 8];
    fp.in.get_bytes(body, (unsigned)nbytes);
    std::memset(body + nbytes, 0, 8);
    if (crc_read >= 0) {
      uint8_t h2[2] = {(uint8_t)(h.raw16 >> 8), (uint8_t)h.raw16};
      uint16_t crc = crc16_mpeg_bits(body, l12_protected_bits(h, body, nbytes),
                                     crc16_mpeg(h2, 2, 0xFFFF));
      if ((int32_t)crc != crc_read) continue;  // body consumed: next header
    }
    if (code_side(h, body, nbytes, side, geom) != PDMP3_OK) return PDMP3_ERR;
    if (h.layer != layer) return kWrongLayer;
    std::memcpy(body_row, body, (size_t)nbytes);
    std::memset(body_row + nbytes, 0, (size_t)(kBodyBytes - nbytes));
    return PDMP3_OK;
  }
}

int parse_range_codes(pdmp3_handle *const *ids, size_t lo, size_t hi,
                      size_t n_slots, size_t frames, int layer,
                      uint8_t *body, uint8_t *side, int16_t *meta,
                      int16_t *geom, int16_t *active) {
  int n_active = 0;
  pdmp3_granules g;
  for (size_t s = lo; s < hi; s++) {
    pdmp3_handle *id = ids[s];
    size_t f = 0;
    for (; f < frames; f++) {
      const size_t w = f * n_slots + s;
      uint8_t *b = body + w * kBodyBytes;
      uint8_t *sd = side + w * kSideBytes;
      int16_t *gm = geom + w * 2;
      active[w] = 0;
      const auto idle = [&] {
        std::memset(b, 0, (size_t)kBodyBytes);
        std::memset(sd, 0, (size_t)kSideBytes);
        gm[0] = gm[1] = 0;
      };
      // no 2*576 gate: Layer I/II frames can be much smaller
      if (!id || id->fp.in.filled() < 8) {
        idle();
        continue;
      }
      size_t pos0 = id->fp.in.processed;
      unsigned mark0 = id->fp.in.istart;
      int r = parse_codes(id->fp, &g, layer, b, sd, gm);
      if (r == kWrongLayer) {  // consumed: the next frame, next row
        idle();
        continue;
      }
      if (r != PDMP3_OK) {
        id->fp.in.processed = pos0;
        id->fp.in.istart = mark0;
        idle();
        break;
      }
      const FrameHeader &h = id->fp.hdr;
      int16_t *m = meta + w * 4;
      m[0] = (int16_t)h.nch();
      m[1] = (int16_t)(kSampleRatesFam[h.family][h.sampling_frequency] / 25);
      m[2] = (int16_t)h.layer;
      m[3] = (int16_t)h.family;
      active[w] = 1;
      n_active++;
    }
    // a failed parse leaves the slot's later frames of the step inactive
    for (size_t f2 = f + 1; f2 < frames; f2++) {
      const size_t w = f2 * n_slots + s;
      active[w] = 0;
      std::memset(body + w * kBodyBytes, 0, (size_t)kBodyBytes);
      std::memset(side + w * kSideBytes, 0, (size_t)kSideBytes);
      geom[2 * w] = geom[2 * w + 1] = 0;
    }
  }
  return n_active;
}

}  // namespace

extern "C" {

// The coded Layer I/II pool wire (above) for n_slots PDMP3_PROFILE_L12
// handles of one layer, frames_per_step frames a slot, on n_threads
// threads (<= 0: one a core; one below 64 slots) as
// pdmp3_parse_step_wire_l12 splits them.  Returns the number of active
// slot-frames.
int pdmp3_parse_step_wire_l12_codes(pdmp3_handle *const *ids, size_t n_slots,
                                    int n_threads, size_t frames_per_step,
                                    int layer, uint8_t *body, uint8_t *side,
                                    int16_t *meta, int16_t *geom,
                                    int16_t *active) {
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n_slots < 64)
    return parse_range_codes(ids, 0, n_slots, n_slots, frames_per_step,
                             layer, body, side, meta, geom, active);
  std::vector<std::thread> pool;
  std::vector<int> counts((size_t)n_threads, 0);
  size_t chunk = (n_slots + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    size_t lo = (size_t)t * chunk;
    size_t hi = lo + chunk < n_slots ? lo + chunk : n_slots;
    if (lo >= hi) break;
    pool.emplace_back([=, &counts] {
      counts[(size_t)t] = parse_range_codes(ids, lo, hi, n_slots,
                                            frames_per_step, layer, body,
                                            side, meta, geom, active);
    });
  }
  int n_active = 0;
  for (auto &th : pool) th.join();
  for (int c : counts) n_active += c;
  return n_active;
}

// The requantization's tables by class (the side record's cls): cd
// [32][2] double {C, D}, ci [32][4] int32 {codeword bits, steps of a
// grouped codeword (0: ungrouped), fraction bits nb, 0}, scf [64] float
// (kScfL12, then 0).  Class 0 is no allocation (zeros); 1..17 are
// kL2Cls's classes 0..16; 18..31 Layer I's allocations 1..14, nb = a + 1
// bits, C = 2^nb / (2^nb - 1), D = 2^(1 - nb), as parse_l1 computes them.
void pdmp3_l12_requant_tables(double *cd, int32_t *ci, float *scf) {
  std::memset(cd, 0, kClasses * 2 * sizeof(double));
  std::memset(ci, 0, kClasses * 4 * sizeof(int32_t));
  for (int c = 0; c < 17; c++) {
    cd[2 * (c + 1)] = kL2ClsC[c];
    cd[2 * (c + 1) + 1] = kL2ClsD[c];
    ci[4 * (c + 1)] = kL2ClsBits[c];
    ci[4 * (c + 1) + 1] = kL2ClsGroupSteps[c];
    ci[4 * (c + 1) + 2] = kL2ClsNb[c];
  }
  for (int a = 1; a <= 14; a++) {
    const int nb = a + 1, k = kClassL1 + a;
    cd[2 * k] = (double)(1 << nb) / (double)((1 << nb) - 1);
    cd[2 * k + 1] = std::ldexp(1.0, 1 - nb);
    ci[4 * k] = ci[4 * k + 2] = nb;
  }
  for (int i = 0; i < 64; i++) scf[i] = i < 63 ? kScfL12[i] : 0.0f;
}

}  // extern "C"
