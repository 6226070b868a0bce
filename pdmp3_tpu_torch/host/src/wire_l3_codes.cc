// MPEG-1 Layer III pool wire of 4-bit line codes (the port's
// StreamDecoder, family 0).
//
// The packer pdmp3_parse_step_wire16 (api.cc) ships each granule-channel's
// 576 line-ordered spectral values as int16, 1,152 B a row.  Nearly every
// value of a real stream is small: this one ships a 4-bit two's-complement
// code a line and, for the few lines outside -7..7, an escape.  The card
// widens the rows back to int16 (K10, pdmp3_tpu_torch/csrc/l3_expand.cu),
// bit for bit the dense packer's rows.
//
// Sections (models/decoder.py codes_layout), rows r = (f*2 + gr, slot, ch):
//   codes  [F*2][n_slots][2][288] uint8: line 2k in the low nibble of byte
//          k, line 2k + 1 in the high one; a code of -7..7 is the line's
//          value, 0x8 marks an escape
//   starts [F*2][n_slots][2] int32: the row's first escape in esc; its
//          escapes follow in line order
//   scf_l, scf_s, meta, active: pdmp3_parse_step_wire16's, byte for byte
//   esc    [cap] int16: the escapes' values, last in the buffer
// The escape list is ordered by slot, then frame, granule, channel and
// line; a row's start is the exclusive sum of the escapes before it in
// that order, so the wire's bytes do not depend on the thread count.  cap
// must cover the worst case, every line an escape (F*2*n_slots*2*576);
// nothing is ever dropped.  *esc_used returns the escapes written: the
// caller uploads the fixed sections and that prefix of esc (rounded up),
// whose tail it zeroes.
//
// The frame route is parse_range16's (api.cc): the same ring gate,
// parse_frame with the long-block channels decoded straight into the
// row, the short-block reorder, a mono frame's channel 1 zero, the same
// rollback; an LSF or Layer I/II frame is skipped without rollback.  An
// inactive slot-frame's codes are zero and it has no escapes; its
// scf_l, scf_s and meta rows are left as they were, as the dense packer
// leaves them.

#include <cstring>
#include <thread>
#include <vector>

#include "internal.h"

using namespace pdmp3host;

namespace {

constexpr int kLines = 576;
constexpr int kCodeBytes = kLines / 2;  // models/decoder.py CODE_BYTES
constexpr unsigned kEscape = 0x8;

// api.cc's copy_ix_short_tab for family 0: the short-block reorder as
// three stride-1 runs a band interleaved into stride-3 destinations
void copy_ix_short(int16_t *dst, const int16_t *src, const int *S,
                   bool mixed) {
  int b0 = 0;
  if (mixed) {
    std::memcpy(dst, src, (size_t)(3 * S[3]) * sizeof(int16_t));
    b0 = 3;
  }
  for (int b = b0; b < 13; b++) {
    int lo = S[b], w = S[b + 1] - lo;
    const int16_t *s0 = src + 3 * lo, *s1 = s0 + w, *s2 = s1 + w;
    int16_t *d = dst + 3 * lo;
    for (int k = 0; k < w; k++) {
      d[3 * k] = s0[k];
      d[3 * k + 1] = s1[k];
      d[3 * k + 2] = s2[k];
    }
  }
}

// api.cc's write_scf_meta16, which it keeps to itself
void write_scf_meta16(const pdmp3_granules &g, int gr, int16_t *pl,
                      int16_t *ps, int16_t *m) {
  for (int ch = 0; ch < 2; ch++) {
    for (int k = 0; k < 22; k++)
      pl[ch * 22 + k] = (int16_t)g.scf_l[gr][ch][k];
    const uint8_t *src = &g.scf_s[gr][ch][0][0];
    for (int k = 0; k < 39; k++) ps[ch * 39 + k] = (int16_t)src[k];
    m[PDMP3_META_LAYOUT + ch] = (int16_t)g.layout[gr][ch];
    m[PDMP3_META_BLOCK_TYPE + ch] = (int16_t)g.block_type[gr][ch];
    m[PDMP3_META_WIN_SWITCH + ch] = (int16_t)g.win_switch[gr][ch];
    m[PDMP3_META_MIXED + ch] = (int16_t)g.mixed[gr][ch];
    m[PDMP3_META_GLOBAL_GAIN + ch] = (int16_t)g.global_gain[gr][ch];
    m[PDMP3_META_SCALEFAC_SCALE + ch] = (int16_t)g.scalefac_scale[gr][ch];
    m[PDMP3_META_PREFLAG + ch] = (int16_t)g.preflag[gr][ch];
    m[PDMP3_META_COUNT1 + ch] = (int16_t)g.count1[gr][ch];
    for (int w = 0; w < 3; w++)
      m[PDMP3_META_SUBBLOCK_GAIN + ch * 3 + w] =
          (int16_t)g.subblock_gain[gr][ch][w];
  }
  m[PDMP3_META_MS] = (int16_t)g.ms_flag;
  m[PDMP3_META_IS] = (int16_t)g.is_flag;
  m[PDMP3_META_NCH] = (int16_t)g.nch;
  m[PDMP3_META_SAMPLE_RATE] = (int16_t)(g.sample_rate / 25);
  m[PDMP3_META_FAMILY] = (int16_t)g.family;
  m[PDMP3_META_ISCALE] = (int16_t)g.iscale;
}

// One row of 576 lines as codes; its escapes appended at esc[*n], in
// line order.  The codes first, without a branch; then the escapes, 8
// lines (4 code bytes, little-endian: nibble j is line 8c + j) at a
// time, a chunk without a code of 8 skipped by the nibble test K10 uses.
void encode_row(const int16_t *line, uint8_t *code, int16_t *esc,
                long long *n) {
  for (int k = 0; k < kCodeBytes; k++) {
    const int v0 = line[2 * k], v1 = line[2 * k + 1];
    const unsigned n0 = (unsigned)(v0 + 7) > 14u ? kEscape : v0 & 0xF;
    const unsigned n1 = (unsigned)(v1 + 7) > 14u ? kEscape : v1 & 0xF;
    code[k] = (uint8_t)(n0 | (n1 << 4));
  }
  for (int c = 0; c < kCodeBytes / 4; c++) {
    uint32_t w;
    std::memcpy(&w, code + 4 * c, 4);
    const uint32_t x = w ^ 0x88888888u;  // a nibble of 8 becomes 0
    uint32_t mark = ~(((x & 0x77777777u) + 0x77777777u) | x) & 0x88888888u;
    while (mark) {
      esc[(*n)++] = line[8 * c + __builtin_ctz(mark) / 4];
      mark &= mark - 1;
    }
  }
}

// Slots [lo, hi): their escapes go to esc from index base on, their rows'
// starts count from base; returns (active slot-frames, escapes written)
struct RangeOut {
  int n_active = 0;
  long long n_esc = 0;
};

RangeOut parse_range_codes(pdmp3_handle *const *ids, size_t lo, size_t hi,
                           size_t n_slots, size_t frames, uint8_t *codes,
                           int32_t *starts, int16_t *scf_l, int16_t *scf_s,
                           int16_t *meta, int16_t *active, int16_t *esc,
                           long long base) {
  const size_t gstride = n_slots * 2;  // rows of one granule
  RangeOut out;
  long long n = 0;                     // escapes of this range so far
  pdmp3_granules g;
  int16_t rows[2][2][kLines];
  int16_t *dst[2][2] = {{rows[0][0], rows[0][1]}, {rows[1][0], rows[1][1]}};
  for (size_t s = lo; s < hi; s++) {
    pdmp3_handle *id = ids[s];
    bool failed = false;
    for (size_t f = 0; f < frames; f++) {
      const size_t r0 = (2 * f) * gstride + s * 2;  // granule 0, ch 0
      active[f * n_slots + s] = 0;
      bool ok = false;
      if (!failed && id && id->fp.in.filled() >= 2 * 576) {
        size_t pos0 = id->fp.in.processed;
        unsigned mark0 = id->fp.in.istart;
        if (id->fp.parse_frame(&g, dst) != PDMP3_OK) {
          id->fp.in.processed = pos0;
          id->fp.in.istart = mark0;
          failed = true;  // the slot's later frames stay inactive
        } else {
          ok = !g.family && g.layer == 3;  // else skipped, no rollback
        }
      }
      for (int gr = 0; gr < 2; gr++) {
        const size_t r = r0 + (size_t)gr * gstride;
        if (!ok) {
          std::memset(codes + r * kCodeBytes, 0, 2 * kCodeBytes);
          starts[r] = starts[r + 1] = (int32_t)(base + n);
          continue;
        }
        for (int ch = 0; ch < g.nch; ch++) {
          unsigned lay = (unsigned)g.layout[gr][ch];
          if (lay <= 8 && lay % 3 != 0)
            copy_ix_short(dst[gr][ch], g.ix[gr][ch], kSfbShort[lay / 3],
                          lay % 3 == 2);
        }
        if (g.nch == 1) std::memset(dst[gr][1], 0, sizeof rows[gr][1]);
        for (int ch = 0; ch < 2; ch++) {
          starts[r + ch] = (int32_t)(base + n);
          encode_row(dst[gr][ch], codes + (r + ch) * kCodeBytes, esc, &n);
        }
        write_scf_meta16(g, gr, scf_l + r * 22, scf_s + r * 39,
                         meta + (r / 2) * PDMP3_META_WORDS);
      }
      if (ok) {
        active[f * n_slots + s] = 1;
        out.n_active++;
      }
    }
  }
  out.n_esc = n;
  return out;
}

}  // namespace

extern "C" {

// The coded MPEG-1 pool wire (above) for n_slots handles, frames_per_step
// frames a slot, on n_threads threads (<= 0: one a core; one below 64
// slots) as pdmp3_parse_step_wire16 splits them.  Each thread writes its
// slots' escapes at the list position of its first slot's worst case and
// counts its starts from there; after the join each range moves down to
// the exclusive sum of the ranges before it, in slot order.  Returns the
// number of active slot-frames; *esc_used the escapes in the list.
int pdmp3_parse_step_wire_l3_codes(pdmp3_handle *const *ids, size_t n_slots,
                                   int n_threads, size_t frames_per_step,
                                   uint8_t *codes, int32_t *starts,
                                   int16_t *scf_l, int16_t *scf_s,
                                   int16_t *meta, int16_t *active,
                                   int16_t *esc, long long *esc_used) {
  // the worst case of one slot's rows: every line an escape
  const long long per_slot = (long long)frames_per_step * 2 * 2 * kLines;
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n_slots < 64) {
    RangeOut o = parse_range_codes(ids, 0, n_slots, n_slots, frames_per_step,
                                   codes, starts, scf_l, scf_s, meta, active,
                                   esc, 0);
    if (esc_used) *esc_used = o.n_esc;
    return o.n_active;
  }
  std::vector<std::thread> pool;
  std::vector<RangeOut> outs((size_t)n_threads);
  std::vector<size_t> los((size_t)n_threads, 0), his((size_t)n_threads, 0);
  size_t chunk = (n_slots + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    size_t lo = (size_t)t * chunk;
    size_t hi = lo + chunk < n_slots ? lo + chunk : n_slots;
    if (lo >= hi) break;
    los[(size_t)t] = lo;
    his[(size_t)t] = hi;
    pool.emplace_back([=, &outs] {
      long long at = (long long)lo * per_slot;
      outs[(size_t)t] = parse_range_codes(
          ids, lo, hi, n_slots, frames_per_step, codes, starts, scf_l, scf_s,
          meta, active, esc + at, at);
    });
  }
  for (auto &th : pool) th.join();
  int n_active = 0;
  long long total = 0;
  for (size_t t = 0; t < pool.size(); t++) {
    const long long at = (long long)los[t] * per_slot;
    const long long shift = at - total;  // >= 0: ranges only move down
    if (shift) {
      std::memmove(esc + total, esc + at,
                   (size_t)outs[t].n_esc * sizeof(int16_t));
      for (size_t r = 0; r < 2 * frames_per_step; r++)
        for (size_t s = los[t]; s < his[t]; s++) {
          int32_t *st = starts + (r * n_slots + s) * 2;
          st[0] = (int32_t)(st[0] - shift);
          st[1] = (int32_t)(st[1] - shift);
        }
    }
    total += outs[t].n_esc;
    n_active += outs[t].n_active;
  }
  if (esc_used) *esc_used = total;
  return n_active;
}

}  // extern "C"
