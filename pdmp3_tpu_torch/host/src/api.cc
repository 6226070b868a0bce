// libmpg123-subset streaming API + CLI player (native).
//
// Return-code protocol, input-cursor rollback, NEW_FORMAT handshake and
// partial-frame draining match the reference (pdmp3.c:2301-2535,
// 2540-2589).  Sinks are runtime-selected (instead of the reference's
// compile-time OUTPUT_SOUND/OUTPUT_RAW): <file>.raw / stdout by default,
// OSS /dev/dsp when a device argument is given (pdmp3.c:2222-2298).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <new>
#include <type_traits>
#include <thread>
#include <vector>

#include "internal.h"

using namespace pdmp3host;

#ifdef PDMP3_PARSE_STATS
extern "C" {
extern unsigned long long pdmp3_cyc_pack, pdmp3_cyc_frame;
}
#define PDMP3_TSC(dst, expr) do { \
    unsigned long long t0_ = __builtin_ia32_rdtsc(); \
    expr; \
    dst += __builtin_ia32_rdtsc() - t0_; \
  } while (0)
#else
#define PDMP3_TSC(dst, expr) expr
#endif

// The device wire carries *line-ordered* spectra: the short-block reorder
// (pdmp3.c:1786-1823) is folded into this copy as a table-driven gather,
// so the device never pays the [B,2,576] permutation (requantize reads
// constant maps precomposed with kReorderSrc, ops/dsp.py).  Long-block
// layouts (0,3,6) are the identity and keep the memcpy fast path.
// Structured short-block gather: within each short sfb the raw
// (Huffman-order) layout is [win][k] and line order is [k][win], so the
// permutation is three stride-1 source runs interleaving into stride-3
// destinations — a vectorizable pattern, vs. the 576 dependent loads of
// a table-driven gather.  Verified against kReorderSrc by the frontend
// parity tests (the Python packer still uses the table).
static inline void copy_ix_short_tab(int16_t *dst, const int16_t *src,
                                     const int *S, bool mixed) {
  int b0 = 0;
  if (mixed) {  // long region stays in place (pdmp3.c:1791-1798); its
    // extent is 3*S[3] lines: 36 except 8 kHz LSF, where it is 72
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

static inline void copy_ix_short(int16_t *dst, const int16_t *src, int sf,
                                 bool mixed) {
  copy_ix_short_tab(dst, src, kSfbShort[sf], mixed);
}

static inline void copy_ix_wire(int16_t *dst, const int16_t *src,
                                int layout) {
  unsigned lay = (unsigned)layout;
  if (lay > 8 || lay % 3 == 0) {  // identity (or inactive-channel junk)
    std::memcpy(dst, src, 576 * sizeof(int16_t));
    return;
  }
  copy_ix_short(dst, src, (int)(lay / 3), lay % 3 == 2);
}

extern "C" {

pdmp3_handle *pdmp3_new(const char *decoder, int *error) {
  (void)decoder;
  pdmp3_handle *h = new (std::nothrow) pdmp3_handle();
  if (error) *error = h ? PDMP3_OK : PDMP3_ERR;
  return h;
}

void pdmp3_delete(pdmp3_handle *id) { delete id; }

int pdmp3_open_feed(pdmp3_handle *id) {
  if (!id) return PDMP3_ERR;
  id->fp.reset();
  id->dsp.reset();
  id->ostart = 0;
  id->owords = 2 * 576;
  return PDMP3_OK;
}

int pdmp3_feed(pdmp3_handle *id, const unsigned char *in, size_t size) {
  if (!id || !in || !size) return PDMP3_ERR;
  return id->fp.in.feed(in, size);
}

unsigned pdmp3_inbuf_filled(pdmp3_handle *id) { return id->fp.in.filled(); }
unsigned pdmp3_inbuf_free(pdmp3_handle *id) { return id->fp.in.free_space(); }

long long pdmp3_feed_loop(pdmp3_handle *const *ids, size_t n,
                          const unsigned char *const *srcs,
                          const size_t *src_len, size_t *pos) {
  // Top up every ring from its looping source buffer in ONE call — the
  // serving/bench feeder (a per-slot Python feed loop costs more than
  // the parse itself at 400k frames/s).  Stays a byte short of
  // exactly-full: istart == iend is indistinguishable from empty
  // (pdmp3.c:1062-1068).
  long long total = 0;
  for (size_t s = 0; s < n; s++) {
    pdmp3_handle *id = ids[s];
    if (!id || !srcs[s] || !src_len[s]) continue;
    for (;;) {
      unsigned free_b = id->fp.in.free_space();
      if (free_b < 2) break;
      if (pos[s] >= src_len[s]) pos[s] = 0;  // loop (resync at seam)
      size_t take = src_len[s] - pos[s];
      if (take > free_b - 1) take = free_b - 1;
      if (id->fp.in.feed(srcs[s] + pos[s], take) != PDMP3_OK) break;
      pos[s] += take;
      total += (long long)take;
    }
  }
  return total;
}

static_assert(std::is_trivially_copyable<pdmp3_handle>::value,
              "handle must remain a flat state blob for checkpoint/resume");

size_t pdmp3_state_size(void) { return sizeof(pdmp3_handle); }
void pdmp3_state_save(const pdmp3_handle *id, void *buf) {
  std::memcpy(buf, id, sizeof(pdmp3_handle));
}
void pdmp3_state_restore(pdmp3_handle *id, const void *buf) {
  std::memcpy(id, buf, sizeof(pdmp3_handle));
}

int pdmp3_parse_frame(pdmp3_handle *id, pdmp3_granules *g) {
  if (!id || !g) return PDMP3_ERR;
  if (id->fp.id3_enabled()) id->fp.skip_id3();  // before the snapshot
  size_t pos = id->fp.in.processed;
  unsigned mark = id->fp.in.istart;
  int r = id->fp.parse_frame(g);
  if (r != PDMP3_OK) {
    id->fp.in.processed = pos;
    id->fp.in.istart = mark;
  }
  return r;
}

void pdmp3_dsp_frame(pdmp3_handle *id, const pdmp3_granules *g,
                     uint32_t out_words[2][576]) {
  id->dsp.decode_frame(*g, out_words, id->fp.profile);
}

void pdmp3_set_profile(pdmp3_handle *id, unsigned flags) {
  if (id) id->fp.profile = flags;
}

unsigned pdmp3_get_profile(const pdmp3_handle *id) {
  return id ? id->fp.profile : 0;
}

int pdmp3_parse_frame_soa(pdmp3_handle *id, size_t slot, size_t n_slots,
                          int16_t *ix, uint8_t *scf_l, uint8_t *scf_s,
                          int32_t *meta) {
  pdmp3_granules g;
  int r = pdmp3_parse_frame(id, &g);
  if (r != PDMP3_OK) return r;
  for (int gr = 0; gr < 2; gr++) {
    size_t base = ((size_t)gr * n_slots + slot);
    for (int ch = 0; ch < 2; ch++)
      copy_ix_wire(ix + base * 2 * 576 + ch * 576, g.ix[gr][ch],
                   g.layout[gr][ch]);
    std::memcpy(scf_l + base * 2 * 22, g.scf_l[gr], sizeof g.scf_l[gr]);
    std::memcpy(scf_s + base * 2 * 39, g.scf_s[gr], sizeof g.scf_s[gr]);
    int32_t *m = meta + base * PDMP3_META_WORDS;
    for (int ch = 0; ch < 2; ch++) {
      m[PDMP3_META_LAYOUT + ch] = g.layout[gr][ch];
      m[PDMP3_META_BLOCK_TYPE + ch] = g.block_type[gr][ch];
      m[PDMP3_META_WIN_SWITCH + ch] = g.win_switch[gr][ch];
      m[PDMP3_META_MIXED + ch] = g.mixed[gr][ch];
      m[PDMP3_META_GLOBAL_GAIN + ch] = g.global_gain[gr][ch];
      m[PDMP3_META_SCALEFAC_SCALE + ch] = g.scalefac_scale[gr][ch];
      m[PDMP3_META_PREFLAG + ch] = g.preflag[gr][ch];
      m[PDMP3_META_COUNT1 + ch] = g.count1[gr][ch];
      for (int w = 0; w < 3; w++)
        m[PDMP3_META_SUBBLOCK_GAIN + ch * 3 + w] =
            g.subblock_gain[gr][ch][w];
    }
    m[PDMP3_META_MS] = g.ms_flag;
    m[PDMP3_META_IS] = g.is_flag;
    m[PDMP3_META_NCH] = g.nch;
    m[PDMP3_META_SAMPLE_RATE] = g.sample_rate;
    m[PDMP3_META_FAMILY] = g.family;
    m[PDMP3_META_ISCALE] = g.iscale;
  }
  return PDMP3_OK;
}

long pdmp3_parse_stream(pdmp3_handle *id, const unsigned char *data,
                        size_t size, size_t max_frames, int16_t *ix,
                        uint8_t *scf_l, uint8_t *scf_s, int32_t *meta) {
  if (!id) return -1;
  pdmp3_open_feed(id);
  size_t pos = 0, t = 0;
  while (t < max_frames) {
    while (pos < size) {
      unsigned free_b = id->fp.in.free_space();
      if (free_b < 4096) break;
      // never fill the ring completely: istart == iend is indistinguishable
      // from empty (reference parity, pdmp3.c:1062-1068), so an exactly-full
      // ring would read back as 0 bytes and lose the whole buffer
      size_t n = size - pos < free_b - 1 ? size - pos : free_b - 1;
      if (n > 8192) n = 8192;
      if (pdmp3_feed(id, data + pos, n) != PDMP3_OK) break;
      pos += n;
    }
    int r = pdmp3_parse_frame_soa(id, t, max_frames, ix, scf_l, scf_s,
                                  meta);
    if (r == PDMP3_OK) {
      t++;
      continue;
    }
    if (r == PDMP3_ERR) break;
    if (pos >= size || id->fp.in.free_space() == 0) break;  // starved
  }
  return (long)t;
}

// int16 wire variant: every section (spectra, scalefacs, meta, active) is
// int16 so the device consumes the single uploaded buffer with pure
// slicing — no byte recombination (which tiles catastrophically on TPU).
static void write_scf_meta16(const pdmp3_granules &g, int gr, int16_t *pl,
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

static int parse_range16(pdmp3_handle *const *ids, size_t lo, size_t hi,
                         size_t n_slots, size_t frames, int16_t *ix,
                         int16_t *scf_l, int16_t *scf_s, int16_t *meta,
                         int16_t *active) {
  const size_t six = 2 * n_slots * 2 * 576;
  const size_t sl = 2 * n_slots * 2 * 22;
  const size_t ss = 2 * n_slots * 2 * 39;
  const size_t sm = 2 * n_slots * PDMP3_META_WORDS;
  int n_active = 0;
  pdmp3_granules g;
  for (size_t s = lo; s < hi; s++) {
    pdmp3_handle *id = ids[s];
    for (size_t f = 0; f < frames; f++) {
      active[f * n_slots + s] = 0;
      if (!id || id->fp.in.filled() < 2 * 576) continue;
      // long-block channels decode straight into the wire (identity
      // layout); only short/mixed channels pay the reorder gather below
      int16_t *dst[2][2];
      for (int gr = 0; gr < 2; gr++) {
        size_t base = f * six + (size_t)gr * n_slots * 2 * 576 +
                      s * 2 * 576;
        dst[gr][0] = ix + base;
        dst[gr][1] = ix + base + 576;
      }
      size_t pos0 = id->fp.in.processed;
      unsigned mark0 = id->fp.in.istart;
      int pr_;
      PDMP3_TSC(pdmp3_cyc_frame, pr_ = id->fp.parse_frame(&g, dst));
      if (pr_ != PDMP3_OK) {
        id->fp.in.processed = pos0;
        id->fp.in.istart = mark0;
        // later frames stay inactive (double-buffered wire: stale
        // active entries are the previous step's values)
        for (size_t f2 = f + 1; f2 < frames; f2++)
          active[f2 * n_slots + s] = 0;
        break;
      }
      if (g.family || g.layer != 3) {
        // an LSF or Layer I/II frame in a dense MPEG-1 pool (only
        // reachable when the caller set PDMP3_PROFILE_LSF/_L12 on a
        // dense-pool handle): the wire has no layout for it — skip the
        // frame WITHOUT rollback (a rollback would re-parse it
        // forever); the slot stays inactive this step.  LSF pools use
        // the _lsf packer, Layer I/II pools the _l12 packer.
        continue;
      }
      PDMP3_TSC(pdmp3_cyc_pack, {
      for (int gr = 0; gr < 2; gr++) {
        for (int ch = 0; ch < g.nch; ch++) {
          unsigned lay = (unsigned)g.layout[gr][ch];
          if (lay <= 8 && lay % 3 != 0)
            copy_ix_short(dst[gr][ch], g.ix[gr][ch], (int)(lay / 3),
                          lay % 3 == 2);
        }
        if (g.nch == 1)
          std::memset(dst[gr][1], 0, 576 * sizeof(int16_t));
        write_scf_meta16(
            g, gr, scf_l + f * sl + ((size_t)gr * n_slots + s) * 2 * 22,
            scf_s + f * ss + ((size_t)gr * n_slots + s) * 2 * 39,
            meta + f * sm + ((size_t)gr * n_slots + s) * PDMP3_META_WORDS);
      }});
      active[f * n_slots + s] = 1;
      n_active++;
    }
  }
  return n_active;
}

int pdmp3_parse_step_wire16(pdmp3_handle *const *ids, size_t n_slots,
                            int n_threads, size_t frames_per_step,
                            int16_t *ix, int16_t *scf_l, int16_t *scf_s,
                            int16_t *meta, int16_t *active) {
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n_slots < 64)
    return parse_range16(ids, 0, n_slots, n_slots, frames_per_step, ix,
                         scf_l, scf_s, meta, active);
  std::vector<std::thread> pool;
  std::vector<int> counts((size_t)n_threads, 0);
  size_t chunk = (n_slots + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    size_t lo = (size_t)t * chunk;
    size_t hi = lo + chunk < n_slots ? lo + chunk : n_slots;
    if (lo >= hi) break;
    pool.emplace_back([=, &counts] {
      counts[(size_t)t] = parse_range16(ids, lo, hi, n_slots,
                                        frames_per_step, ix, scf_l, scf_s,
                                        meta, active);
    });
  }
  int n_active = 0;
  for (auto &th : pool) th.join();
  for (int c : counts) n_active += c;
  return n_active;
}

// LSF pool packer (see pdmp3.h): one granule per frame, so sections drop
// the granule axis; carries the intensity-stereo sidecar + family/iscale
// meta.  Handles must have PDMP3_PROFILE_LSF; frames of a different
// family than the pool's first-seen one are skipped without rollback.
static int parse_range16_lsf(pdmp3_handle *const *ids, size_t lo,
                             size_t hi, size_t n_slots, size_t frames,
                             int16_t *ix, int16_t *scf_l, int16_t *scf_s,
                             int16_t *meta, int16_t *is_pos,
                             int16_t *active) {
  const size_t six = n_slots * 2 * 576;
  const size_t sl = n_slots * 2 * 22;
  const size_t ss = n_slots * 2 * 39;
  const size_t sm = n_slots * PDMP3_META_WORDS;
  const size_t sp = n_slots * 64;
  int n_active = 0;
  pdmp3_granules g;
  int16_t scratch[2][576];  // gr-1 sink if a stray MPEG-1 frame decodes
  for (size_t s = lo; s < hi; s++) {
    pdmp3_handle *id = ids[s];
    for (size_t f = 0; f < frames; f++) {
      active[f * n_slots + s] = 0;
      if (!id || id->fp.in.filled() < 2 * 576) continue;
      size_t base = f * six + s * 2 * 576;
      int16_t *dst[2][2] = {{ix + base, ix + base + 576},
                            {scratch[0], scratch[1]}};
      size_t pos0 = id->fp.in.processed;
      unsigned mark0 = id->fp.in.istart;
      int pr_;
      PDMP3_TSC(pdmp3_cyc_frame, pr_ = id->fp.parse_frame(&g, dst));
      if (pr_ != PDMP3_OK) {
        id->fp.in.processed = pos0;
        id->fp.in.istart = mark0;
        for (size_t f2 = f + 1; f2 < frames; f2++)
          active[f2 * n_slots + s] = 0;
        break;
      }
      if (!g.family || g.layer != 3)
        continue;  // stray MPEG-1 / Layer I/II frame: skip, no rollback
      PDMP3_TSC(pdmp3_cyc_pack, {
        for (int ch = 0; ch < g.nch; ch++) {
          unsigned lay = (unsigned)g.layout[0][ch];
          if (lay <= 8 && lay % 3 != 0)
            copy_ix_short_tab(dst[0][ch], g.ix[0][ch],
                              kSfbShortFam[g.family][lay / 3],
                              lay % 3 == 2);
        }
        if (g.nch == 1) std::memset(dst[0][1], 0, 576 * sizeof(int16_t));
        write_scf_meta16(g, 0, scf_l + f * sl + s * 2 * 22,
                         scf_s + f * ss + s * 2 * 39,
                         meta + f * sm + s * PDMP3_META_WORDS);
        int16_t *ip = is_pos + f * sp + s * 64;
        std::memcpy(ip, g.is_pos_l, sizeof g.is_pos_l);
        std::memcpy(ip + 22, g.is_pos_s, sizeof g.is_pos_s);
        ip[61] = ip[62] = ip[63] = 0;
      });
      active[f * n_slots + s] = 1;
      n_active++;
    }
  }
  return n_active;
}

int pdmp3_parse_step_wire16_lsf(pdmp3_handle *const *ids, size_t n_slots,
                                int n_threads, size_t frames_per_step,
                                int16_t *ix, int16_t *scf_l,
                                int16_t *scf_s, int16_t *meta,
                                int16_t *is_pos, int16_t *active) {
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n_slots < 64)
    return parse_range16_lsf(ids, 0, n_slots, n_slots, frames_per_step,
                             ix, scf_l, scf_s, meta, is_pos, active);
  std::vector<std::thread> pool;
  std::vector<int> counts((size_t)n_threads, 0);
  size_t chunk = (n_slots + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    size_t lo = (size_t)t * chunk;
    size_t hi = lo + chunk < n_slots ? lo + chunk : n_slots;
    if (lo >= hi) break;
    pool.emplace_back([=, &counts] {
      counts[(size_t)t] = parse_range16_lsf(ids, lo, hi, n_slots,
                                            frames_per_step, ix, scf_l,
                                            scf_s, meta, is_pos, active);
    });
  }
  int n_active = 0;
  for (auto &th : pool) th.join();
  for (int c : counts) n_active += c;
  return n_active;
}

// Layer I/II pool wire: frontend-requantized float subband samples
// (PDMP3_PROFILE_L12 handles; one layer per pool — S = 12 or 36
// synthesis steps).  Frames of any OTHER layer are consumed and
// skipped like the LSF packer's stray-MPEG-1 rule.
static int parse_range_l12(pdmp3_handle *const *ids, size_t lo, size_t hi,
                           size_t n_slots, size_t frames, int layer,
                           float *sb, int16_t *meta, int16_t *active) {
  const size_t S = layer == 1 ? 12 : 36;
  const size_t ssb = n_slots * 2 * S * 32;
  const size_t sm = n_slots * 4;
  int n_active = 0;
  pdmp3_granules g;
  for (size_t s = lo; s < hi; s++) {
    pdmp3_handle *id = ids[s];
    for (size_t f = 0; f < frames; f++) {
      active[f * n_slots + s] = 0;
      // no 2*576 gate: Layer I/II frames can be much smaller (the
      // parse returns NEED_MORE + rollback on short input)
      if (!id || id->fp.in.filled() < 8) continue;
      size_t pos0 = id->fp.in.processed;
      unsigned mark0 = id->fp.in.istart;
      int pr = id->fp.parse_frame(&g);
      if (pr != PDMP3_OK) {
        id->fp.in.processed = pos0;
        id->fp.in.istart = mark0;
        for (size_t f2 = f + 1; f2 < frames; f2++)
          active[f2 * n_slots + s] = 0;
        break;
      }
      if (g.layer != layer) continue;  // wrong-layer frame: skip
      float *d = sb + f * ssb + s * 2 * S * 32;
      std::memcpy(d, g.sb_samples[0], S * 32 * sizeof(float));
      std::memcpy(d + S * 32, g.sb_samples[1], S * 32 * sizeof(float));
      int16_t *m = meta + f * sm + s * 4;
      m[0] = (int16_t)g.nch;
      m[1] = (int16_t)(g.sample_rate / 25);
      m[2] = (int16_t)g.layer;
      m[3] = (int16_t)g.family;
      active[f * n_slots + s] = 1;
      n_active++;
    }
  }
  return n_active;
}

int pdmp3_parse_step_wire_l12(pdmp3_handle *const *ids, size_t n_slots,
                              int n_threads, size_t frames_per_step,
                              int layer, float *sb, int16_t *meta,
                              int16_t *active) {
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n_slots < 64)
    return parse_range_l12(ids, 0, n_slots, n_slots, frames_per_step,
                           layer, sb, meta, active);
  std::vector<std::thread> pool;
  std::vector<int> counts((size_t)n_threads, 0);
  size_t chunk = (n_slots + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    size_t lo = (size_t)t * chunk;
    size_t hi = lo + chunk < n_slots ? lo + chunk : n_slots;
    if (lo >= hi) break;
    pool.emplace_back([=, &counts] {
      counts[(size_t)t] = parse_range_l12(ids, lo, hi, n_slots,
                                          frames_per_step, layer, sb,
                                          meta, active);
    });
  }
  int n_active = 0;
  for (auto &th : pool) th.join();
  for (int c : counts) n_active += c;
  return n_active;
}

// Sparse LSF pool wire: count1-bounded blocks over the one-granule
// layout (family band maps for the reorder + perm bound).
static int parse_range16_lsf_sparse(
    pdmp3_handle *const *ids, size_t lo, size_t hi, size_t n_slots,
    size_t frames, int16_t *ix_flat, size_t cap_blocks,
    std::atomic<long long> *cursor, int16_t *blk, int16_t *scf_l,
    int16_t *scf_s, int16_t *meta, int16_t *is_pos, int16_t *active) {
  const size_t sb = n_slots * 2 * 4;
  const size_t sl = n_slots * 2 * 22;
  const size_t ss = n_slots * 2 * 39;
  const size_t sm = n_slots * PDMP3_META_WORDS;
  const size_t sp = n_slots * 64;
  int n_active = 0;
  pdmp3_granules g;
  for (size_t s = lo; s < hi; s++) {
    pdmp3_handle *id = ids[s];
    for (size_t f = 0; f < frames; f++) {
      active[f * n_slots + s] = 0;
      int pr = (id && id->fp.in.filled() >= 2 * 576)
                   ? pdmp3_parse_frame(id, &g)
                   : PDMP3_NEED_MORE;
      // a stray MPEG-1 frame (parse OK, family 0) was CONSUMED: skip it
      // without rollback and try this frame slot's next... frame rows
      // stay inactive either way (see the dense packer)
      bool skip_mpeg1 = pr == PDMP3_OK && (g.family == 0 || g.layer != 3);
      int16_t *e = blk + f * sb + s * 2 * 4;
      if (pr != PDMP3_OK || skip_mpeg1) {
        std::memset(e, 0, 2 * 4 * sizeof(int16_t));
        if (skip_mpeg1) continue;
        for (size_t f2 = f + 1; f2 < frames; f2++) {
          active[f2 * n_slots + s] = 0;
          std::memset(blk + f2 * sb + s * 2 * 4, 0,
                      2 * 4 * sizeof(int16_t));
        }
        break;
      }
      const pdmp3host::LayoutMaps &lm = pdmp3host::layout_maps(g.family);
      for (int ch = 0; ch < 2; ch++, e += 4) {
        int c1 = ch < g.nch ? (int)g.count1[0][ch] : 0;
        if (c1 < 0) c1 = 0;
        if (c1 > 576) c1 = 576;
        unsigned lay = (unsigned)g.layout[0][ch];
        int bound = lay <= 8 ? (int)lm.perm_bound[lay][c1] : c1;
        int nb = (bound + 127) / 128;
        long long start = 0;
        if (nb) {
          start = cursor->fetch_add(nb);
          if (start + nb > (long long)cap_blocks) {  // saturate (see
            nb = 0;                                  // dense packer)
            start = 0;
          }
        }
        if (nb) {
          int n16 = nb * 128 < 576 ? nb * 128 : 576;
          int16_t *dst = ix_flat + start * 128;
          if (lay > 8 || lay % 3 == 0) {
            std::memcpy(dst, g.ix[0][ch], (size_t)n16 * sizeof(int16_t));
          } else {
            const int16_t *p = lm.reorder[lay];
            for (int i = 0; i < n16; i++) dst[i] = g.ix[0][ch][p[i]];
          }
          if (nb * 128 > 576)
            std::memset(ix_flat + start * 128 + 576, 0,
                        (size_t)(nb * 128 - 576) * sizeof(int16_t));
        }
        e[0] = (int16_t)(start & 0xFFFF);
        e[1] = (int16_t)(start >> 16);
        e[2] = (int16_t)nb;
        e[3] = 0;
      }
      write_scf_meta16(g, 0, scf_l + f * sl + s * 2 * 22,
                       scf_s + f * ss + s * 2 * 39,
                       meta + f * sm + s * PDMP3_META_WORDS);
      int16_t *ip = is_pos + f * sp + s * 64;
      std::memcpy(ip, g.is_pos_l, sizeof g.is_pos_l);
      std::memcpy(ip + 22, g.is_pos_s, sizeof g.is_pos_s);
      ip[61] = ip[62] = ip[63] = 0;
      active[f * n_slots + s] = 1;
      n_active++;
    }
  }
  return n_active;
}

int pdmp3_parse_step_wire16_lsf_sparse(
    pdmp3_handle *const *ids, size_t n_slots, int n_threads,
    size_t frames_per_step, int16_t *ix_flat, size_t cap_blocks,
    int16_t *blk, int16_t *scf_l, int16_t *scf_s, int16_t *meta,
    int16_t *is_pos, int16_t *active, long long *blocks_used) {
  std::atomic<long long> cursor{0};
  int n_active = 0;
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n_slots < 64) {
    n_active = parse_range16_lsf_sparse(
        ids, 0, n_slots, n_slots, frames_per_step, ix_flat, cap_blocks,
        &cursor, blk, scf_l, scf_s, meta, is_pos, active);
  } else {
    std::vector<std::thread> pool;
    std::vector<int> counts((size_t)n_threads, 0);
    size_t chunk = (n_slots + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      size_t lo = (size_t)t * chunk;
      size_t hi = lo + chunk < n_slots ? lo + chunk : n_slots;
      if (lo >= hi) break;
      pool.emplace_back([=, &counts, &cursor] {
        counts[(size_t)t] = parse_range16_lsf_sparse(
            ids, lo, hi, n_slots, frames_per_step, ix_flat, cap_blocks,
            &cursor, blk, scf_l, scf_s, meta, is_pos, active);
      });
    }
    for (auto &th : pool) th.join();
    for (int c : counts) n_active += c;
  }
  if (blocks_used) *blocks_used = cursor.load();
  return n_active;
}

// Sparse count1-bounded wire (see pdmp3.h): frequency lines are zero from
// count1 up (rzero, pdmp3.c:2108-2111), so only ceil(count1/128) 128-line
// blocks per (gr,ch) ship.  One atomic cursor allocates blocks across
// threads; the per-channel block table keeps the device result
// deterministic regardless of placement.
static int parse_range16_sparse(pdmp3_handle *const *ids, size_t lo,
                                size_t hi, size_t n_slots, size_t frames,
                                int16_t *ix_flat, size_t cap_blocks,
                                std::atomic<long long> *cursor,
                                int16_t *blk, int16_t *scf_l,
                                int16_t *scf_s, int16_t *meta,
                                int16_t *active) {
  const size_t sb = 2 * n_slots * 2 * 4;
  const size_t sl = 2 * n_slots * 2 * 22;
  const size_t ss = 2 * n_slots * 2 * 39;
  const size_t sm = 2 * n_slots * PDMP3_META_WORDS;
  int n_active = 0;
  pdmp3_granules g;
  for (size_t s = lo; s < hi; s++) {
    pdmp3_handle *id = ids[s];
    for (size_t f = 0; f < frames; f++) {
      active[f * n_slots + s] = 0;
      bool ok = id && id->fp.in.filled() >= 2 * 576 &&
                pdmp3_parse_frame(id, &g) == PDMP3_OK &&
                g.family == 0 &&
                g.layer == 3;  // LSF/L12 frames skip (see dense packer)
      for (int gr = 0; gr < 2; gr++) {
        int16_t *e =
            blk + f * sb + (((size_t)gr * n_slots + s) * 2) * 4;
        if (!ok) {
          // zero table entries so stale starts never alias live blocks
          std::memset(e, 0, 2 * 4 * sizeof(int16_t));
          continue;
        }
        for (int ch = 0; ch < 2; ch++, e += 4) {
          int c1 = ch < g.nch ? (int)g.count1[gr][ch] : 0;
          if (c1 < 0) c1 = 0;           // Huffman overrun rollback
          if (c1 > 576) c1 = 576;
          // line-ordered wire: nonzero lines live below kPermBound (the
          // reorder permutes within sfb spans, so the count1 prefix only
          // rounds up to the containing band's end; identity for long)
          unsigned lay = (unsigned)g.layout[gr][ch];
          int bound = lay <= 8 ? (int)kPermBound[lay][c1] : c1;
          int nb = (bound + 127) / 128;
          long long start = 0;
          if (nb) {
            start = cursor->fetch_add(nb);
            if (start + nb > (long long)cap_blocks) {  // cap too small
              // Saturate: leave the cursor past cap so the final
              // blocks_used > cap_blocks signals truncation to the
              // caller.  (A fetch_sub rollback here could race: another
              // thread's successful allocation taken between the two ops
              // would later be handed out again, overlapping live
              // blocks.)  The channel decodes as silence.
              nb = 0;
              start = 0;
            }
          }
          if (nb) {
            int n16 = nb * 128 < 576 ? nb * 128 : 576;
            int16_t *dst = ix_flat + start * 128;
            if (lay > 8 || lay % 3 == 0) {
              std::memcpy(dst, g.ix[gr][ch],
                          (size_t)n16 * sizeof(int16_t));
            } else {
              const short *p = kReorderSrc[lay];
              for (int i = 0; i < n16; i++) dst[i] = g.ix[gr][ch][p[i]];
            }
            if (nb * 128 > 576)  // 5th block: pad lines 576..639
              std::memset(ix_flat + start * 128 + 576, 0,
                          (size_t)(nb * 128 - 576) * sizeof(int16_t));
          }
          e[0] = (int16_t)(start & 0xFFFF);
          e[1] = (int16_t)(start >> 16);
          e[2] = (int16_t)nb;
          e[3] = 0;
        }
        write_scf_meta16(
            g, gr, scf_l + f * sl + ((size_t)gr * n_slots + s) * 2 * 22,
            scf_s + f * ss + ((size_t)gr * n_slots + s) * 2 * 39,
            meta + f * sm + ((size_t)gr * n_slots + s) * PDMP3_META_WORDS);
      }
      if (!ok) {
        // frames are sequential per stream; later frames of this slot
        // stay inactive — zero their table entries too (the wire is
        // double-buffered, so stale entries are the previous step's)
        for (size_t f2 = f + 1; f2 < frames; f2++) {
          active[f2 * n_slots + s] = 0;
          for (int gr = 0; gr < 2; gr++)
            std::memset(blk + f2 * sb + (((size_t)gr * n_slots + s) * 2) * 4,
                        0, 2 * 4 * sizeof(int16_t));
        }
        break;
      }
      active[f * n_slots + s] = 1;
      n_active++;
    }
  }
  return n_active;
}

int pdmp3_parse_step_wire16_sparse(pdmp3_handle *const *ids,
                                   size_t n_slots, int n_threads,
                                   size_t frames_per_step,
                                   int16_t *ix_flat, size_t cap_blocks,
                                   int16_t *blk, int16_t *scf_l,
                                   int16_t *scf_s, int16_t *meta,
                                   int16_t *active,
                                   long long *blocks_used) {
  std::atomic<long long> cursor{0};
  int n_active = 0;
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n_slots < 64) {
    n_active = parse_range16_sparse(ids, 0, n_slots, n_slots,
                                    frames_per_step, ix_flat, cap_blocks,
                                    &cursor, blk, scf_l, scf_s, meta,
                                    active);
  } else {
    std::vector<std::thread> pool;
    std::vector<int> counts((size_t)n_threads, 0);
    size_t chunk = (n_slots + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      size_t lo = (size_t)t * chunk;
      size_t hi = lo + chunk < n_slots ? lo + chunk : n_slots;
      if (lo >= hi) break;
      pool.emplace_back([=, &counts, &cursor] {
        counts[(size_t)t] = parse_range16_sparse(
            ids, lo, hi, n_slots, frames_per_step, ix_flat, cap_blocks,
            &cursor, blk, scf_l, scf_s, meta, active);
      });
    }
    for (auto &th : pool) th.join();
    for (int c : counts) n_active += c;
  }
  if (blocks_used) *blocks_used = cursor.load();
  return n_active;
}

static int parse_range(pdmp3_handle *const *ids, size_t lo, size_t hi,
                       size_t n_slots, size_t frames, int16_t *ix,
                       uint8_t *scf_l, uint8_t *scf_s, int32_t *meta,
                       int32_t *active) {
  // per-slot frame-step tensor strides (layout [F][2][n_slots][...])
  const size_t six = 2 * n_slots * 2 * 576;
  const size_t sl = 2 * n_slots * 2 * 22;
  const size_t ss = 2 * n_slots * 2 * 39;
  const size_t sm = 2 * n_slots * PDMP3_META_WORDS;
  int n_active = 0;
  for (size_t s = lo; s < hi; s++) {
    pdmp3_handle *id = ids[s];
    for (size_t f = 0; f < frames; f++) {
      active[f * n_slots + s] = 0;
      if (!id || id->fp.in.filled() < 2 * 576) continue;
      if (pdmp3_parse_frame_soa(id, s, n_slots, ix + f * six,
                                scf_l + f * sl, scf_s + f * ss,
                                meta + f * sm) == PDMP3_OK) {
        active[f * n_slots + s] = 1;
        n_active++;
      } else {
        // frames are sequential per stream; later frames stay inactive
        for (size_t f2 = f + 1; f2 < frames; f2++)
          active[f2 * n_slots + s] = 0;
        break;
      }
    }
  }
  return n_active;
}

int pdmp3_parse_step(pdmp3_handle *const *ids, size_t n_slots, int16_t *ix,
                     uint8_t *scf_l, uint8_t *scf_s, int32_t *meta,
                     int32_t *active) {
  return parse_range(ids, 0, n_slots, n_slots, 1, ix, scf_l, scf_s, meta,
                     active);
}

int pdmp3_parse_step_multi(pdmp3_handle *const *ids, size_t n_slots,
                           int n_threads, size_t frames_per_step,
                           int16_t *ix, uint8_t *scf_l, uint8_t *scf_s,
                           int32_t *meta, int32_t *active) {
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n_slots < 64)
    return parse_range(ids, 0, n_slots, n_slots, frames_per_step, ix,
                       scf_l, scf_s, meta, active);
  // slots/handles are fully independent — embarrassingly parallel host
  // Huffman fan-out (SURVEY.md §7: the frontend must outrun the TPU)
  std::vector<std::thread> pool;
  std::vector<int> counts((size_t)n_threads, 0);
  size_t chunk = (n_slots + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    size_t lo = (size_t)t * chunk;
    size_t hi = lo + chunk < n_slots ? lo + chunk : n_slots;
    if (lo >= hi) break;
    pool.emplace_back([=, &counts] {
      counts[(size_t)t] = parse_range(ids, lo, hi, n_slots,
                                      frames_per_step, ix, scf_l, scf_s,
                                      meta, active);
    });
  }
  int n_active = 0;
  for (auto &th : pool) th.join();
  for (int c : counts) n_active += c;
  return n_active;
}

int pdmp3_parse_step_mt(pdmp3_handle *const *ids, size_t n_slots,
                        int n_threads, int16_t *ix, uint8_t *scf_l,
                        uint8_t *scf_s, int32_t *meta, int32_t *active) {
  return pdmp3_parse_step_multi(ids, n_slots, n_threads, 1, ix, scf_l,
                                scf_s, meta, active);
}

// Convert_Frame_S16 (pdmp3.c:2307-2345)
static size_t convert_s16(pdmp3_handle *id, unsigned char *outbuf,
                          size_t buflen) {
  int nch = id->fp.hdr.nch();
  size_t framesz = 2 * (size_t)nch;
  size_t nsamps = buflen / framesz;
  // owords = PCM words this frame carries: 1152 for MPEG-1, 576 for LSF
  // one-granule frames (cf. api.PDMP3.owords).  ostart can exceed
  // owords in one exotic interleaving (an odd-sized read leaves a
  // partially-drained 1152-word frame, then an LSF frame decodes with
  // owords 576): clamp — the unsigned difference would otherwise
  // underflow and read past id->out.
  size_t remain = id->ostart < id->owords ? id->owords - id->ostart : 0;
  if (nsamps > remain) nsamps = remain;
  if (remain == 0) {
    id->ostart = 0;
    return 0;
  }
  int16_t *s = (int16_t *)outbuf;
  const uint32_t *flat = &id->out[0][0];
  for (size_t q = 0; q < nsamps; q++) {
    uint32_t w = flat[id->ostart + q];
    if (nch == 1) {
      s[q] = (int16_t)(w & 0xFFFF);
    } else {
      s[2 * q] = (int16_t)((w >> 16) & 0xFFFF);
      s[2 * q + 1] = (int16_t)(w & 0xFFFF);
    }
  }
  id->ostart += (unsigned)nsamps;
  if (id->ostart == id->owords) id->ostart = 0;
  return nsamps * framesz;
}

int pdmp3_read(pdmp3_handle *id, unsigned char *outmemory, size_t outsize,
               size_t *done) {
  // (pdmp3.c:2431-2481)
  if (!id || !outmemory || !done) return PDMP3_ERR;
  *done = 0;
  if (outsize == 0) return PDMP3_NO_SPACE;
  int res = PDMP3_ERR;
  if (id->ostart) {
    size_t n = convert_s16(id, outmemory, outsize);
    outmemory += n;
    outsize -= n;
    *done += n;
    res = PDMP3_OK;
  }
  // input gate: the reference requires 2*576 buffered bytes per frame
  // attempt (pdmp3.c:2445).  Layer I/II frames can be far smaller (a
  // 384-sample Layer I frame is ~420 bytes), so the gate would strand a
  // stream's tail frames — L12-profile handles rely on parse_frame's
  // NEED_MORE + rollback instead (profile 0 keeps reference parity).
  const unsigned gate = id->fp.l12_enabled() ? 8 : 2 * 576;
  while (outsize) {
    if (id->fp.id3_enabled()) id->fp.skip_id3();  // before the snapshot
    if (id->fp.in.filled() >= gate) {
      size_t pos = id->fp.in.processed;
      unsigned mark = id->fp.in.istart;
      pdmp3_granules g;
      res = id->fp.parse_frame(&g);
      if (res == PDMP3_OK || res == PDMP3_NEW_FORMAT) {
        id->dsp.decode_frame(g, id->out, id->fp.profile);
        // PCM words this frame carries: Layer I/II = nparts*32 (384 /
        // 1152), LSF Layer III = 576, MPEG-1 Layer III = 1152
        id->owords = (g.layer == 1 || g.layer == 2)
                         ? (unsigned)g.nparts * 32
                         : (g.family ? 576 : 2 * 576);
        size_t n = convert_s16(id, outmemory, outsize);
        outmemory += n;
        outsize -= n;
        *done += n;
      } else {
        id->fp.in.processed = pos;
        id->fp.in.istart = mark;
        if (res != PDMP3_ERR && res != PDMP3_NEED_MORE) res = PDMP3_ERR;
        break;
      }
    } else {
      res = PDMP3_NEED_MORE;
      break;
    }
  }
  if (id->fp.new_header == 1 && res == PDMP3_OK) res = PDMP3_NEW_FORMAT;
  return res;
}

int pdmp3_decode(pdmp3_handle *id, const unsigned char *in, size_t insize,
                 unsigned char *out, size_t outsize, size_t *done) {
  // (pdmp3.c:2491-2520)
  if (!id || !done) return PDMP3_ERR;
  *done = 0;
  size_t free_space = id->fp.in.free_space();
  if (free_space > insize) free_space = insize;
  int res = pdmp3_feed(id, in, free_space);
  if (res == PDMP3_OK) {
    if (out && outsize) {
      res = pdmp3_read(id, out, outsize, done);
    } else if (id->fp.in.processed == 0) {
      size_t pos = id->fp.in.processed;
      unsigned mark = id->fp.in.istart;
      res = id->fp.search_header();
      id->fp.in.processed = pos;
      id->fp.in.istart = mark;
      if (id->fp.new_header == 1) res = PDMP3_NEW_FORMAT;
    }
  }
  return res;
}

int pdmp3_getformat(pdmp3_handle *id, long *rate, int *channels,
                    int *encoding) {
  // (pdmp3.c:2526-2535)
  if (!id || !rate || !channels || !encoding) return PDMP3_ERR;
  *encoding = PDMP3_ENC_SIGNED_16;
  // a REJECTED header leaves its raw fields in hdr (parse-then-validate,
  // like the reference); sampling_frequency can then be the invalid 3,
  // which the reference dereferences out of bounds into whatever rodata
  // follows its table (pdmp3.c:2530 — layout-dependent garbage, not an
  // emulatable quirk).  Guard instead (found by tools/fuzz.py).
  unsigned sf = (unsigned)id->fp.hdr.sampling_frequency;
  // family is -1 after a REJECTED reserved-version header (LSF mode's
  // parse-then-validate, like sampling_frequency == 3) — guard both
  int fam = id->fp.hdr.family;
  *rate = kSampleRatesFam[fam >= 0 && fam <= 2 ? fam : 0][sf <= 2 ? sf : 2];
  *channels = id->fp.hdr.nch();
  id->fp.new_header = -1;
  return PDMP3_OK;
}

// ---- CLI player (pdmp3.c:2540-2589) ----
//
// Sinks (pdmp3.c:2222-2298): raw PCM to <file>.raw / stdout, and an OSS
// /dev/dsp sink when a device argument is given (runtime-selected instead
// of the reference's compile-time OUTPUT_SOUND/OUTPUT_RAW flags).

#ifdef __linux__
#include <fcntl.h>
#include <sys/ioctl.h>
#include <unistd.h>
#if __has_include(<sys/soundcard.h>)
#include <sys/soundcard.h>
#define PDMP3_HAVE_OSS 1
#endif
#endif

struct AudioSink {
  FILE *file = nullptr;
  int oss_fd = -1;
  long oss_rate = 0;
};

static void audio_write(pdmp3_handle *id, const char *audio_name,
                        const char *filename, const unsigned char *samples,
                        size_t nbytes, AudioSink *sink) {
#ifdef PDMP3_HAVE_OSS
  if (audio_name) {  // OSS output (pdmp3.c:2264-2293)
    if (sink->oss_fd < 0) {
      sink->oss_fd = open(audio_name, O_WRONLY, 0);
      if (sink->oss_fd < 0) {
        perror(audio_name);
        exit(-1);
      }
      int format = AFMT_S16_LE, stereo = 2;
      ioctl(sink->oss_fd, SNDCTL_DSP_SETFMT, &format);
      ioctl(sink->oss_fd, SNDCTL_DSP_CHANNELS, &stereo);
    }
    int fam_ = id->fp.hdr.family;
    long rate = kSampleRatesFam[fam_ >= 0 && fam_ <= 2 ? fam_ : 0]
                               [id->fp.hdr.sampling_frequency];
    if (sink->oss_rate != rate) {
      sink->oss_rate = rate;
      int speed = (int)rate;
      ioctl(sink->oss_fd, SNDCTL_DSP_SPEED, &speed);
    }
    if (nbytes && write(sink->oss_fd, samples, nbytes) != (ssize_t)nbytes) {
      fprintf(stderr, "Unable to write audio data\n");
      exit(-1);
    }
    return;
  }
#else
  (void)audio_name;
  (void)id;
#endif
  if (!sink->file) {
    if (strcmp(filename, "-") == 0) {
      sink->file = stdout;
    } else {
      char fname[1024];
      snprintf(fname, sizeof fname, "%s.raw", filename);
      sink->file = fopen(fname, "wb");
      if (!sink->file) {
        perror(fname);
        exit(-1);
      }
    }
  }
  if (nbytes && fwrite(samples, 1, nbytes, sink->file) != nbytes) {
    fprintf(stderr, "Unable to write raw data\n");
    exit(-1);
  }
}

void pdmp3(char *const *mp3s) {
  static unsigned char out[kInbufSize];
  const char *audio_name = nullptr;
  if (*mp3s && !strncmp("/dev/dsp", *mp3s, 8)) audio_name = *mp3s++;
  pdmp3_handle *id = pdmp3_new(nullptr, nullptr);
  if (!id) {
    fprintf(stderr, "Cannot open stream API (out of memory)\n");
    return;
  }
  while (*mp3s) {
    const char *filename = *mp3s++;
    FILE *fp = strcmp(filename, "-") == 0 ? stdin : fopen(filename, "rb");
    if (!fp) {
      fprintf(stderr, "Cannot open file %s\n", filename);
      exit(0);
    }
    AudioSink sink;
    pdmp3_open_feed(id);
    size_t done;
    int res;
    while ((res = pdmp3_read(id, out, sizeof out, &done)) != PDMP3_ERR) {
      audio_write(id, audio_name, filename, out, done, &sink);
      if (res == PDMP3_NEED_MORE) {
        unsigned char in[4096];
        size_t n = fread(in, 1, sizeof in, fp);
        if (!n) break;
        pdmp3_feed(id, in, n);
      }
    }
    if (sink.file && sink.file != stdout) fclose(sink.file);
    if (sink.oss_fd >= 0) close(sink.oss_fd);
    if (fp != stdin) fclose(fp);
  }
  pdmp3_delete(id);
}

}  // extern "C"
