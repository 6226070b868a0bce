// In-process coverage-guided fuzzer for the native frontend + streaming
// API + wire packers (SURVEY.md §5 robustness: the reference has nothing
// of the kind; its only resilience is runtime guards, pdmp3.c:1293-1315,
// 2105).
//
// No clang/libFuzzer in this toolchain, so this is a self-contained
// mini-AFL: the LIBRARY translation units are compiled with GCC's
// -fsanitize-coverage=trace-pc (plus ASan/UBSan); this driver is NOT
// instrumented and collects AFL-style (prev-pc, pc) edge hashes in a
// bitmap.  Mutated inputs that light up new edges join the corpus.
// Crashes abort via the sanitizer; the current input is pre-dumped to a
// file so the python wrapper (tools/fuzz.py) can save the reproducer.
//
// Usage: fuzz_main <seed_dir> <iterations> <cur_input_file>
#include <dirent.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

#include <string>
#include <vector>

#include "../include/pdmp3.h"

// ---- edge coverage (called from instrumented library code) ----
static const size_t kMapBits = 16;
static uint8_t g_bitmap[1u << kMapBits];
static uint64_t g_edges = 0;
static uint64_t g_new_this_run = 0;
static __thread uintptr_t t_prev_pc = 0;

extern "C" void __sanitizer_cov_trace_pc() {
  uintptr_t pc = (uintptr_t)__builtin_return_address(0);
  size_t idx = ((pc >> 1) ^ (t_prev_pc << 5)) & ((1u << kMapBits) - 1);
  t_prev_pc = pc >> 1;
  if (!g_bitmap[idx]) {
    g_bitmap[idx] = 1;
    g_edges++;
    g_new_this_run++;
  }
}

// ---- deterministic RNG ----
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  uint32_t below(uint32_t n) { return n ? (uint32_t)(next() % n) : 0; }
};

// ---- harness: one fuzz input through API + wire paths ----
static void run_streaming(const uint8_t *data, size_t size, Rng &r) {
  pdmp3_handle *h = pdmp3_new(nullptr, nullptr);
  if (!h) return;
  pdmp3_open_feed(h);
  // all 128 profile combinations: COUNT1B_SPEC, SPEC_INTENSITY, LSF
  // (11-bit sync + one-granule parse), FREE_FORMAT (sync-spacing
  // measurement), ID3 (incremental tag skip + ring-wrap normalization),
  // L12 (Layer I/II bit-allocation parse + host requantize), CRC
  // (ISO CRC-16 verify + whole-frame skip)
  pdmp3_set_profile(h, (unsigned)(r.next() & 127));
  unsigned char out[16384];
  size_t done = 0, pos = 0;
  int guard = 0;
  while (pos < size && guard++ < 4096) {
    size_t n = 1 + r.below(511);
    if (n > size - pos) n = size - pos;
    int fr = pdmp3_feed(h, data + pos, n);
    if (fr == PDMP3_OK)
      pos += n;
    int rd = PDMP3_OK;
    int inner = 0;
    // drain aggressively on NO_SPACE, occasionally otherwise; VARIED
    // read sizes (incl. odd) exercise the partial-drain/owords
    // interleavings a fixed full-buffer read never reaches
    while ((fr == PDMP3_NO_SPACE || (r.next() & 3) == 0) &&
           rd == PDMP3_OK && inner++ < 64) {
      size_t rn = (r.next() & 7) ? sizeof out : 1 + r.below(4096);
      rd = pdmp3_read(h, out, rn, &done);
    }
    if (fr == PDMP3_NO_SPACE && rd != PDMP3_OK)
      break;  // wedged: full buffer the decoder cannot consume
  }
  guard = 0;
  while (pdmp3_read(h, out, sizeof out, &done) == PDMP3_OK &&
         guard++ < 4096) {
  }
  // format query + checkpoint round-trip on whatever state resulted
  long rate;
  int ch, enc;
  pdmp3_getformat(h, &rate, &ch, &enc);
  size_t blob = pdmp3_state_size();
  std::vector<uint8_t> ck(blob);
  pdmp3_state_save(h, ck.data());
  pdmp3_state_restore(h, ck.data());
  pdmp3_delete(h);
}

static void run_wire(const uint8_t *data, size_t size, Rng &r) {
  // serving wire packers, 2 slots x 2 frames/step, dense + sparse + LSF
  enum { kSlots = 2, kFrames = 2 };
  pdmp3_handle *hs[kSlots];
  uint32_t pool = r.below(8);
  bool lsf = pool < 2;  // LSF pool round (1 in 4)
  bool l12 = pool == 2 || pool == 3;  // Layer I/II pool round (1 in 4)
  for (auto &h : hs) {
    h = pdmp3_new(nullptr, nullptr);
    pdmp3_open_feed(h);
    if (lsf) pdmp3_set_profile(h, PDMP3_PROFILE_LSF);
    if (l12) pdmp3_set_profile(h, PDMP3_PROFILE_L12);
  }
  static int16_t ix[kFrames * 2 * kSlots * 2 * 576];
  static int16_t scf_l[kFrames * 2 * kSlots * 2 * 22];
  static int16_t scf_s[kFrames * 2 * kSlots * 2 * 39];
  static int16_t meta[kFrames * 2 * kSlots * PDMP3_META_WORDS];
  static int16_t is_pos[kFrames * kSlots * 64];
  static int16_t active[kFrames * kSlots];
  enum { kCap = kFrames * 2 * kSlots * 2 * 5 };
  static int16_t blk[kFrames * 2 * kSlots * 2 * 4];
  static int16_t flat[kCap * 128];
  size_t pos[kSlots] = {0, r.below((uint32_t)size + 1)};
  for (int step = 0; step < 6; step++) {
    for (int s = 0; s < kSlots; s++) {
      size_t n = 1 + r.below(4095);
      if (n > size - pos[s]) n = size - pos[s];
      if (n)
        if (pdmp3_feed(hs[s], data + pos[s], n) == PDMP3_OK)
          pos[s] += n;
    }
    if (l12) {
      static float sb_l12[kFrames * kSlots * 2 * 36 * 32];
      static int16_t meta_l12[kFrames * kSlots * 4];
      int layer = (step & 1) ? 2 : 1;  // both per-layer pools per input
      pdmp3_parse_step_wire_l12(hs, kSlots, 1, kFrames, layer, sb_l12,
                                meta_l12, active);
    } else if (lsf && (step & 1)) {
      long long used = 0;
      pdmp3_parse_step_wire16_lsf_sparse(hs, kSlots, 1, kFrames, flat,
                                         kCap, blk, scf_l, scf_s, meta,
                                         is_pos, active, &used);
    } else if (lsf)
      pdmp3_parse_step_wire16_lsf(hs, kSlots, 1, kFrames, ix, scf_l,
                                  scf_s, meta, is_pos, active);
    else if (step & 1) {
      long long used = 0;
      pdmp3_parse_step_wire16_sparse(hs, kSlots, 1, kFrames, flat, kCap,
                                     blk, scf_l, scf_s, meta, active,
                                     &used);
    } else
      pdmp3_parse_step_wire16(hs, kSlots, 1, kFrames, ix, scf_l, scf_s,
                              meta, active);
  }
  for (auto h : hs) pdmp3_delete(h);
}

static void run_one(const uint8_t *data, size_t size, uint64_t seed) {
  Rng r(seed);
  t_prev_pc = 0;
  run_streaming(data, size, r);
  run_wire(data, size, r);
}

// ---- mutation engine ----
static void mutate(std::vector<uint8_t> &buf,
                   const std::vector<std::vector<uint8_t>> &corpus,
                   Rng &r) {
  int rounds = 1 + (int)r.below(8);
  for (int i = 0; i < rounds; i++) {
    if (buf.empty()) {
      buf.push_back((uint8_t)r.next());
      continue;
    }
    switch (r.below(8)) {
      case 0:  // bit flip
        buf[r.below((uint32_t)buf.size())] ^= (uint8_t)(1u << r.below(8));
        break;
      case 1:  // byte set
        buf[r.below((uint32_t)buf.size())] = (uint8_t)r.next();
        break;
      case 2:  // insert
        if (buf.size() < 65536)
          buf.insert(buf.begin() + r.below((uint32_t)buf.size()),
                     (uint8_t)r.next());
        break;
      case 3:  // delete run
        if (buf.size() > 4) {
          size_t at = r.below((uint32_t)buf.size() - 1);
          size_t n = 1 + r.below(64);
          if (at + n > buf.size()) n = buf.size() - at;
          buf.erase(buf.begin() + at, buf.begin() + at + n);
        }
        break;
      case 4: {  // inject a syncword-ish header
        size_t at = r.below((uint32_t)buf.size());
        uint8_t hdr[4] = {0xFF, (uint8_t)(0xE0 | r.below(32)),
                          (uint8_t)r.next(), (uint8_t)r.next()};
        for (int k = 0; k < 4 && at + k < buf.size(); k++)
          buf[at + k] = hdr[k];
        break;
      }
      case 5: {  // splice with another corpus entry
        const auto &o = corpus[r.below((uint32_t)corpus.size())];
        if (!o.empty() && buf.size() < 65536) {
          size_t at = r.below((uint32_t)buf.size());
          size_t ofrom = r.below((uint32_t)o.size());
          size_t n = 1 + r.below(512);
          if (ofrom + n > o.size()) n = o.size() - ofrom;
          buf.insert(buf.begin() + at, o.begin() + ofrom,
                     o.begin() + ofrom + n);
        }
        break;
      }
      case 6:  // truncate
        if (buf.size() > 8) buf.resize(buf.size() - 1 - r.below(
            (uint32_t)buf.size() / 2));
        break;
      default: {  // overwrite run with a constant
        size_t at = r.below((uint32_t)buf.size());
        size_t n = 1 + r.below(32);
        uint8_t v = (uint8_t)r.next();
        for (size_t k = at; k < buf.size() && k < at + n; k++) buf[k] = v;
        break;
      }
    }
  }
}

int main(int argc, char **argv) {
  if (argc < 4) {
    fprintf(stderr, "usage: %s <seed_dir> <iterations> <cur_input>\n",
            argv[0]);
    return 2;
  }
  const char *seed_dir = argv[1];
  long iters = atol(argv[2]);
  const char *cur_path = argv[3];
  uint64_t rng_seed = argc > 4 ? strtoull(argv[4], nullptr, 10) : 1;

  std::vector<std::vector<uint8_t>> corpus;
  if (DIR *d = opendir(seed_dir)) {
    while (dirent *e = readdir(d)) {
      if (e->d_name[0] == '.') continue;
      std::string p = std::string(seed_dir) + "/" + e->d_name;
      if (FILE *f = fopen(p.c_str(), "rb")) {
        fseek(f, 0, SEEK_END);
        long n = ftell(f);
        fseek(f, 0, SEEK_SET);
        std::vector<uint8_t> v((size_t)(n > 0 ? n : 0));
        if (!v.empty() && fread(v.data(), 1, v.size(), f) != v.size())
          v.clear();
        fclose(f);
        if (!v.empty()) corpus.push_back(std::move(v));
      }
    }
    closedir(d);
  }
  if (corpus.empty()) corpus.push_back({0xFF, 0xFB, 0x90, 0x44});

  // establish baseline coverage from the seeds
  Rng r(rng_seed);
  for (size_t i = 0; i < corpus.size(); i++)
    run_one(corpus[i].data(), corpus[i].size(), r.next());

  uint64_t finds = 0;
  time_t t0 = time(nullptr);
  for (long it = 0; it < iters; it++) {
    std::vector<uint8_t> buf = corpus[r.below((uint32_t)corpus.size())];
    mutate(buf, corpus, r);
    // pre-dump so a sanitizer abort leaves the reproducer on disk
    if (FILE *f = fopen(cur_path, "wb")) {
      if (!buf.empty()) fwrite(buf.data(), 1, buf.size(), f);
      fclose(f);
    }
    g_new_this_run = 0;
    run_one(buf.data(), buf.size(), r.next());
    if (g_new_this_run && corpus.size() < 4096) {
      corpus.push_back(std::move(buf));
      finds++;
    }
  }
  printf("{\"execs\": %ld, \"edges\": %llu, \"corpus\": %zu, "
         "\"new_inputs\": %llu, \"seconds\": %ld}\n",
         iters, (unsigned long long)g_edges, corpus.size(),
         (unsigned long long)finds, (long)(time(nullptr) - t0));
  return 0;
}
