// Native host-frontend throughput benchmark: drives
// pdmp3_parse_step_wire16 (the serving parse path — sync, side info,
// reservoir, scalefactors, LUT Huffman, line-ordered wire pack) over
// looping streams and reports frames/s.  This is the native counterpart
// of bench.py's host_parse_frames_per_sec_1t (which adds the Python feed
// loop); tools/parse_scaling.py runs it across thread counts to produce
// the HOST_PARSE artifact.
//
// Usage: pdmp3_parsebench n_slots n_threads seconds stream1 [stream2...]
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "../include/pdmp3.h"

namespace {

std::vector<unsigned char> read_file(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) {
    std::fprintf(stderr, "cannot open %s\n", path);
    std::exit(2);
  }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<unsigned char> buf((size_t)n);
  if (std::fread(buf.data(), 1, (size_t)n, f) != (size_t)n) std::exit(2);
  std::fclose(f);
  return buf;
}

}  // namespace

#ifdef PDMP3_PARSE_STATS
extern "C" {
extern unsigned long long pdmp3_stat_pairs, pdmp3_stat_slow,
    pdmp3_stat_quads;
extern unsigned long long pdmp3_cyc_regions, pdmp3_cyc_count1,
    pdmp3_cyc_zfill, pdmp3_cyc_scf, pdmp3_cyc_maindata,
    pdmp3_cyc_header, pdmp3_cyc_sideinfo, pdmp3_cyc_pack,
    pdmp3_cyc_frame;
}
#endif

int main(int argc, char **argv) {
  if (argc < 5) {
    std::fprintf(stderr, "usage: %s n_slots n_threads seconds streams...\n",
                 argv[0]);
    return 2;
  }
  size_t n_slots = (size_t)std::atol(argv[1]);
  int n_threads = std::atoi(argv[2]);
  double seconds = std::atof(argv[3]);
  std::vector<std::vector<unsigned char>> streams;
  for (int i = 4; i < argc; i++) streams.push_back(read_file(argv[i]));

  std::vector<pdmp3_handle *> ids(n_slots);
  std::vector<size_t> pos(n_slots, 0);
  for (size_t s = 0; s < n_slots; s++) {
    ids[s] = pdmp3_new(nullptr, nullptr);
    pdmp3_open_feed(ids[s]);
  }
  // wire buffers (F=1)
  std::vector<int16_t> ix(2 * n_slots * 2 * 576),
      scf_l(2 * n_slots * 2 * 22), scf_s(2 * n_slots * 2 * 39),
      meta(2 * n_slots * PDMP3_META_WORDS), active(n_slots);

  auto feed_all = [&] {
    for (size_t s = 0; s < n_slots; s++) {
      const auto &src = streams[s % streams.size()];
      for (;;) {
        unsigned free_b = pdmp3_inbuf_free(ids[s]);
        if (free_b < 4097) break;  // stay a byte short of exactly-full
        if (pos[s] >= src.size()) pos[s] = 0;  // loop (resync at seam)
        size_t n = src.size() - pos[s];
        if (n > 4096) n = 4096;
        if (pdmp3_feed(ids[s], src.data() + pos[s], n) != PDMP3_OK) break;
        pos[s] += n;
      }
    }
  };

  // warm up (first feed + first parse touch cold pages)
  feed_all();
  pdmp3_parse_step_wire16(ids.data(), n_slots, n_threads, 1, ix.data(),
                          scf_l.data(), scf_s.data(), meta.data(),
                          active.data());

  long long frames = 0;
  auto t0 = std::chrono::steady_clock::now();
  double elapsed = 0.0;
  do {
    feed_all();
    frames += pdmp3_parse_step_wire16(ids.data(), n_slots, n_threads, 1,
                                      ix.data(), scf_l.data(),
                                      scf_s.data(), meta.data(),
                                      active.data());
    elapsed = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
  } while (elapsed < seconds);

#ifdef PDMP3_PARSE_STATS
  std::printf(
      "{\"n_slots\": %zu, \"n_threads\": %d, \"frames\": %lld, "
      "\"seconds\": %.3f, \"frames_per_sec\": %.1f, "
      "\"cycles\": {\"header\": %llu, \"sideinfo\": %llu, "
      "\"maindata\": %llu, \"scf\": %llu, \"huffman_regions\": %llu, "
      "\"count1\": %llu, \"zfill\": %llu, \"wire_pack\": %llu, "
      "\"frame_total\": %llu}, "
      "\"counts\": {\"pairs\": %llu, \"slow_pairs\": %llu, "
      "\"quads\": %llu}}\n",
      n_slots, n_threads, frames, elapsed, frames / elapsed,
      pdmp3_cyc_header, pdmp3_cyc_sideinfo, pdmp3_cyc_maindata,
      pdmp3_cyc_scf, pdmp3_cyc_regions, pdmp3_cyc_count1,
      pdmp3_cyc_zfill, pdmp3_cyc_pack, pdmp3_cyc_frame,
      pdmp3_stat_pairs, pdmp3_stat_slow, pdmp3_stat_quads);
#else
  std::printf("{\"n_slots\": %zu, \"n_threads\": %d, \"frames\": %lld, "
              "\"seconds\": %.3f, \"frames_per_sec\": %.1f}\n",
              n_slots, n_threads, frames, elapsed, frames / elapsed);
#endif
  for (size_t s = 0; s < n_slots; s++) pdmp3_delete(ids[s]);
  return 0;
}
