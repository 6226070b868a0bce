// Threaded-frontend selftest: drives pdmp3_parse_step_wire16 with N
// worker threads against a single-threaded twin over identical streams
// and byte-compares every step tensor.  Exit 0 = identical.  Built plain
// (equality proof) and under -fsanitize=thread (race proof) by
// build.py:selftest_bin; run by tests/test_host_native.py.
//
// Usage: pdmp3_selftest n_slots n_threads steps stream1 [stream2 ...]
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
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

struct Wire {
  size_t B, F;
  std::vector<int16_t> ix, scf_l, scf_s, meta, active;
  explicit Wire(size_t b, size_t f) : B(b), F(f) {
    ix.resize(f * 2 * B * 2 * 576);
    scf_l.resize(f * 2 * B * 2 * 22);
    scf_s.resize(f * 2 * B * 2 * 39);
    meta.resize(f * 2 * B * PDMP3_META_WORDS);
    active.resize(f * B);
  }
  bool operator==(const Wire &o) const {
    return ix == o.ix && scf_l == o.scf_l && scf_s == o.scf_s &&
           meta == o.meta && active == o.active;
  }
};

}  // namespace

int main(int argc, char **argv) {
  if (argc < 5) {
    std::fprintf(stderr, "usage: %s n_slots n_threads steps streams...\n",
                 argv[0]);
    return 2;
  }
  size_t n_slots = (size_t)std::atol(argv[1]);
  int n_threads = std::atoi(argv[2]);
  int steps = std::atoi(argv[3]);
  std::vector<std::vector<unsigned char>> streams;
  for (int i = 4; i < argc; i++) streams.push_back(read_file(argv[i]));

  // two identical handle fleets: multi-threaded vs single-threaded twin
  std::vector<pdmp3_handle *> a(n_slots), b(n_slots);
  std::vector<size_t> pos_a(n_slots, 0), pos_b(n_slots, 0);
  for (size_t s = 0; s < n_slots; s++) {
    a[s] = pdmp3_new(nullptr, nullptr);
    b[s] = pdmp3_new(nullptr, nullptr);
    pdmp3_open_feed(a[s]);
    pdmp3_open_feed(b[s]);
  }
  auto feed = [&](std::vector<pdmp3_handle *> &ids,
                  std::vector<size_t> &pos) {
    for (size_t s = 0; s < n_slots; s++) {
      const auto &src = streams[s % streams.size()];
      while (pos[s] < src.size()) {
        unsigned free_b = pdmp3_inbuf_free(ids[s]);
        if (free_b < 4097) break;  // stay a byte short of exactly-full
        size_t n = src.size() - pos[s];
        if (n > 4096) n = 4096;
        if (pdmp3_feed(ids[s], src.data() + pos[s], n) != PDMP3_OK) break;
        pos[s] += n;
      }
    }
  };

  Wire wa(n_slots, 1), wb(n_slots, 1);
  for (int t = 0; t < steps; t++) {
    feed(a, pos_a);
    feed(b, pos_b);
    int na = pdmp3_parse_step_wire16(a.data(), n_slots, n_threads, 1,
                                     wa.ix.data(), wa.scf_l.data(),
                                     wa.scf_s.data(), wa.meta.data(),
                                     wa.active.data());
    int nb = pdmp3_parse_step_wire16(b.data(), n_slots, 1, 1,
                                     wb.ix.data(), wb.scf_l.data(),
                                     wb.scf_s.data(), wb.meta.data(),
                                     wb.active.data());
    if (na != nb || !(wa == wb)) {
      std::fprintf(stderr, "step %d: tensors diverge (na=%d nb=%d)\n", t,
                   na, nb);
      return 1;
    }
    if (na == 0) break;
  }
  for (size_t s = 0; s < n_slots; s++) {
    pdmp3_delete(a[s]);
    pdmp3_delete(b[s]);
  }
  std::puts("threaded parse == single-threaded parse");
  return 0;
}
