// pdmp3_tpu native host — internal structures.
//
// Original implementation of the MPEG-1 Layer III frame machinery, state
// machine and scalar DSP described in SURVEY.md §2 (semantics matched to
// the reference decoder cited per method; no reference code reused).
#ifndef PDMP3_TPU_HOST_INTERNAL_H_
#define PDMP3_TPU_HOST_INTERNAL_H_

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "../include/pdmp3.h"

namespace pdmp3host {

// ---- generated constant tables (gen_tables.inc, built by
// tools/gen_host_tables.py from ISO 11172-3 data) ----
#define PDMP3_HUFF_PRIMARY_BITS 9
extern const float kPow43[8207];
extern const float kGainQuarter[256];
extern const float kGainGlobal[312];
extern const int kGainGlobalOff;
extern const float kCs[8];
extern const float kCa[8];
extern const float kIsRatioL[16];
extern const float kIsRatioR[16];
extern const float kImdctWin[4][36];
extern const float kCosN12[6][12];
extern const float kCosN36[18][36];
extern const float kSynthD[512];
extern const float kSynthNwin[64][32];
extern const int kSfbLong[3][23];
extern const int kSfbShort[3][14];
// MPEG-2/2.5 LSF extension (13818-3; tables.py LSF section)
extern const int kSfbLongFam[3][3][23];
extern const int kSfbShortFam[3][3][14];
extern const long kBitratesLsf[15];
extern const long kSampleRatesFam[3][3];
extern const int kNrOfSfb[6][3][4];
extern const int kSwitchSfbL[3];
extern const float kLsfK0[2][64];
extern const float kLsfK1[2][64];
constexpr int kLsfIsIllegal = 63;  // tables.LSF_IS_ILLEGAL
// Layer I/II (beyond-reference; 11172-3 tables B.2a-d/B.4, 13818-3 B.1
// — cf. tables.py L12 section; alloc tables as class-index grids over
// one deduplicated 17-entry class list, dequant constants C/D as
// bit-identical doubles)
extern const float kScfL12[63];
extern const long kBitratesL1[15];
extern const long kBitratesL2[15];
extern const long kBitratesLsfL1[15];
extern const int kL2Sblimit[5];       // A,B,C,D,LSF
extern const int kL2Nbal[5][32];
extern const int kL2Cls[5][32][15];   // class index, -1 pad
extern const int kL2ClsBits[17];      // codeword bits
extern const int kL2ClsGroupSteps[17];  // steps if grouped else 0
extern const int kL2ClsNb[17];        // per-sample fraction bits
extern const double kL2ClsC[17];
extern const double kL2ClsD[17];
extern const short kReorderSrc[9][576];
extern const short kPermBound[9][577];
extern const int kPretab[22];
extern const int kScalefacSizes[16][2];
extern const long kBitratesL3[15];
extern const long kSampleRates[3];
extern const unsigned short kHuffPrimary[34][512];
extern const unsigned short kHuffSecondary[];
extern const int kHuffEscOff[];
extern const int kHuffEscExt[];
extern const int kHuffMaxlen[34];
extern const int kHuffLinbits[34];

// ---- derived per-layout line maps (cf. pdmp3_tpu.tables.layout_maps) ----
struct LayoutMaps {
  // layout = sfreq*3 + {0 long, 1 short, 2 mixed}
  int16_t sfb[9][576];        // scalefactor band per line
  int16_t win[9][576];        // window 0-2 for short regions
  int16_t is_short[9][576];   // 1 in short regions
  int16_t reorder[9][576];    // reordered[i] = raw[reorder[i]]
  int16_t band_start[9][576]; // first line of the line's band
  int16_t intensity_ok[9][576];
  // smallest line-ordered prefix covering bitstream lines [0, c): the
  // sparse wire's count1 bound (family generalization of kPermBound,
  // which stays the family-0 table; equality asserted by test)
  int16_t perm_bound[9][577];
};
// family: 0 MPEG-1, 1 MPEG-2, 2 MPEG-2.5 (each family has its own band
// edges, hence its own 9-layout map set — cf. tables.layout_maps(family))
const LayoutMaps &layout_maps(int family = 0);

inline int layout_id(int sfreq, int win_switch, int block_type, int mixed) {
  if (win_switch && block_type == 2) return sfreq * 3 + (mixed ? 2 : 1);
  return sfreq * 3;
}

constexpr unsigned kInbufSize = 4 * 4096;
constexpr uint32_t kEof = 0xFFFFFFFFu;
// internal parse_frame_l12 -> parse_frame signal: CRC mismatch, frame
// body already consumed — restart at the next header (never escapes
// the parser; distinct from every PDMP3_* status)
constexpr int kCrcSkip = -100;

// ---- input ring buffer (semantics: pdmp3.c:1062-1086, 2391-2423) ----
struct InRing {
  uint8_t buf[kInbufSize];
  unsigned istart = 0, iend = 0;
  size_t processed = 0;

  unsigned filled() const {
    return istart <= iend ? iend - istart : kInbufSize - istart + iend;
  }
  unsigned free_space() const {
    return iend < istart ? istart - iend : kInbufSize - iend + istart;
  }
  // A feed that exactly reaches the buffer end parks iend at
  // kInbufSize (reference parity, pdmp3.c:2406-2410).  When a consumer
  // then wraps istart to 0, the remaining data is exactly zero but the
  // parked iend would read as a ghost-full ring — istart could never
  // equal iend again and the sync scan would spin forever (a latent
  // defect in the reference itself: Get_Byte pdmp3.c:1464-1474 has no
  // escape).  Normalizing iend at the wrap moment is exact: data never
  // extends past iend, so istart==0 with iend parked means empty.
  void normalize_wrap() {
    if (istart == 0 && iend == kInbufSize) iend = 0;
  }
  uint32_t get_byte() {
    if (istart == iend) return kEof;
    uint32_t v = buf[istart++];
    if (istart == kInbufSize) {
      istart = 0;
      normalize_wrap();
    }
    processed++;
    return v;
  }
  // non-consuming 32-bit big-endian peek at `off` bytes past the read
  // cursor; kEof when fewer than off+4 bytes are buffered (free-format
  // frame-size measurement)
  uint32_t peek4(unsigned off) const {
    if (off + 4 > filled()) return kEof;
    uint32_t w = 0;
    for (unsigned k = 0; k < 4; k++)
      w = (w << 8) | buf[(istart + off + k) % kInbufSize];
    return w;
  }
  // Bulk get_byte: copies min(n, filled()) bytes into dst (at most two
  // memcpy segments across the wrap) and returns the count — same cursor
  // and `processed` effects as that many get_byte() calls.
  unsigned get_bytes(uint8_t *dst, unsigned n) {
    unsigned avail = filled();
    if (n > avail) n = avail;
    unsigned first = kInbufSize - istart;
    if (first > n) first = n;
    std::memcpy(dst, buf + istart, first);
    std::memcpy(dst + first, buf, n - first);
    istart = (istart + n) % kInbufSize;
    normalize_wrap();
    processed += n;
    return n;
  }
  // consume n buffered bytes without copying (ID3 tag skip)
  void discard(unsigned n) {
    istart = (istart + n) % kInbufSize;
    normalize_wrap();
    processed += n;
  }
  int feed(const uint8_t *in, size_t size);
};

// ---- bit reservoir (pdmp3.c:1096-1122, 1489-1541) ----
//
// The reference reads reservoir bits byte-wise with a word-OR window
// (pdmp3.c:1504-1526); since Get_Bytes never stores EOF sentinels into the
// reservoir (pdmp3.c:1076-1086), the stream is plain MSB-first bytes and a
// single unaligned big-endian 64-bit load serves every read (n <= 56),
// branch-free.  The +16 tail padding covers window overreads of the stale
// region past `top` (the reference reads the same stale bytes).
struct Reservoir {
  uint8_t bytes[2048 + 16] = {0};
  unsigned byte_pos = 0;  // cursor
  unsigned bit_idx = 0;   // 0-7
  unsigned top = 0;

  uint64_t window() const {
    uint64_t w;
    std::memcpy(&w, bytes + byte_pos, 8);
    return __builtin_bswap64(w);
  }
  unsigned get_bit() {
    unsigned b = (bytes[byte_pos] >> (7 - bit_idx)) & 1u;
    bit_idx++;
    byte_pos += bit_idx >> 3;
    bit_idx &= 7;
    return b;
  }
  unsigned get_bits(unsigned n) {  // n <= 24
    if (n == 0) return 0;
    uint32_t v = (uint32_t)((window() << bit_idx) >> (64 - n));
    bit_idx += n;
    byte_pos += bit_idx >> 3;
    bit_idx &= 7;
    return v;
  }
  unsigned pos() const { return byte_pos * 8 + bit_idx; }
  void set_pos(unsigned bitpos) {
    byte_pos = bitpos >> 3;
    bit_idx = bitpos & 7;
  }
  uint32_t peek_bits(unsigned n) const {  // no cursor movement
    return (uint32_t)((window() << bit_idx) >> (64 - n));
  }
  void advance(unsigned n) {
    bit_idx += n;
    byte_pos += bit_idx >> 3;
    bit_idx &= 7;
  }
};

// ---- side-info bit reader (pdmp3.c:1547-1586) ----
struct SideBuf {
  // padded: the reference's stale-cursor side-info quirk (EOF during the
  // side-info read keeps the previous bit cursor, pdmp3.c:1576-1586) can
  // run a full 32-byte parse from a cursor near the end of the buffer
  // (+8 over the worst stale-cursor parse so the 64-bit window loads
  // stay inside the buffer)
  uint8_t bytes[32 + 56] = {0};
  unsigned byte_pos = 0, bit_idx = 0;
  unsigned get_bits(unsigned n) {
    uint64_t w;
    std::memcpy(&w, bytes + byte_pos, 8);
    w = __builtin_bswap64(w) << bit_idx;
    unsigned v = (unsigned)(w >> (64 - n));
    bit_idx += n;
    byte_pos += bit_idx >> 3;
    bit_idx &= 7;
    return v;
  }
};

struct FrameHeader {
  int id = 0, layer = 0, protection_bit = 0, bitrate_index = 0;
  int sampling_frequency = 0, padding_bit = 0, private_bit = 0;
  int mode = 0, mode_extension = 0, copyright = 0, original = 0,
      emphasis = 0;
  // 0 = MPEG-1, 1 = MPEG-2, 2 = MPEG-2.5 (families 1/2 reachable only
  // behind PDMP3_PROFILE_LSF; the reference rejects id==0, pdmp3.c:1295)
  int family = 0;
  // header bits 16-31 verbatim — the CRC-protected half (11172-3
  // §2.4.3.1); consumed only behind PDMP3_PROFILE_CRC
  uint16_t raw16 = 0;
  // measured free-format frame size excl. padding (bitrate_index == 0,
  // reachable only behind PDMP3_PROFILE_FREE_FORMAT)
  int free_size = 0;
  int nch() const { return mode == 3 ? 1 : 2; }
  int ngr() const { return family ? 1 : 2; }  // LSF frames: ONE granule
  // PCM samples per channel carried by one frame (cf. Header.pcm_samples)
  int pcm_samples() const {
    if (layer == 1) return 384;
    if (layer == 2) return 1152;  // LSF halves Layer III frames only
    return family ? 576 : 1152;
  }
  long frame_size() const {
    if (bitrate_index == 0)  // free format: measured size
      return free_size + padding_bit;
    int sf = sampling_frequency > 2 ? 2 : sampling_frequency;
    if (layer == 1)  // 11172-3 §2.4.3.1: 4-byte slots in Layer I
      return 4 * (12 * (family ? kBitratesLsfL1 : kBitratesL1)
                           [bitrate_index] /
                      kSampleRatesFam[family][sf] +
                  padding_bit);
    if (layer == 2)
      return 144 * (family ? kBitratesLsf : kBitratesL2)[bitrate_index] /
                 kSampleRatesFam[family][sf] +
             padding_bit;
    if (family)  // 72-factor LSF framing (tables.lsf_frame_size)
      return 72 * kBitratesLsf[bitrate_index] /
                 kSampleRatesFam[family][sampling_frequency] +
             padding_bit;
    return 144 * kBitratesL3[bitrate_index] /
               kSampleRates[sampling_frequency] +
           padding_bit;
  }
};

struct SideInfo {
  unsigned main_data_begin = 0;
  unsigned scfsi[2][4] = {};
  unsigned part2_3_length[2][2] = {};
  unsigned big_values[2][2] = {};
  unsigned global_gain[2][2] = {};
  unsigned scalefac_compress[2][2] = {};
  unsigned win_switch[2][2] = {};
  unsigned block_type[2][2] = {};
  unsigned mixed[2][2] = {};
  unsigned table_select[2][2][3] = {};
  unsigned subblock_gain[2][2][3] = {};
  unsigned region0_count[2][2] = {};
  unsigned region1_count[2][2] = {};
  unsigned preflag[2][2] = {};
  unsigned scalefac_scale[2][2] = {};
  unsigned count1table_select[2][2] = {};
  int count1[2][2] = {};
};

// ---- streaming frame parser ----
struct FrameParser {
  InRing in;
  Reservoir res;
  SideBuf side;
  FrameHeader hdr;
  SideInfo si;
  int new_header = 0;
  unsigned profile = 0;  // PDMP3_PROFILE_* flags (0 = reference parity)
  // scalefactors persist across frames like the reference's g_main_data
  // (stale entries feed scfsi copies and the sfb21 alias slot)
  uint8_t scf_l_state[2][2][22] = {};
  uint8_t scf_s_state[2][2][13][3] = {};

  // LSF intensity-stereo sidecar (13818-3 §2.4.3.4.3): ch1's transmitted
  // positions with the per-partition all-ones illegal value mapped to
  // kLsfIsIllegal, plus the intensity_scale bit.  Valid only for the
  // current frame when hdr.family != 0 and is_flag.
  int16_t lsf_is_l[22] = {};
  int16_t lsf_is_s[13][3] = {};
  int lsf_iscale = 0;

  bool lsf_enabled() const { return (profile & PDMP3_PROFILE_LSF) != 0; }
  bool free_enabled() const {
    return (profile & PDMP3_PROFILE_FREE_FORMAT) != 0;
  }
  bool id3_enabled() const { return (profile & PDMP3_PROFILE_ID3) != 0; }
  bool l12_enabled() const { return (profile & PDMP3_PROFILE_L12) != 0; }
  bool crc_enabled() const { return (profile & PDMP3_PROFILE_CRC) != 0; }
  // unskipped ID3v2 tag bytes (can exceed the ring); see skip_id3()
  unsigned id3_remaining = 0;
  void skip_id3();
  // measured free-format frame size excl. padding (0 = unknown); reset
  // by open_feed
  unsigned free_size = 0;
  int measure_free_size();
  void reset();                 // pdmp3_open_feed semantics
  int read_header();            // sync scan + field checks
  int search_header();          // resync wrapper with rollback
  int read_side_info();
  int read_side_info_lsf(int nch);
  int get_main_data(unsigned size, unsigned begin);
  void read_scalefactors(int gr, int ch, pdmp3_granules *g);
  void read_scalefactors_lsf(int ch);
  void region_bounds(int gr, int ch, int ends[3], int tnums[3]) const;
  void read_huffman(unsigned part_2_start, int gr, int ch,
                    pdmp3_granules *g, int16_t *line = nullptr);
  // wire_dst: optional per-(gr,ch) destinations; long-block channels
  // decode straight into them (the wire is line-ordered and long-block
  // layouts are the identity), short/mixed channels still land in
  // g->ix for the reorder gather.  g->ix of redirected channels is left
  // stale — callers passing wire_dst must not read it.
  int read_main(pdmp3_granules *g, int16_t *const (*wire_dst)[2] = nullptr);
  int parse_frame(pdmp3_granules *g,
                  int16_t *const (*wire_dst)[2] = nullptr);
  // Layer I/II (PDMP3_PROFILE_L12): bit-parse + requantize one frame's
  // subband samples into g->sb_samples (beyond-reference; mirrors
  // frontend._read_frame_l12 / _parse_l1 / _parse_l2 bitwise).
  // crc_read >= 0 (PDMP3_PROFILE_CRC): verify before parsing; kCrcSkip
  // on mismatch (body consumed, caller restarts)
  int parse_frame_l12(pdmp3_granules *g, int32_t crc_read = -1);
};

// Clear-text per-stage debug dumps for the NATIVE path (equivalent of
// the reference's DEBUG dmp_* printfs, pdmp3.c:894-965, whose build is
// bit-rotted — dmp_scf has a syntax error).  Format matches
// pdmp3_tpu/utils/dumps.py line-for-line so native-vs-Python dump
// diffs are mechanical.  Gated by env PDMP3_DEBUG_DUMPS: "1" = frame
// dumps (header/side-info/scalefacs/Huffman) to stderr after each
// successful parse; "2" additionally dumps requantized (SAMPLES0) and
// post-stereo (SAMPLES1) spectra per granule-channel from the scalar
// DSP.  The env is read once per process.
int debug_dump_level();
void dump_frame_state(const FrameParser &fp, const pdmp3_granules &g);
void dump_samples(const float *x, int stage);

// ---- scalar bit-exact DSP (cf. oracle.py; pdmp3.c:1649-2045) ----
struct ScalarDsp {
  float store[2][32][18] = {};
  // Polyphase FIFO as a ring of 16 64-float matrixing blocks (newest at
  // vhead) instead of the reference's shift-down-by-64 buffer
  // (pdmp3.c:1983-1998) — same values, no 3.8KB memmove per matrixing.
  float v[2][16][64] = {};
  int vhead[2] = {0, 0};
  void reset() {
    std::memset(store, 0, sizeof store);
    std::memset(v, 0, sizeof v);
    vhead[0] = vhead[1] = 0;
  }
  void decode_frame(const pdmp3_granules &g, uint32_t out[2][576],
                    unsigned profile = 0);
  // one 32-sample polyphase synthesis step (pdmp3.c:2006-2042): v FIFO
  // ring-decrement, 64x32 matrixing, D-window FIR, S16 quantize/pack
  // into outrow[32*ss..].  Shared by Layer III (18 steps per granule)
  // and Layer I/II (12/36 steps per frame, samples from the frontend).
  void synth_step(int ch, int nch, const float s_vec[32],
                  uint32_t *outrow, int ss);
};

}  // namespace pdmp3host

struct pdmp3_handle {
  pdmp3host::FrameParser fp;
  pdmp3host::ScalarDsp dsp;
  uint32_t out[2][576] = {};
  unsigned ostart = 0;
  // PCM words the current frame carries: 1152 for MPEG-1 (2 granules),
  // 576 for LSF frames (cf. api.PDMP3.owords)
  unsigned owords = 2 * 576;
};

#endif  // PDMP3_TPU_HOST_INTERNAL_H_
