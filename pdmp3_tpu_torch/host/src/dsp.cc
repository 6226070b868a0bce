// Scalar float32 DSP backend — bit-exact vs the reference decoder.
//
// Per-granule math of pdmp3.c:1024-1060, 1649-2045, 2117-2220 with
// identical float32 operation ordering (sequential accumulations, the
// double-precision rounding points at the MS butterfly and the final
// quantize).  Build with -ffp-contract=off: FMA contraction would change
// the rounding.  State (overlap store, polyphase FIFO) is per-handle, not
// function-static like the reference (pdmp3.c:1755, 1983), so concurrent
// streams are safe.
#include <cmath>

#include "internal.h"

namespace pdmp3host {

namespace {

constexpr double kInvSqrt2 = 0.70710678118654752440;

// Transposed matrixing window so the 64-output loop reads columns
// contiguously (function-local static: safe vs cross-TU init order).
struct NwinT {
  float t[32][64];
  NwinT() {
    for (int i = 0; i < 64; i++)
      for (int j = 0; j < 32; j++) t[j][i] = kSynthNwin[i][j];
  }
};
inline const float (*nwin_t())[64] {
  static const NwinT nt;
  return nt.t;
}

inline float pow43_signed(int v) {
  int a = v < 0 ? -v : v;
  if (a > 8206) a = 8206;
  float p = kPow43[a];
  return v < 0 ? -p : p;
}

void requantize(const pdmp3_granules &g, int gr, int ch, int lay,
                float x[576], const float *prev_gr0_ch0) {
  // pdmp3.c:1829-1905, 2117-2152 — all 576 lines (zeros stay +0.0).
  // LSF (g.family != 0): family band maps; long scalefactors reach 31
  // (slen 5, 13818-3 §2.4.3.4) so q reaches 124 — past the MPEG-1 gain
  // table's 100-entry live region, handled by the same true-2^(-q/4)
  // fallback the short path uses (cf. oracle GAIN_QUARTER_TRUE).
  const LayoutMaps &m = layout_maps(g.family);
  int qpu = g.scalefac_scale[gr][ch] ? 4 : 2;
  int gg = g.global_gain[gr][ch];
  float t2_long = kGainGlobal[gg - 210 + kGainGlobalOff];
  for (int i = 0; i < 576; i++) {
    int sfb = m.sfb[lay][i];
    float t1, t2;
    if (m.is_short[lay][i]) {
      int w = m.win[lay][i];
      uint32_t scf = g.scf_s[gr][ch][sfb > 12 ? 12 : sfb][w];
      if (sfb >= 12 && gr == 1 && ch == 1 && prev_gr0_ch0) {
        // reference OOB: scalefac_s[1][1][12][w] reads the float BITS of
        // is[0][0][w] post-DSP as an unsigned scalefactor (DESIGN.md §6)
        std::memcpy(&scf, &prev_gr0_ch0[w], 4);
      }
      uint64_t qq = (uint64_t)qpu * scf;  // quarter-steps (scf may be
                                          // a full 32-bit bit pattern)
      t1 = qq < 100 ? kGainQuarter[qq]
                    : (float)std::pow(2.0, -0.25 * (double)qq);
      t2 = kGainGlobal[gg - 210 - 8 * g.subblock_gain[gr][ch][w] +
                       kGainGlobalOff];
    } else {
      int scf = g.scf_l[gr][ch][sfb];
      int q = qpu * (scf + g.preflag[gr][ch] * kPretab[sfb]);
      t1 = q < 100 ? kGainQuarter[q]
                   : (float)std::pow(2.0, -0.25 * (double)q);
      t2 = t2_long;
    }
    x[i] = (t1 * t2) * pow43_signed(g.ix[gr][ch][i]);
  }
}

void reorder(int family, int lay, float x[576]) {
  // static permutation form of pdmp3.c:1786-1823
  const LayoutMaps &m = layout_maps(family);
  float tmp[576];
  for (int i = 0; i < 576; i++) tmp[i] = x[m.reorder[lay][i]];
  std::memcpy(x, tmp, sizeof tmp);
}

void stereo(const pdmp3_granules &g, int gr, float x[2][576],
            bool spec_intensity = false) {
  // pdmp3.c:1911-1972, 2154-2220
  if (!g.ms_flag && !g.is_flag) return;
  float raw0[576];
  if (g.family && g.is_flag && g.ms_flag)
    std::memcpy(raw0, x[0], sizeof(raw0));
  if (g.ms_flag) {
    // MPEG-1: butterfly over min(count1): count1[gr][!!(c0>c1)]
    // (pdmp3.c:1920).  LSF: full spectrum — the min-count1 extent is
    // bug parity with no LSF target (the reference rejects id=0);
    // production decoders butterfly everything and real LAME MPEG-2/2.5
    // joint-stereo streams decode wrong under the extrapolated quirk
    // (round-5 real-encoder LSF conformance, DESIGN.md §6).
    int mp;
    if (g.family) {
      mp = 576;
    } else {
      int c0 = g.count1[gr][0], c1 = g.count1[gr][1];
      mp = c0 < c1 ? c0 : c1;
      if (mp > 576) mp = 576;
    }
    for (int i = 0; i < mp; i++) {
      float mid = x[0][i] + x[1][i];
      float sid = x[0][i] - x[1][i];
      x[0][i] = (float)((double)mid * kInvSqrt2);
      x[1][i] = (float)((double)sid * kInvSqrt2);
    }
  }
  if (g.is_flag && g.family) {
    // LSF intensity stereo (13818-3 §2.4.3.2; cf. oracle._intensity_lsf):
    // positions from ch1's transmitted scalefactors (sidecar is_pos_*,
    // illegal pre-mapped to 63 = skip), gains k0/k1 selected by
    // intensity_scale and position parity.  Spec-derived — the reference
    // rejects LSF streams, so there is no bug set to emulate.
    const LayoutMaps &m = layout_maps(g.family);
    int lay = g.layout[gr][0];
    int c1r = g.count1[gr][1];
    const float *k0 = kLsfK0[g.iscale & 1], *k1 = kLsfK1[g.iscale & 1];
    for (int i = 0; i < 576; i++) {
      if (!m.intensity_ok[lay][i]) continue;
      if (m.band_start[lay][i] < c1r) continue;
      int sfb = m.sfb[lay][i];
      int p = m.is_short[lay][i]
                  ? g.is_pos_s[sfb > 12 ? 12 : sfb][m.win[lay][i]]
                  : g.is_pos_l[sfb];
      if (p == kLsfIsIllegal) continue;
      // the carrier is the RAW ch0 (mid) value: with full-spectrum MS
      // above, x[0][i] is already mid/sqrt(2) here (libavcodec runs
      // intensity before MS; raw carrier gives the same result)
      float seg = g.ms_flag ? raw0[i] : x[0][i];
      x[0][i] = k0[p & 63] * seg;
      x[1][i] = k1[p & 63] * seg;
    }
    return;
  }
  if (g.is_flag) {
    const LayoutMaps &m = layout_maps();
    int lay = g.layout[gr][0];
    int c1r = g.count1[gr][1];
    for (int i = 0; i < 576; i++) {
      if (!m.intensity_ok[lay][i]) continue;
      if (m.band_start[lay][i] < c1r) continue;
      int sfb = m.sfb[lay][i];
      int is_pos;
      if (m.is_short[lay][i]) {
        int w = m.win[lay][i];
        is_pos = g.scf_s[gr][0][sfb > 12 ? 12 : sfb][w];
        if (is_pos == 7) continue;
        if (spec_intensity) {
          // PDMP3_PROFILE_SPEC_INTENSITY: pan by the ratio tables like
          // the long-block form (the math pdmp3.c:2190-2213 intended)
          int p = is_pos > 7 ? 7 : is_pos;
          float left = kIsRatioL[p] * x[0][i];
          float right = kIsRatioR[p] * x[0][i];
          x[0][i] = left;
          x[1][i] = right;
        } else {
          // reference transcription bug (pdmp3.c:2212-2213): both
          // channels become (float)(unsigned)trunc(left)
          float u = (float)(uint32_t)(int64_t)x[0][i];
          x[0][i] = u;
          x[1][i] = u;
        }
      } else {
        is_pos = g.scf_l[gr][0][sfb];
        if (is_pos == 7) continue;
        // is_pos 8..15 replays the reference's OOB is_ratios read
        // (pdmp3.c:2170 lands in its rodata padding + ca[]; probed
        // values baked into the 16-wide ratio tables, tables.py)
        float rl = kIsRatioL[is_pos > 15 ? 15 : is_pos];
        float rr = kIsRatioR[is_pos > 15 ? 15 : is_pos];
        float left = rl * x[0][i];
        float right = rr * x[0][i];
        x[0][i] = left;
        x[1][i] = right;
      }
    }
  }
}

void antialias(const pdmp3_granules &g, int gr, int ch, float x[576]) {
  // pdmp3.c:1706-1732
  bool pure_short = g.win_switch[gr][ch] && g.block_type[gr][ch] == 2 &&
                    !g.mixed[gr][ch];
  if (pure_short) return;
  int sblim = (g.win_switch[gr][ch] && g.block_type[gr][ch] == 2 &&
               g.mixed[gr][ch])
                  ? 2
                  : 32;
  for (int sb = 1; sb < sblim; sb++) {
    for (int i = 0; i < 8; i++) {
      int li = 18 * sb - 1 - i, ui = 18 * sb + i;
      float lb = x[li] * kCs[i] - x[ui] * kCa[i];
      float ub = x[ui] * kCs[i] + x[li] * kCa[i];
      x[li] = lb;
      x[ui] = ub;
    }
  }
}

void imdct_win(const float in[18], float out[36], int bt) {
  // pdmp3.c:1649-1700.  The loops run output-outer in the reference; here
  // they run reduction-outer with per-output accumulators so the output
  // axis vectorizes — each output still adds its terms in the same mm
  // order with the same operands, so every sum is bit-identical.
  for (int i = 0; i < 36; i++) out[i] = 0.0f;
  if (bt == 2) {
    for (int i3 = 0; i3 < 3; i3++) {
      float sums[12];
      for (int p = 0; p < 12; p++) sums[p] = 0.0f;
      for (int mm = 0; mm < 6; mm++) {
        float s = in[i3 + 3 * mm];
        const float *row = kCosN12[mm];
        for (int p = 0; p < 12; p++) sums[p] += s * row[p];
      }
      for (int p = 0; p < 12; p++)
        out[6 * i3 + p + 6] += sums[p] * kImdctWin[2][p];
    }
  } else {
    float sums[36];
    for (int p = 0; p < 36; p++) sums[p] = 0.0f;
    for (int mm = 0; mm < 18; mm++) {
      float s = in[mm];
      const float *row = kCosN36[mm];
      for (int p = 0; p < 36; p++) sums[p] += s * row[p];
    }
    for (int p = 0; p < 36; p++) out[p] = sums[p] * kImdctWin[bt][p];
  }
}

}  // namespace

void ScalarDsp::synth_step(int ch, int nch, const float s_vec[32],
                           uint32_t *outrow, int ss) {
  // polyphase synthesis (pdmp3.c:1978-2045).  The reference shifts a
  // 1024-float buffer down by 64 every matrixing and gathers a 512-tap
  // window; we keep the FIFO as a ring of 16 blocks and accumulate the
  // D-window directly from the ring.  Per output sample i the 16 FIR
  // terms are added in the same j=0..15 order with identical float
  // operands, so the PCM is bit-identical.
  float(*vb)[64] = v[ch];
  int &vh = vhead[ch];
  vh = (vh + 15) & 15;  // ring-decrement: new block becomes age 0
  // matrixing, reduction-outer (same j order per output → bit-exact)
  float *nb = vb[vh];
  const float(*nt)[64] = nwin_t();
  for (int i = 0; i < 64; i++) nb[i] = 0.0f;
  for (int j = 0; j < 32; j++) {
    float sj = s_vec[j];
    const float *col = nt[j];
    for (int i = 0; i < 64; i++) nb[i] += col[i] * sj;
  }
  // FIR term j reads the block of age j: even j at offsets [0,32),
  // odd j at [32,64) (the reference's u[] gather, pdmp3.c:2005-2012)
  float sums[32];
  for (int i = 0; i < 32; i++) sums[i] = 0.0f;
  for (int j = 0; j < 16; j++) {
    const float *bj = vb[(vh + j) & 15] + ((j & 1) << 5);
    const float *dj = kSynthD + (j << 5);
    for (int i = 0; i < 32; i++) sums[i] += bj[i] * dj[i];
  }
  for (int i = 0; i < 32; i++) {
    float sum = sums[i];
    int32_t samp = (int32_t)((double)sum * 32767.0);
    if (samp > 32767) samp = 32767;
    else if (samp < -32767) samp = -32767;
    samp &= 0xFFFF;
    unsigned o = 32 * (unsigned)ss + (unsigned)i;
    if (ch == 0) {
      outrow[o] = (nch == 1) ? (((uint32_t)samp << 16) | (uint32_t)samp)
                             : ((uint32_t)samp << 16);
    } else {
      outrow[o] |= (uint32_t)samp;
    }
  }
}

void ScalarDsp::decode_frame(const pdmp3_granules &g, uint32_t out[2][576],
                             unsigned profile) {
  int nch = g.nch;
  if (g.layer == 1 || g.layer == 2) {
    // Layer I/II: the frontend already requantized; the DSP is the
    // polyphase filterbank alone (cf. oracle.OracleDSP.decode_frame's
    // sb_samples path — same ch-outer/step-inner order, bit-identical)
    for (int ch = 0; ch < nch; ch++)
      for (int p = 0; p < g.nparts; p++)
        synth_step(ch, nch, g.sb_samples[ch][p], out[p / 18], p % 18);
    return;
  }
  int ngr = g.family ? 1 : 2;  // LSF frames carry ONE granule
  float prev_gr0_ch0[3] = {0, 0, 0};
  for (int gr = 0; gr < ngr; gr++) {
    float x[2][576] = {};
    for (int ch = 0; ch < nch; ch++) {
      int lay = g.layout[gr][ch];
      requantize(g, gr, ch, lay, x[ch], gr == 1 ? prev_gr0_ch0 : nullptr);
      if (g.win_switch[gr][ch] && g.block_type[gr][ch] == 2)
        reorder(g.family, lay, x[ch]);
    }
    if (debug_dump_level() >= 2)
      for (int ch = 0; ch < nch; ch++) dump_samples(x[ch], 0);
    stereo(g, gr, x, (profile & PDMP3_PROFILE_SPEC_INTENSITY) != 0);
    if (debug_dump_level() >= 2)
      for (int ch = 0; ch < nch; ch++) dump_samples(x[ch], 1);
    for (int ch = 0; ch < nch; ch++) {
      antialias(g, gr, ch, x[ch]);
      // hybrid synthesis: IMDCT + overlap-add (pdmp3.c:1752-1780)
      for (int sb = 0; sb < 32; sb++) {
        int bt = (g.win_switch[gr][ch] && g.mixed[gr][ch] && sb < 2)
                     ? 0
                     : g.block_type[gr][ch];
        float raw[36];
        imdct_win(&x[ch][sb * 18], raw, bt);
        for (int i = 0; i < 18; i++) {
          x[ch][sb * 18 + i] = raw[i] + store[ch][sb][i];
          store[ch][sb][i] = raw[i + 18];
        }
      }
      // frequency inversion (pdmp3.c:1738-1746)
      for (int sb = 1; sb < 32; sb += 2)
        for (int i = 1; i < 18; i += 2) x[ch][sb * 18 + i] = -x[ch][sb * 18 + i];
      // polyphase synthesis (pdmp3.c:1978-2045).  The reference shifts a
      // 1024-float buffer down by 64 every matrixing and gathers a 512-tap
      // window; we keep the FIFO as a ring of 16 blocks and accumulate the
      // D-window directly from the ring.  Per output sample i the 16 FIR
      // terms are added in the same j=0..15 order with identical float
      // operands, so the PCM is bit-identical.
      for (int ss = 0; ss < 18; ss++) {
        float s_vec[32];
        for (int i = 0; i < 32; i++) s_vec[i] = x[ch][i * 18 + ss];
        synth_step(ch, nch, s_vec, out[gr], ss);
      }
    }
    for (int k = 0; k < 3; k++) prev_gr0_ch0[k] = x[0][k];
  }
}

}  // namespace pdmp3host
