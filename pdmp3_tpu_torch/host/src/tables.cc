// Constant tables + derived per-layout maps for the native host library.
#include "internal.h"

namespace pdmp3host {

#include "gen_tables.inc"

namespace {

LayoutMaps build_maps(int family) {
  // family-parameterized band maps (cf. tables.layout_maps(family)):
  // LSF families swap in the 13818-3 band edges and switch from long to
  // short bands at long sfb 6 in mixed blocks (kSwitchSfbL) — both
  // families keep the 36-line boundary (L[switch_l] == 36 == 3*S[3]).
  LayoutMaps m{};
  int switch_l = kSwitchSfbL[family];
  for (int sf = 0; sf < 3; sf++) {
    const int *L = kSfbLongFam[family][sf];
    const int *S = kSfbShortFam[family][sf];

    // long layout
    {
      int lay = sf * 3;
      for (int b = 0; b < 22; b++)
        for (int i = L[b]; i < L[b + 1]; i++) {
          m.sfb[lay][i] = (int16_t)b;
          m.band_start[lay][i] = (int16_t)L[b];
          m.intensity_ok[lay][i] = b < 21;
        }
      for (int i = 0; i < 576; i++) m.reorder[lay][i] = (int16_t)i;
    }

    for (int kind = 1; kind <= 2; kind++) {  // short, mixed
      int lay = sf * 3 + kind;
      int start_sfb = kind == 2 ? 3 : 0;
      for (int i = 0; i < 576; i++) m.reorder[lay][i] = (int16_t)i;
      // mixed: long bands 0..switch_l-1 cover lines [0, L[switch_l])
      // == [0, 3*S[3]) — 36 lines except 8 kHz LSF, where the split
      // sits at 72 (tables.py layout_maps asserts the equality)
      if (kind == 2) {
        for (int b = 0; b < switch_l; b++)
          for (int i = L[b]; i < L[b + 1] && i < 576; i++) {
            m.sfb[lay][i] = (int16_t)b;
            m.band_start[lay][i] = (int16_t)L[b];
            m.intensity_ok[lay][i] = 1;
          }
      }
      int i = 3 * S[start_sfb];
      for (int b = start_sfb; b < 13; b++) {
        int wl = S[b + 1] - S[b];
        for (int w = 0; w < 3; w++)
          for (int j = 0; j < wl; j++, i++) {
            m.sfb[lay][i] = (int16_t)b;
            m.win[lay][i] = (int16_t)w;
            m.is_short[lay][i] = 1;
            m.band_start[lay][i] = (int16_t)(3 * S[b]);
            m.intensity_ok[lay][i] = b < 12;
          }
      }
      // reorder: within band b (and the trailing band-12 region),
      // reordered[3*s+3*j+w] = raw[3*s + w*wl + j]  (pdmp3.c:1786-1823)
      for (int b = start_sfb; b < 12; b++) {
        int s0 = 3 * S[b], wl = S[b + 1] - S[b];
        for (int w = 0; w < 3; w++)
          for (int j = 0; j < wl; j++)
            m.reorder[lay][s0 + 3 * j + w] = (int16_t)(s0 + w * wl + j);
      }
      int s0 = 3 * S[12], wl = S[13] - S[12];
      for (int w = 0; w < 3; w++)
        for (int j = 0; j < wl; j++)
          m.reorder[lay][s0 + 3 * j + w] = (int16_t)(s0 + w * wl + j);
    }
  }
  // perm_bound[lay][c] = 1 + max{i : reorder[i] < c} (0 for c == 0):
  // the smallest line-ordered prefix covering bitstream lines [0, c).
  // at[v] = latest wire position (+1) reading bitstream line v; the
  // bound is its prefix max.
  for (int lay = 0; lay < 9; lay++) {
    int16_t at[576] = {};
    for (int i = 0; i < 576; i++) {
      int v = m.reorder[lay][i];
      if (i + 1 > at[v]) at[v] = (int16_t)(i + 1);
    }
    int run = 0;
    m.perm_bound[lay][0] = 0;
    for (int c = 1; c <= 576; c++) {
      if (at[c - 1] > run) run = at[c - 1];
      m.perm_bound[lay][c] = (int16_t)run;
    }
  }
  return m;
}

}  // namespace

const LayoutMaps &layout_maps(int family) {
  static const LayoutMaps m0 = build_maps(0);
  static const LayoutMaps m1 = build_maps(1);
  static const LayoutMaps m2 = build_maps(2);
  return family == 2 ? m2 : (family == 1 ? m1 : m0);
}

}  // namespace pdmp3host
