// Device code shared by the granule kernels (K1-K5 run the body of
// granule_persist.cuh): the wire's constants, the table operands and
// small helpers.  Each rounding point here mirrors the plain PyTorch
// stage ops (pdmp3_tpu_torch/ops/dsp.py), so every kernel is held to its
// plain version bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rounding.cuh"

namespace pdmp3 {

constexpr int kLines = 576;
constexpr int kThreads = 576;  // a block's threads: one per line
constexpr int kMetaWords = 32;
constexpr int kLayouts = 9;
constexpr int kPow43Max = 8206;
constexpr int kGainTrue = 640;  // GAIN_QUARTER_TRUE entries

// meta words of the wire (PDMP3_META_*, pdmp3_tpu/host/include/pdmp3.h)
constexpr int M_LAYOUT = 0, M_BT = 2, M_WSF = 4, M_MIXED = 6, M_GG = 8,
              M_SFS = 10, M_PRE = 12, M_C1 = 14, M_SBG = 16, M_MS = 22,
              M_IS = 23, M_NCH = 24, M_ISCALE = 27;
constexpr int kLsfIsIllegal = 63;  // LSF sidecar: no intensity position
// rows of the line maps (pdmp3_tpu_torch/ops/consts.py MAP_*)
constexpr int MAP_SFB_L = 0, MAP_SFB_S = 1, MAP_SFB_S_PLAIN = 2,
              MAP_WIN = 3, MAP_PRETAB = 4, MAP_SHORT = 5,
              MAP_BAND_START = 6, MAP_IOK = 7, MAP_SFB12 = 8;

struct Tables {
  const float* pow43;              // [8207] |x|^(4/3)
  const float* cos36;              // [18][36] long IMDCT basis (m, p)
  const float* c3;                 // [18][36] folded short IMDCT basis
  const float* imdct_win;          // [4][36] window per block type
  const float* win2;               // [12] short window
  const float* nwin;               // [64][32] polyphase matrixing
  const float* synth_d;            // [16][32] D window
  const float* cs;                 // [8] antialias
  const float* ca;                 // [8]
  const float* ratio_l;            // [16] intensity ratios (8..15: OOB)
  const float* ratio_r;            // [16]
  const float* quarter_down;       // [4] 2^(-d/4)
  const float* quarter_up;         // [4] 2^(d/4)
  const float* inv_sqrt2;          // [1] f32(1/sqrt(2))
  const float* gain_quarter_true;  // [640] true 2^(-q/4), subnormals kept
  const int16_t* maps;             // [9][9][576] per-(layout, line) maps
                                   // of the step's family
};
constexpr int kTables = 16;        // pointers of Tables, in that order

// the first kTables table pointers in the order of fused_step.TABLES
inline Tables make_tables(const void* const* p) {
  Tables t;
  t.pow43 = static_cast<const float*>(p[0]);
  t.cos36 = static_cast<const float*>(p[1]);
  t.c3 = static_cast<const float*>(p[2]);
  t.imdct_win = static_cast<const float*>(p[3]);
  t.win2 = static_cast<const float*>(p[4]);
  t.nwin = static_cast<const float*>(p[5]);
  t.synth_d = static_cast<const float*>(p[6]);
  t.cs = static_cast<const float*>(p[7]);
  t.ca = static_cast<const float*>(p[8]);
  t.ratio_l = static_cast<const float*>(p[9]);
  t.ratio_r = static_cast<const float*>(p[10]);
  t.quarter_down = static_cast<const float*>(p[11]);
  t.quarter_up = static_cast<const float*>(p[12]);
  t.inv_sqrt2 = static_cast<const float*>(p[13]);
  t.gain_quarter_true = static_cast<const float*>(p[14]);
  t.maps = static_cast<const int16_t*>(p[15]);
  return t;
}

__device__ __forceinline__ int line_map(const Tables& t, int map, int lay,
                                        int i) {
  return __ldg(t.maps + (map * kLayouts + lay) * kLines + i);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// fast quantize: x32767 in f32, truncate toward zero, clip; NaN and
// values outside int32 become -32767 like the reference's cvttsd2si
// (INT32_MIN, then the clip)
__device__ __forceinline__ float quantize_fast(float acc) {
  const float scaled = acc * 32767.0f;
  const float tr = truncf(scaled);
  if (isnan(scaled) || tr < -2147483648.0f || tr > 2147483648.0f)
    return -32767.0f;
  return fminf(fmaxf(tr, -32767.0f), 32767.0f);
}

// float PCM (ops/dsp.py float_pack): NaN becomes -1, everything else is
// clamped to [-1, 1].  NaN is tested first: fminf / fmaxf return the
// operand that is not NaN, so the clamp alone would give it +-1
__device__ __forceinline__ float float_sample(float acc) {
  return isnan(acc) ? -1.0f : fminf(fmaxf(acc, -1.0f), 1.0f);
}

}  // namespace pdmp3
