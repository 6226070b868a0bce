// Device code shared by the granule kernels: the wire's constants, the
// table operands and small helpers, for every kernel (K1-K3 and K5 run
// the body of granule_persist.cuh); and, for K4 (back_half.cu) alone,
// the IMDCT / polyphase dot products in both summation orders and the
// back half of one channel.  Each summation order and rounding point
// here mirrors the plain PyTorch stage ops (pdmp3_tpu_torch/ops/dsp.py),
// so every kernel is held to its plain version bit for bit.
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
constexpr int kBlkStride = 65;  // FIFO row stride: the matrixing writes a
                                // column, 65 keeps its banks distinct

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

// sum of v[0..N) as a pairwise tree: neighbours (0,1), (2,3), ... added
// level by level, an odd last term moving up unchanged (dsp._dot_tree)
template <int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    constexpr int M = (N + 1) / 2;
    float w[M];
#pragma unroll
    for (int k = 0; k < N / 2; ++k) w[k] = v[2 * k] + v[2 * k + 1];
    if constexpr (N % 2 == 1) w[M - 1] = v[N - 1];
    return tree_sum<M>(w);
  }
}

// sum over m of x[m * xs] * w[m * ws], each product rounded: sequentially
// from the first product when kExact (dsp._dot_seq, the reference's
// order), else as a pairwise tree (dsp._dot_tree)
template <bool kExact, int N>
__device__ __forceinline__ float dot(const float* x, int xs, const float* w,
                                     int ws) {
  if constexpr (kExact) {
    float acc = x[0] * __ldg(w);
#pragma unroll
    for (int m = 1; m < N; ++m) acc = acc + x[m * xs] * __ldg(w + m * ws);
    return acc;
  } else {
    float v[N];
#pragma unroll
    for (int m = 0; m < N; ++m) v[m] = x[m * xs] * __ldg(w + m * ws);
    return tree_sum<N>(v);
  }
}

// one output sample p (0..35) of the three overlapped, windowed 12-point
// IMDCTs of a short block: [6,12) = c0, [12,18) = c0 + c1, [18,24) =
// c1 + c2, [24,30) = c2, zero elsewhere (pdmp3.c:1684)
template <bool kExact>
__device__ float short_out(const Tables& t, const float* xa, int p) {
  float acc = 0.0f;
  bool any = false;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const int q = p - 6 - 6 * w;
    if (q >= 0 && q < 12) {
      const float c = dot<kExact, 18>(xa, 1, t.c3 + w * 12 + q, 36) *
                      __ldg(t.win2 + q);
      acc = any ? acc + c : c;
      any = true;
    }
  }
  return acc;
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

// The back half of one channel of the block's slot; every thread of the
// block calls it.  xa: the channel's post-antialias spectrum in shared
// memory, subband-major [32][18]; bt: the effective block type of this
// thread's subband (tid / 18); store [32*18] and v [15*64]: the channel's
// state in device memory, updated in place when write_state (each
// element by the thread that read it); prev3: when not null, receives
// x_time[0:3] of subband 0.  s_xt [32*18] and s_blk [33*kBlkStride] are
// shared scratch.  Returns this thread's FIR sum: PCM sample tid of the
// channel (time it = tid / 32, subband output k = tid % 32).
template <bool kExact>
__device__ float back_half_channel(const Tables& t, const float* xa, int bt,
                                   float* store, float* v, bool write_state,
                                   float* prev3, float* s_xt, float* s_blk) {
  const int tid = threadIdx.x;
  // ---- IMDCT + window + overlap-add + frequency inversion: thread =
  // (subband sb, sample ii); out36[ii] meets the store, out36[18+ii]
  // becomes the new store (pdmp3.c:1649-1700, 1738-1780) ----
  {
    const int sb = tid / 18, ii = tid % 18;
    const float* x = xa + sb * 18;
    float o_lo, o_hi;
    if (bt == 2) {
      o_lo = short_out<kExact>(t, x, ii);
      o_hi = short_out<kExact>(t, x, 18 + ii);
    } else {
      o_lo = dot<kExact, 18>(x, 1, t.cos36 + ii, 36) *
             __ldg(t.imdct_win + bt * 36 + ii);
      o_hi = dot<kExact, 18>(x, 1, t.cos36 + 18 + ii, 36) *
             __ldg(t.imdct_win + bt * 36 + 18 + ii);
    }
    float* st = store + sb * 18 + ii;
    const float inv = ((sb & 1) && (ii & 1)) ? -1.0f : 1.0f;
    const float xt = (o_lo + *st) * inv;
    if (write_state) *st = o_hi;
    s_xt[sb * 18 + ii] = xt;
    if (prev3 != nullptr && sb == 0 && ii < 3) prev3[ii] = xt;
  }
  for (int k = tid; k < 15 * 64; k += kThreads)
    s_blk[(k / 64) * kBlkStride + k % 64] = v[k];
  __syncthreads();

  // ---- polyphase matrixing (pdmp3.c:2006-2014) into FIFO rows 15..32:
  // nb[it][j] = sum over subbands k of NWIN[j][k] * x_time[k][it] ----
  for (int k = tid; k < 18 * 64; k += kThreads) {
    const int j = k / 18, it = k % 18;
    s_blk[(15 + it) * kBlkStride + j] =
        dot<kExact, 32>(s_xt + it, 18, t.nwin + j * 32, 1);
  }
  __syncthreads();

  // ---- 16-tap D-window FIR over the 33-block FIFO ----
  const int it = tid / 32, k = tid % 32;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    acc = acc + __ldg(t.synth_d + j * 32 + k) *
                    s_blk[(15 - j + it) * kBlkStride + 32 * (j & 1) + k];
  // the new FIFO is its newest 15 blocks, rows 18..32
  if (write_state)
    for (int m = tid; m < 15 * 64; m += kThreads)
      v[m] = s_blk[(18 + m / 64) * kBlkStride + m % 64];
  __syncthreads();
  return acc;
}

}  // namespace pdmp3
