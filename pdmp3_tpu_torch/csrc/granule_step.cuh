// The body of one fused granule step, shared by the LSF granule kernel
// (fused_granule.cu: K3) and the frame kernel (frame_fused.cu: K5; K1
// and K2 run granule_persist.cuh, which matches it operation for
// operation): requantize, the MPEG-1 and LSF stereo, antialias, the back
// half of both channels (granule.cuh) and the L|R pack, for the slot of
// the calling block.  Kept in an anonymous namespace, as it was inside
// fused_granule.cu, so that each kernel's translation unit compiles its
// own copy exactly as before.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule.cuh"

namespace {

using namespace pdmp3;

// exact 2^n by exponent-field construction; +0.0 outside [-126, 127]
__device__ __forceinline__ float pow2i(int n) {
  return (n >= -126 && n <= 127) ? __int_as_float((n + 127) << 23) : 0.0f;
}

// requantized line i of channel ch (pdmp3.c:1829-1905, 2117-2152):
// (2^(-q/4) * 2^((gg-210-8*sbg)/4)) * sign(x)|x|^(4/3).  Exact MPEG-1
// gives the host's sentinel-63 scalefactors (q >= 100) zero gain, and,
// when g12 is not null (granule 1), ch1's short band-12 lines the true
// gain g12[window] of the band-12 bit-pattern scalefactors; LSF has
// neither
template <bool kExact, bool kLsf>
__device__ float requantize(const Tables& t, const int* meta,
                            const int* scfl, const int* scfs,
                            const float* g12, int lay, int ch, int i,
                            int x) {
  const int mag = min(abs(x), kPow43Max);
  const float tmp3 = (x < 0 ? -1.0f : 1.0f) * __ldg(t.pow43 + mag);
  const int gg = meta[M_GG + ch];
  const int qpu = 2 << meta[M_SFS + ch];  // scalefac_scale is 0 or 1
  const bool short_line = line_map(t, MAP_SHORT, lay, i) == 1;
  int q, eo;
  if (short_line) {
    q = qpu * scfs[ch * 39 + line_map(t, MAP_SFB_S, lay, i)];
    eo = gg - 210 - 8 * meta[M_SBG + ch * 3 + line_map(t, MAP_WIN, lay, i)];
  } else {
    q = qpu * (scfl[ch * 22 + line_map(t, MAP_SFB_L, lay, i)] +
               line_map(t, MAP_PRETAB, lay, i) * meta[M_PRE + ch]);
    eo = gg - 210;
  }
  // >> floors negative values and & 3 keeps d in 0..3 (two's complement)
  float tmp1 = __ldg(t.quarter_down + (q & 3)) * pow2i(-(q >> 2));
  if constexpr (kExact && !kLsf) {
    if (q >= 100) tmp1 = 0.0f;
    if (g12 != nullptr && ch == 1 && line_map(t, MAP_SFB12, lay, i) == 1)
      tmp1 = g12[line_map(t, MAP_WIN, lay, i)];
  }
  const float tmp2 = __ldg(t.quarter_up + (eo & 3)) * pow2i(eo >> 2);
  return (tmp1 * tmp2) * tmp3;
}

// K3's operands beyond the MPEG-1 kernel's: the [B][64] intensity sidecar
// ([0..21] long positions, [22..60] short flat, 63 = illegal) and the
// gain pairs k0/k1 [2][64] by [iscale != 0][position]
struct LsfOperands {
  const int16_t* is_pos;
  const float* k0;
  const float* k1;
};

// the LSF intensity of line i (13818-3 §2.4.3.2; pallas_step.py:976-1004),
// after the full-spectrum MS: on eligible bands at or above ch1's count1
// whose sidecar position is legal, both channels pan the RAW (pre-MS) ch0
// line by the gain pair of the slot's iscale row
__device__ __forceinline__ void lsf_intensity(const Tables& t,
                                              const LsfOperands& lsf,
                                              const int* meta,
                                              const int* ipos, int lay0,
                                              int i, int c1r, float l_raw,
                                              float& l, float& r) {
  // short positions are read window-major, as for MPEG-1
  const int pos = line_map(t, MAP_SHORT, lay0, i) == 1
                      ? ipos[22 + line_map(t, MAP_SFB_S_PLAIN, lay0, i)]
                      : ipos[line_map(t, MAP_SFB_L, lay0, i)];
  if (line_map(t, MAP_IOK, lay0, i) == 1 &&
      line_map(t, MAP_BAND_START, lay0, i) >= c1r && pos != kLsfIsIllegal) {
    const int k = (meta[M_ISCALE] != 0) * 64 + clampi(pos, 0, 63);
    l = __ldg(lsf.k0 + k) * l_raw;
    r = __ldg(lsf.k1 + k) * l_raw;
  }
}

// One granule step of the block's slot, both channels: the body of K1, K2
// (kLsf = false) and K3 (kLsf = true); every thread of the block calls it
template <bool kExact, bool kLsf>
__device__ __forceinline__ void granule_step(
    const int16_t* __restrict__ ix, const int16_t* __restrict__ scf_l,
    const int16_t* __restrict__ scf_s, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ active, int gr1, int bug_compat,
    float* __restrict__ store, float* __restrict__ v,
    float* __restrict__ prev, uint32_t* __restrict__ pcm, const Tables& t,
    const LsfOperands& lsf) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  uint32_t* out = pcm + (size_t)b * kLines;  // one L|R<<16 word per sample

  if (active[b] == 0) {
    // idle slot: silence, state untouched (uniform over the block)
    out[tid] = 0u;
    return;
  }

  __shared__ int s_meta[kMetaWords];
  __shared__ int s_scfl[2 * 22];
  __shared__ int s_scfs[2 * 39];
  __shared__ float s_g12[3];                 // exact band-12 true gains
  __shared__ float s_x[2][kLines];           // spectra, subband-major
  __shared__ float s_xt[32 * 18];            // x_time of one channel [sb][i]
  __shared__ float s_blk[33 * kBlkStride];   // FIFO of one channel, oldest first
  __shared__ int16_t s_left[kLines];         // channel 0 PCM
  __shared__ int s_ipos[kLsf ? 64 : 1];      // LSF intensity sidecar

  if (tid < kMetaWords) s_meta[tid] = meta[b * kMetaWords + tid];
  if (tid < 2 * 22) s_scfl[tid] = scf_l[b * 2 * 22 + tid];
  if (tid < 2 * 39) s_scfs[tid] = scf_s[b * 2 * 39 + tid];
  if constexpr (kLsf) {
    if (tid < 64) s_ipos[tid] = lsf.is_pos[b * 64 + tid];
  }
  __syncthreads();
  if (!kLsf && gr1 && tid < 3) {
    // band-12 OOB read (docs/DESIGN.md §6): granule 1's ch1 short band-12
    // scalefactors alias the float BITS of granule 0's first three ch0
    // output lines, as uint32
    const unsigned bits = __float_as_uint(prev[b * 3 + tid]);
    const int scf12 = bits < 1024u ? (int)bits : 1024;
    s_scfs[39 + 36 + tid] = scf12;
    if constexpr (kExact) {
      // the true 2^(-q/4), +0.0 past the table (2^-160 rounds to zero)
      const int idx = (2 << s_meta[M_SFS + 1]) * scf12;
      s_g12[tid] = idx < kGainTrue ? __ldg(t.gain_quarter_true + idx) : 0.0f;
    }
  }
  __syncthreads();

  // ---- requantize + stereo: thread = line ----
  {
    const int i = tid;
    const int lay0 = clampi(s_meta[M_LAYOUT], 0, kLayouts - 1);
    const int lay1 = clampi(s_meta[M_LAYOUT + 1], 0, kLayouts - 1);
    const int16_t* sx = ix + (size_t)b * 2 * kLines;
    const float* g12 = (kExact && !kLsf && gr1) ? s_g12 : nullptr;
    float l = requantize<kExact, kLsf>(t, s_meta, s_scfl, s_scfs, g12, lay0,
                                       0, i, sx[i]);
    float r = requantize<kExact, kLsf>(t, s_meta, s_scfl, s_scfs, g12, lay1,
                                       1, i, sx[kLines + i]);
    const float l_raw = l;
    // MS below min(count1) (pdmp3.c:1920); LSF: over the full spectrum
    const int c0 = clampi(s_meta[M_C1], 0, kLines);
    const int c1r = clampi(s_meta[M_C1 + 1], 0, kLines);
    if (s_meta[M_MS] != 0 && (kLsf || i < min(c0, c1r))) {
      float mid, side;
      if constexpr (kExact) {
        mid = ms_f64(l + r);
        side = ms_f64(l - r);
      } else {
        const float c = __ldg(t.inv_sqrt2);
        mid = (l + r) * c;
        side = (l - r) * c;
      }
      l = mid;
      r = side;
    }
    if constexpr (kLsf) {
      if (s_meta[M_IS] != 0)
        lsf_intensity(t, lsf, s_meta, s_ipos, lay0, i, c1r, l_raw, l, r);
    } else if (s_meta[M_IS] != 0) {
      // intensity: ch0's layout and scalefactors give the positions (a
      // reference quirk; the spec uses the right channel's)
      const bool short0 = line_map(t, MAP_SHORT, lay0, i) == 1;
      const int is_pos =
          short0 ? s_scfs[line_map(t, MAP_SFB_S_PLAIN, lay0, i)]
                 : s_scfl[line_map(t, MAP_SFB_L, lay0, i)];
      if (line_map(t, MAP_IOK, lay0, i) == 1 &&
          line_map(t, MAP_BAND_START, lay0, i) >= c1r && is_pos != 7) {
        if (bug_compat && short0) {
          // pdmp3.c:2212-2213 assigns trunc(l) through an unsigned int: a
          // FLOOR mod 2^32.  Exact: in f64, -0.0 -> +0.0 as the reference
          // gives it; fast: fmodf is exact and keeps -0.0, as jnp.mod does
          float u;
          if constexpr (kExact) {
            u = uq_f64(l);
          } else {
            u = fmodf(truncf(l), 4294967296.0f);
            if (u < 0.0f) u = u + 4294967296.0f;
          }
          l = u;
          r = u;
        } else {
          int ip = clampi(is_pos, 0, 15);
          if (short0) ip = min(ip, 7);  // spec profile: no OOB ratios
          const float il = __ldg(t.ratio_l + ip) * l;
          const float ir = __ldg(t.ratio_r + ip) * l;
          l = il;
          r = ir;
        }
      }
    }
    s_x[0][i] = l;
    s_x[1][i] = r;
  }
  __syncthreads();

  // ---- antialias (pdmp3.c:1706-1732): butterfly j couples line 17-j of
  // subband sb with line j of subband sb+1; all 2x31x8 are independent ----
  if (tid < 2 * 31 * 8) {
    const int ch = tid / (31 * 8), sb = (tid / 8) % 31, j = tid % 8;
    const bool blocked = s_meta[M_WSF + ch] == 1 && s_meta[M_BT + ch] == 2;
    const int mx = s_meta[M_MIXED + ch];
    const int sblim = blocked && mx == 0 ? 1 : (blocked && mx == 1 ? 2 : 32);
    if (sb + 1 < sblim) {
      float* lo_p = &s_x[ch][sb * 18 + 17 - j];
      float* up_p = &s_x[ch][(sb + 1) * 18 + j];
      const float lo = *lo_p, up = *up_p;
      const float csj = __ldg(t.cs + j), caj = __ldg(t.ca + j);
      *lo_p = lo * csj - up * caj;
      *up_p = up * csj + lo * caj;
    }
  }
  __syncthreads();

  const int nch = max(s_meta[M_NCH], 1);
  for (int ch = 0; ch < 2; ++ch) {
    const int sb = tid / 18;
    int bt = s_meta[M_BT + ch];
    if (s_meta[M_WSF + ch] == 1 && s_meta[M_MIXED + ch] == 1 && sb < 2)
      bt = 0;  // the two long subbands of a mixed block
    bt = clampi(bt, 0, 3);  // a 2-bit field on the wire
    // granule-0 steps latch x_time[0:3] of (ch0, sb0): the band-12 carry
    float* prev3 = (ch == 0 && gr1 == 0) ? prev + b * 3 : nullptr;
    const float acc = back_half_channel<kExact>(
        t, s_x[ch], bt, store + ((size_t)b * 2 + ch) * 32 * 18,
        v + ((size_t)b * 2 + ch) * 15 * 64, true, prev3, s_xt, s_blk);
    const int16_t q = (int16_t)(kExact ? qz_f64(acc) : quantize_fast(acc));
    if (ch == 0) {
      s_left[tid] = q;
    } else {
      const int16_t left = s_left[tid];
      const int16_t right = nch == 1 ? left : q;  // mono: duplicate L
      out[tid] = (uint32_t)(uint16_t)left | ((uint32_t)(uint16_t)right << 16);
    }
  }
}

}  // namespace
