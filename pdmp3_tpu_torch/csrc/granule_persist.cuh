// The one granule body of the port's step kernels: K1 and K2 (MPEG-1,
// fast and exact) and K3 (the LSF families, fast and exact), launched
// from fused_granule.cu, and K5 (the frame kernel, MPEG-1 and LSF, fast),
// launched from frame_fused.cu; and beside it persistent_back_half, the
// same pattern over the same back-half stages (imdct4, matrix4, and
// fir3, the FIR the body writes inline) for K4 (back_half.cu), fast and
// exact, quantized or raw.  With kFloat the granule body writes float
// PCM (the FIR sums as ops/dsp.py float_pack makes them) where it writes
// S16: instances 9-12 of fused_granule.cu.
//
// Persistent blocks walk units: for K1-K3 a unit is one slot's granule
// step, b = blockIdx.x + k * gridDim.x; for K5 it is one (slot, granule)
// of the slot's ng granules, the slots walked the same way.  A two-stage
// ring of unit operands in shared memory is filled by bulk copies one
// unit ahead, the step's tables are in shared memory once per block, and
// dots are blocked four outputs to a thread.  Every product and sum
// rounds where the plain version (ops/fused_step.py:
// fused_granule_step_ref, chained by ops/frame_step.py:frame_step_ref
// for K5) rounds, in its order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <type_traits>

#include "granule.cuh"

namespace {

using namespace pdmp3;

// float offsets of the table image's sections (ops/consts.py SMEM_*)
constexpr int kTCos36 = 0, kTIwin = 648, kTC3p = 792, kTW2p = 2736,
              kTNwinT = 2844, kTSynD = 4892, kTFloats = 5404;
constexpr int kXtRow = 37;  // x_time row stride: 32 subbands' writes at
                            // 37 words apart hit 32 distinct banks
constexpr int kStoreFloats = 2 * 32 * 18;  // both channels' store
constexpr int kNbBytes = 2 * 18 * 64 * 4;  // [2][18][64] FIFO rows
constexpr int kSmallTid = 64;  // first of the threads that copy the
                               // small fields

// The shared memory of one instance, byte offsets.  K1-K3 (kFrame false)
// carry the slot's store and carried FIFO rows in the stage; K5 carries
// the wire only there, and the state in two state sets (slot iterations
// k alternate between them, so the next slot's state arrives during the
// current slot's last granule).  kFloat: the PCM row holds f32 L|R
// pairs, twice the int16 row.
template <bool kLsf, bool kFrame, bool kFloat = false>
struct Smem {
  // one stage of the unit ring: the first kSBulk bytes arrive by bulk
  // copy (16-byte aligned and sized), the small fields by 4-byte
  // cp.async, the active flag from the producer thread
  static constexpr int kSIx = 0;         // int16 [2][576]
  static constexpr int kSMeta = 2304;    // int32 [32]
  static constexpr int kSStore = 2432;   // f32 [2][32][18] (K1-K3)
  static constexpr int kSV = 7040;       // f32 [2][15][64] (K1-K3)
  static constexpr int kSBulk = kFrame ? 2432 : 14720;
  static constexpr int kSScfl = kSBulk;        // int16 [2][22]
  static constexpr int kSScfs = kSScfl + 96;   // int16 [2][39]
  static constexpr int kSPrev = kSScfs + 160;  // f32 [3] (K1, K2)
  static constexpr int kSAct = kSPrev + (kFrame ? 0 : 16);  // int32
  static constexpr int kSIpos = kSAct + 16;    // int16 [64] (LSF sidecar)
  static constexpr int kStage = kSIpos + (kLsf ? 128 : 0);
  // the small fields' 4-byte words: scf_l, scf_s, then the LSF sidecar
  // or (K1, K2) prev_lines
  static constexpr int kSmallWords = 22 + 39 + (kLsf ? 32 : kFrame ? 0 : 3);
  // a K5 state set: the store, two FIFO buffers [2][18][64] (rows 3..17
  // of one hold the carried rows, the other receives the new rows; they
  // swap every active granule) and the band-12 carry f32 [3]
  static constexpr int kXStore = 0;
  static constexpr int kXNb = kStoreFloats * 4;
  static constexpr int kXPrev = kXNb + 2 * kNbBytes;
  static constexpr int kStateSet = kXPrev + 16;
  // the block
  static constexpr int kOTab = 0;                       // table image
  static constexpr int kOStage = kOTab + kTFloats * 4;  // two stages
  static constexpr int kOX = kOStage + 2 * kStage;      // f32 [2][576]
  static constexpr int kOXt = kOX + 2 * kLines * 4;     // f32 [32][kXtRow]
                                                        // x_time, row k:
                                                        // [ch][18]
  // K1-K3: the new FIFO rows f32 [2][18][64]; K5: the two state sets
  static constexpr int kONb = kOXt + 32 * kXtRow * 4;
  static constexpr int kOPcm = kONb + (kFrame ? 2 * kStateSet : kNbBytes);
  static constexpr int kOBar =                         // two mbarriers
      kOPcm + kLines * (kFloat ? 8 : 4);
  // K5: thread 0's active-granule masks of slots b and b + G, in shared
  // memory rather than in registers, which the unit body needs
  static constexpr int kOMask = kOBar + 16;
  static constexpr int kSmemBytes = kOMask + (kFrame ? 16 : 0);
  static_assert(kOStage % 16 == 0 && kOX % 16 == 0 && kONb % 16 == 0 &&
                    kOPcm % 16 == 0 && kOBar % 8 == 0 && kStage % 16 == 0 &&
                    kSBulk % 16 == 0 && kStateSet % 16 == 0,
                "bulk copies need 16-byte aligned shared addresses");
};

// ---- asynchronous copies (PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the phase of `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global in the calling thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the calling thread's bulk stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// order this thread's shared-memory writes before later bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- dots of four outputs at once ----

__device__ __forceinline__ float4 scale4(float x, float4 c) {
  return make_float4(x * c.x, x * c.y, x * c.z, x * c.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// pairwise tree of the products xf(m) * w[m * ws + 0..3] over m in
// [LO, LO + N), N a power of two: dsp._dot_tree's order for each output
template <int LO, int N, class XF>
__device__ __forceinline__ float4 tree4(const XF& xf, const float* w,
                                        int ws) {
  if constexpr (N == 1) {
    return scale4(xf(LO), *reinterpret_cast<const float4*>(w + LO * ws));
  } else {
    const float4 a = tree4<LO, N / 2>(xf, w, ws);
    return add4(a, tree4<LO + N / 2, N / 2>(xf, w, ws));
  }
}

// four outputs e = 0..3 of sum over m < N of xf(m) * w[m * ws + e] (w
// 16-byte aligned, ws a multiple of 4), each summed as the plain version
// sums one (ops/dsp.py): sequentially from the first product when kExact
// (_dot_seq), else as a pairwise tree (_dot_tree; N = 18: the tree of
// the first 16 plus the last pair)
template <bool kExact, int N, class XF>
__device__ __forceinline__ float4 dot4(const XF& xf, const float* w,
                                       int ws) {
  if constexpr (kExact) {
    float4 acc = scale4(xf(0), *reinterpret_cast<const float4*>(w));
#pragma unroll
    for (int m = 1; m < N; ++m)
      acc = add4(acc,
                 scale4(xf(m), *reinterpret_cast<const float4*>(w + m * ws)));
    return acc;
  } else if constexpr (N == 18) {
    const float4 a = tree4<0, 16>(xf, w, ws);
    return add4(a, tree4<16, 2>(xf, w, ws));
  } else {
    static_assert(N == 32, "tree of a power of two");
    return tree4<0, N>(xf, w, ws);
  }
}

// ---- the front half of line i ----

// exact 2^n by exponent-field construction; +0.0 outside [-126, 127]
__device__ __forceinline__ float pow2i(int n) {
  return (n >= -126 && n <= 127) ? __int_as_float((n + 127) << 23) : 0.0f;
}

// K3's and K5's LSF operands: the [rows][64] intensity sidecar ([0..21]
// long positions, [22..60] short flat, 63 = illegal) and the gain pairs
// k0/k1 [2][64] by [iscale != 0][position]
struct LsfOperands {
  const int16_t* is_pos;
  const float* k0;
  const float* k1;
};

__device__ __forceinline__ int scf_from_bits(float line) {
  // band-12 OOB read (docs/DESIGN.md §6): the float BITS of a granule-0
  // ch0 output line as uint32, clamped to 1024
  const unsigned bits = __float_as_uint(line);
  return bits < 1024u ? (int)bits : 1024;
}

// requantized line i of channel ch (pdmp3.c:1829-1905, 2117-2152):
// (2^(-q/4) * 2^((gg-210-8*sbg)/4)) * sign(x)|x|^(4/3).  MPEG-1 only:
// when prev12 is not null (granule 1, ch 1) the short slots 36..38 read
// scf_from_bits(prev12[slot - 36]); exact MPEG-1 gives the host's
// sentinel-63 scalefactors (q >= 100) zero gain and, with prev12, the
// band-12 lines the true gain of their scalefactor.  LSF has neither
// (its gains stay true through q = 124; every LSF step is a granule-0
// step)
template <bool kExact, bool kLsf>
__device__ __forceinline__ float requantize_line(
    const Tables& t, const int* meta, const int16_t* scfl,
    const int16_t* scfs, const float* prev12, int lay, int ch, int i,
    int x) {
  const int mag = min(abs(x), kPow43Max);
  const float tmp3 = (x < 0 ? -1.0f : 1.0f) * __ldg(t.pow43 + mag);
  const int gg = meta[M_GG + ch];
  const int qpu = 2 << meta[M_SFS + ch];  // scalefac_scale is 0 or 1
  const bool short_line = line_map(t, MAP_SHORT, lay, i) == 1;
  int q, eo;
  if (short_line) {
    const int slot = line_map(t, MAP_SFB_S, lay, i);
    const int scf = (!kLsf && prev12 != nullptr && slot >= 36)
                        ? scf_from_bits(prev12[slot - 36])
                        : scfs[ch * 39 + slot];
    q = qpu * scf;
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
    if (prev12 != nullptr && line_map(t, MAP_SFB12, lay, i) == 1) {
      // the true 2^(-q/4), +0.0 past the table (2^-160 rounds to zero)
      const int idx =
          qpu * scf_from_bits(prev12[line_map(t, MAP_WIN, lay, i)]);
      tmp1 = idx < kGainTrue ? __ldg(t.gain_quarter_true + idx) : 0.0f;
    }
  }
  const float tmp2 = __ldg(t.quarter_up + (eo & 3)) * pow2i(eo >> 2);
  return (tmp1 * tmp2) * tmp3;
}

// the LSF intensity of line i (13818-3 §2.4.3.2; pallas_step.py:976-1004),
// after the full-spectrum MS: on eligible bands at or above ch1's count1
// whose sidecar position is legal, both channels pan the RAW (pre-MS) ch0
// line by the gain pair of the slot's iscale row
__device__ __forceinline__ void lsf_intensity(const Tables& t,
                                              const LsfOperands& lsf,
                                              const int* meta,
                                              const int16_t* ipos, int lay0,
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

// requantize + stereo of line i, both channels (the step's first stage):
// MPEG-1 MS below min(count1) and its intensity (ch0's layout and
// scalefactors give the positions, a reference quirk; the spec uses the
// right channel's), or the LSF stereo (full-spectrum MS, then the
// sidecar's intensity); prev12: the slot's band-12 carry on MPEG-1
// granule-1 steps
template <bool kExact, bool kLsf>
__device__ __forceinline__ void front_line(
    const Tables& t, const LsfOperands& lsf, const int* sm,
    const int16_t* sx, const int16_t* scfl, const int16_t* scfs,
    const int16_t* ipos, const float* prev12, int bug_compat, int i,
    float& l, float& r) {
  const int lay0 = clampi(sm[M_LAYOUT], 0, kLayouts - 1);
  const int lay1 = clampi(sm[M_LAYOUT + 1], 0, kLayouts - 1);
  l = requantize_line<kExact, kLsf>(t, sm, scfl, scfs, nullptr, lay0, 0, i,
                                    sx[i]);
  r = requantize_line<kExact, kLsf>(t, sm, scfl, scfs, prev12, lay1, 1, i,
                                    sx[kLines + i]);
  const float l_raw = l;
  const int c0 = clampi(sm[M_C1], 0, kLines);
  const int c1r = clampi(sm[M_C1 + 1], 0, kLines);
  if (sm[M_MS] != 0 && (kLsf || i < min(c0, c1r))) {
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
    if (sm[M_IS] != 0)
      lsf_intensity(t, lsf, sm, ipos, lay0, i, c1r, l_raw, l, r);
  } else if (sm[M_IS] != 0) {
    const bool short0 = line_map(t, MAP_SHORT, lay0, i) == 1;
    const int is_pos = short0 ? scfs[line_map(t, MAP_SFB_S_PLAIN, lay0, i)]
                              : scfl[line_map(t, MAP_SFB_L, lay0, i)];
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
}

// ---- the back half, four outputs to a thread ----

// outputs p0..p0+3 (p0 = 4g) of the 36 windowed IMDCT outputs of one
// subband (xf(m): its line m), bt its effective block type: the long
// IMDCT, or the three short IMDCTs overlapped as dsp.hybrid_synthesis
// adds them, window by window in increasing w (outputs no window covers
// are +0.0)
template <bool kExact, class XF>
__device__ __forceinline__ void imdct4(const float* tab, const XF& xf,
                                       int bt, int p0, float (&o)[4]) {
  if (bt != 2) {
    const float4 d = dot4<kExact, 18>(xf, tab + kTCos36 + p0, 36);
    const float4 w =
        *reinterpret_cast<const float4*>(tab + kTIwin + bt * 36 + p0);
    o[0] = d.x * w.x;
    o[1] = d.y * w.y;
    o[2] = d.z * w.z;
    o[3] = d.w * w.w;
    return;
  }
  bool any[4] = {false, false, false, false};
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = 0.0f;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const int lo = 6 + 6 * w;  // window w covers outputs [lo, lo + 12)
    if (p0 + 3 < lo || p0 >= lo + 12) continue;
    const float4 d = dot4<kExact, 18>(xf, tab + kTC3p + w * 648 + p0, 36);
    const float4 wv =
        *reinterpret_cast<const float4*>(tab + kTW2p + w * 36 + p0);
    const float c[4] = {d.x * wv.x, d.y * wv.y, d.z * wv.z, d.w * wv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + e;
      if (p >= lo && p < lo + 12) {
        o[e] = any[e] ? o[e] + c[e] : c[e];
        any[e] = true;
      }
    }
  }
}

// polyphase matrixing of both channels into the new FIFO rows: thread =
// (four columns 4jg.., channel, time it) = lt; nb[it][j] = sum over
// subbands k of NWIN[j][k] * x_time[k][it] (s_xt row k: [ch][18])
template <bool kExact>
__device__ __forceinline__ void matrix4(const float* tab, const float* s_xt,
                                        float* s_nb, int lt) {
  const int jg = lt / 36, c = lt % 36;
  const float* xt = s_xt + c;
  const float4 nb = dot4<kExact, 32>([&](int kk) { return xt[kk * kXtRow]; },
                                     tab + kTNwinT + 4 * jg, 64);
  *reinterpret_cast<float4*>(s_nb + c * 64 + 4 * jg) = nb;
}

// the 16-tap D-window FIR of one channel over its 33-row FIFO (15
// carried rows vold, 18 new rows vnew): the sums of time steps it0,
// it0 + 2 and it0 + 4 of column kc, which share 14 of their 16 taps,
// each summed sequentially from tap 0.  K4's copy of the FIR that
// persistent_granules writes inline: called there, it changes K1-K3's
// register allocation.
__device__ __forceinline__ void fir3(const float* tab, const float* vold,
                                     const float* vnew, int it0, int kc,
                                     float (&acc)[3]) {
  // e[q] = FIFO row it0 + q, half 32 * (j & 1) of the taps j that read
  // it: j = 15 + 2o - q, so its parity is that of q + 1
  float e[20];
#pragma unroll
  for (int q = 0; q < 20; ++q) {
    const int row = it0 + q, col = (q & 1) ? kc : 32 + kc;
    e[q] = row < 15 ? vold[row * 64 + col] : vnew[(row - 15) * 64 + col];
  }
#pragma unroll
  for (int o = 0; o < 3; ++o) acc[o] = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float d = tab[kTSynD + j * 32 + kc];
#pragma unroll
    for (int o = 0; o < 3; ++o) acc[o] = acc[o] + d * e[15 - j + 2 * o];
  }
}

// bit g set where slot `slot` is active in granule g of a K5 launch
__device__ __forceinline__ unsigned granule_mask(
    const int32_t* __restrict__ active, int slot, int ng, int B) {
  unsigned m = 0;
  for (int g = 0; g < ng; ++g)
    m |= (unsigned)(__ldg(active + (size_t)g * B + slot) != 0) << g;
  return m;
}

// The units of the block, one after the other.  Per unit: wait for its
// stage, start the next unit's copies, front half (thread = line),
// antialias, IMDCT + overlap-add of both channels (thread = four
// outputs, channel, subband: a warp is the 32 subbands of one channel
// and output group, so every coefficient load is a broadcast), matrixing
// of both channels (thread = four FIFO columns at one channel and time),
// FIR of both channels (thread = one channel, column and three time
// steps), and the PCM back by bulk copy.  Five barriers a unit.  An idle
// unit writes silence and copies no state.
//
// K1-K3 (kFrame false): the unit is slot b's granule step, gr1 its
// parity (0 for LSF); the stage brings the slot's store and carried FIFO
// rows, and the new store and FIFO rows go back every unit.
//
// K5 (kFrame true): the units are (b, g) for g < ng, the parity of g bit
// g of `parities`.  The slot's store, FIFO and carry arrive in the state
// set of its slot iteration with its first active granule, cross its
// granules in shared memory (the new FIFO rows of one granule are the
// carried rows of the next: the set's two FIFO buffers swap), and go
// back after its last active granule; a parity-0 granule latches the
// band-12 carry into the set, a parity-1 granule reads it.  Granule g's
// PCM goes to row b * ng + g.
//
// kFloat (K1-K3 only): the FIR sums go out as float PCM, float_sample of
// each (no quantize, so no f64 rounding point in the exact instances),
// interleaved L|R as f32 with mono duplicating L; an idle unit writes
// +0.0 in both channels.  Everything before the FIR's output is the S16
// instances' own code.
template <bool kFloat>
using PcmLine = std::conditional_t<kFloat, float2, uint32_t>;  // one L|R

template <bool kExact, bool kLsf, bool kFrame, bool kFloat = false>
__device__ __forceinline__ void persistent_granules(
    const int16_t* __restrict__ ix, const int16_t* __restrict__ scf_l,
    const int16_t* __restrict__ scf_s, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ active, int gr1, int bug_compat,
    float* __restrict__ store, float* __restrict__ v,
    float* __restrict__ prev, PcmLine<kFloat>* __restrict__ pcm,
    const Tables& t, const float4* __restrict__ image, int B,
    const LsfOperands& lsf, int ng, unsigned parities) {
  static_assert(!(kFloat && kFrame), "float PCM is a granule instance");
  using L = Smem<kLsf, kFrame, kFloat>;
  constexpr int kPcmRowBytes = kLines * (int)sizeof(PcmLine<kFloat>);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  float* tab = reinterpret_cast<float*>(smem + L::kOTab);
  float* s_x = reinterpret_cast<float*>(smem + L::kOX);
  float* s_xt = reinterpret_cast<float*>(smem + L::kOXt);
  int16_t* s_pcm = reinterpret_cast<int16_t*>(smem + L::kOPcm);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kOBar);
  const int G = gridDim.x;

  // K5: state set k (0 or 1)
  const auto state_set = [&](int k) {
    return smem + L::kONb + k * L::kStateSet;
  };
  // unit (slot, gran) into stage s: the producer (thread 0) sets the
  // stage's active flag and, for an active unit, starts the bulk copies;
  // K5 also fetches the slot's state into its state set k with the
  // slot's first active granule (first)
  const auto produce = [&](int s, int slot, int gran, int act, int first,
                           int k) {
    unsigned char* st = smem + L::kOStage + s * L::kStage;
    *reinterpret_cast<int*>(st + L::kSAct) = act;
    if (act) {
      if constexpr (kFrame) {
        const size_t w = (size_t)gran * B + slot;
        unsigned char* ss = state_set(k);
        mbar_expect_tx(bar + s, L::kSBulk + (first ? (kStoreFloats +
                                                      2 * 15 * 64) * 4 : 0));
        bulk_load(st + L::kSIx, ix + w * 2 * kLines, 2 * kLines * 2, bar + s);
        bulk_load(st + L::kSMeta, meta + w * kMetaWords, kMetaWords * 4,
                  bar + s);
        if (first) {
          bulk_load(ss + L::kXStore, store + (size_t)slot * kStoreFloats,
                    kStoreFloats * 4, bar + s);
          // the carried rows into rows 3..17 of the set's first buffer
          for (int c = 0; c < 2; ++c)
            bulk_load(ss + L::kXNb + (c * 18 + 3) * 64 * 4,
                      v + ((size_t)slot * 2 + c) * 15 * 64, 15 * 64 * 4,
                      bar + s);
          for (int p = 0; p < 3; ++p)
            copy4_async(ss + L::kXPrev + 4 * p, prev + (size_t)slot * 3 + p);
        }
      } else {
        mbar_expect_tx(bar + s, L::kSBulk);
        bulk_load(st + L::kSIx, ix + (size_t)slot * 2 * kLines, 2 * kLines * 2,
                  bar + s);
        bulk_load(st + L::kSMeta, meta + (size_t)slot * kMetaWords,
                  kMetaWords * 4, bar + s);
        bulk_load(st + L::kSStore, store + (size_t)slot * 2 * 32 * 18,
                  2 * 32 * 18 * 4, bar + s);
        bulk_load(st + L::kSV, v + (size_t)slot * 2 * 15 * 64,
                  2 * 15 * 64 * 4, bar + s);
      }
    } else {
      mbar_arrive(bar + s);
    }
  };
  // the small fields of unit (slot, gran) into stage s, word w per thread
  const auto copy_small = [&](int s, int slot, int gran) {
    const int w = tid - kSmallTid;
    if (w < 0 || w >= L::kSmallWords) return;
    unsigned char* st = smem + L::kOStage + s * L::kStage;
    // the wire row gran * B + slot is written out in each branch: held
    // in one variable, it cost K1 and K2 their signed wide multiplies
    if (w < 22)
      copy4_async(st + L::kSScfl + 4 * w,
                  reinterpret_cast<const char*>(
                      scf_l + ((size_t)gran * B + slot) * 44) +
                      4 * w);
    else if (w < 61)
      copy4_async(st + L::kSScfs + 4 * (w - 22),
                  reinterpret_cast<const char*>(
                      scf_s + ((size_t)gran * B + slot) * 78) +
                      4 * (w - 22));
    else if constexpr (kLsf)
      copy4_async(st + L::kSIpos + 4 * (w - 61),
                  reinterpret_cast<const char*>(
                      lsf.is_pos + ((size_t)gran * B + slot) * 64) +
                      4 * (w - 61));
    else
      copy4_async(st + L::kSPrev + 4 * (w - 61), prev + (size_t)slot * 3 +
                                                     (w - 61));
  };

  for (int k = tid; k < kTFloats / 4; k += kThreads)
    reinterpret_cast<float4*>(tab)[k] = __ldg(image + k);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int b = blockIdx.x;    // the launch keeps gridDim.x <= B
  int g = 0;             // K5: the unit's granule
  int kx = 0;            // K5: bit 1 the slot's state set (slot
                         // iterations alternate), bit 0 the set's buffer
                         // holding the carried rows
  const auto advance = [&]() {
    if constexpr (kFrame) {
      if (++g == ng) {
        g = 0;
        b += G;
        kx = (kx ^ 2) & 2;
      }
    } else {
      b += G;
    }
  };
  int act_next = 0;      // thread 0 (K1-K3): active flag of slot b + G
  // thread 0 (K5): active granules of slot b, and of slot b + G
  unsigned* mask = reinterpret_cast<unsigned*>(smem + L::kOMask);
  int pend = -1;         // thread 0: PCM row waiting in s_pcm
  if (tid == 0) {
    if constexpr (kFrame) {
      const unsigned m0 = granule_mask(active, b, ng, B);
      mask[1] = m0;
      produce(0, b, 0, m0 & 1, m0 & 1, 0);
    } else {
      produce(0, b, 0, __ldg(active + b), 0, 0);
      if (b + G < B) act_next = __ldg(active + b + G);
    }
  }
  copy_small(0, b, 0);

  for (int n = 0; b < B; ++n, advance()) {
    const int s = n & 1;
    unsigned char* st = smem + L::kOStage + s * L::kStage;
    mbar_wait(bar + s, (n >> 1) & 1);
    copy4_wait();
    __syncthreads();
    const int act = *reinterpret_cast<const int*>(st + L::kSAct);
    // the next unit
    const int gn = kFrame && g + 1 < ng ? g + 1 : 0;
    const int bn = gn ? b : b + G;
    const int prow = kFrame ? b * ng + g : b;  // the unit's PCM row
    if (tid == 0) {
      // the last unit's bulk stores have left shared memory: its stage
      // (and state set, and s_nb) may be refilled; then its PCM goes out
      bulk_wait_read();
      if constexpr (kFrame) {
        if (g == 0) {
          mask[0] = mask[1];
          mask[1] = b + G < B ? granule_mask(active, b + G, ng, B) : 0;
        }
        if (bn < B) {
          const unsigned m = mask[gn ? 0 : 1];
          const int an = (m >> gn) & 1;
          produce(s ^ 1, bn, gn, an, an && (m & ((1u << gn) - 1u)) == 0,
                  (kx >> 1) ^ (gn == 0));
        }
      } else if (bn < B) {
        produce(s ^ 1, bn, 0, act_next, 0, 0);
        act_next = bn + G < B ? __ldg(active + bn + G) : 0;
      }
      if (pend >= 0) {
        bulk_store(pcm + (size_t)pend * kLines, s_pcm, kPcmRowBytes);
        bulk_commit();
      }
      pend = act ? prow : -1;
    }
    if (bn < B) copy_small(s ^ 1, bn, gn);
    if (!act) {
      // silence, state untouched
      if constexpr (kFloat)
        pcm[(size_t)prow * kLines + tid] = make_float2(0.0f, 0.0f);
      else
        pcm[(size_t)prow * kLines + tid] = 0u;
      continue;
    }
    // the thread index, opaque per unit: otherwise the compiler hoists
    // every per-thread address of the unit's stages (the FIR's 20 FIFO
    // taps, the IMDCT's and matrixing's operands) out of the unit loop
    // and, at 56 registers, spills them across it
    int lt = tid;
    asm volatile("" : "+r"(lt));
    const int* sm = reinterpret_cast<const int*>(st + L::kSMeta);
    // the unit's store (rewritten in place), carried FIFO rows (channel
    // stride vch floats), new FIFO rows, band-12 carry and parity
    float* s_store;
    const float* s_v;
    float* s_nb;
    float* s_prev = nullptr;
    int par = gr1;
    constexpr int vch = (kFrame ? 18 : 15) * 64;
    if constexpr (kFrame) {
      unsigned char* ss = state_set(kx >> 1);
      const int x = kx & 1;
      s_store = reinterpret_cast<float*>(ss + L::kXStore);
      s_v = reinterpret_cast<const float*>(ss + L::kXNb + x * kNbBytes) +
            3 * 64;
      s_nb = reinterpret_cast<float*>(ss + L::kXNb + (x ^ 1) * kNbBytes);
      s_prev = reinterpret_cast<float*>(ss + L::kXPrev);
      par = (parities >> g) & 1u;
      kx ^= 1;
    } else {
      s_store = reinterpret_cast<float*>(st + L::kSStore);
      s_v = reinterpret_cast<const float*>(st + L::kSV);
      s_nb = reinterpret_cast<float*>(smem + L::kONb);
      if (gr1) s_prev = reinterpret_cast<float*>(st + L::kSPrev);
    }

    // ---- requantize + stereo: thread = line ----
    {
      float l, r;
      front_line<kExact, kLsf>(
          t, lsf, sm, reinterpret_cast<const int16_t*>(st + L::kSIx),
          reinterpret_cast<const int16_t*>(st + L::kSScfl),
          reinterpret_cast<const int16_t*>(st + L::kSScfs),
          reinterpret_cast<const int16_t*>(st + L::kSIpos),
          par ? s_prev : nullptr, bug_compat, lt, l, r);
      s_x[lt] = l;
      s_x[kLines + lt] = r;
    }
    __syncthreads();

    // ---- antialias: butterfly j couples line 17-j of subband sb with
    // line j of subband sb+1 ----
    if (lt < 2 * 31 * 8) {
      const int ch = lt / (31 * 8), sb = (lt / 8) % 31, j = lt % 8;
      const bool blocked = sm[M_WSF + ch] == 1 && sm[M_BT + ch] == 2;
      const int mx = sm[M_MIXED + ch];
      const int sblim = blocked && mx == 0 ? 1 : (blocked && mx == 1 ? 2 : 32);
      if (sb + 1 < sblim) {
        float* lo_p = s_x + ch * kLines + sb * 18 + 17 - j;
        float* up_p = s_x + ch * kLines + (sb + 1) * 18 + j;
        const float lo = *lo_p, up = *up_p;
        const float csj = __ldg(t.cs + j), caj = __ldg(t.ca + j);
        *lo_p = lo * csj - up * caj;
        *up_p = up * csj + lo * caj;
      }
    }
    __syncthreads();

    // ---- IMDCT + window + overlap-add + frequency inversion: thread =
    // (outputs 4g..4g+3, channel, subband) ----
    float hi[4];
    const int og = lt / 64, ch = lt / 32 % 2, sb = lt % 32, p0 = 4 * og;
    {
      int bt = sm[M_BT + ch];
      if (sm[M_WSF + ch] == 1 && sm[M_MIXED + ch] == 1 && sb < 2) bt = 0;
      bt = clampi(bt, 0, 3);
      // the subband's 18 lines in registers (9 LDS.64), reused by the
      // three short windows; K5 reads them from shared memory, as at 56
      // registers its longer unit loop spilled otherwise
      const float* xs = s_x + ch * kLines + sb * 18;
      float xr[18];
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        const float2 p = reinterpret_cast<const float2*>(xs)[m];
        xr[2 * m] = p.x;
        xr[2 * m + 1] = p.y;
      }
      float o[4];
      if constexpr (kFrame)
        imdct4<kExact>(tab, [&](int m) { return xs[m]; }, bt, p0, o);
      else
        imdct4<kExact>(tab, [&](int m) { return xr[m]; }, bt, p0, o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + e;
        hi[e] = o[e];
        if (p < 18) {
          const float inv = ((sb & 1) && (p & 1)) ? -1.0f : 1.0f;
          const float xt = (o[e] + s_store[ch * 576 + sb * 18 + p]) * inv;
          s_xt[sb * kXtRow + ch * 18 + p] = xt;
          // granule-0 steps latch x_time[0:3] of (ch0, sb0): the carry
          if (par == 0 && ch == 0 && sb == 0 && p < 3) {
            if constexpr (kFrame)
              s_prev[p] = xt;
            else
              prev[(size_t)b * 3 + p] = xt;
          }
        }
      }
    }
    if (tid == 0) bulk_wait_read();  // the last PCM has left s_pcm
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p0 + e >= 18) s_store[ch * 576 + sb * 18 + p0 + e - 18] = hi[e];

    // ---- polyphase matrixing into the new FIFO rows: thread = (four
    // columns 4jg.., channel, time it); nb[it][j] = sum over subbands k
    // of NWIN[j][k] * x_time[k][it] ----
    { matrix4<kExact>(tab, s_xt, s_nb, lt); }
    fence_async_shared();
    __syncthreads();
    // the state goes back: every unit (K1-K3), after the slot's last
    // active granule (K5)
    if (tid == 0 && (!kFrame || ((mask[0] >> g) >> 1) == 0)) {
      bulk_store(store + (size_t)b * 2 * 32 * 18, s_store, 2 * 32 * 18 * 4);
      // the new FIFO is the newest 15 rows, nb rows 3..17 of each channel
      for (int c2 = 0; c2 < 2; ++c2)
        bulk_store(v + ((size_t)b * 2 + c2) * 15 * 64,
                   s_nb + (c2 * 18 + 3) * 64, 15 * 64 * 4);
      bulk_commit();
      if constexpr (kFrame)
        for (int p = 0; p < 3; ++p) prev[(size_t)b * 3 + p] = s_prev[p];
    }

    // ---- 16-tap D-window FIR over the 33-row FIFO (15 carried rows, 18
    // new in s_nb): thread = (channel, time steps it0, it0 + 2, it0 + 4,
    // column k), which share 14 of their 16 taps ----
    if (lt < 2 * 6 * 32) {
      const int fch = lt / 192, grp = lt / 32 % 6, kc = lt % 32;
      const int it0 = (grp & 1) + 6 * (grp >> 1);
      const float* vold = s_v + fch * vch;
      const float* vnew = s_nb + fch * 18 * 64;
      // e[q] = FIFO row it0 + q, half 32 * (j & 1) of the taps j that
      // read it: j = 15 + 2o - q, so its parity is that of q + 1
      float e[20];
#pragma unroll
      for (int q = 0; q < 20; ++q) {
        const int row = it0 + q, col = (q & 1) ? kc : 32 + kc;
        e[q] = row < 15 ? vold[row * 64 + col] : vnew[(row - 15) * 64 + col];
      }
      float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float d = tab[kTSynD + j * 32 + kc];
#pragma unroll
        for (int o = 0; o < 3; ++o) acc[o] = acc[o] + d * e[15 - j + 2 * o];
      }
      const int nch = max(sm[M_NCH], 1);
      if constexpr (kFloat) {
        float* s_pcmf = reinterpret_cast<float*>(smem + L::kOPcm);
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          const int idx = (it0 + 2 * o) * 32 + kc;
          const float f = float_sample(acc[o]);
          if (fch == 0) {
            s_pcmf[2 * idx] = f;
            if (nch == 1) s_pcmf[2 * idx + 1] = f;  // mono: duplicate L
          } else if (nch != 1) {
            s_pcmf[2 * idx + 1] = f;
          }
        }
      } else {
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          const int idx = (it0 + 2 * o) * 32 + kc;
          const int16_t q =
              (int16_t)(kExact ? qz_f64(acc[o]) : quantize_fast(acc[o]));
          if (fch == 0) {
            s_pcm[2 * idx] = q;
            if (nch == 1) s_pcm[2 * idx + 1] = q;  // mono: duplicate L
          } else if (nch != 1) {
            s_pcm[2 * idx + 1] = q;
          }
        }
      }
    }
    fence_async_shared();
  }

  __syncthreads();
  if (tid == 0) {
    if (pend >= 0) {
      bulk_store(pcm + (size_t)pend * kLines, s_pcm, kPcmRowBytes);
      bulk_commit();
    }
    bulk_wait_all();
  }
}

// K4's shared memory, byte offsets: the table image, a two-stage ring of
// one slot's operands (all bulk-copied, so 16-byte aligned and sized),
// x_time, the new FIFO rows and the output row.
struct SmemBack {
  static constexpr int kSXa = 0;         // f32 [2][32][18] spectra
  static constexpr int kSBt = 4608;      // int32 [2][32] block types
  static constexpr int kSStore = 4864;   // f32 [2][32][18]
  static constexpr int kSV = 9472;       // f32 [2][15][64]
  static constexpr int kSAct = 17152;    // int32 active flag (producer)
  static constexpr int kStage = kSAct + 16;
  static constexpr int kBulkIdle = kSV;  // an idle slot's copies: xa,
                                         // bt_eff and store (its prev3)
  static constexpr int kBulk = kSAct;    // an active slot's: and v
  static constexpr int kOTab = 0;
  static constexpr int kOStage = kOTab + kTFloats * 4;
  static constexpr int kOXt = kOStage + 2 * kStage;  // f32 [32][kXtRow]
  static constexpr int kONb = kOXt + 32 * kXtRow * 4;  // f32 [2][18][64]
  static constexpr int kOOut = kONb + kNbBytes;       // f32 [2][576]
  static constexpr int kOBar = kOOut + 2 * kLines * 4;  // two mbarriers
  static constexpr int kSmemBytes = kOBar + 16;
  static_assert(kOStage % 16 == 0 && kStage % 16 == 0 && kSBt % 16 == 0 &&
                    kSStore % 16 == 0 && kSV % 16 == 0 && kONb % 16 == 0 &&
                    kOOut % 16 == 0 && kOBar % 8 == 0,
                "bulk copies need 16-byte aligned shared addresses");
};

// K4: the back half of B slots from post-antialias spectra, on the same
// persistent, bulk-staged pattern and the same stages as the granule
// body.  A unit is one slot b = blockIdx.x + k * gridDim.x; the producer
// (thread 0) fills the other stage one slot ahead: xa, bt_eff and store
// for every slot, v for an active one.  Per active slot: IMDCT + window
// + overlap-add + frequency inversion of both channels (imdct4, thread =
// four outputs, channel, subband), matrixing (matrix4), FIR (fir3,
// thread = channel, three time steps, column), three barriers; the new
// store and FIFO rows and the f32 output row [2][576] go back by bulk
// stores: the raw FIR sums, or with kQuantize quantize_fast's samples as
// floats.  An idle slot leaves its state alone and writes a zero row,
// and thread 0 still computes its prev3 (x_time[0:3] of ch0, subband 0,
// outputs 0..2 of imdct4 plus the store: no frequency inversion in
// subband 0), as it does for every slot.
template <bool kExact, bool kQuantize>
__device__ __forceinline__ void persistent_back_half(
    const float* __restrict__ xa, const int32_t* __restrict__ bt_eff,
    const int32_t* __restrict__ active, float* __restrict__ store,
    float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ prev3, const float4* __restrict__ image, int B) {
  using L = SmemBack;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  float* tab = reinterpret_cast<float*>(smem + L::kOTab);
  float* s_xt = reinterpret_cast<float*>(smem + L::kOXt);
  float* s_nb = reinterpret_cast<float*>(smem + L::kONb);
  float* s_out = reinterpret_cast<float*>(smem + L::kOOut);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kOBar);
  const int G = gridDim.x;

  const auto produce = [&](int s, int slot, int act) {
    unsigned char* st = smem + L::kOStage + s * L::kStage;
    *reinterpret_cast<int*>(st + L::kSAct) = act;
    mbar_expect_tx(bar + s, act ? L::kBulk : L::kBulkIdle);
    bulk_load(st + L::kSXa, xa + (size_t)slot * 2 * kLines, 2 * kLines * 4,
              bar + s);
    bulk_load(st + L::kSBt, bt_eff + (size_t)slot * 64, 64 * 4, bar + s);
    bulk_load(st + L::kSStore, store + (size_t)slot * kStoreFloats,
              kStoreFloats * 4, bar + s);
    if (act)
      bulk_load(st + L::kSV, v + (size_t)slot * 2 * 15 * 64, 2 * 15 * 64 * 4,
                bar + s);
  };

  for (int k = tid; k < kTFloats / 4; k += kThreads)
    reinterpret_cast<float4*>(tab)[k] = __ldg(image + k);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int b = blockIdx.x;  // the launch keeps gridDim.x <= B
  int act_next = 0;    // thread 0: active flag of slot b + G
  int pend = -1;       // thread 0: output row waiting in s_out
  if (tid == 0) {
    produce(0, b, __ldg(active + b) != 0);
    if (b + G < B) act_next = __ldg(active + b + G) != 0;
  }

  for (int n = 0; b < B; ++n, b += G) {
    const int s = n & 1;
    unsigned char* st = smem + L::kOStage + s * L::kStage;
    mbar_wait(bar + s, (n >> 1) & 1);
    __syncthreads();
    const int act = *reinterpret_cast<const int*>(st + L::kSAct);
    const int bn = b + G;
    if (tid == 0) {
      // the last slot's bulk stores have left shared memory: its stage
      // may be refilled; then its output row goes out
      bulk_wait_read();
      if (bn < B) {
        produce(s ^ 1, bn, act_next);
        act_next = bn + G < B ? __ldg(active + bn + G) != 0 : 0;
      }
      if (pend >= 0) {
        bulk_store(out + (size_t)pend * 2 * kLines, s_out, 2 * kLines * 4);
        bulk_commit();
      }
      pend = act ? b : -1;
    }
    const float* s_xa = reinterpret_cast<const float*>(st + L::kSXa);
    const int* s_bt = reinterpret_cast<const int*>(st + L::kSBt);
    float* s_store = reinterpret_cast<float*>(st + L::kSStore);
    if (!act) {
      out[(size_t)b * 2 * kLines + tid] = 0.0f;
      out[(size_t)b * 2 * kLines + kLines + tid] = 0.0f;
      if (tid == 0) {
        float o[4];
        imdct4<kExact>(tab, [&](int m) { return s_xa[m]; },
                       clampi(s_bt[0], 0, 3), 0, o);
        for (int p = 0; p < 3; ++p)
          prev3[(size_t)b * 3 + p] = o[p] + s_store[p];
      }
      continue;
    }
    // opaque per slot, as in the granule body: otherwise the per-thread
    // addresses of the stages are hoisted out of the slot loop and spill
    int lt = tid;
    asm volatile("" : "+r"(lt));

    // IMDCT stage: thread = (outputs 4og..4og+3, channel, subband)
    float hi[4];
    const int og = lt / 64, ch = lt / 32 % 2, sb = lt % 32, p0 = 4 * og;
    {
      const int bt = clampi(s_bt[ch * 32 + sb], 0, 3);
      const float* xs = s_xa + ch * kLines + sb * 18;
      float xr[18];
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        const float2 p = reinterpret_cast<const float2*>(xs)[m];
        xr[2 * m] = p.x;
        xr[2 * m + 1] = p.y;
      }
      float o[4];
      imdct4<kExact>(tab, [&](int m) { return xr[m]; }, bt, p0, o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + e;
        hi[e] = o[e];
        if (p < 18) {
          const float inv = ((sb & 1) && (p & 1)) ? -1.0f : 1.0f;
          const float xt = (o[e] + s_store[ch * 576 + sb * 18 + p]) * inv;
          s_xt[sb * kXtRow + ch * 18 + p] = xt;
          if (ch == 0 && sb == 0 && p < 3) prev3[(size_t)b * 3 + p] = xt;
        }
      }
    }
    if (tid == 0) bulk_wait_read();  // the last output row has left s_out
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p0 + e >= 18) s_store[ch * 576 + sb * 18 + p0 + e - 18] = hi[e];

    matrix4<kExact>(tab, s_xt, s_nb, lt);
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
      bulk_store(store + (size_t)b * kStoreFloats, s_store, kStoreFloats * 4);
      // the new FIFO is the newest 15 rows, nb rows 3..17 of each channel
      for (int c2 = 0; c2 < 2; ++c2)
        bulk_store(v + ((size_t)b * 2 + c2) * 15 * 64,
                   s_nb + (c2 * 18 + 3) * 64, 15 * 64 * 4);
      bulk_commit();
    }

    // FIR stage: thread = (channel, time steps it0, it0 + 2, it0 + 4,
    // column kc)
    if (lt < 2 * 6 * 32) {
      const int fch = lt / 192, grp = lt / 32 % 6, kc = lt % 32;
      const int it0 = (grp & 1) + 6 * (grp >> 1);
      const float* s_v = reinterpret_cast<const float*>(st + L::kSV);
      float acc[3];
      fir3(tab, s_v + fch * 15 * 64, s_nb + fch * 18 * 64, it0, kc, acc);
#pragma unroll
      for (int o = 0; o < 3; ++o)
        s_out[fch * kLines + (it0 + 2 * o) * 32 + kc] =
            kQuantize ? quantize_fast(acc[o]) : acc[o];
    }
    fence_async_shared();
  }

  __syncthreads();
  if (tid == 0) {
    if (pend >= 0) {
      bulk_store(out + (size_t)pend * 2 * kLines, s_out, 2 * kLines * 4);
      bulk_commit();
    }
    bulk_wait_all();
  }
}

// ---- launch geometry (host) ----

constexpr int kMaxDevices = 64;
// the persistent instances: K1, K2, K3 fast, K3 exact, K5 MPEG-1, K5 LSF,
// K4 fast, K4 exact, K4 fast raw sums, then the float-PCM granule
// instances: MPEG-1 fast, MPEG-1 exact, LSF fast, LSF exact; then K7's
// eight (l12_synth.cu): Layer I, Layer II, each S16 and float, fast and
// exact
constexpr int kInstances = 21;

// The persistent grid of one kernel instance on the current device: SM
// count x resident blocks per SM at `smem` bytes of dynamic shared
// memory and `threads` threads a block (the attribute set on first use
// per device); info, when not
// null, receives {grid, blocks per SM, dynamic shared bytes, registers,
// local (spill) bytes, SM count}.  The figures are cached per (instance,
// device) once, under a lock, and published by a release store, so a
// host thread that sees the flag reads them whole.  Returns a
// cudaError_t.
int persistent_grid(int instance, const void* kernel, int smem, int* grid,
                    int* info, int threads = kThreads) {
  static int cache[kInstances][kMaxDevices][6];
  static std::atomic<int> filled[kInstances][kMaxDevices];
  static std::mutex fill_lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices || instance < 0 ||
      instance >= kInstances)
    return (int)cudaErrorInvalidValue;
  int* c = cache[instance][dev];
  std::atomic<int>& ready = filled[instance][dev];
  if (!ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> hold(fill_lock);
    if (!ready.load(std::memory_order_relaxed)) {
      int sms = 0, per_sm = 0;
      cudaFuncAttributes fa;
      if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
          (e = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               smem)) != cudaSuccess ||
          (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, threads, smem)) != cudaSuccess ||
          (e = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess)
        return (int)e;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      const int got[6] = {sms * per_sm, per_sm, smem, fa.numRegs,
                          (int)fa.localSizeBytes, sms};
      for (int j = 0; j < 6; ++j) c[j] = got[j];
      ready.store(1, std::memory_order_release);
    }
  }
  *grid = c[0];
  if (info != nullptr)
    for (int j = 0; j < 6; ++j) info[j] = c[j];
  return 0;
}

}  // namespace
