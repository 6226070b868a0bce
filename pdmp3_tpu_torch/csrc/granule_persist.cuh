// The body of K1 and K2, the MPEG-1 granule kernels (fused_granule.cu):
// persistent blocks that walk slots b = blockIdx.x + k * gridDim.x, a
// two-stage ring of slot operands in shared memory filled by bulk copies
// one slot ahead, the step's tables in shared memory once per block, and
// dots blocked four outputs to a thread.  The arithmetic is that of
// granule_step<kExact, false> (granule_step.cuh) operation for operation:
// every product and sum rounds where the plain version
// (ops/fused_step.py:fused_granule_step_ref) rounds, in its order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_step.cuh"

namespace {

using namespace pdmp3;

// float offsets of the table image's sections (ops/consts.py SMEM_*)
constexpr int kTCos36 = 0, kTIwin = 648, kTC3p = 792, kTW2p = 2736,
              kTNwinT = 2844, kTSynD = 4892, kTFloats = 5404;

// one stage of the slot ring, byte offsets: the first kSBulk bytes arrive
// by bulk copy (16-byte aligned and sized), the small fields by 4-byte
// cp.async, the active flag from the producer thread
constexpr int kSIx = 0;         // int16 [2][576]
constexpr int kSMeta = 2304;    // int32 [32]
constexpr int kSStore = 2432;   // f32 [2][32][18], rewritten in place
constexpr int kSV = 7040;       // f32 [2][15][64]
constexpr int kSBulk = 14720;
constexpr int kSScfl = 14720;   // int16 [2][22]
constexpr int kSScfs = 14816;   // int16 [2][39]
constexpr int kSPrev = 14976;   // f32 [3]
constexpr int kSAct = 14992;    // int32
constexpr int kStage = 15008;
constexpr int kSmallWords = 22 + 39 + 3;  // scf_l, scf_s, prev_lines
constexpr int kSmallTid = 64;   // first of the threads that copy them

// the block's shared memory, byte offsets
constexpr int kOTab = 0;                       // table image
constexpr int kOStage = kOTab + kTFloats * 4;  // two stages
constexpr int kXtRow = 37;  // x_time row stride: 32 subbands' writes at
                            // 37 words apart hit 32 distinct banks
constexpr int kOX = kOStage + 2 * kStage;      // f32 [2][576] spectra
constexpr int kOXt = kOX + 2 * kLines * 4;     // f32 [32][kXtRow] x_time,
                                               // row k: [ch][18]
constexpr int kONb = kOXt + 32 * kXtRow * 4;   // f32 [2][18][64] new FIFO rows
constexpr int kOPcm = kONb + 2 * 18 * 64 * 4;  // int16 [576][2] PCM
constexpr int kOBar = kOPcm + kLines * 4;      // two mbarriers
constexpr int kSmemBytes = kOBar + 16;
static_assert(kOStage % 16 == 0 && kOX % 16 == 0 && kONb % 16 == 0 &&
                  kOPcm % 16 == 0 && kOBar % 8 == 0 && kStage % 16 == 0,
              "bulk copies need 16-byte aligned shared addresses");

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
// [LO, LO + N), N a power of two: tree_sum's order for each output
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
// 16-byte aligned, ws a multiple of 4), each summed as dot<kExact, N>
// sums one (granule.cuh): sequentially from the first product when
// kExact, else as tree_sum<N> (N = 18: the tree of the first 16 plus the
// last pair)
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

__device__ __forceinline__ int scf_from_bits(float line) {
  // band-12 OOB read (docs/DESIGN.md §6): the float BITS of a granule-0
  // ch0 output line as uint32, clamped to 1024
  const unsigned bits = __float_as_uint(line);
  return bits < 1024u ? (int)bits : 1024;
}

// requantize<kExact, false> (granule_step.cuh) with the band-12
// substitution done per line: when prev12 is not null (granule 1, ch 1)
// the short slots 36..38 read scf_from_bits(prev12[slot - 36]) and, in
// exact mode, the band-12 lines take the true gain of that scalefactor
template <bool kExact>
__device__ __forceinline__ float requantize_line(
    const Tables& t, const int* meta, const int16_t* scfl,
    const int16_t* scfs, const float* prev12, int lay, int ch, int i,
    int x) {
  const int mag = min(abs(x), kPow43Max);
  const float tmp3 = (x < 0 ? -1.0f : 1.0f) * __ldg(t.pow43 + mag);
  const int gg = meta[M_GG + ch];
  const int qpu = 2 << meta[M_SFS + ch];
  const bool short_line = line_map(t, MAP_SHORT, lay, i) == 1;
  int q, eo;
  if (short_line) {
    const int slot = line_map(t, MAP_SFB_S, lay, i);
    const int scf = (prev12 != nullptr && slot >= 36)
                        ? scf_from_bits(prev12[slot - 36])
                        : scfs[ch * 39 + slot];
    q = qpu * scf;
    eo = gg - 210 - 8 * meta[M_SBG + ch * 3 + line_map(t, MAP_WIN, lay, i)];
  } else {
    q = qpu * (scfl[ch * 22 + line_map(t, MAP_SFB_L, lay, i)] +
               line_map(t, MAP_PRETAB, lay, i) * meta[M_PRE + ch]);
    eo = gg - 210;
  }
  float tmp1 = __ldg(t.quarter_down + (q & 3)) * pow2i(-(q >> 2));
  if constexpr (kExact) {
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

// requantize + MPEG-1 stereo of line i, both channels (granule_step's
// first stage); prev12: the slot's prev_lines on granule-1 steps
template <bool kExact>
__device__ __forceinline__ void front_line(const Tables& t, const int* sm,
                                           const int16_t* sx,
                                           const int16_t* scfl,
                                           const int16_t* scfs,
                                           const float* prev12,
                                           int bug_compat, int i, float& l,
                                           float& r) {
  const int lay0 = clampi(sm[M_LAYOUT], 0, kLayouts - 1);
  const int lay1 = clampi(sm[M_LAYOUT + 1], 0, kLayouts - 1);
  l = requantize_line<kExact>(t, sm, scfl, scfs, nullptr, lay0, 0, i, sx[i]);
  r = requantize_line<kExact>(t, sm, scfl, scfs, prev12, lay1, 1, i,
                              sx[kLines + i]);
  const int c0 = clampi(sm[M_C1], 0, kLines);
  const int c1r = clampi(sm[M_C1 + 1], 0, kLines);
  if (sm[M_MS] != 0 && i < min(c0, c1r)) {
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
  if (sm[M_IS] != 0) {
    // intensity: ch0's layout and scalefactors give the positions
    const bool short0 = line_map(t, MAP_SHORT, lay0, i) == 1;
    const int is_pos = short0 ? scfs[line_map(t, MAP_SFB_S_PLAIN, lay0, i)]
                              : scfl[line_map(t, MAP_SFB_L, lay0, i)];
    if (line_map(t, MAP_IOK, lay0, i) == 1 &&
        line_map(t, MAP_BAND_START, lay0, i) >= c1r && is_pos != 7) {
      if (bug_compat && short0) {
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
        if (short0) ip = min(ip, 7);
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
// IMDCT, or the three short IMDCTs overlapped as short_out (granule.cuh)
// adds them, window by window in increasing w
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

// One granule step for every slot of the block (K1 / K2).  Per slot:
// wait for its stage, start the next slot's copies, front half (thread =
// line), antialias, IMDCT + overlap-add of both channels (thread = four
// outputs, channel, subband: a warp is the 32 subbands of one channel
// and output group, so every coefficient load is a broadcast), matrixing
// of both channels (thread = four FIFO columns at one channel and time),
// FIR of both channels
// (thread = one channel, column and three time steps), and the stage's
// new store, new FIFO rows and PCM back by bulk copies.  Five barriers a
// slot.  An idle slot writes silence and copies no state.
template <bool kExact>
__device__ __forceinline__ void persistent_granules(
    const int16_t* __restrict__ ix, const int16_t* __restrict__ scf_l,
    const int16_t* __restrict__ scf_s, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ active, int gr1, int bug_compat,
    float* __restrict__ store, float* __restrict__ v,
    float* __restrict__ prev, uint32_t* __restrict__ pcm, const Tables& t,
    const float4* __restrict__ image, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  float* tab = reinterpret_cast<float*>(smem + kOTab);
  float* s_x = reinterpret_cast<float*>(smem + kOX);
  float* s_xt = reinterpret_cast<float*>(smem + kOXt);
  float* s_nb = reinterpret_cast<float*>(smem + kONb);
  int16_t* s_pcm = reinterpret_cast<int16_t*>(smem + kOPcm);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kOBar);
  const int G = gridDim.x;

  // slot `slot` into stage s: the producer (thread 0) sets the stage's
  // active flag and, for an active slot, starts the bulk copies
  const auto produce = [&](int s, int slot, int act) {
    unsigned char* st = smem + kOStage + s * kStage;
    *reinterpret_cast<int*>(st + kSAct) = act;
    if (act) {
      mbar_expect_tx(bar + s, kSBulk);
      bulk_load(st + kSIx, ix + (size_t)slot * 2 * kLines, 2 * kLines * 2,
                bar + s);
      bulk_load(st + kSMeta, meta + (size_t)slot * kMetaWords,
                kMetaWords * 4, bar + s);
      bulk_load(st + kSStore, store + (size_t)slot * 2 * 32 * 18,
                2 * 32 * 18 * 4, bar + s);
      bulk_load(st + kSV, v + (size_t)slot * 2 * 15 * 64, 2 * 15 * 64 * 4,
                bar + s);
    } else {
      mbar_arrive(bar + s);
    }
  };
  // the small fields of `slot` into stage s, word w per thread
  const auto copy_small = [&](int s, int slot) {
    const int w = tid - kSmallTid;
    if (w < 0 || w >= kSmallWords) return;
    unsigned char* st = smem + kOStage + s * kStage;
    if (w < 22)
      copy4_async(st + kSScfl + 4 * w,
                  reinterpret_cast<const char*>(scf_l + (size_t)slot * 44) +
                      4 * w);
    else if (w < 61)
      copy4_async(st + kSScfs + 4 * (w - 22),
                  reinterpret_cast<const char*>(scf_s + (size_t)slot * 78) +
                      4 * (w - 22));
    else
      copy4_async(st + kSPrev + 4 * (w - 61), prev + (size_t)slot * 3 +
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

  int b = blockIdx.x;   // the launch keeps gridDim.x <= B
  int act_next = 0;     // thread 0: active flag of slot b + G
  int pend = -1;        // thread 0: slot whose PCM waits in s_pcm
  if (tid == 0) {
    produce(0, b, __ldg(active + b));
    if (b + G < B) act_next = __ldg(active + b + G);
  }
  copy_small(0, b);

  for (int n = 0; b < B; ++n, b += G) {
    const int s = n & 1;
    unsigned char* st = smem + kOStage + s * kStage;
    mbar_wait(bar + s, (n >> 1) & 1);
    copy4_wait();
    __syncthreads();
    const int act = *reinterpret_cast<const int*>(st + kSAct);
    const int bn = b + G;
    if (tid == 0) {
      // the last slot's store and FIFO rows have left shared memory: its
      // stage and s_nb may be refilled; then its PCM goes out
      bulk_wait_read();
      if (bn < B) {
        produce(s ^ 1, bn, act_next);
        act_next = bn + G < B ? __ldg(active + bn + G) : 0;
      }
      if (pend >= 0) {
        bulk_store(pcm + (size_t)pend * kLines, s_pcm, kLines * 4);
        bulk_commit();
      }
      pend = act ? b : -1;
    }
    if (bn < B) copy_small(s ^ 1, bn);
    if (!act) {
      pcm[(size_t)b * kLines + tid] = 0u;  // silence, state untouched
      continue;
    }
    // the thread index, opaque per slot: otherwise the compiler hoists
    // every per-thread address of the slot's stages (the FIR's 20 FIFO
    // taps, the IMDCT's and matrixing's operands) out of the slot loop
    // and, at 56 registers, spills them across it
    int lt = tid;
    asm volatile("" : "+r"(lt));
    const int* sm = reinterpret_cast<const int*>(st + kSMeta);
    float* s_store = reinterpret_cast<float*>(st + kSStore);
    const float* s_v = reinterpret_cast<const float*>(st + kSV);

    // ---- requantize + stereo: thread = line ----
    {
      float l, r;
      front_line<kExact>(t, sm, reinterpret_cast<const int16_t*>(st + kSIx),
                         reinterpret_cast<const int16_t*>(st + kSScfl),
                         reinterpret_cast<const int16_t*>(st + kSScfs),
                         gr1 ? reinterpret_cast<const float*>(st + kSPrev)
                             : nullptr,
                         bug_compat, lt, l, r);
      s_x[lt] = l;
      s_x[kLines + lt] = r;
    }
    __syncthreads();

    // ---- antialias, as granule_step ----
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
    const int g = lt / 64, ch = lt / 32 % 2, sb = lt % 32, p0 = 4 * g;
    {
      int bt = sm[M_BT + ch];
      if (sm[M_WSF + ch] == 1 && sm[M_MIXED + ch] == 1 && sb < 2) bt = 0;
      bt = clampi(bt, 0, 3);
      // the subband's 18 lines in registers (9 LDS.64), reused by the
      // three short windows
      const float* xs = s_x + ch * kLines + sb * 18;
      float x[18];
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        const float2 p = reinterpret_cast<const float2*>(xs)[m];
        x[2 * m] = p.x;
        x[2 * m + 1] = p.y;
      }
      float o[4];
      imdct4<kExact>(tab, [&](int m) { return x[m]; }, bt, p0, o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + e;
        hi[e] = o[e];
        if (p < 18) {
          const float inv = ((sb & 1) && (p & 1)) ? -1.0f : 1.0f;
          const float xt = (o[e] + s_store[ch * 576 + sb * 18 + p]) * inv;
          s_xt[sb * kXtRow + ch * 18 + p] = xt;
          // granule-0 steps latch x_time[0:3] of (ch0, sb0): the carry
          if (gr1 == 0 && ch == 0 && sb == 0 && p < 3)
            prev[(size_t)b * 3 + p] = xt;
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
    {
      const int jg = lt / 36, c = lt % 36;
      const float* xt = s_xt + c;
      const float4 nb = dot4<kExact, 32>(
          [&](int k) { return xt[k * kXtRow]; }, tab + kTNwinT + 4 * jg, 64);
      *reinterpret_cast<float4*>(s_nb + c * 64 + 4 * jg) = nb;
    }
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
      bulk_store(store + (size_t)b * 2 * 32 * 18, s_store, 2 * 32 * 18 * 4);
      // the new FIFO is the newest 15 rows, nb rows 3..17 of each channel
      for (int c2 = 0; c2 < 2; ++c2)
        bulk_store(v + ((size_t)b * 2 + c2) * 15 * 64,
                   s_nb + (c2 * 18 + 3) * 64, 15 * 64 * 4);
      bulk_commit();
    }

    // ---- 16-tap D-window FIR over the 33-row FIFO (15 carried rows in
    // the stage, 18 new in s_nb): thread = (channel, time steps it0,
    // it0 + 2, it0 + 4, column k), which share 14 of their 16 taps ----
    if (lt < 2 * 6 * 32) {
      const int fch = lt / 192, grp = lt / 32 % 6, k = lt % 32;
      const int it0 = (grp & 1) + 6 * (grp >> 1);
      const float* vold = s_v + fch * 15 * 64;
      const float* vnew = s_nb + fch * 18 * 64;
      // e[q] = FIFO row it0 + q, half 32 * (j & 1) of the taps j that
      // read it: j = 15 + 2o - q, so its parity is that of q + 1
      float e[20];
#pragma unroll
      for (int q = 0; q < 20; ++q) {
        const int row = it0 + q, col = (q & 1) ? k : 32 + k;
        e[q] = row < 15 ? vold[row * 64 + col] : vnew[(row - 15) * 64 + col];
      }
      float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float d = tab[kTSynD + j * 32 + k];
#pragma unroll
        for (int o = 0; o < 3; ++o) acc[o] = acc[o] + d * e[15 - j + 2 * o];
      }
      const int nch = max(sm[M_NCH], 1);
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const int idx = (it0 + 2 * o) * 32 + k;
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
    fence_async_shared();
  }

  __syncthreads();
  if (tid == 0) {
    if (pend >= 0) {
      bulk_store(pcm + (size_t)pend * kLines, s_pcm, kLines * 4);
      bulk_commit();
    }
    bulk_wait_all();
  }
}

}  // namespace
