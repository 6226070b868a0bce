// Layer I/II synthesis step for NVIDIA Hopper (sm_90a): K7, fast and
// exact, S16 or float PCM, for Layer I (S = 12 time steps a frame) and
// Layer II (S = 36): eight instances (persistent instances 13-20).
//
// Replaces the XLA stage pdmp3_tpu/models/l12.py:decode_l12_frames (the
// JAX package has no Pallas kernel for it: dsp.subband_synthesis, then
// quantize_pack or float_pack).  Plain PyTorch twin:
// pdmp3_tpu_torch/ops/l12_synth.py:l12_synth_step_ref.
//
// From the requantized subband samples sb [B][2][S][32] and the FIFO v
// [B][2][15][64] (oldest row first): the NWIN matrixing of the S time
// steps into S new FIFO rows, the 16-tap D-window FIR over the (15 + S)-row
// window, then the quantize and the L|R pack (S16: x32767, truncate, clip;
// exact through f64; NaN and values outside int32 give -32767) or
// float_pack (clip to [-1, 1], NaN to -1); mono (nch <= 1) duplicates L.
// The new FIFO is the window's last 15 rows: for Layer II the last 15 of
// the 36 new rows, for Layer I the 3 newest carried rows and the 12 new
// ones.  An idle slot writes a silent PCM row and leaves its FIFO alone.
//
// What bounds it.  Per active slot sb 3,072 B (Layer I) or 9,216 B
// (Layer II) in, v 7,680 B read and written, PCM S x 128 B (float S x
// 256 B) out: at S = 36 about 29 KB a slot, so bytes set the bound (Layer
// II S16 at B = 8192: 239 MB, 0.071 ms at 3.35 TB/s).  Built with
// -fmad=false, every product and every sum is its own f32 instruction:
// 2 x S x 33 dots of 32 terms and 2 x S x 32 FIR sums of 16 taps, about
// 0.22 M instructions a Layer II slot, 0.055 ms at B = 8192 on 132 SMs x
// 128 lanes x 1.98 GHz, below the bytes.
//
// The design is the granule body's pattern
// (granule_persist.cuh): min(B, SM count x blocks per SM) persistent
// blocks walk the slots; a two-stage ring brings slot n + G's sb and v
// rows into shared memory by cp.async.bulk on an mbarrier while slot n
// computes; the new FIFO rows and the PCM row go back by bulk stores;
// two barriers a slot.  K7's own table image (ops/consts.py
// l12_smem_image, 6,800 B) sits in shared memory once per block:
// - Matrixing over the unique NWIN rows.  31 of NWIN's 64 rows are
//   bitwise copies or negations of another (the host derives the map
//   from the table and passes it in the image), so only 33 rows need a
//   dot, packed into 36 columns (9 quads of 4).  Negation is exact and
//   round-to-nearest symmetric, so a negated row's dot, summed in the
//   same order, is exactly the negation wherever it is nonzero and not
//   NaN.  Where it is zero its sign depends on the products' signs: over
//   a row of +0.0 samples (silence, a mono slot's second channel) it is
//   -0.0 exactly when every mirrored coefficient's sign bit is set (the
//   host's bit in the image), else, and for NaN, the thread sums it again
//   with the negated coefficients.  A copy row's dot is the same bits.
// - Register tiles.  Lanes 0-26 of a warp are 9 column quads x 3 row
//   groups: a thread takes kR rows x 4 columns, so a float4 of the table
//   serves 4 kR products.  Exact mode: 4 kR sequential sums, a float4 of
//   sb serving four k of a row; kR = 4 for Layer II (on half of the
//   warps: a warp's 14 shared wavefronts a chunk then serve twice the
//   products), 2 for Layer I.  Fast mode, kR = 2: the pairwise tree,
//   chunk sums of four k and their pairs, quads and halves pending across
//   the chunk loop (up to five partials an output).  The chunk loops are
//   rolled (exact) or unrolled twice (fast); a full unroll hoists the
//   coefficient loads and spills.  A warp's sb loads touch three rows,
//   which share banks (a row is 128 B), its table loads 144 contiguous
//   bytes.
// - The FIR: a warp is one channel and one parity of a run of time
//   steps, a thread one column kc = lane of it: Layer I six steps (a
//   channel's parity), Layer II nine (half of it, on eight of the twelve
//   warps), each summed from tap 0 onto +0.0 as dsp.subband_synthesis
//   sums them.  The run's first window row is fixed at compile time per
//   warp, so each of its 2 x steps + 14 window values is one load at a
//   fixed offset, from the carried rows or the new ones.
// 32 x S / 3 threads a block (128 / 384).  Shared memory 36,032 B (Layer
// I) / 63,680 B (Layer II), float PCM 37,568 / 68,288 B; five blocks per
// SM (Layer I) or two (Layer II: its tiles take 85 registers).  The
// bulk copies need 16-byte aligned sb, v and PCM (ops/l12_synth.py checks
// them); nch and active are read where they lie, int16 or int32 with an
// element stride (the pool's wire holds nch as a strided int16 view).
// Built with -fmad=false and without flush-to-zero, so every product and
// sum rounds where the plain version rounds, in its order: the kernel
// equals it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_persist.cuh"

namespace {

using namespace pdmp3;

// K7's table image (ops/consts.py L12_*), float offsets: the unique NWIN
// rows transposed and packed [32][kK7Cols], synth_d [16][32], and the
// packed columns' store map (int32: bits 0-7 the dot's FIFO column, 8-15
// its mirror's, bit 16 the mirror is negated, bit 17 its dot over a row of
// +0.0 samples is -0.0; kK7None: no store)
constexpr int kK7Cols = 36;
constexpr int kK7UT = 0, kK7SynD = 32 * kK7Cols, kK7Map = kK7SynD + 512;
constexpr int kK7Floats = kK7Map + kK7Cols;
constexpr int kK7None = 64, kK7Neg = 1 << 16, kK7ZeroNeg = 1 << 17;
// the rows of a thread's matrixing tile: fast mode two (its tree's
// pending partials take the registers), exact mode two for Layer I and
// four for Layer II (on half of the warps: fewer shared-memory
// wavefronts a product)
__host__ __device__ constexpr int l12_tile_rows(int S, bool exact) {
  return exact && S == 36 ? 4 : 2;
}

// the resident blocks per SM each instance's registers are budgeted for:
// Layer II's tiles (fast: two-row trees, up to five partials an output;
// exact: four rows) need more than the 56 registers of three blocks, so
// they take two blocks of 85
__host__ __device__ constexpr int l12_min_blocks(int S) {
  return S == 36 ? 2 : 5;
}

// K7's shared memory, byte offsets: the table image, a two-stage ring of
// one slot's sb and FIFO rows (both bulk-copied) and its flags, the new
// FIFO rows f32 [2][S][64], the PCM row and the stages' two mbarriers
template <int S, bool kFloat>
struct L12Smem {
  static constexpr int kThreads = 32 * S / 3;
  static constexpr int kSbBytes = 2 * S * 32 * 4;
  static constexpr int kVBytes = 2 * 15 * 64 * 4;
  static constexpr int kSSb = 0;
  static constexpr int kSV = kSbBytes;
  static constexpr int kSFlags = kSV + kVBytes;  // int32 active, nch
  static constexpr int kStage = kSFlags + 16;
  static constexpr int kOTab = 0;
  static constexpr int kOStage = kOTab + kK7Floats * 4;
  static constexpr int kONb = kOStage + 2 * kStage;
  static constexpr int kOPcm = kONb + 2 * S * 64 * 4;
  static constexpr int kOBar = kOPcm + S * 32 * (kFloat ? 8 : 4);
  static constexpr int kSmemBytes = kOBar + 16;
  static_assert(S % 12 == 0, "a FIR warp spans twelve time steps");
  static_assert(kK7Cols % 4 == 0 && kOStage % 16 == 0 &&
                    kStage % 16 == 0 && kSV % 16 == 0 && kONb % 16 == 0 &&
                    kOPcm % 16 == 0 && kOBar % 8 == 0,
                "bulk copies and float4 loads need 16-byte alignment");
};

// element i of an int16 (es 2) or int32 (es 4) vector with an element
// stride
__device__ __forceinline__ int load_int(const void* p, int es,
                                        long long stride, int i) {
  const long long k = (long long)i * stride;
  return es == 2 ? (int)__ldg(static_cast<const int16_t*>(p) + k)
                 : __ldg(static_cast<const int32_t*>(p) + k);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// the coefficients of k for four packed columns (ut: the quad's first
// column), negated when kNeg
template <bool kNeg>
__device__ __forceinline__ float4 coef4(const float* ut, int k) {
  const float4 w = *reinterpret_cast<const float4*>(ut + k * kK7Cols);
  return kNeg ? make_float4(-w.x, -w.y, -w.z, -w.w) : w;
}

// the 32-term dots of kR sb rows (row r at x + 32 r) with four packed
// columns, each summed as the plain version sums one: sequentially from
// the first product (exact, dsp._dot_seq) or as the pairwise tree (fast,
// dsp._dot_tree: chunk sums of four k, then pairs, quads and halves of
// chunks, the pending partials carried across the chunk loop).  Each
// coefficient load serves every row.  The chunk loop is rolled (exact)
// or unrolled twice (fast): a full unroll hoists the 32 coefficient
// loads and spills.
template <bool kExact, int kR, bool kNeg>
__device__ __forceinline__ void quad_dots(const float* x, const float* ut,
                                          float4 (&o)[kR],
                                          unsigned (&orx)[kR]) {
  // orx[r]: the OR of row r's sample bits (0: a row of +0.0), taken as
  // the samples load (not in the negated recompute)
  const auto take = [&](int r, float v) {
    if constexpr (!kNeg) orx[r] |= __float_as_uint(v);
  };
  if constexpr (!kNeg)
#pragma unroll
    for (int r = 0; r < kR; ++r) orx[r] = 0;
  if constexpr (!kExact) {
    static_assert(kR == 2, "fast mode: two rows");
    float4 pair[2], quad[2], half[2];  // pending partials of the tree
#pragma unroll 2
    for (int c = 0; c < 8; ++c) {
      // the chunk sums (p0 + p1) + (p2 + p3), one coefficient float4 at
      // a time (registers)
      float4 t01[2], cs[2];
      const float* xc = x + 4 * c;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = coef4<kNeg>(ut, 4 * c + kk);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float xv = xc[32 * r + kk];
          take(r, xv);
          const float4 p = scale4(xv, w);
          if (kk == 0) t01[r] = p;
          if (kk == 1) t01[r] = add4(t01[r], p);
          if (kk == 2) cs[r] = p;
          if (kk == 3) cs[r] = add4(t01[r], add4(cs[r], p));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!(c & 1)) {
          pair[r] = cs[r];
        } else {
          const float4 p = add4(pair[r], cs[r]);  // chunks c - 1, c
          if (!(c & 2)) {
            quad[r] = p;
          } else {
            const float4 q = add4(quad[r], p);  // chunks c - 3 .. c
            if (c == 3)
              half[r] = q;
            else
              o[r] = add4(half[r], q);
          }
        }
      }
    }
  } else {
    // chunk 0 peeled: its first product starts each sum
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = coef4<kNeg>(ut, kk);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float xv = x[32 * r + kk];
        take(r, xv);
        const float4 p = scale4(xv, w);
        o[r] = kk == 0 ? p : add4(o[r], p);
      }
    }
#pragma unroll 1
    for (int c = 1; c < 8; ++c) {
      float4 a[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        a[r] = *reinterpret_cast<const float4*>(x + 32 * r + 4 * c);
        if constexpr (!kNeg)
          orx[r] |= __float_as_uint(a[r].x) | __float_as_uint(a[r].y) |
                    __float_as_uint(a[r].z) | __float_as_uint(a[r].w);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = coef4<kNeg>(ut, 4 * c + kk);
#pragma unroll
        for (int r = 0; r < kR; ++r)
          o[r] = add4(o[r], scale4(comp(a[r], kk), w));
      }
    }
  }
}

// kR FIFO rows nb[row0 + r][*] from their sb rows: the quad's dots go to
// their columns, and each mirrored column gets the copy, the negation,
// or, for a zero or NaN dot of a negated row: over a row of +0.0 samples
// the signed zero its sum of signed zeros makes (the table's bit), else
// its own dot with the negated coefficients, summed again only where one
// is needed
template <bool kExact, int kR>
__device__ __forceinline__ void matrix_tile(const float* s_sb,
                                            const float* ut, const int* map,
                                            int row0, float* s_nb) {
  const float* x = s_sb + row0 * 32;
  float4 v[kR];
  unsigned orx[kR];
  quad_dots<kExact, kR, false>(x, ut, v, orx);
  const int4 map4 = *reinterpret_cast<const int4*>(map);
  const int m[4] = {map4.x, map4.y, map4.z, map4.w};
  int need = 0;  // bit 4 r + e: the mirror of (r, e) is summed again
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float* row = s_nb + (row0 + r) * 64;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float f = comp(v[r], e);
      const int j = m[e] & 0xff, mir = (m[e] >> 8) & 0xff;
      if (j < kK7None) row[j] = f;
      if (mir < kK7None) {
        if (!(m[e] & kK7Neg))
          row[mir] = f;
        else if (f == 0.0f && orx[r] == 0)
          row[mir] = m[e] & kK7ZeroNeg ? -0.0f : 0.0f;
        else if (f == 0.0f || isnan(f))
          need |= 1 << (4 * r + e);
        else
          row[mir] = -f;
      }
    }
  }
  if (need) {
    quad_dots<kExact, kR, true>(x, ut, v, orx);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (need & (1 << (4 * r + e)))
          s_nb[(row0 + r) * 64 + ((m[e] >> 8) & 0xff)] = comp(v[r], e);
  }
}

// the 16-tap D-window FIR of kO time steps kI0 + 2o of one channel's
// (15 + S)-row window (rows < 15 carried, vold; the others new, vnew) for
// column kc, each summed from tap 0 onto +0.0, as dsp.subband_synthesis
// sums them (e[q] = window row kI0 + q, half 32 x (j & 1) of the taps j
// that read it: j = 15 + 2o - q, so its parity is that of q + 1); the
// first row kI0 is fixed at compile time, so every load takes a fixed
// offset from vold or vnew; synd: synth_d [16][32]
template <int kI0, int kO>
__device__ __forceinline__ void l12_fir_fixed(const float* synd,
                                              const float* vold,
                                              const float* vnew, int kc,
                                              float (&acc)[kO]) {
  float e[2 * kO + 14];
#pragma unroll
  for (int q = 0; q < 2 * kO + 14; ++q) {
    const int row = kI0 + q, col = (q & 1) ? kc : 32 + kc;
    e[q] = row < 15 ? vold[row * 64 + col] : vnew[(row - 15) * 64 + col];
  }
#pragma unroll
  for (int o = 0; o < kO; ++o) acc[o] = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float d = synd[j * 32 + kc];
#pragma unroll
    for (int o = 0; o < kO; ++o) acc[o] = acc[o] + d * e[15 - j + 2 * o];
  }
}

// Per slot b = blockIdx.x + k * gridDim.x: wait for its stage; thread 0
// starts the next slot's copies and sends the previous slot's PCM row;
// matrixing (lanes 0-26 of warp w: column quad lane % 9 of the row group
// 3 w + lane / 9, rows c * S + s); the new FIFO rows go back; FIR (warp =
// channel, parity and run of time steps; lane = column) into the PCM row.
template <bool kExact, bool kFloat, int S>
__global__ void __launch_bounds__(L12Smem<S, kFloat>::kThreads,
                                  l12_min_blocks(S))
subband_synth_kernel(const float* __restrict__ sb,
                     const void* __restrict__ nch, int nch_es,
                     long long nch_stride, const void* __restrict__ active,
                     int act_es, long long act_stride, float* __restrict__ v,
                     void* __restrict__ pcm_out,
                     const float4* __restrict__ image, int B) {
  using L = L12Smem<S, kFloat>;
  using Line = PcmLine<kFloat>;
  constexpr int kT = L::kThreads;
  constexpr int kRow = S * 32;  // PCM lines (L|R pairs) of a frame
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  float* s_tab = reinterpret_cast<float*>(smem + L::kOTab);
  const float* s_synd = s_tab + kK7SynD;  // [16][32]
  float* s_nb = reinterpret_cast<float*>(smem + L::kONb);
  unsigned char* s_pcm = smem + L::kOPcm;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kOBar);
  Line* pcm = static_cast<Line*>(pcm_out);
  const int G = gridDim.x;

  // slot into stage s (thread 0): its flags, and for an active slot the
  // bulk copies of its sb and FIFO rows
  const auto produce = [&](int s, int slot) {
    unsigned char* st = smem + L::kOStage + s * L::kStage;
    int* flags = reinterpret_cast<int*>(st + L::kSFlags);
    const int act = load_int(active, act_es, act_stride, slot) != 0;
    flags[0] = act;
    flags[1] = load_int(nch, nch_es, nch_stride, slot);
    if (act) {
      mbar_expect_tx(bar + s, L::kSbBytes + L::kVBytes);
      bulk_load(st + L::kSSb, sb + (size_t)slot * 2 * S * 32, L::kSbBytes,
                bar + s);
      bulk_load(st + L::kSV, v + (size_t)slot * 2 * 15 * 64, L::kVBytes,
                bar + s);
    } else {
      mbar_arrive(bar + s);
    }
  };

  for (int k = tid; k < kK7Floats / 4; k += kT)
    reinterpret_cast<float4*>(s_tab)[k] = __ldg(image + k);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int b = blockIdx.x;  // the launch keeps gridDim.x <= B
  int pend = -1;       // thread 0: PCM row waiting in s_pcm
  if (tid == 0) produce(0, b);

  for (int n = 0; b < B; ++n, b += G) {
    const int s = n & 1;
    unsigned char* st = smem + L::kOStage + s * L::kStage;
    mbar_wait(bar + s, (n >> 1) & 1);
    // the last slot's FIFO stores have left shared memory: s_nb and its
    // stage (whose carried rows Layer I stores) may be written again
    if (tid == 0) bulk_wait_read();
    __syncthreads();
    const int* flags = reinterpret_cast<const int*>(st + L::kSFlags);
    const int act = flags[0];
    const bool mono = flags[1] <= 1;
    if (tid == 0) {
      if (b + G < B) produce(s ^ 1, b + G);
      if (pend >= 0) {
        bulk_store(pcm + (size_t)pend * kRow, s_pcm, kRow * sizeof(Line));
        bulk_commit();
      }
      pend = act ? b : -1;
    }
    if (!act) {
      // silence, state untouched
      for (int i = tid; i < kRow; i += kT) pcm[(size_t)b * kRow + i] = Line{};
      continue;
    }
    // the thread index, opaque per slot, as in the granule body: keeps
    // the per-thread addresses of the stages from being hoisted out of
    // the slot loop
    int lt = tid;
    asm volatile("" : "+r"(lt));
    const float* s_sb = reinterpret_cast<const float*>(st + L::kSSb);
    const float* s_v = reinterpret_cast<const float*>(st + L::kSV);

    // ---- matrixing: nb[c][s][j] = sum over k of sb[c][s][k] * NWIN[j][k]
    {
      const int lane = lt & 31;
      if (lane < 27) {
        const int cq = lane % 9, row0 = 2 * (3 * (lt >> 5) + lane / 9);
        const float* ut = s_tab + kK7UT + 4 * cq;
        const int* map = reinterpret_cast<const int*>(s_tab + kK7Map) + 4 * cq;
        constexpr int kR = l12_tile_rows(S, kExact);
        // the tiles of 2 S rows: 3 kR rows a warp, on the first 2 S / 3 kR
        // warps
        if (lt >> 5 < 2 * S / (3 * kR))
          matrix_tile<kExact, kR>(s_sb, ut, map, kR * (row0 / 2), s_nb);
      }
    }
    fence_async_shared();
    if (tid == 0) bulk_wait_read();  // the last PCM row has left s_pcm
    __syncthreads();
    if (tid == 0) {
      // the new FIFO: the window's last 15 rows
      for (int c = 0; c < 2; ++c) {
        float* dst = v + ((size_t)b * 2 + c) * 15 * 64;
        if constexpr (S >= 15) {
          bulk_store(dst, s_nb + (c * S + S - 15) * 64, 15 * 64 * 4);
        } else {
          bulk_store(dst, s_v + (c * 15 + S) * 64, (15 - S) * 64 * 4);
          bulk_store(dst + (15 - S) * 64, s_nb + c * S * 64, S * 64 * 4);
        }
      }
      bulk_commit();
    }

    // ---- FIR and the pack.  Layer I: warp = (channel, parity), lane =
    // column kc, time steps i0 + 2o, o < 6.  Layer II: warps 0-7 =
    // (channel, parity, half), time steps i0 + 2o, o < 9, i0 = parity +
    // 18 half
    {
      const int kc = lt & 31, w = lt >> 5;
      constexpr int kO = S == 36 ? 9 : 6;
      if (w < 8 || S == 12) {
        const int fch = w >> (S == 36 ? 2 : 1);
        const int i0 = (w & 1) + (S == 36 ? 18 * ((w >> 1) & 1) : 0);
        const float* vold = s_v + fch * 15 * 64;
        const float* vnew = s_nb + fch * S * 64;
        float acc[kO];
        if constexpr (S == 36) {
          switch (i0) {
            case 0: l12_fir_fixed<0, kO>(s_synd, vold, vnew, kc, acc); break;
            case 1: l12_fir_fixed<1, kO>(s_synd, vold, vnew, kc, acc); break;
            case 18:
              l12_fir_fixed<18, kO>(s_synd, vold, vnew, kc, acc);
              break;
            default: l12_fir_fixed<19, kO>(s_synd, vold, vnew, kc, acc);
          }
        } else if (i0) {
          l12_fir_fixed<1, kO>(s_synd, vold, vnew, kc, acc);
        } else {
          l12_fir_fixed<0, kO>(s_synd, vold, vnew, kc, acc);
        }
#pragma unroll
        for (int o = 0; o < kO; ++o) {
          const int idx = (i0 + 2 * o) * 32 + kc;
          if constexpr (kFloat) {
            float* pc = reinterpret_cast<float*>(s_pcm);
            const float f = float_sample(acc[o]);
            if (fch == 0) {
              pc[2 * idx] = f;
              if (mono) pc[2 * idx + 1] = f;  // mono: duplicate L
            } else if (!mono) {
              pc[2 * idx + 1] = f;
            }
          } else {
            int16_t* pc = reinterpret_cast<int16_t*>(s_pcm);
            const int16_t q =
                (int16_t)(kExact ? qz_f64(acc[o]) : quantize_fast(acc[o]));
            if (fch == 0) {
              pc[2 * idx] = q;
              if (mono) pc[2 * idx + 1] = q;  // mono: duplicate L
            } else if (!mono) {
              pc[2 * idx + 1] = q;
            }
          }
        }
      }
    }
    fence_async_shared();
  }

  __syncthreads();
  if (tid == 0) {
    if (pend >= 0) {
      bulk_store(pcm + (size_t)pend * kRow, s_pcm, kRow * sizeof(Line));
      bulk_commit();
    }
    bulk_wait_all();
  }
}

// the instance of mode = 4 (Layer II) + 2 (float PCM) + 1 (exact)
using L12Fn = void (*)(const float*, const void*, int, long long,
                       const void*, int, long long, float*, void*,
                       const float4*, int);

L12Fn l12_fn(int mode) {
  switch (mode) {
    case 0: return subband_synth_kernel<false, false, 12>;
    case 1: return subband_synth_kernel<true, false, 12>;
    case 2: return subband_synth_kernel<false, true, 12>;
    case 3: return subband_synth_kernel<true, true, 12>;
    case 4: return subband_synth_kernel<false, false, 36>;
    case 5: return subband_synth_kernel<true, false, 36>;
    case 6: return subband_synth_kernel<false, true, 36>;
    default: return subband_synth_kernel<true, true, 36>;
  }
}

int l12_smem(int mode) {
  switch (mode >> 1) {
    case 0: return L12Smem<12, false>::kSmemBytes;
    case 1: return L12Smem<12, true>::kSmemBytes;
    case 2: return L12Smem<36, false>::kSmemBytes;
    default: return L12Smem<36, true>::kSmemBytes;
  }
}

int l12_threads(int mode) {
  return mode & 4 ? L12Smem<36, false>::kThreads
                  : L12Smem<12, false>::kThreads;
}

int l12_grid(int mode, int* grid, int* info) {
  if (mode < 0 || mode > 7) return (int)cudaErrorInvalidValue;
  return persistent_grid(13 + mode, reinterpret_cast<const void*>(l12_fn(mode)),
                         l12_smem(mode), grid, info, l12_threads(mode));
}

}  // namespace

extern "C" {

// The launch geometry of K7's instance 13 + mode (mode: 4 Layer II + 2
// float PCM + 1 exact) on the current device, as pdmp3_granule_launch_info
// gives it.
int pdmp3_l12_synth_launch_info(int mode, int* info) {
  int grid = 0;
  return l12_grid(mode, &grid, info);
}

// Launch one Layer I/II synthesis step for B slots on `stream`: sb f32
// [B][2][S][32] (S = 12 or 36); nch and active int16 or int32 (element
// size nch_es / act_es bytes) at element strides nch_stride / act_stride;
// v f32 [B][2][15][64], updated in place for active slots; pcm int16
// [B][S * 32][2], or f32 with float_pcm; image: the table image
// (ops/consts.py l12_smem_image) on the device.  Returns the
// launch-geometry query's or cudaGetLastError()'s code (0 when the
// launch was accepted).
int pdmp3_l12_synth(const float* sb, const void* nch, int nch_es,
                    long long nch_stride, const void* active, int act_es,
                    long long act_stride, float* v, void* pcm,
                    const void* image, int B, int S, int exact, int float_pcm,
                    void* stream) {
  if ((S != 12 && S != 36) || (nch_es != 2 && nch_es != 4) ||
      (act_es != 2 && act_es != 4))
    return (int)cudaErrorInvalidValue;
  const int mode = 4 * (S == 36) + 2 * (float_pcm != 0) + (exact != 0);
  int grid = 0;
  const int e = l12_grid(mode, &grid, nullptr);
  if (e != 0) return e;
  const int blocks = grid < B ? grid : B;
  l12_fn(mode)<<<blocks, l12_threads(mode), l12_smem(mode),
                 (cudaStream_t)stream>>>(
      sb, nch, nch_es, nch_stride, active, act_es, act_stride, v, pcm,
      static_cast<const float4*>(image), B);
  return (int)cudaGetLastError();
}

}  // extern "C"
