// Fused fast-mode MPEG-1 Layer III granule step for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pdmp3_tpu/ops/pallas_step.py:_kernel_full (fast
// mode, family 0: _fused_granule + _back_ch_sb), together with the glue of
// decode_granules_pallas's fast branch: the band-12 scalefactor
// substitution, the L|R int16 pack with mono duplication, and the gated
// prev_lines update.  Plain PyTorch twin:
// pdmp3_tpu_torch/ops/fused_step.py:fused_granule_step_ref.
//
// One thread block decodes one slot, both channels (stereo couples them),
// with 576 threads: one per spectral line for requantize and stereo, one
// per (subband, sample) for the IMDCT and overlap-add, two outputs each
// for the polyphase matrixing, one per PCM sample for the FIR.  Both
// spectra, one channel's x_time and its 33x64 synthesis FIFO stay in
// shared memory; nothing intermediate reaches device memory.
//
// What bounds it.  Per slot and granule the step moves about 30 KB of
// device memory: ix 2,304 B in, store 4,608 B and v 7,680 B each read and
// written, PCM 2,304 B out, plus small fields.  It computes about 0.3
// MFLOP (IMDCT ~83 k, matrixing ~147 k, FIR ~37 k): about 10 FLOP per
// byte, under the f32 CUDA-core ridge of the card, so the state round
// trip bounds the kernel.  The design touches each state byte once
// (store and v are read once and updated in place, by the thread that
// read them), keeps every intermediate on chip, and keeps the products
// in f32 on CUDA cores: TF32 tensor cores would break the 1 LSB contract.
//
// Arithmetic.  Built with -fmad=false: no product is contracted into an
// FMA, so every operation rounds exactly where the plain PyTorch version
// rounds, and the sums run in the same fixed order (a pairwise tree for
// the IMDCT and matrixing dots, sequential taps for the FIR).  The kernel
// therefore matches the plain version bit for bit.  |x|^(4/3) is read
// from the frozen 8207-entry table (the correctly rounded value); the
// TPU computed it with a Newton cube root only because it gathers
// slowly.  Denormals are kept (no -ftz): the band-12 carry reads the
// float BITS of three output lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLines = 576;
constexpr int kThreads = 576;
constexpr int kMetaWords = 32;
constexpr int kLayouts = 9;
constexpr int kPow43Max = 8206;
constexpr int kBlkStride = 65;  // FIFO row stride: the matrixing writes a
                                // column, 65 keeps its banks distinct

// meta words of the wire (PDMP3_META_*, pdmp3_tpu/host/include/pdmp3.h)
constexpr int M_LAYOUT = 0, M_BT = 2, M_WSF = 4, M_MIXED = 6, M_GG = 8,
              M_SFS = 10, M_PRE = 12, M_C1 = 14, M_SBG = 16, M_MS = 22,
              M_IS = 23, M_NCH = 24;
// rows of the line maps (pdmp3_tpu_torch/ops/consts.py MAP_*)
constexpr int MAP_SFB_L = 0, MAP_SFB_S = 1, MAP_SFB_S_PLAIN = 2,
              MAP_WIN = 3, MAP_PRETAB = 4, MAP_SHORT = 5,
              MAP_BAND_START = 6, MAP_IOK = 7;

struct Tables {
  const float* pow43;         // [8207] |x|^(4/3)
  const float* cos36;         // [18][36] long IMDCT basis (m, p)
  const float* c3;            // [18][36] folded short IMDCT basis
  const float* imdct_win;     // [4][36] window per block type
  const float* win2;          // [12] short window
  const float* nwin;          // [64][32] polyphase matrixing
  const float* synth_d;       // [16][32] D window
  const float* cs;            // [8] antialias
  const float* ca;            // [8]
  const float* ratio_l;       // [16] intensity ratios (8..15: OOB slots)
  const float* ratio_r;       // [16]
  const float* quarter_down;  // [4] 2^(-d/4)
  const float* quarter_up;    // [4] 2^(d/4)
  const float* inv_sqrt2;     // [1] f32(1/sqrt(2))
  const int16_t* maps;        // [8][9][576] per-(layout, line) index maps
};

__device__ __forceinline__ int line_map(const Tables& t, int map, int lay,
                                        int i) {
  return __ldg(t.maps + (map * kLayouts + lay) * kLines + i);
}

// exact 2^n by exponent-field construction; +0.0 outside [-126, 127]
__device__ __forceinline__ float pow2i(int n) {
  return (n >= -126 && n <= 127) ? __int_as_float((n + 127) << 23) : 0.0f;
}

// sum of v[0..N) as a pairwise tree: neighbours (0,1), (2,3), ... added
// level by level, an odd last term moving up unchanged
// (fused_step._dot_tree sums in the same order)
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

// sum over m of x[m * xs] * w[m * ws], rounded product by product
template <int N>
__device__ __forceinline__ float dot_tree(const float* x, int xs,
                                          const float* w, int ws) {
  float v[N];
#pragma unroll
  for (int m = 0; m < N; ++m) v[m] = x[m * xs] * __ldg(w + m * ws);
  return tree_sum<N>(v);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// requantized line i of channel ch (pdmp3.c:1829-1905, 2117-2152):
// (2^(-q/4) * 2^((gg-210-8*sbg)/4)) * sign(x)|x|^(4/3)
__device__ float requantize(const Tables& t, const int* meta,
                            const int* scfl, const int* scfs, int lay,
                            int ch, int i, int x) {
  const int mag = min(abs(x), kPow43Max);
  const float tmp3 = (x < 0 ? -1.0f : 1.0f) * __ldg(t.pow43 + mag);
  const int gg = meta[M_GG + ch];
  const int qpu = 2 << meta[M_SFS + ch];  // scalefac_scale is 0 or 1
  int q, eo;
  if (line_map(t, MAP_SHORT, lay, i) == 1) {
    q = qpu * scfs[ch * 39 + line_map(t, MAP_SFB_S, lay, i)];
    eo = gg - 210 - 8 * meta[M_SBG + ch * 3 + line_map(t, MAP_WIN, lay, i)];
  } else {
    q = qpu * (scfl[ch * 22 + line_map(t, MAP_SFB_L, lay, i)] +
               line_map(t, MAP_PRETAB, lay, i) * meta[M_PRE + ch]);
    eo = gg - 210;
  }
  // >> floors negative values and & 3 keeps d in 0..3 (two's complement)
  const float tmp1 = __ldg(t.quarter_down + (q & 3)) * pow2i(-(q >> 2));
  const float tmp2 = __ldg(t.quarter_up + (eo & 3)) * pow2i(eo >> 2);
  return (tmp1 * tmp2) * tmp3;
}

// one output sample p (0..35) of the three overlapped, windowed 12-point
// IMDCTs of a short block: [6,12) = c0, [12,18) = c0 + c1, [18,24) =
// c1 + c2, [24,30) = c2, zero elsewhere (pdmp3.c:1684)
__device__ float short_out(const Tables& t, const float* xa, int p) {
  float acc = 0.0f;
  bool any = false;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const int q = p - 6 - 6 * w;
    if (q >= 0 && q < 12) {
      const float c = dot_tree<18>(xa, 1, t.c3 + w * 12 + q, 36) *
                      __ldg(t.win2 + q);
      acc = any ? acc + c : c;
      any = true;
    }
  }
  return acc;
}

__device__ __forceinline__ int16_t quantize(float acc) {
  // x32767, truncate toward zero, clip; NaN and values outside int32
  // become -32767 like the reference's cvttsd2si (INT32_MIN, then clip)
  const float scaled = acc * 32767.0f;
  const float tr = truncf(scaled);
  if (isnan(scaled) || tr < -2147483648.0f || tr > 2147483648.0f)
    return -32767;
  return (int16_t)fminf(fmaxf(tr, -32767.0f), 32767.0f);
}

// two resident blocks per SM: ptxas then fits 56 registers with no
// spills (73 unbounded, one block per SM); three spill
__global__ void __launch_bounds__(kThreads, 2)
fused_granule_kernel(const int16_t* __restrict__ ix,
                     const int16_t* __restrict__ scf_l,
                     const int16_t* __restrict__ scf_s,
                     const int32_t* __restrict__ meta,
                     const int32_t* __restrict__ active, int gr1,
                     int bug_compat, float* __restrict__ store,
                     float* __restrict__ v, float* __restrict__ prev,
                     uint32_t* __restrict__ pcm, Tables t) {
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
  __shared__ float s_x[2][kLines];           // spectra, subband-major
  __shared__ float s_xt[32 * 18];            // x_time of one channel [sb][i]
  __shared__ float s_blk[33 * kBlkStride];   // FIFO of one channel, oldest first
  __shared__ int16_t s_left[kLines];         // channel 0 PCM

  if (tid < kMetaWords) s_meta[tid] = meta[b * kMetaWords + tid];
  if (tid < 2 * 22) s_scfl[tid] = scf_l[b * 2 * 22 + tid];
  if (tid < 2 * 39) s_scfs[tid] = scf_s[b * 2 * 39 + tid];
  __syncthreads();
  if (gr1 && tid < 3) {
    // band-12 OOB read (docs/DESIGN.md §6): granule 1's ch1 short band-12
    // scalefactors alias the float BITS of granule 0's first three ch0
    // output lines, as uint32
    const unsigned bits = __float_as_uint(prev[b * 3 + tid]);
    s_scfs[39 + 36 + tid] = bits < 1024u ? (int)bits : 1024;
  }
  __syncthreads();

  // ---- requantize + stereo: thread = line ----
  {
    const int i = tid;
    const int lay0 = clampi(s_meta[M_LAYOUT], 0, kLayouts - 1);
    const int lay1 = clampi(s_meta[M_LAYOUT + 1], 0, kLayouts - 1);
    const int16_t* sx = ix + (size_t)b * 2 * kLines;
    float l = requantize(t, s_meta, s_scfl, s_scfs, lay0, 0, i, sx[i]);
    float r = requantize(t, s_meta, s_scfl, s_scfs, lay1, 1, i,
                         sx[kLines + i]);
    // MS below min(count1) (pdmp3.c:1920)
    const int c0 = clampi(s_meta[M_C1], 0, kLines);
    const int c1r = clampi(s_meta[M_C1 + 1], 0, kLines);
    if (s_meta[M_MS] != 0 && i < min(c0, c1r)) {
      const float c = __ldg(t.inv_sqrt2);
      const float mid = (l + r) * c, side = (l - r) * c;
      l = mid;
      r = side;
    }
    // intensity: ch0's layout and scalefactors give the positions (a
    // reference quirk; the spec uses the right channel's)
    if (s_meta[M_IS] != 0) {
      const bool short0 = line_map(t, MAP_SHORT, lay0, i) == 1;
      const int is_pos =
          short0 ? s_scfs[line_map(t, MAP_SFB_S_PLAIN, lay0, i)]
                 : s_scfl[line_map(t, MAP_SFB_L, lay0, i)];
      if (line_map(t, MAP_IOK, lay0, i) == 1 &&
          line_map(t, MAP_BAND_START, lay0, i) >= c1r && is_pos != 7) {
        if (bug_compat && short0) {
          // pdmp3.c:2212-2213 assigns trunc(l) through an unsigned int:
          // a FLOOR mod 2^32 (fmodf is exact; -0.0 stays -0.0)
          float u = fmodf(truncf(l), 4294967296.0f);
          if (u < 0.0f) u = u + 4294967296.0f;
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
    // ---- IMDCT + window + overlap-add + frequency inversion: thread =
    // (subband sb, sample ii); out36[ii] meets the store, out36[18+ii]
    // becomes the new store (pdmp3.c:1649-1700, 1738-1780) ----
    {
      const int sb = tid / 18, ii = tid % 18;
      const float* xa = &s_x[ch][sb * 18];
      int bt = s_meta[M_BT + ch];
      if (s_meta[M_WSF + ch] == 1 && s_meta[M_MIXED + ch] == 1 && sb < 2)
        bt = 0;  // the two long subbands of a mixed block
      bt = clampi(bt, 0, 3);  // a 2-bit field on the wire
      float o_lo, o_hi;
      if (bt == 2) {
        o_lo = short_out(t, xa, ii);
        o_hi = short_out(t, xa, 18 + ii);
      } else {
        o_lo = dot_tree<18>(xa, 1, t.cos36 + ii, 36) *
               __ldg(t.imdct_win + bt * 36 + ii);
        o_hi = dot_tree<18>(xa, 1, t.cos36 + 18 + ii, 36) *
               __ldg(t.imdct_win + bt * 36 + 18 + ii);
      }
      float* st = store + (((size_t)b * 2 + ch) * 32 + sb) * 18 + ii;
      const float inv = ((sb & 1) && (ii & 1)) ? -1.0f : 1.0f;
      const float xt = (o_lo + *st) * inv;
      *st = o_hi;  // in place: this thread alone reads and writes it
      s_xt[sb * 18 + ii] = xt;
      if (ch == 0 && sb == 0 && ii < 3 && gr1 == 0)
        prev[b * 3 + ii] = xt;  // granule-0 band-12 carry
    }
    float* vb = v + ((size_t)b * 2 + ch) * 15 * 64;
    for (int k = tid; k < 15 * 64; k += kThreads)
      s_blk[(k / 64) * kBlkStride + k % 64] = vb[k];
    __syncthreads();

    // ---- polyphase matrixing (pdmp3.c:2006-2014) into FIFO rows 15..32:
    // nb[it][j] = sum over subbands k of NWIN[j][k] * x_time[k][it] ----
    for (int k = tid; k < 18 * 64; k += kThreads) {
      const int j = k / 18, it = k % 18;
      s_blk[(15 + it) * kBlkStride + j] =
          dot_tree<32>(s_xt + it, 18, t.nwin + j * 32, 1);
    }
    __syncthreads();

    // ---- 16-tap D-window FIR over the 33-block FIFO, quantize, pack ----
    {
      const int it = tid / 32, k = tid % 32;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc = acc + __ldg(t.synth_d + j * 32 + k) *
                        s_blk[(15 - j + it) * kBlkStride + 32 * (j & 1) + k];
      const int16_t q = quantize(acc);
      if (ch == 0) {
        s_left[tid] = q;
      } else {
        const int16_t left = s_left[tid];
        const int16_t right = nch == 1 ? left : q;  // mono: duplicate L
        out[tid] = (uint32_t)(uint16_t)left | ((uint32_t)(uint16_t)right << 16);
      }
    }
    // the new FIFO is its newest 15 blocks, rows 18..32
    for (int k = tid; k < 15 * 64; k += kThreads)
      vb[k] = s_blk[(18 + k / 64) * kBlkStride + k % 64];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launch one granule step for B slots on `stream`; returns
// cudaGetLastError() (0 when the launch was accepted).
int pdmp3_fused_granule(const int16_t* ix, const int16_t* scf_l,
                        const int16_t* scf_s, const int32_t* meta,
                        const int32_t* active, float* store, float* v,
                        float* prev, int16_t* pcm, const float* pow43,
                        const float* cos36, const float* c3,
                        const float* imdct_win, const float* win2,
                        const float* nwin, const float* synth_d,
                        const float* cs, const float* ca,
                        const float* ratio_l, const float* ratio_r,
                        const float* quarter_down, const float* quarter_up,
                        const float* inv_sqrt2, const int16_t* maps, int B,
                        int gr1, int bug_compat, void* stream) {
  Tables t{pow43,   cos36,   c3,      imdct_win, win2,
           nwin,    synth_d, cs,      ca,        ratio_l,
           ratio_r, quarter_down, quarter_up, inv_sqrt2, maps};
  fused_granule_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      ix, scf_l, scf_s, meta, active, gr1, bug_compat, store, v, prev,
      reinterpret_cast<uint32_t*>(pcm), t);
  return (int)cudaGetLastError();
}

const char* pdmp3_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
