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
// 256 B) out; 2 x S x 64 dots of 32 terms and 2 x S x 32 FIR sums of 16:
// at S = 36 about 29 KB and 0.36 MFLOP a slot, ~12 FLOP per byte, so
// bytes set the bound (Layer II S16 at B = 8192: 239 MB, 0.071 ms at
// 3.35 TB/s).  The design is the granule body's (granule_persist.cuh):
// min(B, SM count x blocks per SM) persistent blocks walk the slots; a
// two-stage ring brings slot n + G's sb and v rows into shared memory by
// cp.async.bulk on an mbarrier while slot n computes; the nwin_t and
// synth_d sections of the table image (10,240 B) sit in shared memory
// once per block; the matrixing computes four FIFO columns of one row
// to a thread (dot4, sequential in exact mode, the pairwise tree in fast
// mode: dsp._dot_seq / _dot_tree); the FIR gives a thread three time
// steps of one column, which share 14 of their 16 taps; the new FIFO
// rows and the PCM row go back by bulk stores.  32 x S / 3 threads a
// block (128 / 384), so the matrixing takes three rounds and the FIR two
// with every thread busy; two barriers a slot.  Shared memory 39,472 B
// (Layer I) / 67,120 B (Layer II), float PCM 41,008 / 71,728 B: five or
// three blocks per SM.  The bulk copies need 16-byte aligned sb, v and
// PCM (ops/l12_synth.py checks them); nch and active are read where they
// lie, int16 or int32 with an element stride (the pool's wire holds nch
// as a strided int16 view).  Built with -fmad=false and without
// flush-to-zero, so every product and sum rounds where the plain version
// rounds, in its order: the kernel equals it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_persist.cuh"

namespace {

using namespace pdmp3;

// K7's shared memory, byte offsets: the nwin_t and synth_d sections of
// the table image, a two-stage ring of one slot's sb and FIFO rows (both
// bulk-copied) and its flags, the new FIFO rows f32 [2][S][64], the PCM
// row and the stages' two mbarriers
template <int S, bool kFloat>
struct L12Smem {
  static constexpr int kThreads = 32 * S / 3;
  static constexpr int kSbBytes = 2 * S * 32 * 4;
  static constexpr int kVBytes = 2 * 15 * 64 * 4;
  static constexpr int kSSb = 0;
  static constexpr int kSV = kSbBytes;
  static constexpr int kSFlags = kSV + kVBytes;  // int32 active, nch
  static constexpr int kStage = kSFlags + 16;
  static constexpr int kTabFloats = kTFloats - kTNwinT;
  static constexpr int kOTab = 0;
  static constexpr int kOStage = kOTab + kTabFloats * 4;
  static constexpr int kONb = kOStage + 2 * kStage;
  static constexpr int kOPcm = kONb + 2 * S * 64 * 4;
  static constexpr int kOBar = kOPcm + S * 32 * (kFloat ? 8 : 4);
  static constexpr int kSmemBytes = kOBar + 16;
  static_assert(S % 6 == 0, "the FIR's time groups span six steps");
  static_assert(kTNwinT % 4 == 0 && kOStage % 16 == 0 && kStage % 16 == 0 &&
                    kSV % 16 == 0 && kONb % 16 == 0 && kOPcm % 16 == 0 &&
                    kOBar % 8 == 0,
                "bulk copies need 16-byte aligned shared addresses");
};

// element i of an int16 (es 2) or int32 (es 4) vector with an element
// stride
__device__ __forceinline__ int load_int(const void* p, int es,
                                        long long stride, int i) {
  const long long k = (long long)i * stride;
  return es == 2 ? (int)__ldg(static_cast<const int16_t*>(p) + k)
                 : __ldg(static_cast<const int32_t*>(p) + k);
}

// the 16-tap D-window FIR of one channel over its (15 + S)-row window (15
// carried rows vold, the new rows vnew): the sums of time steps it0,
// it0 + 2 and it0 + 4 of column kc, each summed from tap 0 onto +0.0, as
// dsp.subband_synthesis sums them; synd: synth_d [16][32].  The same
// order as fir3 (K4), with the table apart from the image's offsets
__device__ __forceinline__ void l12_fir3(const float* synd, const float* vold,
                                         const float* vnew, int it0, int kc,
                                         float (&acc)[3]) {
  // e[q] = window row it0 + q, half 32 * (j & 1) of the taps j that read
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
    const float d = synd[j * 32 + kc];
#pragma unroll
    for (int o = 0; o < 3; ++o) acc[o] = acc[o] + d * e[15 - j + 2 * o];
  }
}

// Per slot b = blockIdx.x + k * gridDim.x: wait for its stage; thread 0
// starts the next slot's copies and sends the previous slot's PCM row;
// matrixing (task = row c * S + s, four columns 4jg..; a warp is 16
// column groups of two rows, so each coefficient load serves two
// threads); the new FIFO rows go back; FIR (task = channel, time group,
// column: a warp is the 32 columns of one group) into the PCM row.
template <bool kExact, bool kFloat, int S>
__global__ void __launch_bounds__(L12Smem<S, kFloat>::kThreads,
                                  S == 36 ? 3 : 5)
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
  float* s_nwin = reinterpret_cast<float*>(smem + L::kOTab);  // [32][64]
  const float* s_synd = s_nwin + (kTSynD - kTNwinT);          // [16][32]
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

  for (int k = tid; k < L::kTabFloats / 4; k += kT)
    reinterpret_cast<float4*>(s_nwin)[k] = __ldg(image + kTNwinT / 4 + k);
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
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int task = lt + r * kT;  // < 2 * S * 16
      const int jg = task & 15, row = task >> 4;
      const float* x = s_sb + row * 32;
      const float4 o = dot4<kExact, 32>([&](int k) { return x[k]; },
                                        s_nwin + 4 * jg, 64);
      *reinterpret_cast<float4*>(s_nb + row * 64 + 4 * jg) = o;
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

    // ---- FIR and the pack: thread = (channel, time steps it0, it0 + 2,
    // it0 + 4, column kc)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int task = lt + r * kT;  // < 2 * (S / 3) * 32
      const int kc = task & 31, grp = (task >> 5) % (S / 3);
      const int fch = (task >> 5) / (S / 3);
      const int it0 = (grp & 1) + 6 * (grp >> 1);
      float acc[3];
      l12_fir3(s_synd, s_v + fch * 15 * 64, s_nb + fch * S * 64, it0, kc,
               acc);
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const int idx = (it0 + 2 * o) * 32 + kc;
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
// (ops/consts.py granule_smem_image) on the device.  Returns the
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
