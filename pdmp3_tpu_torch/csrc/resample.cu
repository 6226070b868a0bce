// One block of the streaming polyphase resampler for NVIDIA Hopper
// (sm_90a): K8, int16 or f32 PCM in, int16 or f32 out.
//
// Replaces the XLA stage pdmp3_tpu/ops/resample.py:_resample_block (a
// window gather and an einsum; the JAX package has no Pallas kernel for
// it) and the carry update of its StreamResampler.__call__.  Plain
// PyTorch twin: pdmp3_tpu_torch/ops/resample.py:resample_block_ref.
//
// x is the stream's carry f32 [taps - 1][C] followed by its block
// [N][C]; output j reads the window at m_j with phase p_j, (m_j, p_j) =
// divmod(phase + j * down, up), and is y[j][c] = sum over t of x[m_j +
// t][c] * H[p_j][t], each product rounded and the sum taken from t = 0,
// as the plain version sums it.  int16 output is rounded half to even
// (torch.round), clamped to [-32768, 32767] and cast (NaN casts to 0,
// as on the card's PyTorch); f32 output is the sum.  The new carry is
// the last taps - 1 samples of x as f32, part of the old carry when
// N < taps - 1.
//
// What bounds it.  Per step the block is read once and the output
// written once, the carry read and written: 44.1 -> 48 kHz at B = 8192,
// N = 1152, C = 2, int16 in and out: 82 MB, 0.024 ms at 3.35 TB/s; 0.99
// GFLOP, and built with -fmad=false each product and sum is its own f32
// instruction: 0.030 ms of issue on 132 SMs x 128 lanes x 1.98 GHz.
// Reading every tap of every output from shared memory (a coefficient
// and two samples a tap, 72 loads an output) would cost about 0.09 ms of
// shared-memory wavefronts alone, so:
// - Window starts, not outputs.  The outputs that start at window
//   position m are j*(m) + r, r < f or f + 1 (f = floor(up / down)),
//   with phases phi(m) + r * down, phi(m) in [0, down); the next
//   position's j* and phi follow by an add and a compare.  A thread
//   takes kRsRun = 4 consecutive positions and every output that starts
//   there: it loads the union of their windows (kRsRun + taps - 1
//   samples a channel) into registers once, and every output reads it
//   at offsets fixed at compile time.  Each output's taps come as
//   float4s from the bank laid out [up][hstride] (taps contiguous, the
//   row stride an odd number of float4s).
// - Classes.  phi repeats every `down` positions, so the runs are laid
//   out period by period (L = a multiple of down, at least kRsRun): run
//   (c, k) starts at P0 + k L + c kRsRun, and lanes take k fastest, so a
//   warp's lanes share a few classes c: the same phases (their
//   coefficient loads are near broadcasts) and the same pattern of extra
//   outputs (rank f), which diverges only between those classes.  One
//   divmod per class and chunk (a table in shared memory); none per
//   output.
// - Staging.  Where a stream's block is 16-byte aligned in address and
//   size and its window fits one chunk (a serving block does), a
//   two-stage ring brings stream n + G's block into shared memory by
//   cp.async.bulk on an mbarrier while stream n computes; each sample is
//   converted to f32 once, from shared memory, into the window (carry by
//   plain loads, then the block).  Otherwise (short or unaligned blocks,
//   strided views, blocks whose window is split into chunks of at most
//   K8_WINDOW samples) the window is staged by plain loads in the
//   kernel.
// 320 threads a block, so a serving stream's 37 x 8 runs take one round;
// two blocks per SM (93 registers).  The stream's new carry goes to a
// fresh buffer (other units may still read the old one): from the staged
// window when the stream is one chunk, else from device memory by the
// first chunk's unit.  The block needs only its channels contiguous (a
// [B][N][C] view with any stream stride); C is 1 or 2.  Built with
// -fmad=false: no product is contracted into the sum.  Earlier designs
// and their times: PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_persist.cuh"

namespace {

constexpr int kRsThreads = 320;  // threads of a block
constexpr int kRsRun = 4;        // window positions a thread takes at once
constexpr int kRsTaps = 24;      // the taps of the register-window instances

// the positions after which the phases repeat: a multiple of down, at
// least kRsRun (ops/resample.py k8_period)
__host__ __device__ __forceinline__ int rs_period(int down) {
  return down >= kRsRun ? down : down * ((kRsRun + down - 1) / down);
}

__host__ __device__ __forceinline__ int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// K8's shared memory, byte offsets (ops/resample.py k8_geometry): the
// bank f32 [up][hstride], the class table int32 [classes][2] (j*, phi),
// the two stages of the raw block (bulk path), the window f32 [win][C],
// the stages' two mbarriers
struct RsSmem {
  int h, cls, stage, stage_bytes, x, bar, total;
  __host__ __device__ RsSmem(int up, int hstride, int classes, int bulk,
                             int block_bytes, int win, int C) {
    h = 0;
    cls = h + 4 * up * hstride;
    stage = align_up(cls + 8 * classes, 16);
    stage_bytes = bulk ? align_up(block_bytes, 16) : 0;
    x = stage + 2 * stage_bytes;
    bar = align_up(x + 4 * C * win, 8);
    total = bar + 16;
  }
};

// sample n of the window x = carry (K rows) then the block, channel c
template <int kC, typename TIn>
__device__ __forceinline__ float rs_sample(const float* cb, const TIn* xb,
                                           int K, int n, int c) {
  return n < K ? cb[n * kC + c] : (float)xb[(n - K) * kC + c];
}

// torch.round (half to even), the clamp and the cast, NaN to 0, in one
// conversion: round to nearest even, saturate to int16 (NaN gives 0)
__device__ __forceinline__ int16_t rs_pcm16(float y) {
  short r;
  asm("cvt.rni.sat.s16.f32 %0, %1;" : "=h"(r) : "f"(y));
  return r;
}

template <int kC>
__device__ __forceinline__ void rs_store(int16_t* o, const float (&y)[kC]) {
  if constexpr (kC == 2) {
    *reinterpret_cast<uint32_t*>(o) =
        (uint16_t)rs_pcm16(y[0]) | ((uint32_t)(uint16_t)rs_pcm16(y[1]) << 16);
  } else {
    *o = rs_pcm16(y[0]);
  }
}

template <int kC>
__device__ __forceinline__ void rs_store(float* o, const float (&y)[kC]) {
  if constexpr (kC == 2)
    *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
  else
    *o = y[0];
}

__device__ __forceinline__ float h_at(const float4& h, int e) {
  return e == 0 ? h.x : e == 1 ? h.y : e == 2 ? h.z : h.w;
}

// ceil(a / b) for b > 0
__device__ __forceinline__ long long ceil_div(long long a, long long b) {
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

// Per unit (stream b, chunk q of its window positions [P0, P1)): the
// stream's new carry is written from the staged window (one chunk) or by
// the first chunk's unit from device memory; the window [W0, W1)
// of x is staged as f32 [n - W0][C] (the whole x for one chunk), each
// sample converted once; the class table of the chunk is built; then the
// runs (c, k), k fastest, each thread kRsRun positions at a time.
// kTaps: the taps at compile time (the window in registers), or 0 (any
// taps, the window read from shared memory).
template <typename TIn, typename TOut, int kC, int kTaps>
__global__ void __launch_bounds__(kRsThreads, 2)
resample_kernel(const float* __restrict__ carry, const TIn* __restrict__ in,
                long long in_stride, const float* __restrict__ H,
                float* __restrict__ new_carry, TOut* __restrict__ out, int B,
                int N, int taps, int up, int down, int phase, int n_out,
                int p_first, int p_end, int p_chunk, int chunks, int hstride,
                int win, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int K = taps - 1;
  const int L = rs_period(down);
  const int classes = (L + kRsRun - 1) / kRsRun;
  const int f = up / down;
  const int j_step = L / down * up;  // outputs a period of L positions
  const int block_bytes = N * kC * (int)sizeof(TIn);
  const RsSmem lay(up, hstride, classes, bulk, block_bytes, win, kC);
  float* s_h = reinterpret_cast<float*>(smem + lay.h);
  int* s_cls = reinterpret_cast<int*>(smem + lay.cls);
  float* s_x = reinterpret_cast<float*>(smem + lay.x);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const int units = B * chunks;
  const int G = gridDim.x;

  for (int i = tid; i < up * hstride; i += kRsThreads) {
    const int p = i / hstride, t = i - p * hstride;
    s_h[i] = t < taps ? __ldg(H + p * taps + t) : 0.0f;
  }
  if (bulk && tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // stream `unit`'s block into stage s (thread 0, bulk path)
  const auto produce = [&](int s, int unit) {
    mbar_expect_tx(bar + s, block_bytes);
    bulk_load(smem + lay.stage + s * lay.stage_bytes,
              in + (size_t)unit * in_stride, block_bytes, bar + s);
  };
  int u = blockIdx.x;  // the launch keeps gridDim.x <= units
  if (bulk && tid == 0) produce(0, u);
  int cls_q = -1;  // the chunk whose class table is in s_cls
  // bulk path: carry value tid of the next unit (stream), loaded a unit
  // early, so its latency is off the unit's path (a carry of more than
  // kRsThreads values is read in place past that)
  const int kcc = K * kC;
  float cn0 = 0.0f;
  if (bulk && tid < kcc) cn0 = carry[(size_t)u * kcc + tid];

  for (int n = 0; u < units; ++n, u += G) {
    const int b = u / chunks, q = u - b * chunks;
    const int P0 = p_first + q * p_chunk;
    const int P1 = min(P0 + p_chunk, p_end);
    const int W0 = chunks == 1 ? 0 : P0;
    const int W1 = chunks == 1 ? K + N : min(P1 + K, K + N);
    const float* cb = carry + (size_t)b * K * kC;
    const TIn* xb = in + (size_t)b * in_stride;
    if (q == 0 && chunks > 1)
      for (int i = tid; i < K; i += kRsThreads)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          new_carry[((size_t)b * K + i) * kC + c] =
              rs_sample<kC>(cb, xb, K, N + i, c);
    if (q != cls_q) {
      for (int c = tid; c < classes; c += kRsThreads) {
        const long long m = (long long)P0 + (long long)c * kRsRun;
        const long long j = ceil_div(m * up - phase, down);
        s_cls[2 * c] = (int)j;
        s_cls[2 * c + 1] = (int)(phase + j * down - m * up);
      }
      cls_q = q;
    }
    if (bulk) {
      const int s = n & 1;
      mbar_wait(bar + s, (n >> 1) & 1);
      // stage s ^ 1 was converted in the last iteration, before its
      // barriers
      if (tid == 0 && u + G < units) produce(s ^ 1, u + G);
      const TIn* st =
          reinterpret_cast<const TIn*>(smem + lay.stage + s * lay.stage_bytes);
      if (tid < kcc) s_x[tid] = cn0;
      for (int i = tid + kRsThreads; i < kcc; i += kRsThreads)
        s_x[i] = cb[i];
      if (u + G < units && tid < kcc)
        cn0 = carry[(size_t)(u + G) * kcc + tid];
      for (int i = tid; i < N * kC; i += kRsThreads)
        s_x[kcc + i] = (float)st[i];
    } else {
      for (int i = W0 + tid; i < W1; i += kRsThreads)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          s_x[(i - W0) * kC + c] = rs_sample<kC>(cb, xb, K, i, c);
    }
    __syncthreads();  // the window and the class table are in
    if (chunks == 1)  // the window is the whole x: the new carry from it
      for (int i = tid; i < kcc; i += kRsThreads)
        new_carry[(size_t)b * kcc + i] = s_x[N * kC + i];

    const int periods = P1 > P0 ? (P1 - P0 + L - 1) / L : 0;
    const int last = W1 - W0 - 1;
    for (int t = tid; t < classes * periods; t += kRsThreads) {
      const int c = t / periods, k = t - c * periods;
      const int m0 = P0 + k * L + c * kRsRun;
      int j = s_cls[2 * c] + k * j_step;
      int phi = s_cls[2 * c + 1];
      const float* xw = s_x + (size_t)(m0 - W0) * kC;
      // the bank's row stride, fixed at compile time with the taps (a
      // register fewer in the hot loop)
      const int hs = kTaps > 0 ? (kTaps / 4 % 2 ? kTaps : kTaps + 4) : hstride;
      // the union of the run's windows (kTaps > 0), clamped to the
      // staged window: positions past it compute nothing
      float u_[kTaps > 0 ? kRsRun + kTaps - 1 : 1][kC];
      if constexpr (kTaps > 0) {
#pragma unroll
        for (int s = 0; s < kRsRun + kTaps - 1; ++s) {
          const int idx = min(m0 - W0 + s, last) * kC;
          if constexpr (kC == 2) {
            const float2 v2 = *reinterpret_cast<const float2*>(s_x + idx);
            u_[s][0] = v2.x;
            u_[s][1] = v2.y;
          } else {
            u_[s][0] = s_x[idx];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRsRun; ++i) {
        const bool pos_ok = c * kRsRun + i < L && m0 + i < P1;
        const int cnt = f + (phi + f * down < up);
        for (int r = 0; r < cnt; ++r) {
          const int jj = j + r;
          if (!pos_ok || jj < 0 || jj >= n_out) continue;
          const float* hp = s_h + (phi + r * down) * hs;
          float acc[kC];
          if constexpr (kTaps > 0) {
#pragma unroll
            for (int t4 = 0; t4 < kTaps / 4; ++t4) {
              const float4 h = *reinterpret_cast<const float4*>(hp + 4 * t4);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int tt = 4 * t4 + e;
#pragma unroll
                for (int ch = 0; ch < kC; ++ch) {
                  const float prod = u_[i + tt][ch] * h_at(h, e);
                  acc[ch] = tt == 0 ? prod : acc[ch] + prod;
                }
              }
            }
          } else {
#pragma unroll
            for (int ch = 0; ch < kC; ++ch) acc[ch] = xw[i * kC + ch] * hp[0];
            for (int tt = 1; tt < taps; ++tt) {
              const float h = hp[tt];
#pragma unroll
              for (int ch = 0; ch < kC; ++ch)
                acc[ch] = acc[ch] + xw[(i + tt) * kC + ch] * h;
            }
          }
          rs_store<kC>(out + ((size_t)b * n_out + jj) * kC, acc);
        }
        j += cnt;
        phi += cnt * down - up;
      }
    }
    __syncthreads();  // the window and the stage may be written again
  }
}

template <typename TIn, typename TOut, int kC, int kTaps>
int launch(const float* carry, const void* in, long long in_stride,
           const float* H, float* new_carry, void* out, int B, int N,
           int taps, int up, int down, int phase, int n_out, int p_first,
           int p_end, int p_chunk, int chunks, int hstride, int win,
           int bulk, int smem, cudaStream_t stream) {
  const auto kernel = resample_kernel<TIn, TOut, kC, kTaps>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kRsThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int units = B * chunks;
  const int grid = units < sms * per_sm ? units : sms * per_sm;
  kernel<<<grid, kRsThreads, smem, stream>>>(
      carry, static_cast<const TIn*>(in), in_stride, H, new_carry,
      static_cast<TOut*>(out), B, N, taps, up, down, phase, n_out, p_first,
      p_end, p_chunk, chunks, hstride, win, bulk);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_c(int C, const float* carry, const void* in, long long in_stride,
             const float* H, float* new_carry, void* out, int B, int N,
             int taps, int up, int down, int phase, int n_out, int p_first,
             int p_end, int p_chunk, int chunks, int hstride, int win,
             int bulk, int smem, cudaStream_t stream) {
#define PDMP3_RS_LAUNCH(kC, kTaps)                                          \
  return launch<TIn, TOut, kC, kTaps>(                                      \
      carry, in, in_stride, H, new_carry, out, B, N, taps, up, down, phase, \
      n_out, p_first, p_end, p_chunk, chunks, hstride, win, bulk, smem,     \
      stream)
  if (C == 1 && taps == kRsTaps) PDMP3_RS_LAUNCH(1, kRsTaps);
  if (C == 1) PDMP3_RS_LAUNCH(1, 0);
  if (C == 2 && taps == kRsTaps) PDMP3_RS_LAUNCH(2, kRsTaps);
  if (C == 2) PDMP3_RS_LAUNCH(2, 0);
#undef PDMP3_RS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Resample one block of B streams on `stream`: carry f32 [B][taps - 1][C]
// (C = 1 or 2); in int16 (in_f32 = 0) or f32 [B][N][C], stream b at in +
// b * in_stride elements, its N x C samples contiguous; H f32 [up][taps];
// new_carry f32 [B][taps - 1][C], not aliasing carry; out int16 (out_f32
// = 0) or f32 [B][n_out][C]; phase: the running phase in 1/up input
// samples, with phase + n_out * down < 2^31.  The geometry is
// ops/resample.py k8_geometry's: the window positions [p_first, p_end)
// of the outputs, in chunks of p_chunk positions, `chunks` of them; the
// bank's row stride hstride; the staged window's capacity win samples;
// bulk: stage each block by bulk copy (one chunk, the block 16-byte
// aligned in address and size); smem: the dynamic shared memory, bytes.
// Returns cudaGetLastError()'s code, or an attribute query's (0 when the
// launch was accepted).
int pdmp3_resample(const float* carry, const void* in, long long in_stride,
                   int in_f32, const float* H, float* new_carry, void* out,
                   int out_f32, int B, int N, int C, int taps, int up,
                   int down, int phase, int n_out, int p_first, int p_end,
                   int p_chunk, int chunks, int hstride, int win, int bulk,
                   int smem, void* stream) {
  auto* s = (cudaStream_t)stream;
  const int es = in_f32 ? 4 : 2;
  if (RsSmem(up, hstride, (rs_period(down) + kRsRun - 1) / kRsRun, bulk,
             N * C * es, win, C)
          .total != smem)
    return (int)cudaErrorInvalidValue;
#define PDMP3_RS_ARGS                                                       \
  C, carry, in, in_stride, H, new_carry, out, B, N, taps, up, down, phase, \
      n_out, p_first, p_end, p_chunk, chunks, hstride, win, bulk, smem, s
  if (in_f32 && out_f32) return launch_c<float, float>(PDMP3_RS_ARGS);
  if (in_f32) return launch_c<float, int16_t>(PDMP3_RS_ARGS);
  if (out_f32) return launch_c<int16_t, float>(PDMP3_RS_ARGS);
  return launch_c<int16_t, int16_t>(PDMP3_RS_ARGS);
#undef PDMP3_RS_ARGS
}

}  // extern "C"
