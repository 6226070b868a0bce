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
// N = 1152, C = 2, int16 in and out: 82 MB, 0.024 ms at 3.35 TB/s, and
// 0.99 GFLOP (0.015 ms at 67 TFLOP/s f32), so bytes.  The plain version
// concatenates the carry and the block (a 75 MB f32 copy), uploads two
// index vectors and makes 24 gather and multiply-add passes over the
// batch.  Here the window is read where it lies (carry or block, no
// copy) and the indices come from the host's integer phase.  Persistent
// blocks (SM count x 4) walk (stream, chunk of outputs) units, a chunk
// being all of a stream's outputs when its input window fits 4,096
// samples a channel (a serving block does); a unit stages that window
// into shared memory as f32, channel-major, each sample read and
// converted once, and each thread then computes the outputs tid, tid +
// 256, ... of the chunk, both channels at each tap (one coefficient load
// for two products); the outputs' windows overlap, so consecutive
// threads read consecutive words.  The filter bank sits in shared memory
// once per block, transposed to [taps][up]: at 44.1 -> 48 kHz (up = 160
// = 5 x 32, down = 147) the 32 phases a warp reads at one tap fall in 32
// distinct banks.  The first chunk's unit writes the stream's new carry
// into a fresh buffer (other units may still read the old one).  The
// block needs only its channels contiguous (a [B][N][C] view with any
// stream stride); C is 1 or 2.  Built with -fmad=false: no product is
// contracted into the sum.  Earlier designs (PERF.md): every tap read
// from device memory through a carry-or-block branch with 64-bit index
// arithmetic, 0.61 ms; a window staged per 256-output tile, 0.31 ms;
// both on an H100 80GB HBM3 at 700 W, bound by their instructions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRsThreads = 256;    // threads of a block
constexpr int kRsBlocksPerSm = 4;  // persistent blocks per SM

// sample n of the window x = carry (K rows) then the block, channel c
template <int kC, typename TIn>
__device__ __forceinline__ float rs_sample(const float* cb, const TIn* xb,
                                           int K, int n, int c) {
  return n < K ? cb[n * kC + c] : (float)xb[(n - K) * kC + c];
}

// torch.round (half to even), the clamp and the cast; NaN casts to 0
__device__ __forceinline__ int16_t rs_pcm16(float y) {
  return isnan(y) ? (int16_t)0
                  : (int16_t)fminf(fmaxf(rintf(y), -32768.0f), 32767.0f);
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

// Per unit (stream b, chunk of outputs j0..j1): the first chunk's unit
// writes the stream's new carry; the block stages the chunk's input
// window as f32 in shared memory, channel-major [kC][len] (len = the
// last window start - the first + taps), each sample read and converted
// once; then each thread takes outputs j0 + tid, j0 + tid + 256, ...,
// every channel at each tap.
template <typename TIn, typename TOut, int kC>
__global__ void __launch_bounds__(kRsThreads, kRsBlocksPerSm)
resample_kernel(const float* __restrict__ carry, const TIn* __restrict__ in,
                long long in_stride, const float* __restrict__ H,
                float* __restrict__ new_carry, TOut* __restrict__ out, int B,
                int N, int taps, int up, int down, int phase, int n_out,
                int chunk, int chunks) {
  extern __shared__ float smem[];
  float* s_h = smem;              // the bank transposed, [taps][up]
  float* s_x = smem + up * taps;  // the chunk's window, [kC][len]
  const int tid = threadIdx.x;
  for (int i = tid; i < up * taps; i += kRsThreads)
    s_h[(i % taps) * up + i / taps] = __ldg(H + i);
  const int K = taps - 1;
  for (int u = blockIdx.x; u < B * chunks; u += gridDim.x) {
    const int b = u / chunks, j0 = (u - b * chunks) * chunk;
    const float* cb = carry + (size_t)b * K * kC;
    const TIn* xb = in + (size_t)b * in_stride;
    if (j0 == 0)
      for (int i = tid; i < K; i += kRsThreads)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          new_carry[((size_t)b * K + i) * kC + c] =
              rs_sample<kC>(cb, xb, K, N + i, c);
    const int j1 = min(j0 + chunk, n_out) - 1;
    const int m0 = (phase + j0 * down) / up;
    const int len = j1 >= j0 ? (phase + j1 * down) / up - m0 + taps : 0;
    __syncthreads();  // the bank is in; the last unit's window is read
    for (int n = tid; n < len; n += kRsThreads)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        s_x[c * len + n] = rs_sample<kC>(cb, xb, K, m0 + n, c);
    __syncthreads();
    for (int j = j0 + tid; j <= j1; j += kRsThreads) {
      const int pos = phase + j * down;
      const float* xw = s_x + (pos / up - m0);
      const float* hp = s_h + pos % up;
      float acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = xw[c * len] * hp[0];
#pragma unroll 8
      for (int t = 1; t < taps; ++t) {
        const float h = hp[t * up];
#pragma unroll
        for (int c = 0; c < kC; ++c)
          acc[c] = acc[c] + xw[c * len + t] * h;
      }
      rs_store<kC>(out + ((size_t)b * n_out + j) * kC, acc);
    }
  }
}

template <typename TIn, typename TOut, int kC>
int launch(const float* carry, const void* in, long long in_stride,
           const float* H, float* new_carry, void* out, int B, int N,
           int taps, int up, int down, int phase, int n_out, int chunk,
           int chunks, int smem, cudaStream_t stream) {
  const auto kernel = resample_kernel<TIn, TOut, kC>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int units = B * chunks;
  const int grid = units < sms * kRsBlocksPerSm ? units : sms * kRsBlocksPerSm;
  kernel<<<grid, kRsThreads, smem, stream>>>(
      carry, static_cast<const TIn*>(in), in_stride, H, new_carry,
      static_cast<TOut*>(out), B, N, taps, up, down, phase, n_out, chunk,
      chunks);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_c(int C, const float* carry, const void* in, long long in_stride,
             const float* H, float* new_carry, void* out, int B, int N,
             int taps, int up, int down, int phase, int n_out, int chunk,
             int chunks, int smem, cudaStream_t stream) {
  if (C == 1)
    return launch<TIn, TOut, 1>(carry, in, in_stride, H, new_carry, out, B,
                                N, taps, up, down, phase, n_out, chunk,
                                chunks, smem, stream);
  if (C == 2)
    return launch<TIn, TOut, 2>(carry, in, in_stride, H, new_carry, out, B,
                                N, taps, up, down, phase, n_out, chunk,
                                chunks, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Resample one block of B streams on `stream`: carry f32 [B][taps - 1][C]
// (C = 1 or 2); in int16 (in_f32 = 0) or f32 [B][N][C], stream b at in +
// b * in_stride elements, its N x C samples contiguous; H f32 [up][taps];
// new_carry f32 [B][taps - 1][C], not aliasing carry; out int16 (out_f32
// = 0) or f32 [B][n_out][C]; phase: the running phase in 1/up input
// samples, with phase + n_out * down < 2^31; the outputs of a stream in
// chunks of `chunk` outputs, `chunks` of them; smem: the dynamic shared
// memory, bytes (ops/resample.py k8_geometry).  Returns
// cudaGetLastError()'s code, or an attribute query's (0 when the launch
// was accepted).
int pdmp3_resample(const float* carry, const void* in, long long in_stride,
                   int in_f32, const float* H, float* new_carry, void* out,
                   int out_f32, int B, int N, int C, int taps, int up,
                   int down, int phase, int n_out, int chunk, int chunks,
                   int smem, void* stream) {
  auto* s = (cudaStream_t)stream;
  if (in_f32 && out_f32)
    return launch_c<float, float>(C, carry, in, in_stride, H, new_carry, out,
                                  B, N, taps, up, down, phase, n_out, chunk,
                                  chunks, smem, s);
  if (in_f32)
    return launch_c<float, int16_t>(C, carry, in, in_stride, H, new_carry,
                                    out, B, N, taps, up, down, phase, n_out,
                                    chunk, chunks, smem, s);
  if (out_f32)
    return launch_c<int16_t, float>(C, carry, in, in_stride, H, new_carry,
                                    out, B, N, taps, up, down, phase, n_out,
                                    chunk, chunks, smem, s);
  return launch_c<int16_t, int16_t>(C, carry, in, in_stride, H, new_carry,
                                    out, B, N, taps, up, down, phase, n_out,
                                    chunk, chunks, smem, s);
}

}  // extern "C"
