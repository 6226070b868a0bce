// Back half of an MPEG-1 Layer III granule step for NVIDIA Hopper
// (sm_90a): K4, in fast and exact precision.
//
// Replaces the TPU kernel pdmp3_tpu/ops/pallas_step.py:_kernel (launched
// by back_half_t; body _back_ch), and computes the band-12 carry that the
// JAX package recomputes beside it (_prev3).  Plain PyTorch twin:
// pdmp3_tpu_torch/ops/back_half.py:back_half_step_ref.
//
// From post-antialias spectra xa [B][2][32][18]: IMDCT, window,
// overlap-add, frequency inversion, polyphase matrixing and the D-window
// FIR, with the device code of the fused kernels (granule.cuh
// back_half_channel), so the fast form equals K1's back half bit for bit
// and the exact form K2's.  Out [B][2][576]: the raw FIR sums in exact
// mode (the caller quantizes through float64), the quantized samples as
// floats in fast mode; zeros for idle slots.  prev3 [B][3]: x_time[0:3]
// of (ch0, subband 0) for every slot, idle ones included.
//
// One 576-thread block per slot; state updated in place for active slots
// only.  What bounds it: per slot and granule about 33 KB of device
// memory (xa 4,608 B in, store and v read and written, out 4,608 B) for
// the same ~0.3 MFLOP as the fused kernel, so it is bound by the state
// and spectra round trip, and pays the xa / out traffic the fused kernel
// avoids.  Built with -fmad=false and without flush-to-zero, like the
// fused kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule.cuh"

namespace {

using namespace pdmp3;

// resident blocks per SM, the fastest of 1, 2 and 3 by measurement
// (PERF.md, "Launch bounds"): exact fits 32 registers with no spills at
// 3 blocks; fast spills at 3 and, as K1, runs fastest at 2
template <bool kExact>
__global__ void __launch_bounds__(kThreads, kExact ? 3 : 2)
back_half_kernel(const float* __restrict__ xa,
                 const int32_t* __restrict__ bt_eff,
                 const int32_t* __restrict__ active,
                 float* __restrict__ store, float* __restrict__ v,
                 float* __restrict__ out, float* __restrict__ prev3,
                 Tables t) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // idle slots run the same arithmetic for their prev3, and leave their
  // state untouched and their output zero
  const bool act = active[b] != 0;

  __shared__ float s_x[kLines];              // one channel's spectrum
  __shared__ float s_xt[32 * 18];            // x_time of one channel [sb][i]
  __shared__ float s_blk[33 * kBlkStride];   // FIFO of one channel

  for (int ch = 0; ch < 2; ++ch) {
    const size_t sc = (size_t)b * 2 + ch;
    s_x[tid] = xa[sc * kLines + tid];
    __syncthreads();
    const int bt = clampi(bt_eff[sc * 32 + tid / 18], 0, 3);
    const float acc = back_half_channel<kExact>(
        t, s_x, bt, store + sc * 32 * 18, v + sc * 15 * 64, act,
        ch == 0 ? prev3 + b * 3 : nullptr, s_xt, s_blk);
    out[sc * kLines + tid] =
        act ? (kExact ? acc : quantize_fast(acc)) : 0.0f;
  }
}

}  // namespace

extern "C" {

// Launch the back half for B slots on `stream`; tables: the device
// pointers of fused_step.TABLES.  Returns cudaGetLastError().
int pdmp3_back_half(const float* xa, const int32_t* bt_eff,
                    const int32_t* active, float* store, float* v,
                    float* out, float* prev3, const void* const* tables,
                    int B, int exact, void* stream) {
  const Tables t = make_tables(tables);
  auto* s = (cudaStream_t)stream;
  if (exact)
    back_half_kernel<true><<<B, kThreads, 0, s>>>(xa, bt_eff, active, store,
                                                   v, out, prev3, t);
  else
    back_half_kernel<false><<<B, kThreads, 0, s>>>(xa, bt_eff, active,
                                                    store, v, out, prev3, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
