// Back half of a Layer III granule step for NVIDIA Hopper (sm_90a): K4,
// in fast and exact precision, with quantized or raw output.
//
// Replaces the TPU kernel pdmp3_tpu/ops/pallas_step.py:_kernel (launched
// by back_half_t; body _back_ch), and computes the band-12 carry that the
// JAX package recomputes beside it (_prev3).  Plain PyTorch twin:
// pdmp3_tpu_torch/ops/back_half.py:back_half_step_ref.
//
// From post-antialias spectra xa [B][2][32][18] and the effective block
// types bt_eff [B][2][32]: IMDCT, window, overlap-add, frequency
// inversion, polyphase matrixing and the D-window FIR, with the stages of
// the granule body (granule_persist.cuh: imdct4, matrix4, fir3), so the
// fast form equals K1's back half bit for bit and the exact form K2's.
// Out [B][2][576]: the raw FIR sums in exact mode (the caller quantizes
// through float64) and in fast mode with raw (the float-PCM route packs
// them as floats), else the quantized samples as floats; zeros for idle
// slots.  prev3 [B][3]: x_time[0:3] of (ch0, subband 0) for
// every slot, idle ones included.  State is updated in place for active
// slots only.
//
// What bounds it.  Per slot about 34 KB of device memory: xa 4,608 B and
// bt_eff 256 B in, store 4,608 B and v 7,680 B read and written, out
// 4,608 B; about 0.3 MFLOP, ~9 FLOP per byte, so bytes set the bound
// (0.0833 ms at B = 8192).  The former design (one 576-thread block per
// slot, the channels one after the other, six barriers a slot, every
// table operand an __ldg inside the dot) ran at 15% of that bound on an
// H100 80GB HBM3 at 700 W.  This one is persistent_back_half
// (granule_persist.cuh): min(B, SM count x 2) blocks walk the slots, a
// two-stage ring filled one slot ahead by cp.async.bulk on an mbarrier,
// the tables in shared memory once per block, four-output
// register-blocked dots, both channels in one pass (three barriers a
// slot), results back by bulk stores.  The bulk copies need 16-byte
// aligned xa, bt_eff, store, v and out (ops/back_half.py checks them).
// Two resident blocks per SM at 56 registers a thread, 74,528 B of
// dynamic shared memory per block.  Built with -fmad=false and without
// flush-to-zero, like every kernel of the port.

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_persist.cuh"

namespace {

using namespace pdmp3;

// kQuantize: fast mode's samples; without it the raw sums (exact mode,
// or fast mode's float-PCM route)
template <bool kExact, bool kQuantize>
__global__ void __launch_bounds__(kThreads, 2)
back_half_kernel(const float* __restrict__ xa,
                 const int32_t* __restrict__ bt_eff,
                 const int32_t* __restrict__ active,
                 float* __restrict__ store, float* __restrict__ v,
                 float* __restrict__ out, float* __restrict__ prev3,
                 const float4* __restrict__ image, int B) {
  persistent_back_half<kExact, kQuantize>(xa, bt_eff, active, store, v, out,
                                          prev3, image, B);
}

// the kernel of persistent instance 6 + mode: mode 0 fast (quantized),
// 1 exact (raw sums), 2 fast raw sums
using BackHalfFn = void (*)(const float*, const int32_t*, const int32_t*,
                            float*, float*, float*, float*, const float4*,
                            int);
BackHalfFn back_half_fn(int mode) {
  switch (mode) {
    case 0: return back_half_kernel<false, true>;
    case 1: return back_half_kernel<true, false>;
    default: return back_half_kernel<false, false>;
  }
}

int back_half_grid(int mode, int* grid, int* info) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  return persistent_grid(6 + mode,
                         reinterpret_cast<const void*>(back_half_fn(mode)),
                         SmemBack::kSmemBytes, grid, info);
}

}  // namespace

extern "C" {

// The launch geometry of K4's instance 6 + mode (0 fast, 1 exact, 2 fast
// raw sums) on the current device, as pdmp3_granule_launch_info gives it.
int pdmp3_back_half_launch_info(int mode, int* info) {
  int grid = 0;
  return back_half_grid(mode, &grid, info);
}

// Launch the back half for B slots on `stream`: the exact instance when
// exact, else the fast one, with raw sums when raw; tables: the device
// pointers of fused_step.TABLES (K4 reads the shared-memory table image,
// the last).  Returns the launch-geometry query's or cudaGetLastError()'s
// code (0 when the launch was accepted).
int pdmp3_back_half(const float* xa, const int32_t* bt_eff,
                    const int32_t* active, float* store, float* v,
                    float* out, float* prev3, const void* const* tables,
                    int B, int exact, int raw, void* stream) {
  const auto* image = static_cast<const float4*>(tables[kTables + 2]);
  auto* s = (cudaStream_t)stream;
  const int mode = exact ? 1 : raw ? 2 : 0;
  int grid = 0;
  const int e = back_half_grid(mode, &grid, nullptr);
  if (e != 0) return e;
  const int blocks = grid < B ? grid : B;
  const BackHalfFn kernel = back_half_fn(mode);
  kernel<<<blocks, kThreads, SmemBack::kSmemBytes, s>>>(
      xa, bt_eff, active, store, v, out, prev3, image, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
