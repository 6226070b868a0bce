// On-card sweep of the exact kernel's three float64 rounding points over
// f32 bit patterns, for NVIDIA Hopper (sm_90a): K6.
//
// Replaces the TPU sweep kernel of tools/prove_on_tpu.py:_device_fn (the
// inline `kern` there), which ran the JAX package's f32 emulations of
// those points.  Here each thread takes one input whose bit pattern is
// base + i, built on the card (no input traffic), applies the SAME
// __device__ function that the exact granule kernel calls (rounding.cuh:
// ms_f64, uq_f64 or qz_f64) and writes the f32 result.  The caller
// (pdmp3_tpu_torch/ops/rounding.py:sweep) compares each chunk bitwise
// with the plain PyTorch f64 versions on the card.  Nothing is masked:
// the card keeps subnormal inputs and results (built without
// flush-to-zero), unlike the TPU, whose sweep had to skip them.
//
// What bounds it: 4 bytes written per input and a handful of f64
// operations, so the f32 store stream (and the f64 rate, half the f32
// rate on the H100) bound it; 2^24 inputs write 64 MB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rounding.cuh"

namespace {

using namespace pdmp3;

template <int kConstruction>
__global__ void rounding_sweep_kernel(uint32_t base, float* __restrict__ out,
                                      long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __uint_as_float(base + (uint32_t)i);
  if constexpr (kConstruction == 0)
    out[i] = ms_f64(x);
  else if constexpr (kConstruction == 1)
    out[i] = uq_f64(x);
  else
    out[i] = qz_f64(x);
}

}  // namespace

extern "C" {

// out[i] = construction(f32 with bits base + i) for i < n on `stream`;
// construction 0 = ms, 1 = uq, 2 = qz (rounding.CONSTRUCTIONS).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another construction.
int pdmp3_rounding_sweep(int construction, unsigned base, float* out,
                         long long n, void* stream) {
  constexpr int kBlock = 256;
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  auto* s = (cudaStream_t)stream;
  switch (construction) {
    case 0:
      rounding_sweep_kernel<0><<<grid, kBlock, 0, s>>>(base, out, n);
      break;
    case 1:
      rounding_sweep_kernel<1><<<grid, kBlock, 0, s>>>(base, out, n);
      break;
    case 2:
      rounding_sweep_kernel<2><<<grid, kBlock, 0, s>>>(base, out, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
