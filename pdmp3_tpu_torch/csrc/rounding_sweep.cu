// On-card sweep of the exact kernel's three float64 rounding points over
// f32 bit patterns, for NVIDIA Hopper (sm_90a): K6.
//
// Replaces the TPU sweep kernel of tools/prove_on_tpu.py:_device_fn (the
// inline `kern` there), which ran the JAX package's f32 emulations of
// those points.  Here the inputs of a chunk are the bit patterns base,
// base + 1, ..., base + n - 1, built on the card (no input traffic); each
// applies the SAME __device__ function that the exact granule kernel
// calls (rounding.cuh: ms_f64, uq_f64, qz_f64), and the f32 results are
// written out.  The caller (pdmp3_tpu_torch/ops/rounding.py:sweep)
// compares each chunk bitwise with the plain PyTorch f64 versions on the
// card.  Nothing is masked: the card keeps subnormal inputs and results
// (built without flush-to-zero), unlike the TPU, whose sweep had to skip
// them.
//
// What bounds it: 4 bytes written per input and construction and a
// handful of f64 operations, so the store stream bounds it (2^24 inputs
// and three constructions write 201 MB: 0.060 ms at 3.35 TB/s).  The
// design serves that stream: one launch writes all three
// constructions, rows out + c * ld; each thread takes four consecutive
// inputs, generates their bit patterns in registers and writes each
// construction's four results with one 16-byte store (neighbouring
// threads on neighbouring 16 bytes); SM count x resident blocks walk the
// chunk in a grid-stride loop with 32-bit offsets.  A ragged n leaves
// n % 4 inputs past the last whole vector, written one per thread of
// block 0; offsets stay below 2^32 for any chunk that ends at or before
// 2^32.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "rounding.cuh"

namespace {

using namespace pdmp3;

constexpr int kBlock = 256;
constexpr int kMaxDevices = 64;

// the three constructions of the f32 input with bits b: ms, uq, qz
__device__ __forceinline__ void points(uint32_t b, float& ms, float& uq,
                                       float& qz) {
  const float x = __uint_as_float(b);
  ms = ms_f64(x);
  uq = uq_f64(x);
  qz = qz_f64(x);
}

// construction c of input base + i into out[c * ld + i], i < n = 4 * nvec
// + tail; out and ld 16-byte aligned
__global__ void __launch_bounds__(kBlock)
rounding_sweep_kernel(uint32_t base, float* __restrict__ out, size_t ld,
                      uint32_t nvec, uint32_t tail) {
  const uint32_t stride = gridDim.x * kBlock;
  for (uint32_t q = blockIdx.x * kBlock + threadIdx.x; q < nvec;
       q += stride) {
    const uint32_t i = 4u * q, b = base + i;
    float4 ms, uq, qz;
    points(b, ms.x, uq.x, qz.x);
    points(b + 1u, ms.y, uq.y, qz.y);
    points(b + 2u, ms.z, uq.z, qz.z);
    points(b + 3u, ms.w, uq.w, qz.w);
    *reinterpret_cast<float4*>(out + i) = ms;
    *reinterpret_cast<float4*>(out + ld + i) = uq;
    *reinterpret_cast<float4*>(out + 2 * ld + i) = qz;
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const uint32_t i = 4u * nvec + threadIdx.x;
    points(base + i, out[i], out[ld + i], out[2 * ld + i]);
  }
}

// SM count x resident blocks on the current device, cached per device;
// racing first calls compute the same value.  Returns a cudaError_t.
int sweep_grid(int* grid) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidValue;
  int g = cache[dev].load(std::memory_order_acquire);
  if (g == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, rounding_sweep_kernel, kBlock, 0)) != cudaSuccess)
      return (int)e;
    g = sms * (per_sm > 0 ? per_sm : 1);
    cache[dev].store(g, std::memory_order_release);
  }
  *grid = g;
  return 0;
}

}  // namespace

extern "C" {

// The three constructions (0 = ms, 1 = uq, 2 = qz: rounding.CONSTRUCTIONS)
// of the f32 inputs with bits base + i, i < n, construction c into
// out[c * ld + i], on `stream`.  Needs 0 < n <= 2^32 - base, ld >= n a
// multiple of 4 and out 16-byte aligned.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for other arguments.
int pdmp3_rounding_sweep(unsigned base, float* out, long long n,
                         long long ld, void* stream) {
  if (n <= 0 || n > (1LL << 32) - (long long)base || ld % 4 != 0 ||
      ld < n || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int e = sweep_grid(&grid);
  if (e != 0) return e;
  const auto nvec = (uint32_t)(n / 4), tail = (uint32_t)(n % 4);
  const long long need = ((long long)nvec + kBlock - 1) / kBlock;
  const int blocks = (int)(need < 1 ? 1 : need < grid ? need : grid);
  rounding_sweep_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      base, out, (size_t)ld, nvec, tail);
  return (int)cudaGetLastError();
}

}  // extern "C"
