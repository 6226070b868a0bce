// Frame-fused fast Layer III step for NVIDIA Hopper (sm_90a): K5, ng
// granule steps of one family in one launch, MPEG-1 and LSF.
//
// Replaces the TPU kernel pdmp3_tpu/ops/pallas_step.py:_kernel_frame
// (launched by frame_step_t), together with the glue of
// decode_frames_pallas (the L|R pack with mono duplication, silence for
// idle slots, the gated prev_lines carry).  Plain PyTorch twin:
// pdmp3_tpu_torch/ops/frame_step.py:frame_step_ref, which chains the
// plain granule step; K5 equals chaining K1 (MPEG-1) or K3 (LSF) bit for
// bit: each granule runs granule_step<false, kLsf> (granule_step.cuh),
// K3's body, which K1's (granule_persist.cuh) matches operation for
// operation.
//
// One 576-thread block per slot loops over the ng granules.  Both
// channels' overlap-add store (4,608 B) and polyphase FIFO (7,680 B) and
// the band-12 carry are read into shared memory once, cross the granules
// there, and are written back once, so the state makes one device-memory
// round trip per launch instead of one per granule.  The band-12 carry
// chains in shared memory as well: a parity-0 granule latches x_time[0:3]
// of (ch0, subband 0) for its active slots, and a parity-1 granule reads
// it for ch1's band-12 scalefactors, after the barrier that ends the
// granule before it.  An idle granule writes silence and leaves state and
// carry as they are; a slot idle in every granule reads no state at all.
//
// granule_step indexes every operand by blockIdx.x with the strides of
// one granule step; K5 hands it pointers rebased so that this indexing
// lands on granule g's section of the [ng][B][...] operands, on the
// slot's PCM rows of granule g in [B][ng*576], and on the block's shared
// state.  Its static shared scratch is reused by every granule, so a
// barrier separates granules.
//
// What bounds it.  Per slot and frame (ng = 2) the launch moves about
// 34.6 KB of device memory, where two granule launches move 2 x 29.6 KB:
// the wire and PCM of both granules, and the state once.  It computes the
// same ~0.3 MFLOP per granule as K1, so it stays bound by memory and, as
// K1, by latency (barriers per channel and granule).  Built with
// -fmad=false and without flush-to-zero, like every kernel of the port.

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_step.cuh"

namespace {

using namespace pdmp3;

constexpr int kStore = 2 * 32 * 18;  // both channels' overlap-add store
constexpr int kFifo = 2 * 15 * 64;   // both channels' polyphase FIFO

// two resident blocks per SM, as K1: 56 registers at most
template <bool kLsf>
__global__ void __launch_bounds__(kThreads, 2)
frame_fused_kernel(const int16_t* __restrict__ ix,
                   const int16_t* __restrict__ scf_l,
                   const int16_t* __restrict__ scf_s,
                   const int32_t* __restrict__ meta,
                   const int32_t* __restrict__ active, int ng,
                   unsigned parities, int bug_compat,
                   float* __restrict__ store, float* __restrict__ v,
                   float* __restrict__ prev, uint32_t* __restrict__ pcm,
                   Tables t, LsfOperands lsf) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t B = gridDim.x;

  bool any = false;
  for (int g = 0; g < ng; ++g) any = any || active[g * B + b] != 0;
  if (!any) {
    // idle in every granule: silence, state untouched (uniform)
    for (int g = 0; g < ng; ++g) pcm[((size_t)b * ng + g) * kLines + tid] = 0u;
    return;
  }

  __shared__ float s_store[kStore];
  __shared__ float s_v[kFifo];
  __shared__ float s_prev[3];
  float* g_store = store + (size_t)b * kStore;
  float* g_v = v + (size_t)b * kFifo;
  for (int k = tid; k < kStore; k += kThreads) s_store[k] = g_store[k];
  for (int k = tid; k < kFifo; k += kThreads) s_v[k] = g_v[k];
  if (tid < 3) s_prev[tid] = prev[b * 3 + tid];
  __syncthreads();

  for (int g = 0; g < ng; ++g) {
    const size_t o = g * B;  // granule g's first slot in [ng][B][...]
    const LsfOperands lsf_g{kLsf ? lsf.is_pos + o * 64 : nullptr, lsf.k0,
                            lsf.k1};
    // The antialias table pointers, made opaque per granule: otherwise the
    // compiler hoists the per-thread antialias addresses out of this loop,
    // and holding them across the whole granule spills 36 bytes at the 56
    // registers of two blocks per SM; opaque, it spills none
    Tables tg = t;
    asm volatile("" : "+l"(tg.cs), "+l"(tg.ca));
    granule_step<false, kLsf>(
        ix + o * 2 * kLines, scf_l + o * 2 * 22, scf_s + o * 2 * 39,
        meta + o * kMetaWords, active + o, (parities >> g) & 1u, bug_compat,
        s_store - (size_t)b * kStore, s_v - (size_t)b * kFifo,
        s_prev - (size_t)b * 3, pcm + ((size_t)b * (ng - 1) + g) * kLines,
        tg, lsf_g);
    __syncthreads();
  }

  for (int k = tid; k < kStore; k += kThreads) g_store[k] = s_store[k];
  for (int k = tid; k < kFifo; k += kThreads) g_v[k] = s_v[k];
  if (tid < 3) prev[b * 3 + tid] = s_prev[tid];
}

}  // namespace

extern "C" {

// Launch K5 for B slots and ng granules on `stream`: the MPEG-1 instance
// (lsf = 0) or the LSF one (lsf = 1, is_pos the [ng][B][64] sidecar).
// Operands are [ng][B][...] (active [ng][B]); granule g decodes as
// granule 1 of its frame when bit g of `parities` is set (0 for LSF).
// pcm: [B][ng*576] L|R words.  tables: the device pointers of
// fused_step.TABLES (maps of the step's family; the LSF gains k0/k1
// last).  Returns cudaGetLastError() (0 when the launch was accepted).
int pdmp3_frame_fused(const int16_t* ix, const int16_t* scf_l,
                      const int16_t* scf_s, const int32_t* meta,
                      const int32_t* active, const int16_t* is_pos,
                      float* store, float* v, float* prev, int16_t* pcm,
                      const void* const* tables, int B, int ng,
                      int parities, int bug_compat, int lsf, void* stream) {
  const Tables t = make_tables(tables);
  const LsfOperands ops{is_pos, static_cast<const float*>(tables[kTables]),
                        static_cast<const float*>(tables[kTables + 1])};
  auto* out = reinterpret_cast<uint32_t*>(pcm);
  auto* s = (cudaStream_t)stream;
  const auto kernel =
      lsf ? frame_fused_kernel<true> : frame_fused_kernel<false>;
  kernel<<<B, kThreads, 0, s>>>(ix, scf_l, scf_s, meta, active, ng,
                                (unsigned)parities, bug_compat, store, v,
                                prev, out, t, ops);
  return (int)cudaGetLastError();
}

}  // extern "C"
