// Frame-fused fast Layer III step for NVIDIA Hopper (sm_90a): K5, ng
// granule steps of one family in one launch, MPEG-1 and LSF.
//
// Replaces the TPU kernel pdmp3_tpu/ops/pallas_step.py:_kernel_frame
// (launched by frame_step_t), together with the glue of
// decode_frames_pallas (the L|R pack with mono duplication, silence for
// idle slots, the gated prev_lines carry).  Plain PyTorch twin:
// pdmp3_tpu_torch/ops/frame_step.py:frame_step_ref, which chains the
// plain granule step; K5 equals chaining K1 (MPEG-1) or K3 (LSF) bit for
// bit: it runs their body (granule_persist.cuh, kFrame = true), operation
// for operation.
//
// Persistent blocks (min(B, SM count x 2), persistent_grid) walk the
// units (slot, granule), slot b's ng granules one after the other, the
// slots b = blockIdx.x + k * gridDim.x.  A granule's wire (ix, meta,
// scf_l, scf_s and, for LSF, the is_pos sidecar; operands [ng][B][...])
// arrives one unit ahead in the two-stage ring, as in K1.  Both channels'
// overlap-add store (4,608 B), polyphase FIFO (7,680 B) and the band-12
// carry live in one of two state sets in shared memory: fetched by bulk
// copy with the slot's first active granule (during the unit before it,
// so the next slot's state arrives during the current slot's last
// granule), carried across its granules (the 18 new FIFO rows of one
// granule are the next one's carried rows: the set's two FIFO buffers
// swap, no copy), and written back by bulk store after its last active
// granule.  The band-12 carry chains in the set: a parity-0 granule
// latches x_time[0:3] of (ch0, subband 0), and a parity-1 granule reads it
// for ch1's band-12 scalefactors, barriers later.  An idle granule writes
// silence and leaves state and carry as they are; a slot idle in every
// granule fetches no state at all.  Granule g's PCM (2,304 B) leaves by
// bulk store to row b * ng + g of pcm [B][ng * 576] (L|R words).
//
// What bounds it.  Per slot and frame (ng = 2) the launch moves about
// 34.6 KB of device memory, where two granule launches move 2 x 29.6 KB:
// the wire and PCM of both granules, and the state once.  It computes the
// same ~0.3 MFLOP per granule as K1, so bytes set its bound (0.0845 ms at
// B = 8192, under two K1 launches' 0.1446 ms).  Bounded, as K1, to two
// blocks per SM (56 registers a thread), with 84,816 B (MPEG-1) or
// 85,072 B (LSF) of dynamic shared memory per block.  Built with
// -fmad=false and without flush-to-zero, like every kernel of the port.

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_persist.cuh"

namespace {

using namespace pdmp3;

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
                   Tables t, const float4* __restrict__ image, int B,
                   LsfOperands lsf) {
  persistent_granules<false, kLsf, true>(ix, scf_l, scf_s, meta, active, 0,
                                         bug_compat, store, v, prev, pcm, t,
                                         image, B, lsf, ng, parities);
}

int frame_grid(int lsf, int* grid, int* info) {
  return lsf ? persistent_grid(
                   5, reinterpret_cast<const void*>(frame_fused_kernel<true>),
                   Smem<true, true>::kSmemBytes, grid, info)
             : persistent_grid(
                   4, reinterpret_cast<const void*>(frame_fused_kernel<false>),
                   Smem<false, true>::kSmemBytes, grid, info);
}

}  // namespace

extern "C" {

// K5's launch geometry (the MPEG-1 instance, or the LSF one when lsf) on
// the current device, as pdmp3_granule_launch_info gives it.
int pdmp3_frame_launch_info(int lsf, int* info) {
  int grid = 0;
  return frame_grid(lsf, &grid, info);
}

// Launch K5 for B slots and ng granules on `stream`: the MPEG-1 instance
// (lsf = 0) or the LSF one (lsf = 1, is_pos the [ng][B][64] sidecar).
// Operands are [ng][B][...] (active [ng][B]); granule g decodes as
// granule 1 of its frame when bit g of `parities` is set (0 for LSF).
// pcm: [B][ng*576] L|R words.  tables: the device pointers of
// fused_step.TABLES (maps of the step's family; the LSF gains k0/k1 and
// the shared-memory table image last).  Returns the launch-geometry
// query's or cudaGetLastError()'s code (0 when the launch was accepted).
int pdmp3_frame_fused(const int16_t* ix, const int16_t* scf_l,
                      const int16_t* scf_s, const int32_t* meta,
                      const int32_t* active, const int16_t* is_pos,
                      float* store, float* v, float* prev, int16_t* pcm,
                      const void* const* tables, int B, int ng,
                      int parities, int bug_compat, int lsf, void* stream) {
  const Tables t = make_tables(tables);
  const LsfOperands ops{is_pos, static_cast<const float*>(tables[kTables]),
                        static_cast<const float*>(tables[kTables + 1])};
  const auto* image = static_cast<const float4*>(tables[kTables + 2]);
  auto* out = reinterpret_cast<uint32_t*>(pcm);
  auto* s = (cudaStream_t)stream;
  int grid = 0;
  const int e = frame_grid(lsf, &grid, nullptr);
  if (e != 0) return e;
  const int blocks = grid < B ? grid : B;
  if (lsf)
    frame_fused_kernel<true>
        <<<blocks, kThreads, Smem<true, true>::kSmemBytes, s>>>(
            ix, scf_l, scf_s, meta, active, ng, (unsigned)parities,
            bug_compat, store, v, prev, out, t, image, B, ops);
  else
    frame_fused_kernel<false>
        <<<blocks, kThreads, Smem<false, true>::kSmemBytes, s>>>(
            ix, scf_l, scf_s, meta, active, ng, (unsigned)parities,
            bug_compat, store, v, prev, out, t, image, B, ops);
  return (int)cudaGetLastError();
}

}  // extern "C"
