// Fused Layer III granule step for NVIDIA Hopper (sm_90a), in two
// precisions and two family kinds: K1 (MPEG-1, fast), K2 (MPEG-1, exact,
// bit-exact with the reference) and K3 (the LSF families MPEG-2 and
// MPEG-2.5, fast and exact).
//
// Replaces the TPU kernel pdmp3_tpu/ops/pallas_step.py:_kernel_full
// (_fused_granule + _back_ch_sb) for family 0 in fast mode (K1) and exact
// mode (K2), and for families 1 and 2 in both modes (K3, LSF stereo
// :954-1004), together with the glue of decode_granules_pallas's fast and
// fused exact branches: for MPEG-1 the band-12 scalefactor substitution
// and, in exact mode, the band-12 true gains; for LSF the intensity
// sidecar and iscale; the L|R int16 pack with mono duplication, and the
// gated prev_lines update.  Plain PyTorch twin:
// pdmp3_tpu_torch/ops/fused_step.py:fused_granule_step_ref.
//
// The family kind is a second template axis of the step's body,
// granule_step<kExact, kLsf> (granule_step.cuh, shared with the frame
// kernel K5 of frame_fused.cu), as the TPU kernel keeps its MPEG-1 signature
// free of LSF operands: K1 and K2 are its kLsf = false instances behind
// the MPEG-1 kernel's unchanged signature and carry no LSF code; K3 is
// the kLsf = true instance behind fused_granule_lsf_kernel, which adds
// the LSF operands.  K3 differs in three places only: it reads the slot's
// 64-entry intensity sidecar into shared memory, its requantize has no
// sentinel-63 and no band-12 code (LSF gains stay true through q = 124,
// and every LSF step is a granule-0 step), and its stereo is the LSF one
// (full-spectrum MS; intensity positions from the sidecar, gains k0/k1 by
// iscale, panning the raw pre-MS ch0 line).  The family's band maps arrive
// through the table pointers.
//
// One thread block decodes one slot, both channels (stereo couples them),
// with 576 threads: one per spectral line for requantize and stereo, one
// per (subband, sample) for the IMDCT and overlap-add, two outputs each
// for the polyphase matrixing, one per PCM sample for the FIR.  Both
// spectra, one channel's x_time and its 33x64 synthesis FIFO stay in
// shared memory; nothing intermediate reaches device memory.
//
// What bounds it.  Per slot and granule the step moves about 30 KB of
// device memory in both modes: ix 2,304 B in, store 4,608 B and v 7,680 B
// each read and written, PCM 2,304 B out, plus small fields.  It computes
// about 0.3 MFLOP (IMDCT ~83 k, matrixing ~147 k, FIR ~37 k): about 10
// FLOP per byte, under the f32 CUDA-core ridge of the card, so the state
// round trip bounds the kernel.  The design touches each state byte once
// (store and v are read once and updated in place, by the thread that
// read them), keeps every intermediate on chip, and keeps the products in
// f32 on CUDA cores: TF32 tensor cores would break both contracts.
//
// Arithmetic.  Built with -fmad=false: no product is contracted into an
// FMA, so every operation rounds exactly where the plain PyTorch version
// rounds, and the sums run in the same fixed order (fast: a pairwise tree
// for the IMDCT and matrixing dots; exact: sequential from the first
// product, the reference's order; sequential FIR taps in both).  The
// kernel therefore matches the plain version bit for bit.  |x|^(4/3) is
// read from the frozen 8207-entry table (the correctly rounded value).
// Denormals are kept (no -ftz): the band-12 carry reads the float BITS of
// three output lines, and 95 of the exact band-12 gains are subnormal.
// Exact mode adds, per line: for MPEG-1 the sentinel-63 zero gain
// (q >= 100) and the band-12 true gain on granule 1's ch1, and the float64
// rounding points of rounding.cuh (MS, the unsigned quirk, quantize): a
// few f64 operations per line, where the H100 runs f64 at half its f32
// rate.  K3 moves the same bytes plus a 128 B sidecar per slot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_step.cuh"

namespace {

using namespace pdmp3;

// two resident blocks per SM: ptxas then fits K1 and K2 in 56 registers
// with no spills (73 unbounded, one block per SM); three spill.  Both
// ran fastest at 2 of 1, 2 and 3 blocks (PERF.md, "Launch bounds"); K3
// starts from the same bound
template <bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
fused_granule_kernel(const int16_t* __restrict__ ix,
                     const int16_t* __restrict__ scf_l,
                     const int16_t* __restrict__ scf_s,
                     const int32_t* __restrict__ meta,
                     const int32_t* __restrict__ active, int gr1,
                     int bug_compat, float* __restrict__ store,
                     float* __restrict__ v, float* __restrict__ prev,
                     uint32_t* __restrict__ pcm, Tables t) {
  granule_step<kExact, false>(ix, scf_l, scf_s, meta, active, gr1,
                              bug_compat, store, v, prev, pcm, t,
                              LsfOperands{});
}

template <bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
fused_granule_lsf_kernel(const int16_t* __restrict__ ix,
                         const int16_t* __restrict__ scf_l,
                         const int16_t* __restrict__ scf_s,
                         const int32_t* __restrict__ meta,
                         const int32_t* __restrict__ active, int gr1,
                         int bug_compat, float* __restrict__ store,
                         float* __restrict__ v, float* __restrict__ prev,
                         uint32_t* __restrict__ pcm, Tables t,
                         LsfOperands lsf) {
  granule_step<kExact, true>(ix, scf_l, scf_s, meta, active, gr1,
                             bug_compat, store, v, prev, pcm, t, lsf);
}

}  // namespace

extern "C" {

// Launch one granule step for B slots on `stream`: for MPEG-1 (lsf = 0)
// K2 when exact else K1; for the LSF families (lsf = 1, is_pos the [B][64]
// sidecar, gr1 = 0) K3 in the precision `exact` selects.  tables: the
// device pointers of fused_step.TABLES (maps of the step's family; the
// LSF gains k0/k1 last).  Returns cudaGetLastError() (0 when the launch
// was accepted).
int pdmp3_fused_granule(const int16_t* ix, const int16_t* scf_l,
                        const int16_t* scf_s, const int32_t* meta,
                        const int32_t* active, const int16_t* is_pos,
                        float* store, float* v, float* prev, int16_t* pcm,
                        const void* const* tables, int B, int gr1,
                        int bug_compat, int exact, int lsf, void* stream) {
  const Tables t = make_tables(tables);
  auto* out = reinterpret_cast<uint32_t*>(pcm);
  auto* s = (cudaStream_t)stream;
  if (lsf) {
    const LsfOperands ops{is_pos, static_cast<const float*>(tables[kTables]),
                          static_cast<const float*>(tables[kTables + 1])};
    const auto kernel = exact ? fused_granule_lsf_kernel<true>
                              : fused_granule_lsf_kernel<false>;
    kernel<<<B, kThreads, 0, s>>>(ix, scf_l, scf_s, meta, active, gr1,
                                  bug_compat, store, v, prev, out, t, ops);
  } else {
    const auto kernel = exact ? fused_granule_kernel<true>
                              : fused_granule_kernel<false>;
    kernel<<<B, kThreads, 0, s>>>(ix, scf_l, scf_s, meta, active, gr1,
                                  bug_compat, store, v, prev, out, t);
  }
  return (int)cudaGetLastError();
}

const char* pdmp3_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
