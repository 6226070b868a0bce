// Fused Layer III granule step for NVIDIA Hopper (sm_90a), in two
// precisions and two family kinds: K1 (MPEG-1, fast), K2 (MPEG-1, exact,
// bit-exact with the reference) and K3 (the LSF families MPEG-2 and
// MPEG-2.5, fast and exact); and each of the four again with float PCM
// (persistent instances 9-12, below).
//
// Replaces the TPU kernel pdmp3_tpu/ops/pallas_step.py:_kernel_full
// (_fused_granule + _back_ch_sb) for family 0 in fast mode (K1) and exact
// mode (K2), and for families 1 and 2 in both modes (K3, LSF stereo
// :954-1004), launched by pallas_step.py:full_step_t (pallas_call at
// :1525; exact route :1575-1635), together with the glue of
// decode_granules_pallas's fast and fused exact branches: for MPEG-1 the
// band-12 scalefactor substitution and, in exact mode, the band-12 true
// gains; for LSF the intensity sidecar and iscale; the L|R int16 pack
// with mono duplication, and the gated prev_lines update.  Plain PyTorch
// twin: pdmp3_tpu_torch/ops/fused_step.py:fused_granule_step_ref.
//
// What bounds them.  Per slot and granule the step moves about 30 KB of
// device memory: ix 2,304 B in, store 4,608 B and v 7,680 B read and
// written, PCM 2,304 B out, small fields (K3: plus a 128 B sidecar); it
// computes about 0.3 MFLOP (IMDCT, matrixing, FIR), ~10 FLOP per byte,
// so bytes set the bound (0.0723 ms at B = 8192).  What held the former
// design (one 576-thread block per slot, 1.17-1.32 ms on an H100 80GB
// HBM3 at 700 W) far above it was latency: each channel read its state
// in mid-granule behind a barrier, ten barriers a slot, and two memory
// instructions per product.  All four instances now run the persistent
// body of granule_persist.cuh, and each part of its design answers one
// of those:
// - persistent blocks: min(B, SM count x 2) blocks (persistent_grid)
//   walk the slots b = blockIdx.x + k * gridDim.x; tables and barriers
//   are set up once per block, and no partial last wave is left;
// - a two-stage ring: while slot n computes, thread 0 fetches slot n + G
//   into the other stage with cp.async.bulk (ix, the int32 meta, store,
//   v; 14,720 B, completion counted in bytes on the stage's mbarrier) and
//   64 threads fetch scf_l, scf_s and prev_lines (K3: the 128 B is_pos
//   sidecar instead of prev_lines) with 4-byte cp.async (only 4-byte
//   aligned on the wire: the packed LSF wire puts is_pos at F x B x 2,612
//   bytes); an idle slot fetches no state; the new store, the new FIFO
//   rows and the PCM go back by bulk stores from shared memory
//   (fence.proxy.async, then wait_group.read before a buffer is reused).
//   The wrapper raises on an operand those copies cannot take
//   (ops/fused_step.py:check_bulk_alignment);
// - the tables (cos36, imdct_win, the short basis and window re-indexed
//   by output, nwin transposed, synth_d: 21,616 B,
//   ops/consts.py:granule_smem_image, the same for every family) in
//   shared memory once per block, laid out so one LDS.128 brings the
//   four coefficients a thread uses together; pow43 and the line maps
//   (the family's, through the table pointers) stay on __ldg;
// - dots blocked four outputs to a thread (four IMDCT outputs of one
//   subband, four FIFO columns of one channel and time step), each output
//   summed in exactly the pairwise tree's or the sequential order of
//   ops/dsp.py (_dot_tree, _dot_seq); the FIR gives a thread three time
//   steps of one column, which share 14 of 16 taps;
// - both channels' back half in one pass: IMDCT 1,152 outputs, matrixing
//   2,304, FIR 1,152, with both channels' 33-row FIFOs on chip (15 rows
//   in the stage, 18 new rows unpadded, so rows 3..17 are the contiguous
//   new v a bulk store takes; the matrixing's column writes conflict
//   8-way instead): five barriers a slot where the former design had ten.
// At two blocks per SM ptxas fits every instance in 56 registers with no
// spills (the thread index is made opaque per slot; hoisted per-thread
// addresses spilled otherwise); dynamic shared memory per block: 72,512 B
// (K1, K2), 72,768 B (K3) (pdmp3_granule_launch_info; measured in
// PERF.md).
//
// K3's front half has no sentinel-63 and no band-12 code (LSF gains stay
// true through q = 124, and every LSF step is a granule-0 step, which
// latches prev_lines and never reads it), and its stereo is the LSF one
// (full-spectrum MS; intensity positions from the sidecar, gains k0/k1
// by iscale, panning the raw pre-MS ch0 line).
//
// Arithmetic, all four.  Built with -fmad=false: no product is contracted
// into an FMA, so every operation rounds exactly where the plain PyTorch
// version rounds, and the sums run in the same fixed order (fast: a
// pairwise tree for the IMDCT and matrixing dots; exact: sequential from
// the first product, the reference's order; sequential FIR taps in both).
// The kernels therefore match the plain version bit for bit; the products
// stay f32 on CUDA cores (TF32 tensor cores would break both contracts).
// |x|^(4/3) is read from the frozen 8207-entry table (the correctly
// rounded value).  Denormals are kept (no -ftz): the band-12 carry reads
// the float BITS of three output lines, and 95 of the exact band-12 gains
// are subnormal.  Exact mode adds, per line: for MPEG-1 the sentinel-63
// zero gain (q >= 100) and the band-12 true gain on granule 1's ch1, and
// the float64 rounding points of rounding.cuh (MS, the unsigned quirk,
// quantize).
//
// Float PCM (instances 9-12: MPEG-1 fast, MPEG-1 exact, LSF fast, LSF
// exact).  The JAX package computes float PCM in one XLA program
// (pdmp3_tpu/models/decoder.py decode_granules(float_pcm=True)); its
// Pallas step refuses it.  These instances are K1, K2 and K3 with the
// body's kFloat switch: the FIR sums go out as ops/dsp.py float_pack
// makes them (NaN -> -1, clamp to [-1, 1], f32 L|R, mono duplicated)
// instead of quantized, so one launch replaces the split route's stage
// ops and K4 raw-sums launch (ops/back_half.py float_granule_step) for
// every pool on the card.  The exact instances round nowhere in f64 (the
// quantize was K2's and K3's only f64 point after the stereo); their sums
// are the plain version's bit for bit.  The PCM row in shared memory
// doubles to 4,608 B (dynamic shared memory 74,816 B MPEG-1, 75,072 B
// LSF); the bound grows by the 2,304 B more PCM per slot (at B = 8192:
// 37.7 MB of PCM where S16 writes 18.9 MB).

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_persist.cuh"

namespace {

using namespace pdmp3;

// K1 and K2: persistent, two resident blocks per SM (at most 56 registers
// a thread; one block per SM measured slower, PERF.md)
template <bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
fused_granule_kernel(const int16_t* __restrict__ ix,
                     const int16_t* __restrict__ scf_l,
                     const int16_t* __restrict__ scf_s,
                     const int32_t* __restrict__ meta,
                     const int32_t* __restrict__ active, int gr1,
                     int bug_compat, float* __restrict__ store,
                     float* __restrict__ v, float* __restrict__ prev,
                     uint32_t* __restrict__ pcm, Tables t,
                     const float4* __restrict__ image, int B) {
  persistent_granules<kExact, false, false>(
      ix, scf_l, scf_s, meta, active, gr1, bug_compat, store, v, prev, pcm,
      t, image, B, LsfOperands{}, 1, 0u);
}

// K3: the same body with the LSF front half, as K1 two blocks per SM;
// every LSF step is a granule-0 step
template <bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
fused_granule_lsf_kernel(const int16_t* __restrict__ ix,
                         const int16_t* __restrict__ scf_l,
                         const int16_t* __restrict__ scf_s,
                         const int32_t* __restrict__ meta,
                         const int32_t* __restrict__ active,
                         float* __restrict__ store, float* __restrict__ v,
                         float* __restrict__ prev,
                         uint32_t* __restrict__ pcm, Tables t,
                         const float4* __restrict__ image, int B,
                         LsfOperands lsf) {
  persistent_granules<kExact, true, false>(ix, scf_l, scf_s, meta, active,
                                           0, 0, store, v, prev, pcm, t,
                                           image, B, lsf, 1, 0u);
}

// Float PCM: K1 / K2 (instances 9, 10) and K3 (11, 12) writing f32 L|R
// pairs; separate kernels, so the S16 instances keep their names and code
template <bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
fused_granule_float_kernel(const int16_t* __restrict__ ix,
                           const int16_t* __restrict__ scf_l,
                           const int16_t* __restrict__ scf_s,
                           const int32_t* __restrict__ meta,
                           const int32_t* __restrict__ active, int gr1,
                           int bug_compat, float* __restrict__ store,
                           float* __restrict__ v, float* __restrict__ prev,
                           float2* __restrict__ pcm, Tables t,
                           const float4* __restrict__ image, int B) {
  persistent_granules<kExact, false, false, true>(
      ix, scf_l, scf_s, meta, active, gr1, bug_compat, store, v, prev, pcm,
      t, image, B, LsfOperands{}, 1, 0u);
}

template <bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
fused_granule_lsf_float_kernel(const int16_t* __restrict__ ix,
                               const int16_t* __restrict__ scf_l,
                               const int16_t* __restrict__ scf_s,
                               const int32_t* __restrict__ meta,
                               const int32_t* __restrict__ active,
                               float* __restrict__ store,
                               float* __restrict__ v,
                               float* __restrict__ prev,
                               float2* __restrict__ pcm, Tables t,
                               const float4* __restrict__ image, int B,
                               LsfOperands lsf) {
  persistent_granules<kExact, true, false, true>(
      ix, scf_l, scf_s, meta, active, 0, 0, store, v, prev, pcm, t, image, B,
      lsf, 1, 0u);
}

// the kernel of persistent instance 0..3 (K1, K2, K3 fast, K3 exact) or
// 9..12 (the same with float PCM)
const void* granule_kernel(int instance) {
  switch (instance) {
    case 0: return reinterpret_cast<const void*>(fused_granule_kernel<false>);
    case 1: return reinterpret_cast<const void*>(fused_granule_kernel<true>);
    case 2:
      return reinterpret_cast<const void*>(fused_granule_lsf_kernel<false>);
    case 3:
      return reinterpret_cast<const void*>(fused_granule_lsf_kernel<true>);
    case 9:
      return reinterpret_cast<const void*>(fused_granule_float_kernel<false>);
    case 10:
      return reinterpret_cast<const void*>(fused_granule_float_kernel<true>);
    case 11:
      return reinterpret_cast<const void*>(
          fused_granule_lsf_float_kernel<false>);
    default:
      return reinterpret_cast<const void*>(
          fused_granule_lsf_float_kernel<true>);
  }
}

int granule_grid(int instance, int* grid, int* info) {
  const bool lsf = instance == 2 || instance == 3 || instance >= 11;
  const int smem = instance >= 9
                       ? (lsf ? Smem<true, false, true>::kSmemBytes
                              : Smem<false, false, true>::kSmemBytes)
                       : (lsf ? Smem<true, false>::kSmemBytes
                              : Smem<false, false>::kSmemBytes);
  return persistent_grid(instance, granule_kernel(instance), smem, grid,
                         info);
}

}  // namespace

extern "C" {

int pdmp3_frame_launch_info(int lsf, int* info);       // frame_fused.cu
int pdmp3_back_half_launch_info(int mode, int* info);   // back_half.cu
int pdmp3_l12_synth_launch_info(int mode, int* info);   // l12_synth.cu

// The launch geometry of a persistent kernel instance on the current
// device into info[6]: grid, blocks per SM, dynamic shared memory per
// block (bytes), registers per thread, local memory per thread (bytes),
// SM count.  instance: 0 K1, 1 K2, 2 K3 fast, 3 K3 exact, 4 K5 MPEG-1, 5
// K5 LSF, 6 K4 fast, 7 K4 exact, 8 K4 fast raw sums, 9 K1 float, 10 K2
// float, 11 K3 fast float, 12 K3 exact float, 13-20 K7 (13 + 4 Layer II
// + 2 float PCM + 1 exact).  Returns a cudaError_t (0 on success).
int pdmp3_granule_launch_info(int instance, int* info) {
  if (instance < 0 || instance >= kInstances)
    return (int)cudaErrorInvalidValue;
  if (instance >= 13) return pdmp3_l12_synth_launch_info(instance - 13, info);
  if (instance >= 6 && instance < 9)
    return pdmp3_back_half_launch_info(instance - 6, info);
  if (instance >= 4 && instance < 6)
    return pdmp3_frame_launch_info(instance - 4, info);
  int grid = 0;
  return granule_grid(instance, &grid, info);
}

// Launch one granule step for B slots on `stream`: for MPEG-1 (lsf = 0)
// K2 when exact else K1; for the LSF families (lsf = 1, is_pos the [B][64]
// sidecar, gr1 = 0) K3 in the precision `exact` selects; with float_pcm
// the same step writing float PCM (instances 9-12; pcm f32 [B][576][2],
// else int16); min(B, the resident grid) blocks walk the B slots.
// tables: the device pointers of fused_step.TABLES (maps of the step's
// family; then the LSF gains k0/k1 and the shared-memory table image).
// Returns the launch-geometry query's or cudaGetLastError()'s code (0 when
// the launch was accepted).
int pdmp3_fused_granule(const int16_t* ix, const int16_t* scf_l,
                        const int16_t* scf_s, const int32_t* meta,
                        const int32_t* active, const int16_t* is_pos,
                        float* store, float* v, float* prev, void* pcm,
                        const void* const* tables, int B, int gr1,
                        int bug_compat, int exact, int lsf, int float_pcm,
                        void* stream) {
  const Tables t = make_tables(tables);
  auto* out = static_cast<uint32_t*>(pcm);
  auto* outf = static_cast<float2*>(pcm);
  auto* s = (cudaStream_t)stream;
  const auto* image = static_cast<const float4*>(tables[kTables + 2]);
  int grid = 0;
  const int e = granule_grid(
      (float_pcm ? 9 : 0) + 2 * (lsf != 0) + (exact != 0), &grid, nullptr);
  if (e != 0) return e;
  const int blocks = grid < B ? grid : B;
  const LsfOperands ops{is_pos, static_cast<const float*>(tables[kTables]),
                        static_cast<const float*>(tables[kTables + 1])};
  if (float_pcm && lsf) {
    const auto kernel = exact ? fused_granule_lsf_float_kernel<true>
                              : fused_granule_lsf_float_kernel<false>;
    kernel<<<blocks, kThreads, Smem<true, false, true>::kSmemBytes, s>>>(
        ix, scf_l, scf_s, meta, active, store, v, prev, outf, t, image, B,
        ops);
  } else if (float_pcm) {
    const auto kernel = exact ? fused_granule_float_kernel<true>
                              : fused_granule_float_kernel<false>;
    kernel<<<blocks, kThreads, Smem<false, false, true>::kSmemBytes, s>>>(
        ix, scf_l, scf_s, meta, active, gr1, bug_compat, store, v, prev,
        outf, t, image, B);
  } else if (lsf) {
    const auto kernel = exact ? fused_granule_lsf_kernel<true>
                              : fused_granule_lsf_kernel<false>;
    kernel<<<blocks, kThreads, Smem<true, false>::kSmemBytes, s>>>(
        ix, scf_l, scf_s, meta, active, store, v, prev, out, t, image, B,
        ops);
  } else {
    const auto kernel = exact ? fused_granule_kernel<true>
                              : fused_granule_kernel<false>;
    kernel<<<blocks, kThreads, Smem<false, false>::kSmemBytes, s>>>(
        ix, scf_l, scf_s, meta, active, gr1, bug_compat, store, v, prev, out,
        t, image, B);
  }
  return (int)cudaGetLastError();
}

const char* pdmp3_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
