// Layer I/II requantization for NVIDIA Hopper (sm_90a): K9, for Layer I
// (S = 12 time steps a frame) and Layer II (S = 36), two instances
// subband_requant_kernel<S>.
//
// Replaces no TPU kernel: the JAX package requantizes on the host (the
// native packer pdmp3_parse_step_wire_l12, frame.cc parse_l1 / parse_l2)
// and ships f32 subband samples, 9,216 B a Layer II slot-frame.  The
// port's pools ship the coded frames instead (2,398 B a slot-frame,
// host/src/wire_l12_codes.cc) and this kernel computes the samples on
// the card before K7 (csrc/l12_synth.cu) reads them.  Plain PyTorch twin:
// pdmp3_tpu_torch/ops/l12_requant.py:l12_requant_ref.
//
// Per slot-frame n: body[n] (2,000 B, the frame's bytes after its header
// and CRC), side[n] (384 B: class u8 [2][32], scalefactor indices u8
// [2][32][3] at byte 64, code offsets int16 [2][32] at byte 256) and
// geom[n] = {the samples' first bit, a group's bits}.  Code k of (ch,
// sb) in group g starts at bit geom[0] + g x geom[1] + off[ch][sb] (+ k x
// bits for an ungrouped Layer II class); a grouped codeword splits into
// three codes as parse_l2 splits it; each code becomes
//     __double2float_rn(scf[min(idx, 62)] * (C * (frac(code, nb) + D)))
// with every double operation rounded where parse_l1 / parse_l2 round it
// (-fmad=false, no flush-to-zero): the samples equal the host's bit for
// bit.  Class 0 (no allocation, an idle slot-frame's zero side record)
// writes +0.0.  Output sb f32 [n][2][S][32], the layout K7 reads.
//
// What bounds it.  Per slot-frame the body's used bytes (a 256 kbps 48
// kHz Layer II frame: 762 of them, copied in whole 16-byte chunks), the
// 384 B side record and 4 B of geom in, 9,216 B (Layer II) or 3,072 B
// (Layer I) of samples out: at B = 12,800 Layer II about 133 MB, 0.040
// ms at 3.35 TB/s.  The arithmetic, 30 M samples of 3 f64 operations and
// 2 conversions to and from f64 (those at a quarter of the f64 rate),
// takes about 0.015 ms of the SMs' f64 pipes, so bytes set the bound.
// The design keeps the stores whole and the f64 work converged: one
// block of 256 threads a slot-frame (eight blocks an SM); thread 0 brings
// the side record and the body's used chunks into shared memory by one
// cp.async.bulk each on an mbarrier; the eight warps take the 24
// (channel, group) pairs in turn, lane = subband, so each of a pair's 3
// (Layer II) or 1 (Layer I) output rows is one coalesced 128 B store.  A
// code is read through a 64-bit window of two big-endian shared-memory
// words; a warp's lanes split their codewords in their classes' own
// ways (grouped by constant divisors) and then requantize together, and
// the exact division by 2^(nb - 1) is a multiply.  Kept from the design's
// trials (B = 12,800, twolame's frames): a double division and the
// requantization inside each class's branch took 0.230 ms; a persistent
// grid with a two-stage ring, plain loads, whole-row copies or 128 to 768
// threads a block did not beat this one; the same loads and stores with
// no arithmetic take 0.049 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "granule_persist.cuh"

namespace {

using namespace pdmp3;

constexpr int kBody = 2000;              // ops/l12_requant.py BODY_BYTES
constexpr int kSide = 384;               // SIDE_BYTES
constexpr int kSideScf = 64, kSideOff = 256;
constexpr int kClasses = 32;
constexpr int kScfMax = 62;
constexpr int kRqThreads = 256;
constexpr int kBodyWords = (kBody + 16) / 4;  // the window reads a word on

// the nb-bit code (1 <= nb <= 16) at bit `pos` of the body's words
__device__ __forceinline__ unsigned read_code(const uint32_t* w,
                                              unsigned pos, int nb) {
  unsigned i = pos >> 5;
  if (i > kBodyWords - 2) i = kBodyWords - 2;
  const uint64_t v = ((uint64_t)__byte_perm(w[i], 0, 0x0123) << 32) |
                     __byte_perm(w[i + 1], 0, 0x0123);
  return (unsigned)((v << (pos & 31)) >> (64 - nb));
}

// parse_l1 / parse_l2's sample: scale x (C x (frac + D)), then to f32.
// frac = c / 2^(nb - 1) is exact, so the multiply by 2^(1 - nb) here
// gives the division's bits without a double division.
__device__ __forceinline__ float requant(unsigned code, int nb, double2 cd,
                                         double scale) {
  const int msb = 1 << (nb - 1);
  int c = (int)(code ^ (unsigned)msb);
  if (c >= msb) c -= 1 << nb;
  const double frac = __dmul_rn(__int2double_rn(c),
                                __hiloint2double((1024 - nb) << 20, 0));
  return __double2float_rn(
      __dmul_rn(scale, __dmul_rn(cd.x, __dadd_rn(frac, cd.y))));
}

template <int S>
__global__ void __launch_bounds__(kRqThreads) subband_requant_kernel(
    const uint8_t* __restrict__ body, const uint8_t* __restrict__ side,
    const int16_t* __restrict__ geom, float* __restrict__ sb,
    const double2* __restrict__ cd, const int4* __restrict__ ci,
    const float* __restrict__ scf_tab) {
  static_assert(S == 12 || S == 36, "Layer I or II");
  __shared__ __align__(16) uint32_t s_body[kBodyWords];
  __shared__ __align__(16) uint8_t s_side[kSide];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  const int start = __ldg(geom + 2 * n), glen = __ldg(geom + 2 * n + 1);
  if (tid == 0) {
    // the body up to its last code's byte, in whole 16-byte chunks
    int bytes = (start + 12 * glen + 7) >> 3;
    bytes = bytes <= 0 ? 0 : bytes >= kBody ? kBody : (bytes + 15) & ~15;
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&bar, kSide + bytes);
    bulk_load(s_side, side + n * kSide, kSide, &bar);
    if (bytes) bulk_load(s_body, body + n * kBody, bytes, &bar);
  }
  __syncthreads();
  mbar_wait(&bar, 0);

  const int lane = tid & 31;
  const int16_t* off = reinterpret_cast<const int16_t*>(s_side + kSideOff);
  for (int p = tid >> 5; p < 24; p += kRqThreads / 32) {
    const int ch = p / 12, g = p % 12;
    const int k = ch * 32 + lane;
    constexpr int kCodes = S / 12;  // samples a codeword (Layer II: 3)
    float* o = sb + ((n * 2 + ch) * S + kCodes * g) * 32 + lane;
    // a warp's lanes take the codes of their classes apart in their own
    // ways, then requantize together; class 0 computes a dummy code of
    // 2 bits and stores +0.0
    int c = s_side[k];
    if (c >= kClasses) c = 0;
    const int4 info = __ldg(ci + c);  // bits, grouped steps, nb
    const double2 cdc = __ldg(cd + c);
    const int bits = c ? info.x : 2, nb = c ? info.z : 2;
    const int idx = s_side[kSideScf + 3 * k + (g >> 2)];
    const double scale =
        (double)__ldg(scf_tab + (idx > kScfMax ? kScfMax : idx));
    const unsigned pos = (unsigned)(start + g * glen + off[k]);
    unsigned q[kCodes];
    if constexpr (S == 12) {
      q[0] = read_code(s_body, pos, nb);
    } else if (info.y) {  // a grouped codeword: 3, 5 or 9 steps
      const unsigned cw = read_code(s_body, pos, bits);
      if (info.y == 3) {
        q[0] = cw % 3, q[1] = cw / 3 % 3, q[2] = cw / 9 % 3;
      } else if (info.y == 5) {
        q[0] = cw % 5, q[1] = cw / 5 % 5, q[2] = cw / 25 % 5;
      } else {
        q[0] = cw % 9, q[1] = cw / 9 % 9, q[2] = cw / 81 % 9;
      }
    } else {
      for (int j = 0; j < 3; ++j)
        q[j] = read_code(s_body, pos + j * bits, bits);
    }
    for (int j = 0; j < kCodes; ++j) {
      const float v = requant(q[j], nb, cdc, scale);
      o[32 * j] = c ? v : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// Requantize n slot-frames of the coded Layer I/II wire on `stream`:
// body uint8 [n][2000] and side uint8 [n][384], both 16-byte aligned,
// geom int16 [n][2]; sb f32 [n][2][S][32] (S = 12 or 36) written whole;
// the class tables cd double2 [32], ci int4 [32] and scf float [64] on
// the device (ops/l12_requant.py device_tables).  Returns
// cudaGetLastError()'s code (0 when the launch was accepted).
int pdmp3_l12_requant(const void* body, const void* side, const void* geom,
                      void* sb, const void* cd, const void* ci,
                      const void* scf, long long n, int S, void* stream) {
  if ((S != 12 && S != 36) || n <= 0 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto fn = S == 36 ? subband_requant_kernel<36> : subband_requant_kernel<12>;
  fn<<<(unsigned)n, kRqThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(body), static_cast<const uint8_t*>(side),
      static_cast<const int16_t*>(geom), static_cast<float*>(sb),
      static_cast<const double2*>(cd), static_cast<const int4*>(ci),
      static_cast<const float*>(scf));
  return (int)cudaGetLastError();
}

}  // extern "C"
