// The widening of the coded MPEG-1 Layer III wire for NVIDIA Hopper
// (sm_90a): K10, widen_lines_kernel.
//
// Replaces no TPU kernel: the JAX package ships each granule-channel's
// 576 spectral lines as int16 (the native packer pdmp3_parse_step_wire16,
// 1,152 B a row).  The port's MPEG-1 pool ships a 4-bit code a line and
// an escape list for the lines outside -7..7 (host/src/wire_l3_codes.cc,
// about 300 B a row on a 128 kbps stream), and this kernel widens the
// rows on the card into the int16 rows K1, K2 and K5 read, bit for bit
// the dense packer's.  Plain PyTorch twin:
// pdmp3_tpu_torch/ops/l3_expand.py:l3_expand_ref.
//
// Per row r: codes[r] (288 B: line 2k in the low nibble of byte k, line
// 2k + 1 in the high one), starts[r] (int32, the row's first escape in
// esc).  A code of -7..7 is the line's value; the code 0x8 marks an
// escape, whose value is the row's next entry of esc, in line order.  An
// escape outside esc[0, n_esc) reads 0.  Output ix int16 [r][576].
//
// What bounds it.  Per row 292 B in and 1,152 B out, plus the row's
// escapes (about 9 a row, 2 B each, on a 128 kbps stream): at B = 12,800
// (51,200 rows) about 75 MB, 0.022 ms at 3.35 TB/s; the arithmetic is a
// few integer operations a line, so bytes set the bound, and the stores
// are four fifths of them.  The design keeps every load and store whole
// and coalesced: one warp a row, eight rows a block of 256 threads; a
// row is 72 chunks of 8 lines, lane l takes chunks l, l + 32 and l + 64,
// so each of the warp's three passes loads 128 contiguous bytes of codes
// (4 B a lane) and stores 512 contiguous bytes of lines (16 B a lane).
// A chunk's escapes are counted with a nibble test and one popcount, and
// a warp scan of the counts in chunk order gives each lane the index of
// its first escape; the escapes are the only gathered loads, and the
// scan is on registers alone, so the row needs no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunks = 72;          // 8-line chunks a row of 576 lines
constexpr int kExThreads = 256;      // 8 warps: 8 rows a block
constexpr int kRowsPerBlock = kExThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned pack2(int lo, int hi) {
  return (unsigned)(lo & 0xffff) | ((unsigned)hi << 16);
}

__global__ void __launch_bounds__(kExThreads) widen_lines_kernel(
    const uint32_t* __restrict__ codes, const int32_t* __restrict__ starts,
    const int16_t* __restrict__ esc, long long n_esc, int4* __restrict__ ix,
    long long rows) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const uint32_t* c = codes + row * kChunks;
  uint32_t w[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int k = lane + 32 * j;
    w[j] = k < kChunks ? __ldg(c + k) : 0u;  // past the row: no escapes
  }
  long long at = __ldg(starts + row);
  int4* o = ix + row * kChunks;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    // a nibble of 8 becomes 0 under the xor; bit 3 of each nibble of nz
    // is set where the nibble is not 0, so mark holds the escapes
    const uint32_t x = w[j] ^ 0x88888888u;
    const uint32_t nz = ((x & 0x77777777u) + 0x77777777u) | x;
    const int n = __popc(~nz & 0x88888888u);
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    long long e = at + incl - n;
    int v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned nib = (w[j] >> (4 * i)) & 0xfu;
      v[i] = (int)(nib ^ 8u) - 8;
      if (nib == 8u) {
        v[i] = (unsigned long long)e < (unsigned long long)n_esc
                   ? (int)__ldg(esc + e)
                   : 0;
        ++e;
      }
    }
    const int k = lane + 32 * j;
    if (k < kChunks)
      o[k] = make_int4((int)pack2(v[0], v[1]), (int)pack2(v[2], v[3]),
                       (int)pack2(v[4], v[5]), (int)pack2(v[6], v[7]));
    at += __shfl_sync(kFull, incl, 31);
  }
}

}  // namespace

extern "C" {

// Widen `rows` rows of the coded MPEG-1 wire on `stream`: codes uint8
// [rows][288] (4-byte aligned), starts int32 [rows], esc int16 [n_esc];
// ix int16 [rows][576] (16-byte aligned) written whole.  Returns
// cudaGetLastError()'s code (0 when the launch was accepted).
int pdmp3_l3_expand(const void* codes, const void* starts, const void* esc,
                    long long n_esc, void* ix, long long rows, void* stream) {
  if (rows <= 0 || n_esc < 0 ||
      (rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  widen_lines_kernel<<<grid, kExThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(codes), static_cast<const int32_t*>(starts),
      static_cast<const int16_t*>(esc), n_esc, static_cast<int4*>(ix), rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
