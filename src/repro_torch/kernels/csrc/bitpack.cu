// Bitpack page decode for Hopper (sm_90a): packed ELLPACK symbols -> uint8 bins.
//
// Replaces no Pallas kernel: the reference expands a staged bitpack payload
// with jnp ops (src/repro/compress/codecs.py::BitpackCodec.device_decode),
// which gather a (rows, row_syms, bits) int32 plane of every symbol's bits
// and sum it with weights. For one 67,108 x 500 page at 8 bits those planes
// alone are 1.07 GB, twice the streaming budget the codec is meant to
// relieve; this kernel reads each packed byte and writes each symbol once,
// with no temporaries.
//
// payload: (rows, row_bytes) uint8, row_bytes = ceil(row_syms * bits / 8);
// each row is packed on its own, little-endian from bit 0 of its first byte:
// symbol s of a row is the bits [s * bits, s * bits + bits) of the row. With
// bits <= 8 a symbol spans at most two bytes. out: (rows, row_syms) uint8;
// a symbol equal to `missing` (>= 0) becomes 255 (MISSING_BIN). Integer-
// exact: the plain version `kernels/ref.py::bitpack_decode` and the host
// codec decode give the same bytes.
//
// What bounds it on this card: bytes. The work is a shift and a mask a
// symbol; the payload is read once (bits / 8 of a byte a symbol) and the
// bins written once (a byte a symbol). Each thread decodes four consecutive
// symbols of one row, so a warp writes 128 consecutive bytes of a row and
// reads the few dozen packed bytes under them, which the L1 serves to the
// neighbouring threads. A simple kernel first; it is not tuned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSymsPerThread = 4;
constexpr int kMissingBin = 255;

__global__ void __launch_bounds__(kThreads) bitpack_decode_kernel(
    const uint8_t* __restrict__ payload, long rows, long row_syms, long row_bytes, int bits,
    int missing, uint8_t* __restrict__ out) {
  const long quads_per_row = (row_syms + kSymsPerThread - 1) / kSymsPerThread;
  const long n_quads = rows * quads_per_row;
  const unsigned mask = (1u << bits) - 1u;
  for (long q = (long)blockIdx.x * kThreads + threadIdx.x; q < n_quads;
       q += (long)gridDim.x * kThreads) {
    const long r = q / quads_per_row;
    const long s0 = (q - r * quads_per_row) * kSymsPerThread;
    const uint8_t* row = payload + r * row_bytes;
    uint8_t* dst = out + r * row_syms;
#pragma unroll
    for (int k = 0; k < kSymsPerThread; ++k) {
      const long s = s0 + k;
      if (s >= row_syms) break;
      const long bit = s * bits;
      const long byte = bit >> 3;
      unsigned word = __ldg(row + byte);
      if (byte + 1 < row_bytes) word |= (unsigned)__ldg(row + byte + 1) << 8;
      const unsigned v = (word >> (bit & 7)) & mask;
      dst[s] = (uint8_t)(((int)v == missing) ? kMissingBin : v);
    }
  }
}

}  // namespace

// payload (rows, row_bytes) uint8 and out (rows, row_syms) uint8, both
// row-major and contiguous; 1 <= bits <= 8, row_bytes == ceil(row_syms *
// bits / 8); missing is the packed missing symbol, or -1 for none.
extern "C" int bitpack_decode_launch(const uint8_t* payload, long rows, long row_syms,
                                     long row_bytes, int bits, int missing, uint8_t* out,
                                     int n_sms, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long quads = rows * ((row_syms + kSymsPerThread - 1) / kSymsPerThread);
  long blocks = (quads + kThreads - 1) / kThreads;
  const long cap = (long)n_sms * 8;  // grid-stride past 8 blocks an SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  bitpack_decode_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      payload, rows, row_syms, row_bytes, bits, missing, out);
  return (int)cudaGetLastError();
}
