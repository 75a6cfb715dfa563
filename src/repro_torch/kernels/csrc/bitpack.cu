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
// symbol s of a row is the bits [s * bits, s * bits + bits) of the row. out:
// (rows, row_syms) uint8; a symbol equal to `missing` (>= 0) becomes 255
// (MISSING_BIN). Integer-exact: the plain version `kernels/ref.py::
// bitpack_decode` and the host codec decode give the same bytes.
//
// What bounds it on this card: bytes. The payload is read once (bits / 8 of
// a byte a symbol) and the bins written once (a byte a symbol); the work
// between is a few integer operations a symbol. The design:
//
// - Whole groups. Eight symbols are exactly `bits` bytes in and 8 bytes out,
//   so a thread decodes a group at a time, with the width a template
//   parameter (dispatched once a launch): every shift and mask is a
//   constant, and at 8 bits the decode is a copy. The missing remap is one
//   SIMD byte compare a word (__vcmpeq4: equal bytes become 0xFF = 255). A
//   row's last group may be partial; its padding bits never reach `out`.
// - Row tiles through shared memory. A tile is R rows, R a multiple of 16
//   (`tile_rows`, from the wrapper, ~16 KB decoded), so its packed bytes and
//   its decoded bytes are each one contiguous run, a multiple of 16 long and
//   16-byte aligned when the base pointers are. One thread loads each
//   packed tile with a 1-D TMA bulk copy (cp.async.bulk, completing on an
//   mbarrier) into a ring of kStages buffers; all threads decode from
//   shared memory into a decoded tile (aligned word loads and a funnel
//   shift, so any byte offset costs the same), and one thread writes the
//   decoded tile back with a bulk store (cp.async.bulk ... bulk_group), two
//   decoded buffers in turn. Rows that end mid-vector no longer matter: the
//   copies are of whole flat tiles.
// - A persistent grid: as many blocks as fit on the SMs at this tile's
//   shared memory walk the tiles, so the loads of the next tiles and the
//   store of the last one overlap the decode of this one. A row's index and
//   in-row group come from the tile loop and one 32-bit multiply-high
//   division a group; offsets into the page are 64-bit.
// - Edges in the same kernel: the rows past the last whole tile, and the
//   whole page when a base pointer is not 16-byte aligned, a page holds no
//   whole tile, or a tile does not fit in shared memory, go through a
//   direct path that reads a group's bytes from device memory and writes
//   its symbols byte by byte. It is hand-written like the rest and runs
//   on the card; nothing falls back to the plain version.
//
// Measured by chip_smoke.py phase 11 on an NVIDIA H100 80GB HBM3 at 700 W:
// ~0.027 ms on the card for a 67,108 x 500 page at 8 bits, ~74% of its
// 0.0200 ms bytes bound and a little under one device-to-device copy of the
// decoded bytes (~0.028 ms), which is the practical floor for a pass that
// reads and writes a page; ~0.026 ms at 6 bits with missing symbols (~68%
// of 0.0175 ms) and ~0.065 ms for 200,000 x 500 at 6 bits (~80% of 0.0522).
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;       // packed tiles in flight a block
constexpr int kOutBufs = 2;      // decoded tiles: one written, one draining
constexpr int kPad = 16;         // read slack past a packed tile (aligned word loads)
constexpr int kHeader = 128;     // the ring's mbarriers, before the buffers
constexpr int kMaxBlocksPerSm = 4;
constexpr int kDirectBlocksPerSm = 8;
using guard::kMaxDevices;

// n / d for 0 <= n < 2^31 and d >= 1: a round-up multiplier and a shift
// (mul = ceil(2^p / d), p = 31 + ceil(log2 d)), exact over that range.
struct FastDiv {
  uint32_t d, mul, shr;
  __device__ explicit FastDiv(uint32_t den) : d(den), mul(0), shr(0) {
    if (den > 1) {
      const uint32_t p = 31 + (32 - __clz(den - 1));
      mul = (uint32_t)(((1ull << p) + den - 1) / den);
      shr = p - 32;
    }
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shr;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// device memory -> shared memory, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared memory -> device memory, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// every bulk store issued so far has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// this thread's shared-memory writes, visible to the bulk copies after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The eight symbols of a group, one a byte, from the group's packed bits
// (lo: bytes 0-3, hi: bytes 4-7; only the low 8 * BITS bits are read), with
// the missing symbol (mrep: it in every byte) made 255.
template <int BITS>
__device__ __forceinline__ void expand(uint32_t lo, uint32_t hi, bool has_missing,
                                       uint32_t mrep, uint32_t& o0, uint32_t& o1) {
  if constexpr (BITS == 8) {
    o0 = lo;
    o1 = hi;
  } else {
    const uint64_t v = ((uint64_t)hi << 32) | lo;
    constexpr uint64_t kMask = (1u << BITS) - 1u;
    o0 = 0;
    o1 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) o0 |= (uint32_t)((v >> (k * BITS)) & kMask) << (8 * k);
#pragma unroll
    for (int k = 0; k < 4; ++k) o1 |= (uint32_t)((v >> ((k + 4) * BITS)) & kMask) << (8 * k);
  }
  if (has_missing) {
    o0 |= __vcmpeq4(o0, mrep);
    o1 |= __vcmpeq4(o1, mrep);
  }
}

__device__ __forceinline__ void store_bytes(uint8_t* dst, uint32_t o0, uint32_t o1, int n) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < n) dst[k] = (uint8_t)((k < 4 ? o0 >> (8 * k) : o1 >> (8 * (k - 4))) & 0xFFu);
  }
}

// Rows [row_lo, rows) straight from device memory: a group's packed bytes
// read one by one (never past its row), its symbols stored one by one.
// Items (row, group) are walked by the whole grid, in chunks of rows whose
// items stay below 2^31 so that a 32-bit division splits them.
template <int BITS>
__device__ void decode_direct(const uint8_t* __restrict__ payload, uint8_t* __restrict__ out,
                              long row_lo, long rows, long row_syms, long row_bytes,
                              bool has_missing, uint32_t mrep) {
  if (row_lo >= rows) return;
  const long gpr = (row_syms + 7) >> 3;
  const long chunk_rows = gpr >= (1L << 30) ? 1L : ((1L << 31) - 1) / gpr;
  const FastDiv by_row((uint32_t)(chunk_rows > 1 ? gpr : 1));
  const long stride = (long)gridDim.x * kThreads;
  for (long r0 = row_lo; r0 < rows; r0 += chunk_rows) {
    const long n_items = (rows - r0 < chunk_rows ? rows - r0 : chunk_rows) * gpr;
    for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < n_items; i += stride) {
      long r = r0, g = i;
      if (chunk_rows > 1) {
        const uint32_t q = by_row.div((uint32_t)i);
        r += q;
        g = i - (long)q * gpr;
      }
      const uint8_t* src = payload + r * row_bytes + g * BITS;
      const long left = row_bytes - g * BITS;
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int b = 0; b < BITS; ++b) {
        if (b < left) {
          const uint32_t x = __ldg(src + b);
          if (b < 4) lo |= x << (8 * b);
          else hi |= x << (8 * (b - 4));
        }
      }
      uint32_t o0, o1;
      expand<BITS>(lo, hi, has_missing, mrep, o0, o1);
      const long n_out = row_syms - g * 8;
      store_bytes(out + r * row_syms + g * 8, o0, o1, n_out < 8 ? (int)n_out : 8);
    }
  }
}

// n_tiles whole tiles of tile_rows rows go through shared memory (blocks
// walk tiles blockIdx.x, + gridDim.x, ...); the rows after them go through
// the direct path. n_tiles == 0: every row goes direct.
template <int BITS>
__global__ void __launch_bounds__(kThreads) bitpack_decode_kernel(
    const uint8_t* __restrict__ payload, long rows, long row_syms, long row_bytes, int missing,
    int tile_rows, long n_tiles, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const bool has_missing = missing >= 0;
  const uint32_t mrep = has_missing ? (uint32_t)missing * 0x01010101u : 0u;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const uint32_t in_tile = (uint32_t)(tile_rows * row_bytes);
  const uint32_t out_tile = (uint32_t)(tile_rows * row_syms);
  const uint32_t in_stride = in_tile + kPad;
  uint8_t* in_buf = smem + kHeader;
  uint8_t* out_buf = in_buf + kStages * in_stride;

  if (n_tiles > 0) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        const long t = blockIdx.x + (long)s * gridDim.x;
        if (t < n_tiles) {
          mbar_expect_tx(&bar[s], in_tile);
          bulk_load(in_buf + s * in_stride, payload + t * (long)in_tile, in_tile, &bar[s]);
        }
      }
    }
    __syncthreads();
  }
  // while the first tiles load: the rows after the last whole tile
  decode_direct<BITS>(payload, out, n_tiles * tile_rows, rows, row_syms, row_bytes,
                      has_missing, mrep);
  if (n_tiles == 0) return;

  const uint32_t gpr = (uint32_t)((row_syms + 7) >> 3);
  const uint32_t n_items = (uint32_t)tile_rows * gpr;
  const uint32_t rs = (uint32_t)row_syms, rb = (uint32_t)row_bytes;
  const FastDiv by_row(gpr);
  const bool words = (rs & 3u) == 0;  // every full group starts on a 4-byte boundary
  int it = 0;
  for (long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = it % kStages;
    const uint8_t* src = in_buf + s * in_stride;
    uint8_t* dst = out_buf + (it & 1) * out_tile;
    mbar_wait(&bar[s], (uint32_t)(it / kStages) & 1u);
    for (uint32_t i = tid; i < n_items; i += kThreads) {
      const uint32_t r = by_row.div(i);
      const uint32_t g = i - r * gpr;
      const uint32_t off = r * rb + g * BITS;
      // the group's bytes from the aligned words under them (the slack
      // after the tile covers the last group's reads)
      const uint32_t* w = reinterpret_cast<const uint32_t*>(src + (off & ~3u));
      const uint32_t sh = (off & 3u) * 8u;
      const uint32_t w0 = w[0], w1 = w[1];
      const uint32_t lo = __funnelshift_r(w0, w1, sh);
      uint32_t hi = 0;
      if constexpr (BITS > 4) hi = __funnelshift_r(w1, w[2], sh);
      uint32_t o0, o1;
      expand<BITS>(lo, hi, has_missing, mrep, o0, o1);
      const uint32_t o = r * rs + g * 8u;
      const uint32_t n_out = rs - g * 8u;
      if (n_out >= 8u && words) {
        reinterpret_cast<uint32_t*>(dst + o)[0] = o0;
        reinterpret_cast<uint32_t*>(dst + o)[1] = o1;
      } else {
        store_bytes(dst + o, o0, o1, n_out < 8u ? (int)n_out : 8);
      }
    }
    fence_proxy_async();
    if (tid == 0) bulk_wait_read();  // the last tile's store has read the other buffer
    __syncthreads();                 // this tile decoded, its packed stage free
    if (tid == 0) {
      bulk_store(out + t * (long)out_tile, dst, out_tile);
      const long next = t + (long)kStages * gridDim.x;
      if (next < n_tiles) {
        mbar_expect_tx(&bar[s], in_tile);
        bulk_load(in_buf + s * in_stride, payload + next * (long)in_tile, in_tile, &bar[s]);
      }
    }
  }
  if (tid == 0) bulk_wait_all();
}

// per device: SMs, the opt-in shared memory a block, and per width whether
// the kernel's limit was raised and its resident blocks at the last size
struct DeviceState {
  int sms = 0;
  int smem_optin = 0;
  bool raised[9] = {};
  size_t occ_smem[9] = {};
  int occ_blocks[9] = {};
};
DeviceState g_state[kMaxDevices];

template <int BITS>
int launch(const uint8_t* payload, long rows, long row_syms, long row_bytes, int missing,
           long tile_rows, uint8_t* out, int dev, cudaStream_t stream) {
  if (tile_rows < 16 || tile_rows % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  DeviceState& st = g_state[dev];
  if (st.sms == 0) {
    err = cudaDeviceGetAttribute(&st.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = bitpack_decode_kernel<BITS>;
  if (!st.raised[BITS]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               st.smem_optin);
    if (err != cudaSuccess) return (int)err;
    st.raised[BITS] = true;
  }
  const long in_tile = tile_rows * row_bytes, out_tile = tile_rows * row_syms;
  size_t smem = (size_t)(kHeader + kStages * (in_tile + kPad) + kOutBufs * out_tile);
  const bool aligned = ((uintptr_t)payload & 15u) == 0 && ((uintptr_t)out & 15u) == 0;
  const long n_tiles = aligned && smem <= (size_t)st.smem_optin ? rows / tile_rows : 0;
  long blocks;
  if (n_tiles > 0) {
    if (st.occ_smem[BITS] != smem) {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
      if (err != cudaSuccess) return (int)err;
      st.occ_blocks[BITS] = per_sm < 1 ? 1 : (per_sm > kMaxBlocksPerSm ? kMaxBlocksPerSm : per_sm);
      st.occ_smem[BITS] = smem;
    }
    blocks = (long)st.sms * st.occ_blocks[BITS];
    if (blocks > n_tiles) blocks = n_tiles;
  } else {
    smem = 0;
    const long items = rows * ((row_syms + 7) / 8);
    blocks = (items + kThreads - 1) / kThreads;
    const long cap = (long)st.sms * kDirectBlocksPerSm;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(payload, rows, row_syms, row_bytes,
                                                       missing, (int)tile_rows, n_tiles, out);
  return (int)cudaGetLastError();
}

}  // namespace

// payload (rows, row_bytes) uint8 and out (rows, row_syms) uint8, both
// row-major and contiguous; 1 <= bits <= 8, row_bytes == ceil(row_syms *
// bits / 8); missing is the packed missing symbol, or -1 for none;
// tile_rows (a multiple of 16) is the rows of one staged tile. The launch
// runs on ``device``, the tensors' (guard::on_device), on its stream
// stream_ptr.
extern "C" int bitpack_decode_launch(const uint8_t* payload, long rows, long row_syms,
                                     long row_bytes, int bits, int missing, long tile_rows,
                                     uint8_t* out, int device, void* stream_ptr) {
  return guard::on_device(device, [&]() -> int {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
#define BITPACK_LAUNCH(B) \
  launch<B>(payload, rows, row_syms, row_bytes, missing, tile_rows, out, device, stream)
    switch (bits) {
      case 1: return BITPACK_LAUNCH(1);
      case 2: return BITPACK_LAUNCH(2);
      case 3: return BITPACK_LAUNCH(3);
      case 4: return BITPACK_LAUNCH(4);
      case 5: return BITPACK_LAUNCH(5);
      case 6: return BITPACK_LAUNCH(6);
      case 7: return BITPACK_LAUNCH(7);
      case 8: return BITPACK_LAUNCH(8);
      default: return (int)cudaErrorInvalidValue;
    }
#undef BITPACK_LAUNCH
  });
}
