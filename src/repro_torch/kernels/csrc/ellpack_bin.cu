// ELLPACK quantisation (paper Alg. 4, LookupBin) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ellpack_bin.py::bin_values
//           (Pallas `_bin_kernel`, a broadcast compare of every value
//           against all of its feature's edges, summed on the VPU).
//
// Computes, for raw values x (n, m) and +inf-padded right edges (m, B):
//   out[r, f] = 255                                   if x[r, f] is NaN
//             = min(#{k : edges[f, k] < x[r, f]}, n_bins[f] - 1)   otherwise
// cast to uint8. The edges of a feature are non-decreasing (strictly
// increasing real edges, then +inf padding), so the count of edges below x
// is a lower bound found by binary search, and it equals the TPU kernel's
// compare-count #{k : x > edges[f, k]} exactly (the padding is never below
// x).
//
// The comparison runs in the input's own type: a float64 input is compared
// against the float32 edges widened exactly to float64, as numpy's
// `searchsorted(edges_f32, x_f64)` does in the host binning. Casting x to
// float32 first would move a value just above an edge onto it.
//
// What bounds it on this card: bytes. Each value is read once (4 or 8 B)
// and its bin written once (1 B): 168 MB for a 67,108 x 500 f32 page, 50 us
// at 3.35 TB/s. A block can hold the edges of only some features (255 f32
// edges a feature, 32 KB for 32 features), so it reads and writes a slice of
// each row, and how wide that slice is decides how close the DRAM gets to its
// rate; beside that, a value costs log2(B) shared-memory probes that depend
// on each other. The design:
//   * a block owns up to 4 sub-tiles of 32 features (one a lane), as many as
//     the shared-memory budget holds with their edges (4 at up to 256 edges),
//     so it reads 512 B of each f32 row and writes 128 B; and a long run of
//     rows (one wave of blocks over the card), so each sub-tile's edges are
//     staged once for thousands of rows;
//   * the edges sit k-major in shared memory, table[k][lane]: whatever edge
//     index k a lane's search is at, its word is in the lane's own bank. They
//     are staged through a padded 32 x 33 transpose, so the staging reads are
//     coalesced and its shared stores conflict-free too. Each table is padded
//     with +inf to a power of two less one rows, so the search runs a fixed
//     number of steps, each a shared load at a constant offset from the
//     row the search has reached, with no bounds check; the first probe, the
//     same edge for every value of a lane, sits in a register;
//   * values arrive by cp.async into a kStages-deep ring: each thread copies
//     the values it will search (a warp copies 32 neighbouring features of a
//     row, 128 or 256 B, and the block's sub-tiles the neighbouring pieces),
//     so a thread waits on its own copy groups and the loop needs no block
//     barrier;
//   * each thread runs 4 (f32) or 2 (f64) searches interleaved, step by
//     step, with 32 warps an SM;
//   * a warp stores 32 neighbouring bins of one row (32 B) per instruction.
// The shared-memory limit is raised, and the blocks an SM read, once per
// device and table width.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kMissingBin = 255;
constexpr int kLanes = 32;     // features of a sub-tile, one a lane
constexpr int kRowWarps = 8;   // warps a sub-tile, each vals_of<T>() rows of a stage
constexpr int kStages = 3;
constexpr int kMaxEdges = 1024;  // the wrapper's MAX_EDGES
constexpr int kMaxLogP = 10;     // 2^10 = kMaxEdges
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may hold
using guard::kMaxDevices;

int g_resident[2][kMaxLogP + 1][kMaxDevices];  // [x is f64][log_p][device] blocks, once

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Edge rows a sub-tile stages for a table max_bin wide: the search needs
// the first max_bin - 1 edges only (see below), padded with +inf to
// 2^log_p - 1 rows, 2^log_p being the least power of two >= max_bin.
__host__ __device__ constexpr int search_log(int max_bin) {
  int log_p = 0;
  while ((1 << log_p) < max_bin) ++log_p;
  return log_p;
}

__host__ __device__ constexpr size_t table_bytes(int log_p) {
  return (size_t)((1 << log_p) - 1) * kLanes * sizeof(float);
}

// rows a thread searches together: 4 f32 or 2 f64 values, 16 bytes
template <typename T>
__host__ __device__ constexpr int vals_of() {
  return 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t ring_bytes(int n_sub) {
  return (size_t)kStages * kRowWarps * vals_of<T>() * n_sub * kLanes * sizeof(T);
}

// Sub-tiles a block holds: as many of 4 as fit the shared-memory budget
// with their value ring (4 at up to 256 edges, fewer for wider tables).
template <typename T>
__host__ __device__ constexpr int sub_tiles(int log_p) {
  int n = 4;
  while (n > 1 && n * table_bytes(log_p) + ring_bytes<T>(n) > kSmemBudget) n /= 2;
  return n;
}

template <typename T, int kLogP>
__global__ void __launch_bounds__(kRowWarps * 4 * 32) bin_kernel(
    const T* __restrict__ x, long n_rows, int m, const float* __restrict__ edges, int max_bin,
    const int32_t* __restrict__ n_bins, uint8_t* __restrict__ out, long rows_per_block) {
  constexpr int kSub = sub_tiles<T>(kLogP);
  constexpr int kVals = vals_of<T>();
  constexpr int kStageRows = kRowWarps * kVals;
  constexpr int kRows = (1 << kLogP) - 1;  // staged edge rows of a sub-tile
  constexpr int kWidth = kSub * kLanes;    // features of the block
  constexpr int kWarps = kSub * kRowWarps;
  constexpr size_t kTableBytes = (table_bytes(kLogP) + 15) / 16 * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tables = reinterpret_cast<float*>(smem);            // [kSub][kRows][32]
  T* ring = reinterpret_cast<T*>(smem + kSub * kTableBytes);  // [kStages][kStageRows][kWidth]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * kWidth;
  const int nf = min(kWidth, m - f0);

  // edges[f0 + j, k] -> table j / 32, row k, lane j % 32 (+inf from
  // k = max_bin on), 32 edge indices at a time through a padded transpose
  // in the unused ring, one 32 x 33 buffer a sub-tile
  float* tmp = reinterpret_cast<float*>(ring);  // [kSub][32][33]
  for (int kb = 0; kb < kRows; kb += 32) {
    const int k = kb + lane;
    for (int j = warp; j < nf; j += kWarps) {
      tmp[(j >> 5) * 32 * 33 + (j & 31) * 33 + lane] =
          k < max_bin ? edges[(long)(f0 + j) * max_bin + k] : __int_as_float(0x7f800000);
    }
    __syncthreads();
    for (int i = warp; i < kSub * 32; i += kWarps) {
      const int sub = i >> 5, kk = i & 31;
      if (kb + kk < kRows && sub * 32 + lane < nf) {
        tables[(sub * (kTableBytes / sizeof(float))) + (kb + kk) * kLanes + lane] =
            tmp[sub * 32 * 33 + lane * 33 + kk];
      }
    }
    __syncthreads();
  }

  // warp -> (sub-tile, row warp): the kSub warps of a row warp read
  // neighbouring 128 B (f32) pieces of the same rows
  const int sub = warp % kSub, row_warp = warp / kSub;
  const long r_begin = (long)blockIdx.x * rows_per_block;
  const long r_end = r_begin + rows_per_block < n_rows ? r_begin + rows_per_block : n_rows;
  const int fl = sub * kLanes + lane;  // feature within the block
  if (fl >= nf || r_begin >= r_end) return;  // no block barrier below
  const int f = f0 + fl;
  const int last = max(n_bins[f] - 1, 0);
  const int n_chunks = (int)((r_end - r_begin + kStageRows - 1) / kStageRows);
  const long warp_row0 = r_begin + (long)row_warp * kVals;
  constexpr int kHalf = (1 << kLogP) >> 1;  // the first step
  constexpr uint32_t kRowBytes = kLanes * sizeof(float);
  // this lane's edges, k-major: whatever row k a search is at, the word is
  // in the lane's own bank
  const uint32_t col = smem_addr(smem + sub * kTableBytes) + lane * sizeof(float);
  // the first probe of every search is the same edge: keep it in a register
  const T first = kHalf ? (T)lds(col + (kHalf - 1) * kRowBytes) : T(0);

  // the thread's values of chunk c, rows row_warp * kVals + v of the chunk
  // and feature f, into ring stage c % kStages; one commit group a chunk,
  // empty past the last, so the wait below always counts kStages - 1
  const T* x_warp = x + warp_row0 * m + f;
  uint8_t* out_warp = out + warp_row0 * m + f;
  const long chunk_step = (long)kStageRows * m;
  const int rows_left0 = (int)(r_end - warp_row0);  // may be <= 0
  auto issue = [&](int c) {
    const int rows = rows_left0 - c * kStageRows;  // of this warp's kVals
    if (c < n_chunks) {
      T* dst = ring + ((c % kStages) * kStageRows + row_warp * kVals) * kWidth + fl;
      const T* src = x_warp + c * chunk_step;
#pragma unroll
      for (int v = 0; v < kVals; ++v) {
        if (v < rows) cp_async<sizeof(T)>(dst + v * kWidth, src + v * m);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kStages - 1);  // into the stage this thread finished reading last chunk
    cp_async_wait<kStages - 1>();
    const T* src = ring + ((c % kStages) * kStageRows + row_warp * kVals) * kWidth + fl;
    const int rows = rows_left0 - c * kStageRows;
    T val[kVals];
    uint32_t at[kVals];  // col + a row of edges for each edge found below the value
#pragma unroll
    for (int v = 0; v < kVals; ++v) {
      val[v] = src[v * kWidth];  // past the last row: a stale value, never stored
      at[v] = col + (first < val[v] ? kHalf * kRowBytes : 0u);
    }
    // binary lifting over the staged rows, steps kHalf / 2 .. 1, each a
    // shared load at a constant offset from at[v]. It counts the edges below
    // the value among the first min(max_bin, 2^kLogP - 1); the uncounted
    // last edge matters only when all others are below the value, and then
    // the clamp to n_bins - 1 <= max_bin - 1 gives the same bin.
#pragma unroll
    for (int step = kHalf >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int v = 0; v < kVals; ++v) {
        if ((T)lds(at[v] + (step - 1) * kRowBytes) < val[v]) at[v] += step * kRowBytes;
      }
    }
    uint8_t* dst = out_warp + c * chunk_step;
#pragma unroll
    for (int v = 0; v < kVals; ++v) {
      if (v < rows) {
        const int pos = (int)((at[v] - col) / kRowBytes);
        dst[v * m] = val[v] != val[v] ? (uint8_t)kMissingBin : (uint8_t)min(pos, last);
      }
    }
  }
}

template <typename T, int kLogP>
int launch(const void* x, long n_rows, int m, const float* edges, int max_bin,
           const int32_t* n_bins, uint8_t* out, int dev, cudaStream_t stream) {
  static_assert(kLogP <= kMaxLogP, "edge table wider than MAX_EDGES");
  constexpr int kSub = sub_tiles<T>(kLogP);
  constexpr int kThreads = kSub * kRowWarps * 32;
  constexpr int kStageRows = kRowWarps * vals_of<T>();
  cudaError_t err = cudaSuccess;
  const size_t smem = kSub * ((table_bytes(kLogP) + 15) / 16 * 16) + ring_bytes<T>(kSub);
  // once per device: raise the shared-memory limit, read the resident
  // blocks an SM at this table width
  int& resident = g_resident[sizeof(T) == 8][kLogP][dev];
  if (resident == 0) {
    err = cudaFuncSetAttribute(bin_kernel<T, kLogP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bin_kernel<T, kLogP>,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  // one wave: as many row groups as fit beside the feature tiles, each
  // group's rows a whole number of ring stages
  const long n_tiles = (m + kSub * kLanes - 1) / (kSub * kLanes);
  const long groups = resident / n_tiles > 0 ? resident / n_tiles : 1;
  long rows_per_block = (n_rows + groups - 1) / groups;
  rows_per_block = (rows_per_block + kStageRows - 1) / kStageRows * kStageRows;
  const dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block), (unsigned)n_tiles);
  bin_kernel<T, kLogP><<<grid, kThreads, smem, stream>>>(
      (const T*)x, n_rows, m, edges, max_bin, n_bins, out, rows_per_block);
  return (int)cudaGetLastError();
}

template <typename T, int kLogP = 0>
int dispatch(int log_p, const void* x, long n_rows, int m, const float* edges, int max_bin,
             const int32_t* n_bins, uint8_t* out, int dev, cudaStream_t stream) {
  if constexpr (kLogP > kMaxLogP) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (log_p == kLogP) {
      return launch<T, kLogP>(x, n_rows, m, edges, max_bin, n_bins, out, dev, stream);
    }
    return dispatch<T, kLogP + 1>(log_p, x, n_rows, m, edges, max_bin, n_bins, out, dev,
                                  stream);
  }
}

}  // namespace

// x: (n_rows, m) float32 (x_f64 == 0) or float64 (x_f64 == 1), row-major;
// edges: (m, max_bin) float32, 1 <= max_bin <= 1024; n_bins: (m,) int32;
// out: (n_rows, m) uint8. The launch runs on ``device``, the tensors'
// (guard::on_device), on its stream stream_ptr.
extern "C" int ellpack_bin_launch(const void* x, int x_f64, long n_rows, int m,
                                  const float* edges, int max_bin,
                                  const int32_t* n_bins, uint8_t* out, int device,
                                  void* stream_ptr) {
  if (max_bin < 1 || max_bin > kMaxEdges) return (int)cudaErrorInvalidValue;
  return guard::on_device(device, [&]() -> int {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int log_p = search_log(max_bin);
    if (x_f64) {
      return dispatch<double>(log_p, x, n_rows, m, edges, max_bin, n_bins, out, device, stream);
    }
    return dispatch<float>(log_p, x, n_rows, m, edges, max_bin, n_bins, out, device, stream);
  });
}
