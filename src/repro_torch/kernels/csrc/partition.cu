// Row repartition for Hopper (sm_90a): one thread per row, with the next
// level's row counts folded into the same pass.
//
// Replaces: src/repro/kernels/partition.py::partition_rows
//           (Pallas `_partition_kernel`, one-hot MXU gathers of node fields),
//           and the separate count of rows per window node that followed it
//           (`level_row_counts`, src/repro/core/histcache.py).
//
// Per row r with position p = pos[r]:
//   p < 0         -> -1 (inactive row)
//   is_leaf[p]    -> p  (rows freeze at leaves)
//   otherwise     -> 2p + 1 + !go_left, where b = bins[r, feature[p]] and
//                    go_left = default_left[p] if b == 255 else b <= split_bin[p].
// Node lookups clamp p into [0, n_nodes), as the reference's gathers do.
// With a window (offset, count > 0), every row whose new position np has
// offset <= np < offset + count also adds 1 to counts[np - offset]; counts
// is the caller's and is added into, so one buffer zeroed once per level
// sums a level's counts over the pages of a stream pass. Integer-exact and
// order-free (integer atomics), so positions and counts match the plain
// version bit for bit.
//
// The TPU has no per-lane gathers, so the Pallas kernel gathered node fields
// through one-hot matmuls over the whole node table. Here each thread does
// the gathers directly.
//
// What bounds it on this card: bytes. A row reads its position (4 B) and
// writes the new one (4 B); a row that moves also reads one bin of its row.
// Rows are m bytes apart, so each moving row costs the DRAM a whole access
// for that one byte: at 1M rows 32 MB or more beside 8 MB of positions,
// however the kernel is arranged; a PyTorch gather of one byte a row is no
// faster. A thread a row, consecutive threads on consecutive rows so the
// position loads and stores coalesce, already sits at that floor: the node
// tables stay in L1, and tiles of several rows a thread or node records
// staged in shared memory timed no faster on the H100. What the separate
// pass cost was the next level's row counts (`level_row_counts`, about
// seven eager ops over int64 temporaries of the whole row set, per page when
// streaming). They are folded in here: equal window slots of a warp are
// merged (__match_any_sync) and the warp's leader adds them into per-block
// shared counters, flushed with one global atomicAdd per nonzero slot at
// the end; windows wider than kSmemCounts add into the global counters
// directly.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kMissingBin = 255;
constexpr int kThreads = 256;
constexpr int kSmemCounts = 2048;  // window slots counted in shared memory (8 KB)

template <typename BinT>
__global__ void __launch_bounds__(kThreads) partition_kernel(
    const BinT* __restrict__ bins, long n_rows, int m, const int32_t* __restrict__ pos_in,
    const int32_t* __restrict__ feature, const int32_t* __restrict__ split_bin,
    const uint8_t* __restrict__ default_left, const uint8_t* __restrict__ is_leaf,
    int n_nodes, int32_t* __restrict__ pos_out, long offset, int count,
    int32_t* __restrict__ counts) {
  __shared__ int32_t shared_counts[kSmemCounts];
  const long r = (long)blockIdx.x * kThreads + threadIdx.x;
  int np = -1;
  if (r < n_rows) {
    const int p = pos_in[r];
    if (p >= 0) {
      const int q = p < n_nodes ? p : n_nodes - 1;
      if (is_leaf[q]) {
        np = p;
      } else {
        int f = feature[q];
        f = f < 0 ? 0 : (f < m ? f : m - 1);
        const int b = (int)bins[r * m + f];
        const bool go_left =
            (b == kMissingBin) ? (default_left[q] != 0) : (b <= split_bin[q]);
        np = 2 * p + 1 + (go_left ? 0 : 1);
      }
    }
    pos_out[r] = np;
  }
  if (count == 0) return;  // uniform over the grid
  const bool shared = count <= kSmemCounts;
  if (shared) {
    for (int i = threadIdx.x; i < count; i += kThreads) shared_counts[i] = 0;
    __syncthreads();
  }
  // every lane of the warp reaches the match: rows past n_rows carry key -1
  const long lp = (long)np - offset;
  const int key = (np >= 0 && lp >= 0 && lp < count) ? (int)lp : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd((shared ? shared_counts : counts) + key, __popc(peers));
  }
  if (shared) {
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += kThreads) {
      if (shared_counts[i]) atomicAdd(counts + i, shared_counts[i]);
    }
  }
}

}  // namespace

// bins: (n_rows, m) uint8 (bins_u8 == 1) or int32, row-major; node tables
// (n_nodes,); pos_in, pos_out: (n_rows,) int32. count > 0 adds the rows of
// the window [offset, offset + count) into counts (count,) int32; count == 0
// counts nothing and counts may be null. The launch runs on ``device``, the
// tensors' (guard::on_device), on its stream stream_ptr.
extern "C" int partition_launch(const void* bins, int bins_u8, long n_rows, int m,
                                const int32_t* pos_in, const int32_t* feature,
                                const int32_t* split_bin, const uint8_t* default_left,
                                const uint8_t* is_leaf, int n_nodes, int32_t* pos_out,
                                long offset, int count, int32_t* counts, int device,
                                void* stream_ptr) {
  return guard::on_device(device, [&]() -> int {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int blocks = (int)((n_rows + kThreads - 1) / kThreads);
    if (bins_u8) {
      partition_kernel<uint8_t><<<blocks, kThreads, 0, stream>>>(
          (const uint8_t*)bins, n_rows, m, pos_in, feature, split_bin, default_left, is_leaf,
          n_nodes, pos_out, offset, count, counts);
    } else {
      partition_kernel<int32_t><<<blocks, kThreads, 0, stream>>>(
          (const int32_t*)bins, n_rows, m, pos_in, feature, split_bin, default_left, is_leaf,
          n_nodes, pos_out, offset, count, counts);
    }
    return (int)cudaGetLastError();
  });
}
