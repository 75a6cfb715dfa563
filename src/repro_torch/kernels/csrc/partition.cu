// Row repartition for Hopper (sm_90a): one thread per row.
//
// Replaces: src/repro/kernels/partition.py::partition_rows
//           (Pallas `_partition_kernel`, one-hot MXU gathers of node fields).
//
// Per row r with position p = pos[r]:
//   p < 0         -> -1 (inactive row)
//   is_leaf[p]    -> p  (rows freeze at leaves)
//   otherwise     -> 2p + 1 + !go_left, where b = bins[r, feature[p]] and
//                    go_left = default_left[p] if b == 255 else b <= split_bin[p].
// Node lookups clamp p into [0, n_nodes), as the reference's gathers do.
// Integer-exact, so it matches the plain version bit for bit.
//
// The TPU has no per-lane gathers, so the Pallas kernel gathered node fields
// through one-hot matmuls over the whole node table. Here each thread does
// the two gathers directly.
//
// What bounds it on this card: bytes. Each row reads pos (4 B), writes the
// new position (4 B) and reads one bin byte of its row, which costs one
// 32-byte sector per row since rows are m bytes apart; the node tables are a
// few KiB and stay in L1/L2. Consecutive threads take consecutive rows so
// the pos reads and writes coalesce.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMissingBin = 255;

template <typename BinT>
__global__ void partition_kernel(const BinT* __restrict__ bins, int n_rows, int m,
                                 const int32_t* __restrict__ pos_in,
                                 const int32_t* __restrict__ feature,
                                 const int32_t* __restrict__ split_bin,
                                 const uint8_t* __restrict__ default_left,
                                 const uint8_t* __restrict__ is_leaf, int n_nodes,
                                 int32_t* __restrict__ pos_out) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int p = pos_in[r];
  if (p < 0) {
    pos_out[r] = -1;
    return;
  }
  const int q = p < n_nodes ? p : n_nodes - 1;
  if (is_leaf[q]) {
    pos_out[r] = p;
    return;
  }
  int f = feature[q];
  f = f < 0 ? 0 : (f < m ? f : m - 1);
  const int b = (int)bins[r * m + f];
  const bool go_left = (b == kMissingBin) ? (default_left[q] != 0) : (b <= split_bin[q]);
  pos_out[r] = 2 * p + 1 + (go_left ? 0 : 1);
}

}  // namespace

extern "C" int partition_launch(const void* bins, int bins_u8, int n_rows, int m,
                                const int32_t* pos_in, const int32_t* feature,
                                const int32_t* split_bin, const uint8_t* default_left,
                                const uint8_t* is_leaf, int n_nodes, int32_t* pos_out,
                                void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int threads = 256;
  const int blocks = (int)(((long)n_rows + threads - 1) / threads);
  if (bins_u8) {
    partition_kernel<uint8_t><<<blocks, threads, 0, stream>>>(
        (const uint8_t*)bins, n_rows, m, pos_in, feature, split_bin, default_left,
        is_leaf, n_nodes, pos_out);
  } else {
    partition_kernel<int32_t><<<blocks, threads, 0, stream>>>(
        (const int32_t*)bins, n_rows, m, pos_in, feature, split_bin, default_left,
        is_leaf, n_nodes, pos_out);
  }
  return (int)cudaGetLastError();
}
