// Fused whole-forest traversal for Hopper (sm_90a): one thread per row.
//
// Replaces: src/repro/kernels/forest.py::predict_forest
//           (Pallas `_forest_kernel`, one-hot MXU gathers per tree step).
//
// out[r] = margin_in[r] + leaf_0(r) + leaf_1(r) + ... in ascending tree order.
// Each tree is walked at most max_depth steps from the root and stops at a
// leaf (the reference freezes the position there, which reads the same leaf).
// Node lookups clamp into [0, n_nodes), as the reference's gathers do.
//
// Bitwise discipline: the leaf table arrives pre-scaled by the learning rate
// (`repro_torch.kernels.ops.predict_forest` multiplies it eagerly), so the
// kernel only adds. Each add is an explicit __fadd_rn, which nvcc never
// contracts into an FMA, so the result equals the per-tree loop of pure f32
// adds bit for bit.
//
// The TPU kernel gathered node fields and bins through one-hot matmuls; here
// each thread gathers them directly.
//
// What bounds it on this card: bytes. A row reads up to max_depth bins per
// tree from its own m-byte row (one sector each), margin_in, and writes its
// margin; the forest planes (T x n_nodes) are shared by all rows and stay in
// L1/L2. Trees are walked in order inside the thread, so nothing carries
// across blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMissingBin = 255;

template <typename BinT>
__global__ void forest_kernel(const BinT* __restrict__ bins, int n_rows, int m,
                              const int32_t* __restrict__ feature,
                              const int32_t* __restrict__ split_bin,
                              const uint8_t* __restrict__ default_left,
                              const uint8_t* __restrict__ is_leaf,
                              const float* __restrict__ leaf_value, int n_trees,
                              int n_nodes, int max_depth,
                              const float* __restrict__ margin_in,
                              float* __restrict__ out) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const BinT* row = bins + r * m;
  float acc = margin_in[r];
  for (int t = 0; t < n_trees; ++t) {
    const long base = (long)t * n_nodes;
    int p = 0;
    for (int d = 0; d < max_depth; ++d) {
      if (is_leaf[base + p]) break;
      int f = feature[base + p];
      f = f < 0 ? 0 : (f < m ? f : m - 1);
      const int b = (int)row[f];
      const bool go_left =
          (b == kMissingBin) ? (default_left[base + p] != 0) : (b <= split_bin[base + p]);
      p = 2 * p + 1 + (go_left ? 0 : 1);
      p = p < n_nodes ? p : n_nodes - 1;
    }
    acc = __fadd_rn(acc, leaf_value[base + p]);
  }
  out[r] = acc;
}

}  // namespace

extern "C" int forest_launch(const void* bins, int bins_u8, int n_rows, int m,
                             const int32_t* feature, const int32_t* split_bin,
                             const uint8_t* default_left, const uint8_t* is_leaf,
                             const float* leaf_value, int n_trees, int n_nodes,
                             int max_depth, const float* margin_in, float* out,
                             void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int threads = 256;
  const int blocks = (int)(((long)n_rows + threads - 1) / threads);
  if (bins_u8) {
    forest_kernel<uint8_t><<<blocks, threads, 0, stream>>>(
        (const uint8_t*)bins, n_rows, m, feature, split_bin, default_left, is_leaf,
        leaf_value, n_trees, n_nodes, max_depth, margin_in, out);
  } else {
    forest_kernel<int32_t><<<blocks, threads, 0, stream>>>(
        (const int32_t*)bins, n_rows, m, feature, split_bin, default_left, is_leaf,
        leaf_value, n_trees, n_nodes, max_depth, margin_in, out);
  }
  return (int)cudaGetLastError();
}
