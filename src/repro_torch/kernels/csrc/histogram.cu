// Fused node-set gradient histogram for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/histogram.py::build_histogram_nodes
//           (Pallas `_fused_hist_kernel`, one-hot MXU contraction).
//
// Computes out[s, f, b] = (sum g_r, sum h_r) over rows r with
// pos[r] == build_nodes[s] and bins[r, f] == b != 255; shape (S, m, B, 2) f32.
//
// The TPU kernel turned the scatter into two one-hot matmuls because the TPU
// has no atomics. Here the scatter is done directly, as the paper's CUDA
// builder does it: each block privatises a histogram tile in shared memory
// and scatters into it with integer atomics (deterministic; see
// hist_common.cuh, which also holds passes 2 and 3).
//
// Passes (all on the caller's stream, one C entry point):
//   1. row_slot: each row's build slot (first s with build_nodes[s] == pos),
//      or -1, matched against the build-node table staged in shared memory;
//      also max|g|, max|h| over matched rows.
//   2-3. the shared scatter and finalize (hist_common.cuh).
#include "hist_common.cuh"

namespace {

__global__ void row_slot_kernel(const int32_t* __restrict__ pos,
                                const int32_t* __restrict__ nodes, int n_rows,
                                int n_slots, const float* __restrict__ g,
                                const float* __restrict__ h,
                                int32_t* __restrict__ slot_out,
                                unsigned int* __restrict__ absmax) {
  extern __shared__ int32_t snodes[];
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) snodes[i] = nodes[i];
  __syncthreads();
  unsigned int mg = 0u, mh = 0u;
  for (long r = (long)blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += (long)gridDim.x * blockDim.x) {
    int p = pos[r];
    int s = -1;
    if (p >= 0) {
      for (int k = 0; k < n_slots; ++k) {
        if (snodes[k] == p) {
          s = k;
          break;
        }
      }
    }
    slot_out[r] = s;
    if (s >= 0) {
      mg = max(mg, __float_as_uint(fabsf(g[r])));
      mh = max(mh, __float_as_uint(fabsf(h[r])));
    }
  }
  hist::flush_absmax(mg, mh, absmax);
}

}  // namespace

// Scratch buffers come from the caller: slot (n_rows int32), absmax (2 uint32),
// acc (S * m * n_bins * 2 int64). Returns the first CUDA error, or 0.
extern "C" int hist_nodes_launch(const void* bins, int bins_u8, int n_rows, int m,
                                 int n_bins, const float* g, const float* h,
                                 const int32_t* pos, const int32_t* nodes,
                                 int n_slots, int32_t* slot, unsigned int* absmax,
                                 unsigned long long* acc, float* out,
                                 int slot_tile, int feat_tile, int rows_per_chunk,
                                 int lg_rows, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long n_values = (long)n_slots * m * n_bins * 2;
  cudaError_t err = hist::clear_scratch(absmax, acc, n_values, stream);
  if (err != cudaSuccess) return (int)err;

  const long slot_want = ((long)n_rows + 255) / 256;
  const int slot_blocks = (int)(slot_want < 4096 ? slot_want : 4096);
  row_slot_kernel<<<slot_blocks, 256, n_slots * sizeof(int32_t), stream>>>(
      pos, nodes, n_rows, n_slots, g, h, slot, absmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  return (int)hist::scatter_finalize(bins, bins_u8, n_rows, m, n_bins, n_slots, g, h,
                                     slot, absmax, lg_rows, slot_tile, feat_tile,
                                     rows_per_chunk, acc, out, stream);
}
