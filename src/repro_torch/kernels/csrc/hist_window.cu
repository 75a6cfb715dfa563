// Level-window gradient histogram for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/histogram.py::build_histogram
//           (Pallas `_hist_kernel`, one-hot MXU contraction, after the
//           jitted wrapper's `apply_node_map` remap).
//
// Computes out[k, f, b] = (sum g_r, sum h_r) over rows r whose slot is k and
// bins[r, f] == b != 255; shape (n_nodes, m, B, 2) f32. A row's slot is
//   node_map[pos[r]]  if 0 <= pos[r] < map_len    (with a node_map)
//   pos[r]            if 0 <= pos[r]              (without)
// and -1 otherwise; a slot outside [0, n_nodes) matches nothing. pos is the
// row's level-local node index (< 0 = inactive), node_map[j] the build slot
// of level node j, or -1 when j's histogram is derived by subtraction.
//
// The TPU kernel built a one-hot (rows, n_nodes) matrix for the MXU from
// positions remapped beforehand. Here the remap is folded into pass 1: each
// row's position is checked against the window and looked up in the
// node_map, staged in shared memory when it fits, and the same pass takes
// max|g|, max|h| over the matched rows. Passes 2 and 3 are kernel 1's
// (hist_common.cuh), so given the equivalent global build-node list, kernel 1
// (histogram.cu) computes the same bits on the same rows.
#include "hist_common.cuh"

namespace {

__global__ void window_slot_kernel(const int32_t* __restrict__ pos,
                                   const int32_t* __restrict__ node_map, int map_len,
                                   int stage_map, int n_nodes, int n_rows,
                                   const float* __restrict__ g,
                                   const float* __restrict__ h,
                                   int32_t* __restrict__ slot_out,
                                   unsigned int* __restrict__ absmax) {
  extern __shared__ int32_t smap[];
  const int32_t* table = node_map;
  if (stage_map) {  // uniform across the block
    for (int i = threadIdx.x; i < map_len; i += blockDim.x) smap[i] = node_map[i];
    __syncthreads();
    table = smap;
  }
  unsigned int mg = 0u, mh = 0u;
  for (long r = (long)blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += (long)gridDim.x * blockDim.x) {
    const int p = pos[r];
    int s = -1;
    if (node_map == nullptr) {
      s = p;
    } else if (p >= 0 && p < map_len) {
      s = table[p];
    }
    if (s < 0 || s >= n_nodes) s = -1;
    slot_out[r] = s;
    if (s >= 0) {
      mg = max(mg, __float_as_uint(fabsf(g[r])));
      mh = max(mh, __float_as_uint(fabsf(h[r])));
    }
  }
  hist::flush_absmax(mg, mh, absmax);
}

}  // namespace

// node_map may be null (map_len 0): positions are then the slots. stage_map
// copies node_map into shared memory (map_len * 4 bytes, up to 48 KB).
// Scratch buffers come from the caller: slot (n_rows int32), absmax
// (2 uint32), acc (n_nodes * m * n_bins * 2 int64). Returns the first CUDA
// error, or 0.
extern "C" int hist_window_launch(const void* bins, int bins_u8, int n_rows, int m,
                                  int n_bins, const float* g, const float* h,
                                  const int32_t* pos, const int32_t* node_map,
                                  int map_len, int stage_map, int n_nodes,
                                  int32_t* slot, unsigned int* absmax,
                                  unsigned long long* acc, float* out, int slot_tile,
                                  int feat_tile, int rows_per_chunk, int lg_rows,
                                  void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long n_values = (long)n_nodes * m * n_bins * 2;
  cudaError_t err = hist::clear_scratch(absmax, acc, n_values, stream);
  if (err != cudaSuccess) return (int)err;

  const long slot_want = ((long)n_rows + 255) / 256;
  const int slot_blocks = (int)(slot_want < 4096 ? slot_want : 4096);
  const size_t smem = stage_map ? (size_t)map_len * sizeof(int32_t) : 0;
  window_slot_kernel<<<slot_blocks, 256, smem, stream>>>(
      pos, node_map, map_len, stage_map, n_nodes, n_rows, g, h, slot, absmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  return (int)hist::scatter_finalize(bins, bins_u8, n_rows, m, n_bins, n_nodes, g, h,
                                     slot, absmax, lg_rows, slot_tile, feat_tile,
                                     rows_per_chunk, acc, out, stream);
}
