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
// max|g|, max|h| over the matched rows and counts each slot's rows. Passes
// 2-5 are kernel 1's (hist_common.cuh), so given the equivalent global
// build-node list, kernel 1 (histogram.cu) computes the same bits on the same
// rows.
#include "hist_common.cuh"

namespace {

std::atomic<bool> window_slot_allowed[hist::kMaxDevices];  // see hist::allow_max_shared

__global__ void window_slot_kernel(const int32_t* __restrict__ pos,
                                   const int32_t* __restrict__ node_map, int map_len,
                                   int stage_map, int n_nodes, int n_rows,
                                   const float* __restrict__ g,
                                   const float* __restrict__ h, hist::Workspace w,
                                   int shared_counts) {
  extern __shared__ int32_t sh[];
  const int32_t* table = node_map;
  if (stage_map) {  // uniform across the block
    int32_t* smap = sh + (shared_counts ? n_nodes : 0);
    for (int i = threadIdx.x; i < map_len; i += blockDim.x) smap[i] = node_map[i];
    __syncthreads();
    table = smap;
  }
  auto slot_of = [&](long r) {
    const int p = pos[r];
    int s = -1;
    if (node_map == nullptr) {
      s = p;
    } else if (p >= 0 && p < map_len) {
      s = table[p];
    }
    return (s < 0 || s >= n_nodes) ? -1 : s;
  };
  hist::pass1_rows(slot_of, n_rows, n_nodes, g, h, w, shared_counts ? sh : nullptr);
}

}  // namespace

// node_map may be null (map_len 0): positions are then the slots. stage_map
// copies node_map into shared memory (map_len * 4 bytes, up to 48 KB).
// Scratch comes from the caller: ws (`HistPlan.ws_ints` int32, see
// hist::Workspace) and acc (plan[kBigBound] * m * n_bins * 2 int64, may be
// null when that is 0). plan is a host array (hist::PlanField). With
// accumulate, out holds a histogram this one is added into. Everything runs
// on ``device``, the tensors' (guard::on_device), on its stream stream_ptr.
// Returns the first CUDA error, or 0.
extern "C" int hist_window_launch(const void* bins, int bins_u8, int n_rows, int m,
                                  int n_bins, const float* g, const float* h,
                                  const int32_t* pos, const int32_t* node_map,
                                  int map_len, int stage_map, int n_nodes, int32_t* ws,
                                  unsigned long long* acc, float* out, int accumulate,
                                  const int* plan, int lg_rows, int device, void* stream_ptr) {
  return guard::on_device(device, [&]() -> int {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    cudaError_t err = hist::clear_header(ws, n_nodes, stream);
    if (err != cudaSuccess) return (int)err;
    const hist::Workspace w = hist::carve(ws, n_rows, n_nodes, plan[hist::kItemsBound]);

    const int shared_counts = hist::shared_counts(n_nodes);
    const int smem =
        ((shared_counts ? n_nodes : 0) + (stage_map ? map_len : 0)) * (int)sizeof(int32_t);
    err = hist::allow_max_shared(window_slot_kernel, window_slot_allowed, device);
    if (err != cudaSuccess) return (int)err;
    window_slot_kernel<<<hist::pass1_blocks(n_rows), hist::kPass1Threads, smem, stream>>>(
        pos, node_map, map_len, stage_map, n_nodes, n_rows, g, h, w, shared_counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    return (int)hist::bucket_scatter(bins, bins_u8, n_rows, m, n_bins, n_nodes, g, h, w,
                                     lg_rows, plan, acc, out, accumulate, device, stream);
  });
}
