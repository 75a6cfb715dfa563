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
// builder does it: rows are bucketed by build slot, and each block scatters
// one slot's rows into a histogram tile in shared memory with integer
// atomics (deterministic; see hist_common.cuh, which holds passes 2-5).
//
// Passes (all on the caller's stream, one C entry point):
//   1. row_slot: each row's build slot (first s with build_nodes[s] == pos),
//      or -1, looked up in a shared-memory table indexed by node id when the
//      build nodes span fewer than kIdTable ids (a level's nodes always do
//      up to depth 12), else by a search of the build-node list; max|g|,
//      max|h| over matched rows, and the rows of each slot. With 64 build
//      nodes the search made a call ~14% slower on a 67,108-row page and ~3%
//      on 1M rows (NVIDIA H100 80GB HBM3, 700.00 W, `chip_smoke.py`).
//   2-5. bucket by slot, scatter, finalize (hist_common.cuh).
#include "hist_common.cuh"

namespace {

constexpr int kIdTable = 4096;  // node ids a block's slot table spans
std::atomic<bool> row_slot_allowed[hist::kMaxDevices];  // see hist::allow_max_shared

__global__ void row_slot_kernel(const int32_t* __restrict__ pos,
                                const int32_t* __restrict__ nodes, int n_rows,
                                int n_slots, const float* __restrict__ g,
                                const float* __restrict__ h, hist::Workspace w,
                                int shared_counts) {
  extern __shared__ int32_t sh[];
  __shared__ int id_lo, id_hi;
  int32_t* snodes = sh + (shared_counts ? n_slots : 0);
  int32_t* table = snodes + n_slots;  // slot of node id_lo + i, INT_MAX = none
  if (threadIdx.x == 0) {
    id_lo = 0x7fffffff;
    id_hi = -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    snodes[i] = nodes[i];
    atomicMin(&id_lo, nodes[i]);
    atomicMax(&id_hi, nodes[i]);
  }
  __syncthreads();
  const bool by_table = id_lo >= 0 && id_hi - id_lo < kIdTable;
  if (by_table) {
    for (int i = threadIdx.x; i <= id_hi - id_lo; i += blockDim.x) table[i] = 0x7fffffff;
    __syncthreads();
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) atomicMin(&table[snodes[i] - id_lo], i);
    __syncthreads();
  }
  auto slot_of = [&](long r) {
    const int p = pos[r];
    if (by_table) {
      if (p < id_lo || p > id_hi) return -1;
      const int s = table[p - id_lo];
      return s == 0x7fffffff ? -1 : s;
    }
    if (p >= 0) {
      for (int k = 0; k < n_slots; ++k) {
        if (snodes[k] == p) return k;
      }
    }
    return -1;
  };
  hist::pass1_rows(slot_of, n_rows, n_slots, g, h, w, shared_counts ? sh : nullptr);
}

}  // namespace

// Scratch comes from the caller: ws (`HistPlan.ws_ints` int32, see
// hist::Workspace) and acc (plan[kBigBound] * m * n_bins * 2 int64, may be
// null when that is 0). plan is a host array (hist::PlanField). With
// accumulate, out holds a histogram this one is added into. Everything runs
// on ``device``, the tensors' (guard::on_device), on its stream stream_ptr.
// Returns the first CUDA error, or 0.
extern "C" int hist_nodes_launch(const void* bins, int bins_u8, int n_rows, int m,
                                 int n_bins, const float* g, const float* h,
                                 const int32_t* pos, const int32_t* nodes,
                                 int n_slots, int32_t* ws, unsigned long long* acc,
                                 float* out, int accumulate, const int* plan,
                                 int lg_rows, int device, void* stream_ptr) {
  return guard::on_device(device, [&]() -> int {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    cudaError_t err = hist::clear_header(ws, n_slots, stream);
    if (err != cudaSuccess) return (int)err;
    const hist::Workspace w = hist::carve(ws, n_rows, n_slots, plan[hist::kItemsBound]);

    const int shared_counts = hist::shared_counts(n_slots);
    const int smem =
        (n_slots + (shared_counts ? n_slots : 0) + kIdTable) * (int)sizeof(int32_t);
    err = hist::allow_max_shared(row_slot_kernel, row_slot_allowed, device);
    if (err != cudaSuccess) return (int)err;
    row_slot_kernel<<<hist::pass1_blocks(n_rows), hist::kPass1Threads, smem, stream>>>(
        pos, nodes, n_rows, n_slots, g, h, w, shared_counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    return (int)hist::bucket_scatter(bins, bins_u8, n_rows, m, n_bins, n_slots, g, h, w,
                                     lg_rows, plan, acc, out, accumulate, device, stream);
  });
}
