// ELLPACK quantisation (paper Alg. 4, LookupBin) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ellpack_bin.py::bin_values
//           (Pallas `_bin_kernel`, a broadcast compare of every value
//           against all of its feature's edges, summed on the VPU).
//
// Computes, for raw values x (n, m) and +inf-padded right edges (m, B):
//   out[r, f] = 255                                   if x[r, f] is NaN
//             = min(#{k : edges[f, k] < x[r, f]}, n_bins[f] - 1)   otherwise
// as uint8. The edges of a feature are non-decreasing (strictly increasing
// real edges, then +inf padding), so the count of edges below x is a lower
// bound found by binary search, and it equals the TPU kernel's compare-count
// #{k : x > edges[f, k]} exactly (the padding is never below x).
//
// The comparison runs in the input's own type: a float64 input is compared
// against the float32 edges widened exactly to float64, as numpy's
// `searchsorted(edges_f32, x_f64)` does in the host binning. Casting x to
// float32 first would move a value just above an edge onto it.
//
// The TPU has no per-lane gather, so the Pallas kernel compared each value
// against all B edges. Here a block stages the edges of a tile of 32
// features in shared memory (32 x B floats) and each thread searches its
// value with log2(B) steps. The row stride is odd (B or B + 1): the 32 lanes
// of a warp, one feature each, probe the same edge index k at first, and
// with an odd stride those 32 words sit in 32 different banks. (With B =
// 255, a stride of B + 1 = 256 would put them all in one bank.)
//
// What bounds it on this card: bytes. Each value is read once (4 or 8 B)
// and its bin written once (1 B); the edge tile is re-read from L2 once per
// block. A warp covers 32 neighbouring features of one row, so its loads
// (128 or 256 B) and its stores (32 B) are contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMissingBin = 255;
constexpr int kFeatTile = 32;   // features per block, one per lane
constexpr int kRowsPerPass = 8; // warps per block, one row each per pass
constexpr int kRowsPerBlock = 256;  // 32 rows per thread; many small blocks in flight

template <typename T>
__global__ void bin_kernel(const T* __restrict__ x, long n_rows, int m,
                           const float* __restrict__ edges, int max_bin,
                           const int32_t* __restrict__ n_bins,
                           uint8_t* __restrict__ out) {
  extern __shared__ float tile[];  // kFeatTile x stride
  const int stride = max_bin | 1;  // odd: the lanes' rows start in distinct banks
  const int f0 = blockIdx.y * kFeatTile;
  const int nf = min(kFeatTile, m - f0);
  for (int i = threadIdx.y * kFeatTile + threadIdx.x; i < nf * max_bin;
       i += kFeatTile * kRowsPerPass) {
    const int fl = i / max_bin, k = i - fl * max_bin;
    tile[fl * stride + k] = edges[(long)(f0 + fl) * max_bin + k];
  }
  __syncthreads();

  const int fl = threadIdx.x;
  if (fl >= nf) return;
  const int f = f0 + fl;
  const int last = max(n_bins[f] - 1, 0);
  const float* e = tile + fl * stride;
  int top = 1;  // largest power of two <= max_bin
  while (top * 2 <= max_bin) top *= 2;

  const long r0 = (long)blockIdx.x * kRowsPerBlock;
  const long r1 = (r0 + kRowsPerBlock < n_rows) ? r0 + kRowsPerBlock : n_rows;
  for (long r = r0 + threadIdx.y; r < r1; r += kRowsPerPass) {
    const T v = x[r * m + f];
    uint8_t b;
    if (v != v) {
      b = kMissingBin;
    } else {
      // binary lifting: pos = number of edges < v (edges non-decreasing)
      int pos = 0;
      for (int step = top; step > 0; step >>= 1) {
        if (pos + step <= max_bin && (T)e[pos + step - 1] < v) pos += step;
      }
      b = (uint8_t)min(pos, last);
    }
    out[r * m + f] = b;
  }
}

template <typename T>
int launch(const void* x, long n_rows, int m, const float* edges, int max_bin,
           const int32_t* n_bins, uint8_t* out, cudaStream_t stream) {
  const size_t smem = (size_t)kFeatTile * (max_bin | 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bin_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kFeatTile, kRowsPerPass);
  const dim3 grid((unsigned)((n_rows + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)((m + kFeatTile - 1) / kFeatTile));
  bin_kernel<T><<<grid, block, smem, stream>>>((const T*)x, n_rows, m, edges, max_bin,
                                               n_bins, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_rows, m) float32 (x_f64 == 0) or float64 (x_f64 == 1), row-major;
// edges: (m, max_bin) float32; n_bins: (m,) int32; out: (n_rows, m) uint8.
extern "C" int ellpack_bin_launch(const void* x, int x_f64, long n_rows, int m,
                                  const float* edges, int max_bin,
                                  const int32_t* n_bins, uint8_t* out,
                                  void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (x_f64) return launch<double>(x, n_rows, m, edges, max_bin, n_bins, out, stream);
  return launch<float>(x, n_rows, m, edges, max_bin, n_bins, out, stream);
}
