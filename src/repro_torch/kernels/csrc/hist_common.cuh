// Device code shared by the two histogram kernels: the deterministic
// fixed-point scatter and its finalize (passes 2 and 3).
//
//   histogram.cu    kernel 1, rows matched against a global build-node list
//   hist_window.cu  kernel 4, level-local rows remapped through a node_map
//
// Each kernel's own pass 1 writes every row's build slot (-1 = no slot) and
// max|g|, max|h| over the matched rows (float bits, atomicMax). What follows
// depends only on those, so the two kernels give the same bits for the same
// matched rows.
//
// Determinism. Float atomics add in a different order every run, so two fits
// could grow different trees. Every addition here is an integer one instead:
// g and h are converted to 64-bit fixed point with a power-of-two scale
// derived from max|g| and max|h| over the matched rows, so that no partial
// sum of up to n_rows terms can overflow (n * max * scale < 2^62). Integer
// addition is associative, so the shared- and global-memory atomics give the
// same bits in any order. The fixed-point grid is max * 2^-(62 - log2 n),
// about 2^-42 of max|g| at 1M rows: the result is the exact sum rounded once
// to f32, more accurate than a sequential f32 sum.
//
//   2. hist: grid (feature tiles, row chunks, slot tiles). A block zeroes a
//      (slot_tile, feat_tile, B, 2) int64 tile in shared memory, scatters its
//      rows into it, and adds the non-zero cells to a global int64 histogram.
//   3. finalize: int64 -> f32 (one exact power-of-two division, one rounding).
//
// What bounds it on this card: bytes. The bins matrix (n * m bytes as uint8)
// is read once per slot tile; g, h, slot are re-read per feature tile from
// L2. Blocks are ordered feature-tile fastest so the blocks in flight share
// one row chunk and its bins stay in L2. With one feature per block (deep
// levels) a warp reads a column, 32 rows apart by m bytes: the sectors are
// shared by neighbouring feature blocks in L2, not in one request. Making
// this coalesced (staging row tiles through shared memory) is later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hist {

constexpr int kMissingBin = 255;

__device__ __forceinline__ double fixed_scale(unsigned int max_bits, int lg_rows) {
  float mx = __uint_as_float(max_bits);
  int e = 0;
  if (mx > 0.0f) frexpf(mx, &e);  // mx < 2^e
  return ldexp(1.0, 62 - lg_rows - e);
}

// Warp-reduce one thread's max|g|, max|h| bits and fold them into absmax
// (order-free for non-negative floats). Every lane of the warp must call it.
__device__ __forceinline__ void flush_absmax(unsigned int mg, unsigned int mh,
                                             unsigned int* __restrict__ absmax) {
  for (int off = 16; off > 0; off >>= 1) {
    mg = max(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    mh = max(mh, __shfl_xor_sync(0xffffffffu, mh, off));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&absmax[0], mg);
    atomicMax(&absmax[1], mh);
  }
}

template <typename BinT>
__global__ void hist_kernel(const BinT* __restrict__ bins, int n_rows, int m,
                            int n_bins, int n_slots, const float* __restrict__ g,
                            const float* __restrict__ h,
                            const int32_t* __restrict__ slot,
                            const unsigned int* __restrict__ absmax, int lg_rows,
                            int slot_tile, int feat_tile, int rows_per_chunk,
                            unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long sacc[];
  const int f0 = blockIdx.x * feat_tile;
  const int s0 = blockIdx.z * slot_tile;
  const int nf = min(feat_tile, m - f0);
  const int ns = min(slot_tile, n_slots - s0);
  const long r0 = (long)blockIdx.y * rows_per_chunk;
  const long r1 = (r0 + rows_per_chunk < n_rows) ? r0 + rows_per_chunk : (long)n_rows;
  const int cells = ns * nf * n_bins * 2;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sacc[i] = 0ull;
  __syncthreads();

  const double sg = fixed_scale(absmax[0], lg_rows);
  const double sh = fixed_scale(absmax[1], lg_rows);
  const long total = (r1 - r0) * nf;
  for (long i = threadIdx.x; i < total; i += blockDim.x) {
    const long r = r0 + i / nf;
    const int fl = (int)(i % nf);
    const int s = slot[r] - s0;
    if (s < 0 || s >= ns) continue;
    const int b = (int)bins[r * m + f0 + fl];
    if (b == kMissingBin || b >= n_bins) continue;
    const long long qg = __double2ll_rn((double)g[r] * sg);
    const long long qh = __double2ll_rn((double)h[r] * sh);
    const int c = ((s * nf + fl) * n_bins + b) * 2;
    atomicAdd(&sacc[c], (unsigned long long)qg);
    atomicAdd(&sacc[c + 1], (unsigned long long)qh);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long v = sacc[i];
    if (v == 0ull) continue;
    const int pair = i >> 1;
    const int b = pair % n_bins;
    const int fl = (pair / n_bins) % nf;
    const int s = pair / n_bins / nf;
    const long gi = ((((long)(s0 + s) * m + f0 + fl) * n_bins + b) * 2) + (i & 1);
    atomicAdd(&acc[gi], v);
  }
}

__global__ void finalize_kernel(const long long* __restrict__ acc, long n_values,
                                const unsigned int* __restrict__ absmax,
                                int lg_rows, float* __restrict__ out) {
  const double sg = fixed_scale(absmax[0], lg_rows);
  const double sh = fixed_scale(absmax[1], lg_rows);
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_values;
       i += (long)gridDim.x * blockDim.x) {
    out[i] = (float)((double)acc[i] / ((i & 1) ? sh : sg));
  }
}

template <typename BinT>
cudaError_t launch_hist(const BinT* bins, int n_rows, int m, int n_bins,
                        int n_slots, const float* g, const float* h,
                        const int32_t* slot, const unsigned int* absmax,
                        int lg_rows, int slot_tile, int feat_tile,
                        int rows_per_chunk, unsigned long long* acc,
                        cudaStream_t stream) {
  const int smem = slot_tile * feat_tile * n_bins * 2 * (int)sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m + feat_tile - 1) / feat_tile,
            (n_rows + rows_per_chunk - 1) / rows_per_chunk,
            (n_slots + slot_tile - 1) / slot_tile);
  hist_kernel<BinT><<<grid, 512, smem, stream>>>(
      bins, n_rows, m, n_bins, n_slots, g, h, slot, absmax, lg_rows, slot_tile,
      feat_tile, rows_per_chunk, acc);
  return cudaGetLastError();
}

// Zero absmax and the int64 accumulator (before pass 1).
inline cudaError_t clear_scratch(unsigned int* absmax, unsigned long long* acc,
                                 long n_values, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(absmax, 0, 2 * sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  return cudaMemsetAsync(acc, 0, n_values * sizeof(unsigned long long), stream);
}

// Passes 2-3 on the caller's stream, after pass 1 has filled slot and absmax.
inline cudaError_t scatter_finalize(const void* bins, int bins_u8, int n_rows, int m,
                                    int n_bins, int n_slots, const float* g,
                                    const float* h, const int32_t* slot,
                                    const unsigned int* absmax, int lg_rows,
                                    int slot_tile, int feat_tile, int rows_per_chunk,
                                    unsigned long long* acc, float* out,
                                    cudaStream_t stream) {
  cudaError_t err;
  if (bins_u8) {
    err = launch_hist((const uint8_t*)bins, n_rows, m, n_bins, n_slots, g, h, slot,
                      absmax, lg_rows, slot_tile, feat_tile, rows_per_chunk, acc, stream);
  } else {
    err = launch_hist((const int32_t*)bins, n_rows, m, n_bins, n_slots, g, h, slot,
                      absmax, lg_rows, slot_tile, feat_tile, rows_per_chunk, acc, stream);
  }
  if (err != cudaSuccess) return err;
  const long n_values = (long)n_slots * m * n_bins * 2;
  const long fin_want = (n_values + 255) / 256;
  const int fin_blocks = (int)(fin_want < 8192 ? fin_want : 8192);
  finalize_kernel<<<fin_blocks, 256, 0, stream>>>((const long long*)acc, n_values,
                                                  absmax, lg_rows, out);
  return cudaGetLastError();
}

}  // namespace hist
