// Device code shared by the two histogram kernels: rows bucketed by slot,
// then a node-major fixed-point scatter over coalesced row segments.
//
//   histogram.cu    kernel 1, rows matched against a global build-node list
//   hist_window.cu  kernel 4, level-local rows remapped through a node_map
//
// Each kernel's own pass 1 gives every row its build slot (-1 = none) and
// runs `pass1_rows` below, which also takes max|g|, max|h| over the matched
// rows and counts the rows of each slot. What follows depends only on those,
// so the two kernels give the same bits for the same matched rows.
//
// Determinism. Float atomics add in a different order every run, so two fits
// could grow different trees. Every addition here is an integer one instead:
// g and h are converted to 64-bit fixed point with a power-of-two scale
// derived from max|g| and max|h| over the matched rows, so that no partial
// sum of up to n_rows terms can overflow (n * max * scale < 2^62). Integer
// addition is associative, so the shared- and global-memory atomics give the
// same bits in any order, and so does the order of rows within a bucket.
// The fixed-point grid is max * 2^-(62 - log2 n), about 2^-42 of max|g| at
// 1M rows: the result is the exact sum rounded once to f32. The plain
// version with the same bits is `kernels/ref.py::_scatter_histogram_fixed`.
//
// No tensor cores: their products accumulate in f32 (or tf32), and an exact
// 62-bit integer sum would need int8 `wgmma` over eight limbs of every value.
// The scatter is a shared-memory histogram, as the paper's CUDA builder
// (XGBoost `gpu_hist`) does it. A 64-bit atomicAdd on shared memory compiles
// to a compare-and-swap loop on this card (ATOMS.CAST.SPIN.64 in the SASS),
// so each 64-bit cell is kept as two 32-bit words and added with native
// 32-bit atomics: the low word's atomicAdd returns the old value, from which
// the carry out is known, and the high word gets the value's high half plus
// that carry. Every carry is counted once, so the pair holds the exact sum
// modulo 2^64, the same integer a 64-bit atomic would give.
//
// Passes after pass 1, all on the caller's stream, none waiting for the host:
//   2. plan_items (one block): scans the slot counts into each slot's first
//      row in `ridx`, picks the chunk size C (at least the plan's min_chunk,
//      and large enough that the matched rows make about target_items
//      chunks), splits each slot into chunks of at most C rows (one work
//      item each; an empty slot gets one empty item), and numbers the slots
//      with more than C rows ("big" slots).
//   3. bucket: writes each matched row's index into `ridx`, grouped by slot
//      (unmatched rows are never read again), and zeroes the big slots' part
//      of the int64 accumulator.
//   4. scatter: a block takes one work item and one group of F features; its
//      F x B int64 sums of g and of h live in shared memory as four 32-bit
//      planes (g low, g high, h low, h high). Threads run along the
//      features of a row, so a row's bins for the group are one contiguous
//      segment, copied with 4-byte cp.async into a double buffer while the
//      previous batch of rows scatters. Rows are gathered through `ridx`, so
//      TMA (which copies regular tiles) does not fit. Epilogue: a slot of
//      one chunk is owned by this block alone, which converts its tile to
//      f32 and writes (or adds into) `out` directly; a big slot's chunks add
//      their tiles into the compact accumulator with global int64 atomics.
//   5. finalize_big: converts the big slots' accumulator into `out`.
//
// With `accumulate`, every output value is out + float(double(acc) / scale):
// the single f32 addition `hist.add_(page_hist)` makes, with the same bits.
//
// What bounds it on this card: the shared atomics, four 32-bit ones per
// matched (row, feature) (on an NVIDIA H100 80GB HBM3 at 700.00 W kernel 1
// at 1M x 500 rows takes ~12x the time its bytes need, by `chip_smoke.py`);
// then the bins of the matched rows, read once per
// feature group as 4-byte words (a segment not aligned to 4 bytes costs one
// word more); g, h and the row indices are read once per feature group.
// Each word sits in its own plane, so a warp's atomics spread over all 32
// banks.
// Because C is chosen on the device from the matched rows, a level with few
// matched rows still fills the card; the accumulator's size bound, from the
// shapes alone, uses min_chunk.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device_guard.cuh"

namespace hist {

constexpr int kMissingBin = 255;
constexpr int kPass1Threads = 256;
constexpr int kPass1RowsPerThread = 8;
// pass 1 counts a block's rows per slot in shared memory up to this many
// slots, and straight into global memory above it
constexpr int kSharedCountSlots = 1024;
constexpr int kScanThreads = 1024;
// shared memory a block may take on this card; the devices whose limits
// allow_max_shared records are guard::kMaxDevices
constexpr int kMaxBlockShared = 227 * 1024;
using guard::kMaxDevices;

// Launch plan from the wrapper (`kernels/histogram.py::HistPlan.c_args`), a
// host array of ints in this order.
enum PlanField {
  kFeatGroup,   // F, features per block
  kThreads,     // threads per scatter block, a multiple of F
  kBatchRows,   // rows per staged batch (each of two buffers)
  kStageWords,  // 4-byte words staged per row
  kSmemBytes,   // dynamic shared memory of a scatter block
  kMinChunk,    // least C, the most rows of one work item
  kTargetItems, // work items wanted over all slots
  kItemsBound,  // n_slots + n_rows / min_chunk: work items at most
  kBigBound,    // min(n_slots, n_rows / min_chunk): big slots at most
  kPlanFields
};

// The int32 workspace the wrapper allocates (`HistPlan.ws_ints` ints),
// carved in this order. The first kHeader + n_slots ints are zeroed per
// launch.
constexpr int kHeader = 5;
struct Workspace {
  unsigned int* absmax;  // 2: max|g|, max|h| float bits over matched rows
  int* n_items;          // 1: work items of the scatter
  int* n_big;            // 1: slots with more than C rows
  int* chunk;            // 1: C, the most rows of one work item
  int* counts;           // n_slots: matched rows per slot
  int* row_start;        // n_slots: a slot's first entry in ridx
  int* big_idx;          // n_slots: a slot's place in the accumulator, or -1
  int* big_slot;         // n_slots: the slot at each accumulator place
  int* item_slot;        // items_bound: slot of each work item
  int* item_chunk;       // items_bound: chunk of each work item
  int* slot;             // n_rows: each row's slot, -1 = none
  int* rank;             // n_rows: a matched row's place within its slot
  int* ridx;             // n_rows: matched rows grouped by slot
};

inline Workspace carve(int32_t* ws, int n_rows, int n_slots, int items_bound) {
  Workspace w;
  w.absmax = (unsigned int*)ws;
  w.n_items = ws + 2;
  w.n_big = ws + 3;
  w.chunk = ws + 4;
  w.counts = ws + kHeader;
  w.row_start = w.counts + n_slots;
  w.big_idx = w.row_start + n_slots;
  w.big_slot = w.big_idx + n_slots;
  w.item_slot = w.big_slot + n_slots;
  w.item_chunk = w.item_slot + items_bound;
  w.slot = w.item_chunk + items_bound;
  w.rank = w.slot + n_rows;
  w.ridx = w.rank + n_rows;
  return w;
}

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

// The lanes of a warp that share a slot take consecutive places from one
// atomicAdd on cnt[s] (shared or global memory); returns this lane's place.
// Every lane of the warp must call it; s < 0 reserves nothing.
__device__ __forceinline__ int warp_reserve(int* cnt, int s) {
  const unsigned int peers = __match_any_sync(0xffffffffu, s);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader && s >= 0) base = atomicAdd(&cnt[s], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// Pass 1's common body: block b takes rows [b * 256 * 8, ...), asks
// slot_of(r) for each, and writes slot[r], rank[r] (the row's place among its
// slot's rows) and counts; scount is n_slots ints of shared memory, or null
// to count in global memory.
template <typename SlotOf>
__device__ __forceinline__ void pass1_rows(SlotOf slot_of, int n_rows, int n_slots,
                                           const float* __restrict__ g,
                                           const float* __restrict__ h, Workspace w,
                                           int* scount) {
  if (scount != nullptr) {
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) scount[i] = 0;
    __syncthreads();
  }
  int* cnt = scount != nullptr ? scount : w.counts;
  const long base = (long)blockIdx.x * blockDim.x * kPass1RowsPerThread;
  int sl[kPass1RowsPerThread], rk[kPass1RowsPerThread];
  unsigned int mg = 0u, mh = 0u;
#pragma unroll
  for (int k = 0; k < kPass1RowsPerThread; ++k) {
    const long r = base + (long)k * blockDim.x + threadIdx.x;
    const int s = r < n_rows ? slot_of(r) : -1;
    if (s >= 0) {
      mg = max(mg, __float_as_uint(fabsf(g[r])));
      mh = max(mh, __float_as_uint(fabsf(h[r])));
    }
    rk[k] = warp_reserve(cnt, s);
    sl[k] = s;
  }
  if (scount != nullptr) {  // one global reservation per (block, slot)
    __syncthreads();
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
      const int c = scount[i];
      if (c != 0) scount[i] = atomicAdd(&w.counts[i], c);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPass1RowsPerThread; ++k) {
    const long r = base + (long)k * blockDim.x + threadIdx.x;
    if (r >= n_rows) continue;
    w.slot[r] = sl[k];
    if (sl[k] >= 0) w.rank[r] = rk[k] + (scount != nullptr ? scount[sl[k]] : 0);
  }
  flush_absmax(mg, mh, w.absmax);
}

// Blocks of pass 1 for n_rows rows, and its shared memory for the counts.
inline int pass1_blocks(int n_rows) {
  const int per_block = kPass1Threads * kPass1RowsPerThread;
  return (n_rows + per_block - 1) / per_block;
}
inline bool shared_counts(int n_slots) { return n_slots <= kSharedCountSlots; }

// Exclusive prefix sum over the block (blockDim.x == kScanThreads); *total
// gets the block's sum. Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (wid > 0 ? warp_sums[wid - 1] : 0);
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return excl;
}

// Pass 2: one block of kScanThreads; thread t owns a contiguous run of slots.
__global__ void plan_items_kernel(Workspace w, int n_slots, int min_chunk, int target_items) {
  const int per = (n_slots + blockDim.x - 1) / blockDim.x;
  const int lo = min(n_slots, (int)threadIdx.x * per);
  const int hi = min(n_slots, lo + per);
  int rows = 0;
  for (int s = lo; s < hi; ++s) rows += w.counts[s];
  int total_rows;
  int r0 = block_exclusive_scan(rows, &total_rows);
  const int chunk = max(min_chunk, (int)(((long)total_rows + target_items - 1) / target_items));
  int items = 0, bigs = 0;
  for (int s = lo; s < hi; ++s) {
    const int c = w.counts[s];
    items += max(1, (c + chunk - 1) / chunk);
    bigs += c > chunk;
  }
  int total_items, total_bigs;
  int i0 = block_exclusive_scan(items, &total_items);
  int b0 = block_exclusive_scan(bigs, &total_bigs);
  for (int s = lo; s < hi; ++s) {
    const int c = w.counts[s];
    w.row_start[s] = r0;
    r0 += c;
    const int n = max(1, (c + chunk - 1) / chunk);
    for (int k = 0; k < n; ++k) {
      w.item_slot[i0 + k] = s;
      w.item_chunk[i0 + k] = k;
    }
    i0 += n;
    if (c > chunk) {
      w.big_idx[s] = b0;
      w.big_slot[b0++] = s;
    } else {
      w.big_idx[s] = -1;
    }
  }
  if (threadIdx.x == 0) {
    *w.n_items = total_items;
    *w.n_big = total_bigs;
    *w.chunk = chunk;
  }
}

// Pass 3: ridx grouped by slot; zero the big slots' accumulator.
__global__ void bucket_kernel(Workspace w, int n_rows, unsigned long long* __restrict__ acc,
                              long slot_values) {
  const long stride = (long)gridDim.x * blockDim.x;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long r = t; r < n_rows; r += stride) {
    const int s = w.slot[r];
    if (s >= 0) w.ridx[w.row_start[s] + w.rank[r]] = (int)r;
  }
  const long n_zero = (long)*w.n_big * slot_values;
  for (long i = t; i < n_zero; i += stride) acc[i] = 0ull;
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned int dst = (unsigned int)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Adds the 64-bit v into the cell held as 32-bit words *lo, *hi (shared).
__device__ __forceinline__ void add_split(unsigned int* lo, unsigned int* hi,
                                          unsigned long long v) {
  const unsigned int v_lo = (unsigned int)v;
  const unsigned int old = atomicAdd(lo, v_lo);
  const unsigned int up = (unsigned int)(v >> 32) + (old + v_lo < old ? 1u : 0u);
  if (up != 0u) atomicAdd(hi, up);
}

// Pass 4. Block = (work item, feature group), feature group fastest, so the
// blocks in flight read neighbouring segments of the same rows. Shared
// memory: the four 32-bit planes (F * B words each), then two buffers of batch_rows rows
// each: fixed-point (g, h) (int64 pair), the segment's byte offset in its
// first word (int), and stage_words words of bins.
template <typename BinT>
__global__ void __launch_bounds__(512)
    scatter_kernel(const BinT* __restrict__ bins, int m, int n_bins,
                   const float* __restrict__ g, const float* __restrict__ h, Workspace w,
                   int lg_rows, int feat_group, int n_groups, int batch_rows, int stage_words,
                   unsigned long long* __restrict__ acc, float* __restrict__ out,
                   int accumulate) {
  const int item = blockIdx.x / n_groups;
  if (item >= *w.n_items) return;
  const int grp = blockIdx.x - item * n_groups;
  const int s = w.item_slot[item];
  const int chunk = w.item_chunk[item];
  const int f0 = grp * feat_group;
  const int nf = min(feat_group, m - f0);
  const int chunk_rows = *w.chunk;
  const int nr = max(0, min(chunk_rows, w.counts[s] - chunk * chunk_rows));
  const int* __restrict__ rid = w.ridx + w.row_start[s] + chunk * chunk_rows;
  const int n_threads = blockDim.x;

  extern __shared__ unsigned long long smem[];
  // planes [f][b] of g low, g high, h low, h high words
  unsigned int* tile = (unsigned int*)smem;
  long long* sq = (long long*)(smem + (size_t)feat_group * n_bins * 2);
  int* shead = (int*)(sq + 4 * batch_rows);
  unsigned int* words = (unsigned int*)(shead + 2 * batch_rows);
  const int plane = nf * n_bins;
  const int cells = 2 * plane;  // output values of this block
  for (int i = threadIdx.x; i < 4 * plane; i += n_threads) tile[i] = 0u;

  const double sg = fixed_scale(w.absmax[0], lg_rows);
  const double sh = fixed_scale(w.absmax[1], lg_rows);
  const int seg_bytes = nf * (int)sizeof(BinT);
  const int n_batches = (nr + batch_rows - 1) / batch_rows;

  // issue the copies of batch b into buffer b & 1
  auto stage = [&](int b) {
    const int buf = (b & 1) * batch_rows;
    const int j0 = b * batch_rows;
    const int rows = min(batch_rows, nr - j0);
    for (int j = threadIdx.x; j < rows; j += n_threads) {
      const int r = rid[j0 + j];
      shead[buf + j] = (int)((uintptr_t)(bins + (size_t)r * m + f0) & 3);
      sq[2 * (buf + j)] = __double2ll_rn((double)g[r] * sg);
      sq[2 * (buf + j) + 1] = __double2ll_rn((double)h[r] * sh);
    }
    for (int i = threadIdx.x; i < rows * stage_words; i += n_threads) {
      const int j = i / stage_words;
      const int wd = i - j * stage_words;
      const uintptr_t at = (uintptr_t)(bins + (size_t)rid[j0 + j] * m + f0);
      // only words holding a byte of the segment: never past its page
      if (wd < (int)(((at & 3) + seg_bytes + 3) >> 2)) {
        cp_async4(&words[(size_t)(buf + j) * stage_words + wd],
                  (const void*)((at & ~(uintptr_t)3) + 4 * wd));
      }
    }
    cp_async_commit();
  };

  const int f = threadIdx.x % feat_group;
  const int j_step = n_threads / feat_group;
  const int j_first = threadIdx.x / feat_group;
  if (n_batches > 0) stage(0);
  for (int b = 0; b < n_batches; ++b) {
    if (b + 1 < n_batches) {
      stage(b + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = (b & 1) * batch_rows;
    const int rows = min(batch_rows, nr - b * batch_rows);
    if (f < nf) {
      for (int j = j_first; j < rows; j += j_step) {
        const unsigned char* row =
            (const unsigned char*)(words + (size_t)(buf + j) * stage_words) + shead[buf + j];
        const unsigned int bin = (unsigned int)((const BinT*)row)[f];
        if (bin == (unsigned int)kMissingBin || bin >= (unsigned int)n_bins) continue;
        const int c = f * n_bins + (int)bin;
        add_split(&tile[c], &tile[plane + c], (unsigned long long)sq[2 * (buf + j)]);
        add_split(&tile[2 * plane + c], &tile[3 * plane + c],
                  (unsigned long long)sq[2 * (buf + j) + 1]);
      }
    }
    __syncthreads();
  }
  __syncthreads();

  const int big = w.big_idx[s];
  const size_t at = ((size_t)s * m + f0) * n_bins * 2;
  // value i of the (f, b, g|h) output layout: cell i / 2 of the g (i even)
  // or h (i odd) planes
  auto sum = [&](int i) {
    const unsigned int* lo = tile + (i & 1) * 2 * plane + (i >> 1);
    return ((unsigned long long)lo[plane] << 32) | lo[0];
  };
  if (big < 0) {
    float* o = out + at;
    for (int i = threadIdx.x; i < cells; i += n_threads) {
      const float x = (float)((double)(long long)sum(i) / ((i & 1) ? sh : sg));
      o[i] = accumulate ? o[i] + x : x;
    }
  } else {
    unsigned long long* a = acc + ((size_t)big * m + f0) * n_bins * 2;
    for (int i = threadIdx.x; i < cells; i += n_threads) {
      const unsigned long long v = sum(i);
      if (v != 0ull) atomicAdd(&a[i], v);
    }
  }
}

// Pass 5: the big slots' int64 sums -> f32, written or added into out.
__global__ void finalize_big_kernel(const long long* __restrict__ acc, Workspace w,
                                    long slot_values, int lg_rows, float* __restrict__ out,
                                    int accumulate) {
  const double sg = fixed_scale(w.absmax[0], lg_rows);
  const double sh = fixed_scale(w.absmax[1], lg_rows);
  const long total = (long)*w.n_big * slot_values;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const long c = i / slot_values;
    float* o = out + (size_t)w.big_slot[c] * slot_values + (i - c * slot_values);
    const float v = (float)((double)acc[i] / ((i & 1) ? sh : sg));
    *o = accumulate ? *o + v : v;
  }
}

// Zero the workspace's header (absmax, totals, counts) before pass 1.
inline cudaError_t clear_header(int32_t* ws, int n_slots, cudaStream_t stream) {
  return cudaMemsetAsync(ws, 0, (kHeader + (size_t)n_slots) * sizeof(int32_t), stream);
}

// Raises a kernel's dynamic shared-memory limit to all that a block may take
// on device ``dev`` (current, guard::on_device), less the kernel's static
// shared memory, once per device (allowed[dev] records it), so that a page's
// launch makes no attribute
// call; a launch takes only the memory it asks for. Two threads racing here
// both store the same limit. The flags live in an unnamed namespace, one set
// per library as each library has its own kernels: a static inside a
// template would be one object for every library in the process (a GNU
// unique symbol), and the library loaded second would launch without its
// limit raised.
template <typename Kernel>
inline cudaError_t allow_max_shared(Kernel kernel, std::atomic<bool>* allowed, int dev) {
  if (allowed[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess) allowed[dev].store(true, std::memory_order_relaxed);
  return err;
}

namespace {
std::atomic<bool> scatter_allowed[2][kMaxDevices];  // int32 bins, uint8 bins
}  // namespace

template <typename BinT>
cudaError_t launch_scatter(const BinT* bins, int m, int n_bins, const float* g,
                           const float* h, Workspace w, int lg_rows, const int* plan,
                           unsigned long long* acc, float* out, int accumulate, int dev,
                           cudaStream_t stream) {
  const int feat_group = plan[kFeatGroup];
  const int n_groups = (m + feat_group - 1) / feat_group;
  const int words = plan[kStageWords];
  const int batch_rows = plan[kBatchRows];
  const int smem = plan[kSmemBytes];
  const long need = (long)feat_group * n_bins * 16 + (long)batch_rows * (40 + 8L * words);
  const long blocks = (long)plan[kItemsBound] * n_groups;
  if (smem < need || smem > kMaxBlockShared || plan[kThreads] % feat_group != 0 ||
      plan[kThreads] > 512 || (long)feat_group * sizeof(BinT) + 3 > 4L * words ||
      blocks > 0x7fffffffL) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err =
      allow_max_shared(scatter_kernel<BinT>, scatter_allowed[sizeof(BinT) == 1], dev);
  if (err != cudaSuccess) return err;
  scatter_kernel<BinT><<<(unsigned int)blocks, plan[kThreads], smem, stream>>>(
      bins, m, n_bins, g, h, w, lg_rows, feat_group, n_groups, batch_rows, words, acc, out,
      accumulate);
  return cudaGetLastError();
}

// Passes 2-5 on the caller's stream, after pass 1 has filled slot, rank,
// counts and absmax; ``dev`` is the current device (guard::on_device).
inline cudaError_t bucket_scatter(const void* bins, int bins_u8, int n_rows, int m,
                                  int n_bins, int n_slots, const float* g, const float* h,
                                  Workspace w, int lg_rows, const int* plan,
                                  unsigned long long* acc, float* out, int accumulate,
                                  int dev, cudaStream_t stream) {
  const long slot_values = (long)m * n_bins * 2;
  plan_items_kernel<<<1, kScanThreads, 0, stream>>>(w, n_slots, plan[kMinChunk],
                                                    plan[kTargetItems]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long bucket_want = ((long)n_rows + 255) / 256;
  const int bucket_blocks = (int)(bucket_want < 1024 ? (bucket_want > 0 ? bucket_want : 1) : 1024);
  bucket_kernel<<<bucket_blocks, 256, 0, stream>>>(w, n_rows, acc, slot_values);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bins_u8) {
    err = launch_scatter((const uint8_t*)bins, m, n_bins, g, h, w, lg_rows, plan, acc, out,
                         accumulate, dev, stream);
  } else {
    err = launch_scatter((const int32_t*)bins, m, n_bins, g, h, w, lg_rows, plan, acc, out,
                         accumulate, dev, stream);
  }
  if (err != cudaSuccess || plan[kBigBound] == 0) return err;
  const long fin_want = ((long)plan[kBigBound] * slot_values + 255) / 256;
  finalize_big_kernel<<<(int)(fin_want < 4096 ? fin_want : 4096), 256, 0, stream>>>(
      (const long long*)acc, w, slot_values, lg_rows, out, accumulate);
  return cudaGetLastError();
}

}  // namespace hist
