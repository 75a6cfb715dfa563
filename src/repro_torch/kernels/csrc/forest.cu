// Whole-forest traversal for Hopper (sm_90a): node records and row tiles in
// shared memory, several trees walked at once per row, leaves added in tree
// order.
//
// Replaces: src/repro/kernels/forest.py::predict_forest
//           (Pallas `_forest_kernel`, one-hot MXU gathers per tree step).
//
// out[r] = margin_in[r], then out[r] = __fadd_rn(out[r], leaf_t(r)) for
// t = 0..T-1 in ascending order: the chain of pure f32 adds of the plain
// version (kernels/ref.py::predict_forest_bins), never an FMA. Each tree is
// walked at most max_depth steps from the root and stops at a leaf. The
// feature clamps into [0, m) and the child index into [0, n_nodes). A
// missing bin (255) goes default_left; any other goes left when
// b <= split_bin. The leaf table arrives pre-scaled by the learning rate
// (`kernels.ops.predict_forest`), so the kernel only adds.
//
// The TPU kernel gathered node fields and bins through one-hot matmuls over
// a (rows, trees) grid whose tree axis ran in order on one core. Here:
//
//  * pack_kernel packs each node into one record (`Node<BinT>`) that says
//    where a row goes next: the clamped feature, and a child index and a
//    window of bins that go right, with split_bin, default_left, is_leaf and
//    the clamp of children folded in, so that a step is one compare and one
//    add. Records are 8 bytes for uint8 bins, 16 for int32 bins (whose
//    split_bin stays whole); the pre-scaled leaf value is kept as f32 beside
//    them. Trees are padded to a multiple of 4 nodes, so every tree starts
//    on 16 bytes.
//  * forest_kernel: a block owns a tile of kRows rows, one thread a row. It
//    copies the tile's bins into shared memory once (cp.async, 16 bytes
//    where the rows are contiguous at an odd word stride, else rows padded
//    to one) and streams the packed forest through shared memory in chunks
//    of trees, in two buffers when two chunks fit: chunk c + 1 is copied
//    while chunk c is walked.
//  * A thread walks its row through kWalk trees of the chunk at once: kWalk
//    independent chains of max_depth branch-free steps, each one shared
//    load of a record and one of a bin. Then it adds the kWalk leaves in
//    tree order onto its margin, which stays in a register for the whole
//    forest. No atomics and no other order of adds. Every lane of a warp
//    walks the same tree, so the top levels' records are broadcast, and a
//    row's bins lie at an odd word stride, so one feature of 32 rows is read
//    without bank conflicts.
//  * A tree too large for shared memory beside the tile is walked by the
//    same kernel from the packed records in global memory; a tile too wide
//    for shared memory beside a tree is read from global memory.
//
// What bounds it on this card: at one chunk of trees (the fitted forest of
// 10), copying the tile's bins, whole rows though the walks of a fitted
// forest read few of their bytes; with one block an SM the copy does not
// overlap the walks. With hundreds of trees, the walks' shared loads (a
// record and a bin a step; the lanes' nodes and features differ below the
// top levels, so the loads meet bank conflicts) and issuing about a dozen
// instructions a step; the forest, re-read from L2 for every tile, is
// copied behind the walks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kMissingBin = 255;
constexpr int kRows = 256;            // rows a block owns, one thread each
constexpr int kWalk = 4;              // trees a thread walks at once
constexpr int kSmemBudget = 232448;   // 227 KB, the most a block may hold
constexpr int kPackThreads = 256;
using guard::kMaxDevices;

enum Copy { kCopy16 = 0, kCopy4 = 1, kCopy1 = 2 };

template <typename BinT>
struct Node;

// A record says where a row at this node goes next: next = child + right,
// with the leaf freeze and the clamp of children into [0, n_nodes) folded
// in at packing. A leaf has child = its own index and never goes right; a
// node whose children both clamp has child = n_nodes - 1 and never goes
// right; any other has child = 2p + 1 (which is < n_nodes - 1).
//
// uint8 bins: x = feature (bits 0-23) | lo << 24, y = child << 9 | w, with
// lo = clamp(split_bin, -1, 254) + 1 and w = 256 - default_left - lo. A bin
// b goes right exactly when lo <= b < 256 - default_left, that is when
// (unsigned)(b - lo) < w: for b in [0, 254], b > split_bin; b = 255 goes
// right unless default_left. A node that never goes right has w = 0.
template <>
struct Node<uint8_t> {
  using Rec = uint2;
  __device__ static Rec pack(int f, int split, bool dl, int child, bool right) {
    const uint32_t lo = (uint32_t)(min(max(split, -1), 254) + 1);
    const uint32_t w = right ? 256u - (uint32_t)dl - lo : 0u;
    return make_uint2((uint32_t)f | (lo << 24), ((uint32_t)child << 9) | w);
  }
  __device__ static int feature(Rec r) { return (int)(r.x & 0xffffffu); }
  __device__ static int next(Rec r, int b) {
    return (int)(r.y >> 9) + ((uint32_t)(b - (int)(r.x >> 24)) < (r.y & 0x1ffu) ? 1 : 0);
  }
};

// int32 bins may hold any value, so split_bin stays whole: x = feature,
// y = split_bin, z = child, w = where a missing bin goes (1 right). A node
// that never goes right has y = INT_MAX and w = 0.
template <>
struct Node<int32_t> {
  using Rec = uint4;
  __device__ static Rec pack(int f, int split, bool dl, int child, bool right) {
    return make_uint4((uint32_t)f, (uint32_t)(right ? split : 0x7fffffff), (uint32_t)child,
                      right && !dl ? 1u : 0u);
  }
  __device__ static int feature(Rec r) { return (int)r.x; }
  __device__ static int next(Rec r, int b) {
    return (int)r.z + (b == kMissingBin ? (int)r.w : (b > (int)r.y ? 1 : 0));
  }
};

__host__ __device__ constexpr long round16(long x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename BinT>
__global__ void __launch_bounds__(kPackThreads) pack_kernel(
    const int32_t* __restrict__ feature, const int32_t* __restrict__ split_bin,
    const uint8_t* __restrict__ default_left, const uint8_t* __restrict__ is_leaf,
    const float* __restrict__ leaf_value, int n_trees, int n_nodes, int n_pad, int m,
    typename Node<BinT>::Rec* __restrict__ recs, float* __restrict__ leaves) {
  const long i = (long)blockIdx.x * kPackThreads + threadIdx.x;
  if (i >= (long)n_trees * n_pad) return;
  const long t = i / n_pad;
  const int j = (int)(i - t * n_pad);
  if (j >= n_nodes) {  // padding: never reached, no child reaches n_nodes
    recs[i] = Node<BinT>::pack(0, 0, false, j, false);
    leaves[i] = 0.f;
    return;
  }
  const long src = t * n_nodes + j;
  const int f = feature[src];
  const bool inner = is_leaf[src] == 0;
  const bool clamped = 2 * (long)j + 2 > n_nodes - 1;  // both children clamp to n_nodes - 1
  recs[i] = Node<BinT>::pack(f < 0 ? 0 : (f < m ? f : m - 1), split_bin[src],
                             default_left[src] != 0,
                             inner ? (clamped ? n_nodes - 1 : 2 * j + 1) : j,
                             inner && !clamped);
  leaves[i] = leaf_value[src];
}

// The tile's rows into shared memory at `stride` bytes a row.
__device__ __forceinline__ void stage_tile(const unsigned char* __restrict__ src,
                                           unsigned char* dst, int rows, int row_bytes,
                                           int stride, int copy) {
  const int tid = threadIdx.x;
  const int total = rows * row_bytes;
  if (copy == kCopy16) {  // stride == row_bytes, 16-byte aligned source
    const int n16 = total >> 4;
    for (int i = tid; i < n16; i += kRows) cp_async16(dst + 16 * i, src + 16 * (long)i);
    for (int i = (n16 << 4) + tid; i < total; i += kRows) dst[i] = src[i];
  } else if (copy == kCopy4) {  // whole words, a row padded to an odd word count
    const int words = row_bytes >> 2;
    for (int row = tid >> 5; row < rows; row += kRows / 32)
      for (int w = tid & 31; w < words; w += 32)
        cp_async4(dst + row * stride + 4 * w, src + (long)row * row_bytes + 4 * w);
  } else {
    for (int i = tid; i < total; i += kRows)
      dst[(i / row_bytes) * stride + i % row_bytes] = src[i];
  }
}

// `bytes` (a multiple of 16, 16-byte aligned both sides) into shared memory.
__device__ __forceinline__ void stage16(const unsigned char* __restrict__ src,
                                        unsigned char* dst, long bytes) {
  for (long i = threadIdx.x; i < bytes >> 4; i += kRows) cp_async16(dst + 16 * i, src + 16 * i);
}

// Trees g .. g + K - 1 of a chunk for one row: K independent chains of
// max_depth branch-free steps, then the K leaves added in tree order.
template <typename N, int K, typename BinT>
__device__ __forceinline__ float walk(const typename N::Rec* nodes, const float* lv,
                                      const BinT* row, int g, int n_pad, int max_depth,
                                      float acc) {
  int p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = 0;
  for (int d = 0; d < max_depth; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const typename N::Rec rec = nodes[(g + k) * n_pad + p[k]];
      p[k] = N::next(rec, (int)row[N::feature(rec)]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, lv[(g + k) * n_pad + p[k]]);
  return acc;
}

// The chunk's last `rest` trees (fewer than kWalk) as one group of walks.
template <typename N, int K, typename BinT>
__device__ __forceinline__ float walk_rest(int rest, const typename N::Rec* nodes,
                                           const float* lv, const BinT* row, int g, int n_pad,
                                           int max_depth, float acc) {
  if constexpr (K == 0) {
    return acc;
  } else {
    if (rest == K) return walk<N, K>(nodes, lv, row, g, n_pad, max_depth, acc);
    return walk_rest<N, K - 1>(rest, nodes, lv, row, g, n_pad, max_depth, acc);
  }
}

template <typename BinT, bool kBinsShared, bool kNodesShared>
__global__ void __launch_bounds__(kRows) forest_kernel(
    const BinT* __restrict__ bins, int n_rows, int m, int stride, int copy,
    const typename Node<BinT>::Rec* __restrict__ recs, const float* __restrict__ leaves,
    int n_trees, int n_pad, int max_depth, int chunk, int n_buf,
    const float* __restrict__ margin_in, float* __restrict__ out) {
  using N = Node<BinT>;
  using Rec = typename N::Rec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const long r0 = (long)blockIdx.x * kRows;
  const long r = r0 + tid;
  const long bins_bytes = kBinsShared ? round16((long)kRows * stride) : 0;
  const long chunk_nodes = (long)chunk * n_pad;
  Rec* s_recs = (Rec*)(smem + bins_bytes);
  float* s_leaves = (float*)(smem + bins_bytes + n_buf * chunk_nodes * (long)sizeof(Rec));

  // trees t0 .. t0 + cnt - 1 of the packed forest into buffer `buf`
  auto stage_chunk = [&](int t0, int cnt, int buf) {
    stage16((const unsigned char*)(recs + (long)t0 * n_pad),
            (unsigned char*)(s_recs + buf * chunk_nodes), cnt * (long)n_pad * sizeof(Rec));
    stage16((const unsigned char*)(leaves + (long)t0 * n_pad),
            (unsigned char*)(s_leaves + buf * chunk_nodes), cnt * (long)n_pad * 4);
  };
  if (kBinsShared && n_trees > 0)
    stage_tile((const unsigned char*)(bins + r0 * m), smem,
               (int)min((long)kRows, (long)n_rows - r0), m * (int)sizeof(BinT), stride, copy);
  if (kNodesShared && n_trees > 0) stage_chunk(0, min(chunk, n_trees), 0);
  cp_async_commit();

  const BinT* row = kBinsShared ? (const BinT*)(smem + tid * stride) : bins + r * m;
  float acc = r < n_rows ? margin_in[r] : 0.f;
  for (int t0 = 0, c = 0; t0 < n_trees; t0 += chunk, ++c) {
    const int cnt = min(chunk, n_trees - t0);
    const int buf = n_buf == 2 ? (c & 1) : 0;
    if (kNodesShared && n_buf == 1 && c > 0) {  // every walk of chunk c - 1 ends first
      __syncthreads();
      stage_chunk(t0, cnt, 0);
      cp_async_commit();
    }
    if (kNodesShared || c == 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    // two buffers: chunk c + 1 goes where chunk c - 1 was, whose walks all
    // ended before the barrier above
    if (kNodesShared && n_buf == 2 && t0 + cnt < n_trees) {
      stage_chunk(t0 + cnt, min(chunk, n_trees - t0 - cnt), buf ^ 1);
      cp_async_commit();
    }
    const Rec* nodes = kNodesShared ? s_recs + buf * chunk_nodes : recs + (long)t0 * n_pad;
    const float* lv = kNodesShared ? s_leaves + buf * chunk_nodes : leaves + (long)t0 * n_pad;
    if (r < n_rows) {
      int g = 0;
      for (; g + kWalk <= cnt; g += kWalk)
        acc = walk<N, kWalk>(nodes, lv, row, g, n_pad, max_depth, acc);
      acc = walk_rest<N, kWalk - 1>(cnt - g, nodes, lv, row, g, n_pad, max_depth, acc);
    }
  }
  if (r < n_rows) out[r] = acc;
}

bool g_attr_set[8][kMaxDevices];  // [instantiation][device]: smem limit raised

template <typename BinT, bool kBinsShared, bool kNodesShared>
int launch(int dev, const BinT* bins, int n_rows, int m, int stride, int copy,
           const typename Node<BinT>::Rec* recs, const float* leaves, int n_trees,
           int n_pad, int max_depth, int chunk, int n_buf, long smem,
           const float* margin_in, float* out, cudaStream_t stream) {
  auto kernel = forest_kernel<BinT, kBinsShared, kNodesShared>;
  bool& set = g_attr_set[(sizeof(BinT) == 1 ? 0 : 4) + 2 * kBinsShared + kNodesShared][dev];
  if (!set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return (int)err;
    set = true;
  }
  const int blocks = (int)(((long)n_rows + kRows - 1) / kRows);
  kernel<<<blocks, kRows, smem, stream>>>(bins, n_rows, m, stride, copy, recs, leaves, n_trees,
                                          n_pad, max_depth, chunk, n_buf, margin_in, out);
  return (int)cudaGetLastError();
}

template <typename BinT>
int run(const void* bins_ptr, int n_rows, int m, const int32_t* feature,
        const int32_t* split_bin, const uint8_t* default_left, const uint8_t* is_leaf,
        const float* leaf_value, int n_trees, int n_nodes, int max_depth,
        const float* margin_in, float* out, void* scratch, int dev, cudaStream_t stream) {
  using Rec = typename Node<BinT>::Rec;
  cudaError_t err = cudaSuccess;
  const BinT* bins = (const BinT*)bins_ptr;
  const int n_pad = (n_nodes + 3) / 4 * 4;
  Rec* recs = (Rec*)scratch;
  float* leaves = (float*)((unsigned char*)scratch + (long)n_trees * n_pad * sizeof(Rec));
  if (n_trees > 0) {
    const long nodes = (long)n_trees * n_pad;
    pack_kernel<BinT><<<(unsigned)((nodes + kPackThreads - 1) / kPackThreads), kPackThreads, 0,
                        stream>>>(feature, split_bin, default_left, is_leaf, leaf_value,
                                  n_trees, n_nodes, n_pad, m, recs, leaves);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // shared memory: the tile at an odd word stride where rows are whole
  // words, and as many trees as fit beside it, twice if two chunks fit
  const long row_bytes = (long)m * sizeof(BinT);
  const long stride = (row_bytes % 4 == 0 && (row_bytes / 4) % 2 == 0) ? row_bytes + 4 : row_bytes;
  const uintptr_t addr = (uintptr_t)bins_ptr;
  const int copy = (stride == row_bytes && addr % 16 == 0) ? kCopy16
                   : (row_bytes % 4 == 0 && addr % 4 == 0) ? kCopy4
                                                           : kCopy1;
  const long tile_bytes = round16(kRows * stride);
  const long tree_bytes = (long)n_pad * (sizeof(Rec) + 4);
  bool bins_shared, nodes_shared;
  if (tree_bytes > kSmemBudget) {
    nodes_shared = false;
    bins_shared = tile_bytes <= kSmemBudget;
  } else {
    nodes_shared = true;
    bins_shared = tile_bytes + tree_bytes <= kSmemBudget;
  }
  const long avail = kSmemBudget - (bins_shared ? tile_bytes : 0);
  int chunk = n_trees, n_buf = 0;
  if (nodes_shared) {
    const long fit1 = avail / tree_bytes;
    if (fit1 >= n_trees) {
      n_buf = 1;
    } else {
      const long fit2 = avail / (2 * tree_bytes);
      n_buf = fit2 >= 1 ? 2 : 1;
      chunk = (int)(n_buf == 2 ? fit2 : fit1);
      if (chunk > kWalk) chunk -= chunk % kWalk;  // whole groups of walks
    }
  }
  const long smem = (bins_shared ? tile_bytes : 0) + (long)n_buf * chunk * tree_bytes;
#define FOREST_LAUNCH(B, N)                                                             \
  return launch<BinT, B, N>(dev, bins, n_rows, m, B ? (int)stride : 0, copy, recs, leaves, \
                            n_trees, n_pad, max_depth, chunk, n_buf, smem,                 \
                            margin_in, out, stream)
  if (bins_shared && nodes_shared) FOREST_LAUNCH(true, true);
  if (bins_shared) FOREST_LAUNCH(true, false);
  if (nodes_shared) FOREST_LAUNCH(false, true);
  FOREST_LAUNCH(false, false);
#undef FOREST_LAUNCH
}

}  // namespace

// bins: (n_rows, m) uint8 (bins_u8 == 1) or int32, row-major; the five
// planes (n_trees, n_nodes) row-major, default_left and is_leaf as bytes,
// leaf_value pre-scaled f32; scratch: n_trees * round_up(n_nodes, 4)
// records (8 bytes each for uint8 bins, 16 for int32) followed by as many
// f32 leaves, 16-byte aligned; out: (n_rows,) f32. For uint8 bins
// m <= 2^24 and n_nodes <= 2^23 (the record's fields); n_nodes >= 1,
// n_rows >= 1: the wrapper checks. The launches run on ``device``, the
// tensors' (guard::on_device), on its stream stream_ptr.
extern "C" int forest_launch(const void* bins, int bins_u8, int n_rows, int m,
                             const int32_t* feature, const int32_t* split_bin,
                             const uint8_t* default_left, const uint8_t* is_leaf,
                             const float* leaf_value, int n_trees, int n_nodes,
                             int max_depth, const float* margin_in, float* out,
                             void* scratch, int device, void* stream_ptr) {
  return guard::on_device(device, [&]() -> int {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (bins_u8)
      return run<uint8_t>(bins, n_rows, m, feature, split_bin, default_left, is_leaf,
                          leaf_value, n_trees, n_nodes, max_depth, margin_in, out, scratch,
                          device, stream);
    return run<int32_t>(bins, n_rows, m, feature, split_bin, default_left, is_leaf,
                        leaf_value, n_trees, n_nodes, max_depth, margin_in, out, scratch,
                        device, stream);
  });
}
