// grad_class: the gradient pair of a stacked (G, H, L) class of n-tuple
// tables, one (2, G, H, L) f32 tensor, row 0 dsum and row 1 hits,
//   pair[0, g, hi[b, g], lo[b, g]] = sum of dw[b]   over the valid rows b,
//   pair[1, g, hi[b, g], lo[b, g]] = their count,
// zero elsewhere.  The pair is the D4 fold's input as it stands
// (fold_class reads it as (2, G, H * L)), so the train step copies
// nothing between the two kernels.
//
// Replaces tpu2048/ops/pallas_kernels.py::grad_for (its _grad_kernel).
// The TPU kernel is the transpose of the one-hot lookup: per tuple, a
// one-hot (TB, H)^T @ (TB, 3L) matmul on the MXU, accumulated in a
// VMEM-resident output block across a sequential grid of row tiles, so
// every entry's sum is taken in one fixed order and a seed gives one
// result.  Blocks of a GPU run in no order, and f32 atomics add in the
// order they arrive, which changes from run to run: this kernel issues
// no floating-point atomic.  Every dsum is an f32 sum in an order that
// depends only on the rows' positions, so two launches on one input give
// the same bits (``kernels.grad_class_ordered`` is the same arithmetic in
// plain PyTorch).  hits are integers, exact in any order.
//
// The order: per tuple, the valid rows are put in a stable order by hi
// (a counting sort: bucket h holds the rows whose index has hi = h, in
// row order), and bucket (g, h) is reduced into the pair's row
// pair[., g, h, :]:
//   - the bucket's rows are cut into chunks of 32 consecutive
//     positions; W warps take them, warp w the chunks w, w + W, ... in
//     turn: W = 1 for a bucket of at most kSmallChunks chunks (a warp
//     of its own), else W = min(32, chunks) warps of one block;
//   - in a chunk, __match_any_sync groups the lanes by lo; the group's
//     lowest lane adds the group's dw in ascending lane order from 0.0,
//     then adds that sum to its warp's own accumulator for lo (shared
//     memory, one row of L per warp), and the group's size to its count;
//   - then the W warps' accumulators of each lo are added in warp order
//     from 0.0, and dsum and hits written with plain stores: every
//     entry of the pair, zeros included, is written once, so no fill
//     runs first.
// Four kernels, each launched as the previous one's programmatic
// dependent (griddepcontrol), so each one's launch overlaps the last
// one's tail:
//   1. grad_class_count: a block per (tile of 1024 rows, 4 tuples)
//      writes each row's key (hi << 16 | lo, or -1 for an invalid row
//      or an out-of-range index) in (G, B) order, and counts its rows
//      per (tuple, hi) in shared memory, warp-aggregated by
//      __match_any_sync (a fresh start puts almost every row on one
//      hi); bin H counts the valid rows with a bad index;
//   2. grad_class_scan: a block per tuple turns its (H + 1, tiles)
//      counts into exclusive offsets in (bin, tile) order, 1024 at a
//      time, and its total;
//   3. grad_class_place: a block per (tile, tuple) ranks each row among
//      the tile's earlier rows of its bucket (the per-warp bucket
//      counts of the earlier warps, scanned across warps by shuffles,
//      plus __popc of the lower lanes of its __match_any_sync group)
//      and writes (lo, dw) at its bucket's offset plus that rank: a
//      stable order with no atomics at all;
//   4. grad_class_reduce: a block per (set of buckets, tuple), its
//      buckets h = x, x + gridDim.x, ... spread over the hi range (the
//      low digits, empty cells and small tiles, hold most rows); its
//      warps take the small buckets one each, then the block the larger
//      ones one by one.
// What bounds it on an H100: the pair's bytes, which every launch must
// write (8.9 MB for the 16^4 class, 2.66 us at 3.35 TB/s); then the
// four launches' own latency, each waiting for the last; the rows'
// keys and sorted (lo, dw) (12 bytes per row and tuple, 1.7 MB at 8192
// rows of 17 tuples) stay in the L2.  A bucket's rows serialise only
// through its warps' chunks: the "index" learner's 61,880 rows on one
// entry take 61 chunks per warp.
// A valid row's index outside [0, H) x [0, L) is not added: dsum[g, 0,
// 0] becomes NaN instead, so a bad index shows.  Any B; H, L <= 256.
//
// Built by tpu2048_torch/ops/build.py with nvcc for sm_90a into a
// shared library with a C interface, called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;   // rows of a count or place block, one a thread
constexpr int kTileWarps = kTile / 32;
constexpr int kWarps = 32;    // the most warps that reduce one bucket
constexpr int kSmallChunks = 4;  // a bucket of at most 4 chunks: one warp
constexpr int kCountTuples = 4;  // tuples of one count block
constexpr int kSMs = 132;        // an H100 SXM's
constexpr int kMaxSide = 256; // H and L
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// the previous kernel of the chain has ended and its writes are visible
// (a no-op for a grid launched without the programmatic attribute)
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// a block per (tile, kCountTuples tuples)
__global__ void __launch_bounds__(kTile)
    grad_class_count(const int* __restrict__ hi, const int* __restrict__ lo,
                     const bool* __restrict__ valid, int* __restrict__ keys,
                     int* __restrict__ counts, int B, int G, int H, int L,
                     int tiles) {
  extern __shared__ int hist[];  // (kCountTuples, H + 1)
  launch_dependents();
  const int bins = H + 1;
  const int g0 = blockIdx.y * kCountTuples;
  const int ng = min(kCountTuples, G - g0);
  for (int i = threadIdx.x; i < ng * bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const long long b = static_cast<long long>(blockIdx.x) * kTile +
                      threadIdx.x;
  const bool in = b < B;
  const bool live = in && valid[b];
  for (int t = 0; t < ng; ++t) {
    const int g = g0 + t;
    int bin = -1 - static_cast<int>(threadIdx.x & 31);  // matches no lane
    int key = -1;
    if (live) {
      const int h = hi[b * G + g];
      const int l = lo[b * G + g];
      if (static_cast<unsigned>(h) < static_cast<unsigned>(H) &&
          static_cast<unsigned>(l) < static_cast<unsigned>(L)) {
        key = (h << 16) | l;
        bin = h;
      } else {
        bin = H;
      }
    }
    const unsigned peers = __match_any_sync(kAll, bin);
    if (bin >= 0 && (peers & lanes_below()) == 0) {
      atomicAdd(hist + t * bins + bin, __popc(peers));  // integers: exact
    }
    if (in) keys[g * static_cast<long long>(B) + b] = key;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * bins; i += blockDim.x) {
    counts[(static_cast<long long>(g0) * bins + i) * tiles + blockIdx.x] =
        hist[i];
  }
}

// the exclusive prefix sum over the block's 1024 threads of ``v``, and
// the block's total in ``*total`` (every thread); ``warp_sums`` holds 32
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums,
                                               int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();  // warp_sums is free
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int w = warp_sums[lane];
  int w_incl = w;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kAll, w_incl, o);
    if (lane >= o) w_incl += u;
  }
  *total = __shfl_sync(kAll, w_incl, 31);
  return __shfl_sync(kAll, w_incl - w, warp) + incl - v;
}

// one block of 1024 threads per tuple: its n = (H + 1) * tiles counts,
// in (bin, tile) order, become exclusive offsets, 1024 at a time with
// a running carry; totals[g] their sum
__global__ void __launch_bounds__(1024)
    grad_class_scan(int* __restrict__ counts, int* __restrict__ totals,
                    int n) {
  __shared__ int warp_sums[32];
  launch_dependents();
  wait_for_previous();
  int* c = counts + static_cast<long long>(blockIdx.x) * n;
  int carry = 0;
  for (int at = 0; at < n; at += 1024) {
    const int i = at + threadIdx.x;
    const int v = i < n ? c[i] : 0;
    int total;
    const int before = block_exclusive(v, warp_sums, &total);
    if (i < n) c[i] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kTile)
    grad_class_place(const int* __restrict__ keys,
                     const float* __restrict__ dw,
                     const int* __restrict__ offsets,
                     int2* __restrict__ sorted, int B, int H, int tiles) {
  // (kTileWarps, H + 1): a bucket's counts of the 32 warps in 32 banks
  extern __shared__ int warp_counts[];
  const int stride = H + 1;
  launch_dependents();
  for (int i = threadIdx.x; i < kTileWarps * stride; i += blockDim.x) {
    warp_counts[i] = 0;
  }
  __syncthreads();
  wait_for_previous();
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kTile +
                      threadIdx.x;
  const int key = b < B ? keys[g * static_cast<long long>(B) + b] : -1;
  const int bin = key >= 0 ? key >> 16 : -1 - lane;
  const unsigned peers = __match_any_sync(kAll, bin);
  const int rank = __popc(peers & lanes_below());
  if (key >= 0 && rank == 0) {
    warp_counts[warp * stride + bin] = __popc(peers);
  }
  __syncthreads();
  // per bucket, the rows of the tile's earlier warps: warp k scans
  // buckets k, k + 32, ... across the 32 warps, one warp a lane
  static_assert(kTileWarps == 32, "the warps' scan takes one warp a lane");
  for (int t = warp; t < H; t += kTileWarps) {
    const int c = warp_counts[lane * stride + t];
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += u;
    }
    warp_counts[lane * stride + t] = incl - c;
  }
  __syncthreads();
  if (key >= 0) {
    const int at =
        offsets[(static_cast<long long>(g) * (H + 1) + bin) * tiles +
                blockIdx.x] +
        warp_counts[warp * stride + bin] + rank;
    sorted[g * static_cast<long long>(B) + at] =
        make_int2(key & 0xffff, __float_as_int(dw[b]));
  }
}

// one warp's share of the bucket [start, end): its chunks first, first +
// step, ... in turn, each chunk's groups of one lo summed in ascending lane
// order from 0.0 and added to the warp's accumulators ``acc`` and ``cnt``
// (L each); ``x_at`` is the warp's 32 floats of staging
__device__ __forceinline__ void warp_chunks(const int2* __restrict__ rows,
                                            int start, int end, int first,
                                            int step, float* acc, int* cnt,
                                            float* x_at) {
  const int lane = threadIdx.x & 31;
  const int chunks = (end - start + 31) >> 5;
  int p = start + first * 32 + lane;
  int2 e = make_int2(-1, 0);
  if (first < chunks && p < end) e = rows[p];
  for (int c = first; c < chunks; c += step) {
    const bool in = p < end;
    const int key = in ? e.x : -1 - lane;  // an idle lane matches no lane
    const float x = __int_as_float(e.y);
    p += step * 32;
    if (c + step < chunks && p < end) e = rows[p];  // next chunk, in flight
    const unsigned peers = __match_any_sync(kAll, key);
    x_at[lane] = x;
    __syncwarp();
    if (in && (peers & lanes_below()) == 0) {  // the group's lowest lane
      // alone, x is the sum (+0.0 or -0.0 add alike to the accumulator,
      // which starts at +0.0); else the group in lane order, unrolled so
      // that the 32 reads, broadcasts, issue at once
      float sum = x;
      if (peers != (1u << lane)) {
        sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if ((peers >> j) & 1u) sum = __fadd_rn(sum, x_at[j]);
        }
      }
      acc[key] = __fadd_rn(acc[key], sum);
      cnt[key] += __popc(peers);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    grad_class_reduce(const int2* __restrict__ sorted,
                      const int* __restrict__ offsets,
                      const int* __restrict__ totals,
                      float* __restrict__ dsum, float* __restrict__ hits,
                      int B, int H, int L, int tiles, int per_block) {
  extern __shared__ __align__(16) int smem[];
  float* acc = reinterpret_cast<float*>(smem);  // (kWarps, L)
  int* cnt = smem + kWarps * L;                  // (kWarps, L)
  float* xs = reinterpret_cast<float*>(cnt + kWarps * L);  // (kWarps, 32)
  // per bucket its start and end
  int* bounds = reinterpret_cast<int*>(xs + kWarps * 32);  // (per_block, 2)
  wait_for_previous();
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* off = offsets + static_cast<long long>(g) * (H + 1) * tiles;
  const int2* rows = sorted + g * static_cast<long long>(B);
  // valid rows with a bad index sit in bin H, past every bucket
  const bool bad = totals[g] > off[static_cast<long long>(H) * tiles];
  // the block's buckets h = blockIdx.x + i * gridDim.x: spread, since
  // the low digits (empty cells, small tiles) hold most rows
  const int nb = min(per_block,
                     (H - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
                         gridDim.x);
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) {
    const int h = blockIdx.x + (i >> 1) * gridDim.x + (i & 1);
    bounds[i] = off[static_cast<long long>(h) * tiles];
  }
  __syncthreads();
  const float nan = __int_as_float(0x7fc00000);
  // buckets of at most kSmallChunks chunks: one warp each
  for (int i = warp; i < nb; i += kWarps) {
    const int start = bounds[2 * i], end = bounds[2 * i + 1];
    if (end - start > 32 * kSmallChunks) continue;
    float* my_acc = acc + warp * L;
    int* my_cnt = cnt + warp * L;
    for (int l = lane; l < L; l += 32) {
      my_acc[l] = 0.0f;
      my_cnt[l] = 0;
    }
    __syncwarp();
    warp_chunks(rows, start, end, 0, 1, my_acc, my_cnt, xs + warp * 32);
    __syncwarp();
    const int h = blockIdx.x + i * gridDim.x;
    const long long row = (static_cast<long long>(g) * H + h) * L;
    for (int l = lane; l < L; l += 32) {
      dsum[row + l] = bad && h == 0 && l == 0 ? nan : my_acc[l];
      hits[row + l] = static_cast<float>(my_cnt[l]);
    }
    __syncwarp();
  }
  // larger buckets: W = min(kWarps, chunks) warps of the block each
  for (int i = 0; i < nb; ++i) {
    const int start = bounds[2 * i], end = bounds[2 * i + 1];
    const int chunks = (end - start + 31) >> 5;
    if (chunks <= kSmallChunks) continue;
    const int warps = min(kWarps, chunks);
    __syncthreads();  // every warp is done with its accumulators
    for (int j = threadIdx.x; j < warps * L; j += blockDim.x) {
      acc[j] = 0.0f;
      cnt[j] = 0;
    }
    __syncthreads();
    if (warp < warps) {
      warp_chunks(rows, start, end, warp, warps, acc + warp * L,
                  cnt + warp * L, xs + warp * 32);
    }
    __syncthreads();
    const int h = blockIdx.x + i * gridDim.x;
    const long long row = (static_cast<long long>(g) * H + h) * L;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      float total = 0.0f;  // the warps' sums in warp order
      int count = 0;
      for (int w = 0; w < warps; ++w) {
        total = __fadd_rn(total, acc[w * L + l]);
        count += cnt[w * L + l];
      }
      dsum[row + l] = bad && h == 0 && l == 0 ? nan : total;
      hits[row + l] = static_cast<float>(count);
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// cfg for a kernel that may start while the previous one ends
cudaLaunchConfig_t dependent(dim3 grid, dim3 block, size_t smem,
                             cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr->val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// int32 words of scratch that grad_class_launch needs for (B, G, H)
long long grad_class_scratch_words(int B, int G, int H) {
  const long long tiles = (static_cast<long long>(B) + kTile - 1) / kTile;
  return 3LL * G * B + static_cast<long long>(G) * (H + 1) * tiles + G;
}

// pair: (2, G, H, L) f32, its contents ignored; hi, lo: (B, G) int32;
// dw: (B,) f32; valid: (B,) bool; scratch: grad_class_scratch_words
// int32 words, 8-byte aligned.  Returns the cudaError_t of the launches
// (0 = cudaSuccess).
int grad_class_launch(const int* hi, const int* lo, const float* dw,
                      const bool* valid, float* pair, int* scratch,
                      long long scratch_words, int B, int G, int H, int L,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = 2LL * G * H * L;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (H > kMaxSide || L > kMaxSide || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) {
    return static_cast<int>(
        cudaMemsetAsync(pair, 0, n * sizeof(float), s));
  }
  if (scratch_words < grad_class_scratch_words(B, G, H) ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (B + kTile - 1) / kTile;
  int2* sorted = reinterpret_cast<int2*>(scratch);
  int* keys = scratch + 2LL * G * B;
  int* counts = keys + static_cast<long long>(G) * B;
  int* totals = counts + static_cast<long long>(G) * (H + 1) * tiles;

  const size_t smem1 = sizeof(int) * kCountTuples * (H + 1);
  grad_class_count<<<dim3(tiles, (G + kCountTuples - 1) / kCountTuples),
                     kTile, smem1, s>>>(hi, lo, valid, keys, counts, B, G, H,
                                        L, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = dependent(dim3(G), dim3(1024), 0, s, attr);
  e = cudaLaunchKernelEx(&cfg, grad_class_scan, counts, totals,
                         (H + 1) * tiles);
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t smem3 =
      sizeof(int) * static_cast<size_t>(kTileWarps) * (H + 1);
  cfg = dependent(dim3(tiles, G), dim3(kTile), smem3, s, attr);
  e = cudaLaunchKernelEx(&cfg, grad_class_place,
                         static_cast<const int*>(keys), dw,
                         static_cast<const int*>(counts), sorted, B, H,
                         tiles);
  if (e != cudaSuccess) return static_cast<int>(e);

  // at most two blocks an SM, a run of buckets each
  const int per_tuple = max(1, 2 * kSMs / G);
  const int per_block = min(kWarps, (H + per_tuple - 1) / per_tuple);
  const size_t smem4 =
      sizeof(int) * (2 * static_cast<size_t>(kWarps) * (L + 16) +
                     2 * per_block);
  e = allow_smem(reinterpret_cast<const void*>(grad_class_reduce), smem4);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg = dependent(dim3((H + per_block - 1) / per_block, G),
                  dim3(32 * kWarps), smem4, s, attr);
  e = cudaLaunchKernelEx(&cfg, grad_class_reduce,
                         static_cast<const int2*>(sorted),
                         static_cast<const int*>(counts),
                         static_cast<const int*>(totals), pair, pair + n / 2,
                         B, H, L, tiles, per_block);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
