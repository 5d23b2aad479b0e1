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
// one-hot (TB, H)^T @ (TB, 3L) matmul on the MXU, with dw split into a
// bf16 head and residual, accumulated in a VMEM-resident output block
// across a sequential grid.  A GPU scatters natively, so this kernel
// scatters with f32 atomics into the pair.  hits are small integers,
// exact in any order; dsum is an f32 sum of the dw (tighter than
// bf16x2's ~2^-18) in an order that the atomics change from run to run.
//
// What bounds it on an H100: the pair's bytes, which one fill must
// write (8.9 MB for the 16^4 class), then the L2's rate of atomics,
// since the pair stays in the 50 MB L2: a train step sends up to
// 17 x 8192 = 139k updates into it.  The atomics cannot start before
// the fill has ended, so the two times add.  Rows that hit one entry
// serialise on its address, and 2048 boards collide often: empty cells
// are digit 0, so on a fresh start almost every row hits entry 0 of
// each tuple, and mid-training up to a fifth of the rows share one
// entry of a tuple.  So lanes that can collide are put in one warp, and
// their updates are merged before they reach the L2.  Two kernels:
//   - zero_pair writes the pair's zeros with 16-byte stores, and at
//     its start lets the scatter launch (programmatic dependent launch,
//     griddepcontrol), so the scatter's launch and its staging overlap
//     the fill: no gap between the two on the card;
//   - grad_class_kernel: a block takes a tile of 32 rows and stages the
//     tile's hi and lo slabs (32 x G int32 each) in shared memory with
//     16-byte loads, evict-first (the indices are read once), and its
//     dw and valid flags; rows sit at an odd stride, so reading one
//     column across the rows touches 32 distinct banks.  Then it waits
//     for the fill to end (griddepcontrol.wait), and warp w takes the
//     tuples g = w, w + warps, ... (one each for G <= 32), each across
//     the tile's 32 rows, one row per lane: lanes that can collide sit
//     in one warp.  __match_any_sync groups the lanes of valid rows by
//     entry (the other lanes hold keys that match nothing); the
//     group's lowest lane adds the group's dw in ascending lane order,
//     a fixed order, and issues one atomicAdd of that sum into dsum and
//     one of the group's size into hits.  Neither return value is used,
//     so both compile to reductions (RED) that the warp does not wait
//     for.  A fresh start's 32 rows on one entry issue 2 atomics, not
//     64; random rows, which match nothing, pay one match per update.
// Invalid rows' index words are staged with the slab but never used:
// they take no part in a match, and their dw is not read.  A valid
// row's index outside [0, H) x [0, L) is not written: dsum[g, 0, 0]
// becomes NaN instead, so a bad index shows.  Any B; an index tensor
// that is not 16-byte aligned, or a G whose rows need padding, is
// staged with 4-byte loads.
//
// Built by tpu2048_torch/ops/build.py with nvcc for sm_90a into a
// shared library with a C interface, called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;  // rows of a scatter block's tile: one per lane
constexpr int kMaxWarps = 32;
constexpr int kZeroThreads = 512;
constexpr int kZeroBlocks = 264;  // two per SM of an H100

// zeros into pair[0, n) from thread `first` of a grid `step` threads
// wide, 16-byte stores (the pair starts 16-byte aligned)
__device__ __forceinline__ void zero_range(float* __restrict__ pair,
                                          long long n, long long first,
                                          long long step) {
  const long long n4 = n >> 2;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long i = first; i < n4; i += step) {
    reinterpret_cast<float4*>(pair)[i] = z;
  }
  for (long long i = (n4 << 2) + first; i < n; i += step) pair[i] = 0.0f;
}

__global__ void __launch_bounds__(kZeroThreads)
    zero_pair(float* __restrict__ pair, long long n) {
  // the scatter may launch now; it waits for this grid's end before
  // its first atomic
  asm volatile("griddepcontrol.launch_dependents;");
  zero_range(pair, n,
             static_cast<long long>(blockIdx.x) * kZeroThreads + threadIdx.x,
             static_cast<long long>(gridDim.x) * kZeroThreads);
}

// the tile's hi and lo slabs, n int32 each, from device memory to
// shared: element i of a slab is row i / G, column i % G, stored at
// row * stride + column
__device__ __forceinline__ void stage(const int* __restrict__ hi,
                                     const int* __restrict__ lo,
                                     int* __restrict__ s_hi,
                                     int* __restrict__ s_lo, int n, int G,
                                     int stride, bool vec) {
  if (vec) {  // stride == G and both slabs 16-byte aligned
    const int n4 = n >> 2;
    const int4* h4 = reinterpret_cast<const int4*>(hi);
    const int4* l4 = reinterpret_cast<const int4*>(lo);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const int4 a = __ldcs(h4 + i);
      const int4 b = __ldcs(l4 + i);
      reinterpret_cast<int4*>(s_hi)[i] = a;
      reinterpret_cast<int4*>(s_lo)[i] = b;
    }
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += blockDim.x) {
      s_hi[i] = __ldcs(hi + i);
      s_lo[i] = __ldcs(lo + i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / G;
      const int at = r * stride + (i - r * G);
      s_hi[at] = __ldcs(hi + i);
      s_lo[at] = __ldcs(lo + i);
    }
  }
}

// one tile of 32 rows, the one at row b0: stage it, wait for the fill,
// scatter it; shared memory holds hi rows, lo rows, dw and live flags
__device__ __forceinline__ void scatter_tile(
    const int* __restrict__ hi, const int* __restrict__ lo,
    const float* __restrict__ dw, const bool* __restrict__ valid,
    float* __restrict__ dsum, float* __restrict__ hits, int B, int G, int H,
    int L, int stride, bool vec, long long b0, int* __restrict__ slab) {
  int* s_hi = slab;
  int* s_lo = slab + kRows * stride;
  float* s_dw = reinterpret_cast<float*>(s_lo + kRows * stride);
  int* s_live = reinterpret_cast<int*>(s_dw + kRows);
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        B - b0));
  const int lane = threadIdx.x & 31;
  stage(hi + b0 * G, lo + b0 * G, s_hi, s_lo, rows * G, G, stride, vec);
  if (threadIdx.x < kRows) {
    const bool live = lane < rows && valid[b0 + lane];
    s_live[lane] = live;
    s_dw[lane] = live ? dw[b0 + lane] : 0.0f;
  }
  __syncthreads();
  // the pair is zero once zero_pair's grid has ended (a no-op unless
  // this grid was launched as its dependent)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const bool live = s_live[lane];
  const int* hrow = s_hi + lane * stride;
  const int* lrow = s_lo + lane * stride;
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one
  const int warps = blockDim.x >> 5;
  for (int g = threadIdx.x >> 5; g < G; g += warps) {
    int key = -1 - lane;  // matches no other lane
    bool bad = false;
    if (live) {
      const int h = hrow[g];
      const int l = lrow[g];
      if (static_cast<unsigned>(h) < static_cast<unsigned>(H) &&
          static_cast<unsigned>(l) < static_cast<unsigned>(L)) {
        key = h * L + l;
      } else {
        bad = true;
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const long long base = static_cast<long long>(g) * H * L;
    if (key >= 0 && (peers & below) == 0) {  // the group's lowest lane
      float sum;
      if (peers == (1u << lane)) {
        sum = s_dw[lane];
      } else {  // unrolled: the 32 reads are broadcasts, issued at once
        sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if ((peers >> j) & 1u) sum = __fadd_rn(sum, s_dw[j]);
        }
      }
      atomicAdd(dsum + base + key, sum);
      atomicAdd(hits + base + key, static_cast<float>(__popc(peers)));
    }
    if (bad) atomicExch(dsum + base, __int_as_float(0x7fc00000));
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    grad_class_kernel(const int* __restrict__ hi,
                      const int* __restrict__ lo,
                      const float* __restrict__ dw,
                      const bool* __restrict__ valid,
                      float* __restrict__ dsum, float* __restrict__ hits,
                      int B, int G, int H, int L, int stride, bool vec) {
  extern __shared__ __align__(16) int slab[];
  scatter_tile(hi, lo, dw, valid, dsum, hits, B, G, H, L, stride, vec,
               static_cast<long long>(blockIdx.x) * kRows, slab);
}

int zero_blocks(long long n) {
  const long long need = (n / 4 + kZeroThreads - 1) / kZeroThreads;
  return need < 1 ? 1 : need > kZeroBlocks ? kZeroBlocks
                                           : static_cast<int>(need);
}

// how grad_class_kernel is launched for (B, G) rows from hi and lo
struct ScatterShape {
  int stride;  // of a staged row, odd: a column's rows in distinct banks
  bool vec;    // 16-byte staging: stride == G and both slabs aligned
  int warps;   // as few tuples per warp as 32 warps allow, evenly spread
  size_t smem;
  unsigned tiles;
};

ScatterShape scatter_shape(const int* hi, const int* lo, int B, int G) {
  ScatterShape sh;
  sh.stride = G | 1;
  sh.vec = sh.stride == G && ((reinterpret_cast<uintptr_t>(hi) |
                               reinterpret_cast<uintptr_t>(lo)) & 15) == 0;
  const int per_warp = (G + kMaxWarps - 1) / kMaxWarps;
  sh.warps = (G + per_warp - 1) / per_warp;
  sh.smem = sizeof(int) *
            (2 * static_cast<size_t>(kRows) * sh.stride + 2 * kRows);
  sh.tiles = static_cast<unsigned>((static_cast<long long>(B) + kRows - 1) /
                                   kRows);
  return sh;
}

}  // namespace

extern "C" {

// pair: (2, G, H, L) f32, 16-byte aligned, its contents ignored; hi,
// lo: (B, G) int32; dw: (B,) f32; valid: (B,) bool.  Returns the
// cudaError_t of the launches (0 = cudaSuccess).
int grad_class_launch(const int* hi, const int* lo, const float* dw,
                      const bool* valid, float* pair, int B, int G, int H,
                      int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = 2LL * G * H * L;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  zero_pair<<<zero_blocks(n), kZeroThreads, 0, s>>>(pair, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || B <= 0) return static_cast<int>(e);
  const ScatterShape sh = scatter_shape(hi, lo, B, G);
  if (sh.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(grad_class_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sh.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.tiles);
  cfg.blockDim = dim3(32 * sh.warps);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, grad_class_kernel, hi, lo, dw, valid, pair,
                         pair + n / 2, B, G, H, L, sh.stride, sh.vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
