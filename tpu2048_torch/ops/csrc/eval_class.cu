// eval_class: V[b] = sum_g T[g, hi[b, g], lo[b, g]] for a stacked
// (G, H, L) f32 class block of n-tuple tables, accumulated in f32 in
// the order g = 0 .. G-1 (acc = acc + term, from 0).
//
// Replaces tpu2048/ops/pallas_kernels.py::eval_class (its three
// precisions).  The TPU kernel turns each lookup into a one-hot matmul
// on the MXU, because random gathers are slow there, and splits the
// f32 table into a bf16 head and residual ("bf16x2") to run the MXU at
// its bf16 rate.  A GPU gathers natively, so this kernel gathers:
//   - "f32" and "bf16x2" add the exact f32 entries (tighter than
//     bf16x2's ~2^-18; the head/residual split is not ported);
//   - "bf16" rounds each gathered f32 entry to bf16, to nearest even
//     (__float2bfloat16_rn), and widens it: bitwise the term of a
//     round-to-nearest-even bf16 copy of the table, without the copy.
//
// What bounds it on an H100: bytes, and L2 sectors.  The class block
// (at most 17 x 256 x 256 f32 = 4.5 MB) stays in the 50 MB L2; the
// (B, G) int32 hi and lo are read once from device memory, 96% of the
// bytes at the search tree's 2M-row chunks.  The first form of this
// kernel had one thread per row read its own hi[b, :] and lo[b, :], a
// G * 4-byte stride across the warp, so every index load touched ~32
// sectors (404 us at B = 2M, 21% of the bound), and "bf16" converted
// the whole block to a bf16 copy on every call (one more launch and
// 6.7 MB).  This form:
//   - stages a block's rows x G slab of hi and of lo in shared memory
//     with 16-byte loads, evict-first (the indices are read once; the
//     table should stay in L2), then each thread reads its row from
//     shared memory (rows padded to an odd stride: no bank conflicts);
//   - issues a row's G gathers back to back (G = 17, the 16^4 class,
//     fully unrolled), so they are in flight together; only the
//     accumulation depends on them;
//   - rounds in registers for "bf16".
// Indices outside [0, H) x [0, L) are not read: the row's value
// becomes NaN, so a bad index shows instead of reading out of bounds.
// Any B; a misaligned index tensor is staged with 4-byte loads.
//
// Built by tpu2048_torch/ops/build.py with nvcc for sm_90a into a
// shared library with a C interface, called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows, and threads, per block
constexpr int kBatch = 4;   // loads of a thread in flight at once, per slab

// the hi and lo slabs, n int32 each, from device memory to shared:
// element i of a slab is row i / G, column i % G, stored at row *
// stride + column.  Each thread issues up to kBatch loads of each slab
// before it stores any, so they are in flight together.
__device__ __forceinline__ void stage(const int* __restrict__ hi,
                                     const int* __restrict__ lo,
                                     int* __restrict__ s_hi,
                                     int* __restrict__ s_lo, int n, int G,
                                     int stride) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(hi) |
                         reinterpret_cast<uintptr_t>(lo)) & 15) == 0;
  if (stride == G && aligned) {
    const int n4 = n >> 2;
    const int4* h4 = reinterpret_cast<const int4*>(hi);
    const int4* l4 = reinterpret_cast<const int4*>(lo);
    for (int i0 = threadIdx.x; i0 < n4; i0 += kRows * kBatch) {
      int4 a[kBatch], b[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kRows;
        if (i < n4) {
          a[u] = __ldcs(h4 + i);
          b[u] = __ldcs(l4 + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kRows;
        if (i < n4) {
          reinterpret_cast<int4*>(s_hi)[i] = a[u];
          reinterpret_cast<int4*>(s_lo)[i] = b[u];
        }
      }
    }
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += kRows) {
      s_hi[i] = __ldcs(hi + i);
      s_lo[i] = __ldcs(lo + i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kRows) {
      const int r = i / G;
      const int at = r * stride + (i - r * G);
      s_hi[at] = __ldcs(hi + i);
      s_lo[at] = __ldcs(lo + i);
    }
  }
}

// kG > 0: G is kG (fully unrolled); kG = 0: G at run time
template <bool kRound, int kG>
__global__ void __launch_bounds__(kRows)
    eval_class_kernel(const float* __restrict__ tables,
                      const int* __restrict__ hi,
                      const int* __restrict__ lo,
                      float* __restrict__ out, int B, int g_run, int H,
                      int L, int stride) {
  extern __shared__ __align__(16) int slab[];  // hi rows, then lo rows
  const int G = kG > 0 ? kG : g_run;
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        B - b0));
  int* s_hi = slab;
  int* s_lo = slab + kRows * stride;
  stage(hi + b0 * G, lo + b0 * G, s_hi, s_lo, rows * G, G, stride);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;  // ragged last block
  const int* hrow = s_hi + threadIdx.x * stride;
  const int* lrow = s_lo + threadIdx.x * stride;
  float acc = 0.0f;
  bool bad = false;
#pragma unroll(kG > 0 ? kG : 8)
  for (int g = 0; g < G; ++g) {
    const int h = hrow[g];
    const int l = lrow[g];
    const bool ok = static_cast<unsigned>(h) < static_cast<unsigned>(H) &&
                    static_cast<unsigned>(l) < static_cast<unsigned>(L);
    bad |= !ok;
    float t = __ldg(tables + (g * H + (ok ? h : 0)) * L + (ok ? l : 0));
    if (kRound) t = __bfloat162float(__float2bfloat16_rn(t));
    acc = __fadd_rn(acc, t);
  }
  out[b0 + threadIdx.x] = bad ? __int_as_float(0x7fc00000) : acc;
}

template <bool kRound, int kG>
int launch(const float* tables, const int* hi, const int* lo, float* out,
           int B, int G, int H, int L, cudaStream_t stream) {
  const int stride = G | 1;  // odd: a warp's rows fall in distinct banks
  const size_t smem = 2 * sizeof(int) * kRows * static_cast<size_t>(stride);
  auto kernel = eval_class_kernel<kRound, kG>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (static_cast<long long>(B) + kRows - 1) / kRows;
  kernel<<<static_cast<unsigned>(blocks), kRows, smem, stream>>>(
      tables, hi, lo, out, B, G, H, L, stride);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRound>
int launch_g(const float* tables, const int* hi, const int* lo, float* out,
             int B, int G, int H, int L, cudaStream_t stream) {
  if (G == 17) {  // the 16^4 class at n >= 4: the main path
    return launch<kRound, 17>(tables, hi, lo, out, B, G, H, L, stream);
  }
  return launch<kRound, 0>(tables, hi, lo, out, B, G, H, L, stream);
}

}  // namespace

extern "C" {

// tables: (G, H, L) f32, G * H * L < 2^31; hi, lo: (B, G) int32;
// out: (B,) f32.  round_bf16 = 1: each term rounded to bf16 (RNE).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int eval_class_launch(const float* tables, int round_bf16, const int* hi,
                      const int* lo, float* out, int B, int G, int H, int L,
                      void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (round_bf16) return launch_g<true>(tables, hi, lo, out, B, G, H, L, s);
  return launch_g<false>(tables, hi, lo, out, B, G, H, L, s);
}

// The message of a cudaError_t returned by any *_launch of the library.
const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
