// eval_class: V[b] = sum_g T[g, hi[b, g], lo[b, g]] for a stacked
// (G, H, L) class block of n-tuple tables, in f32.
//
// Replaces tpu2048/ops/pallas_kernels.py::eval_class (its three
// precisions).  The TPU kernel turns each lookup into a one-hot matmul
// on the MXU, because random gathers are slow there, and splits the
// f32 table into a bf16 head and residual ("bf16x2") to run the MXU at
// its bf16 rate.  A GPU gathers natively, so this kernel gathers:
//   - "f32" and "bf16x2" read the f32 table.  Each term is the exact
//     f32 weight and the sum runs in f32, tighter than bf16x2's
//     ~2^-18; the head/residual split is not ported.
//   - "bf16" reads a round-to-nearest-even bf16 copy of the table
//     (made by the wrapper) and widens each term to f32.
//
// What bounds it on an H100: the class block is at most 17 x 256 x 256
// f32 = 4.5 MB (2.2 MB in bf16), so it stays resident in the 50 MB L2
// and the G gathers per row are L2 random loads, each 4 (or 2) useful
// bytes of a 32-byte sector.  The kernel is bound by L2 load latency,
// not by DRAM bandwidth or arithmetic.  What the design does about it:
// one thread owns one batch row and issues its G independent gathers
// back to back (the loop is unrolled, the accumulation is the only
// dependency), so each warp keeps many L2 loads in flight; the
// accumulation runs in a fixed g order, so results do not depend on
// the launch shape.  Indices outside [0, H) x [0, L) are not read:
// the row's value becomes NaN, so a bad index shows instead of reading
// out of bounds.  Later work: fuse the 16^5 gathers and the feature
// indexing, so the (B, G) index tensors never reach device memory.
//
// Built by tpu2048_torch/ops/build.py with nvcc for sm_90a into a
// shared library with a C interface, called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    eval_class_kernel(const T* __restrict__ tables,
                      const int* __restrict__ hi,
                      const int* __restrict__ lo,
                      float* __restrict__ out, int B, int G, int H, int L) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;  // ragged last block
  const int* hrow = hi + static_cast<long long>(b) * G;
  const int* lrow = lo + static_cast<long long>(b) * G;
  float acc = 0.0f;
  bool bad = false;
#pragma unroll 8
  for (int g = 0; g < G; ++g) {
    const int h = hrow[g];
    const int l = lrow[g];
    const bool ok = static_cast<unsigned>(h) < static_cast<unsigned>(H) &&
                    static_cast<unsigned>(l) < static_cast<unsigned>(L);
    bad |= !ok;
    const long long e =
        (static_cast<long long>(g) * H + (ok ? h : 0)) * L + (ok ? l : 0);
    acc += widen(tables[e]);
  }
  out[b] = bad ? __int_as_float(0x7fc00000) : acc;
}

template <typename T>
int launch(const void* tables, const int* hi, const int* lo, float* out,
           int B, int G, int H, int L, cudaStream_t stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    eval_class_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(tables), hi, lo, out, B, G, H, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table_bf16 = 0: tables are f32; 1: tables are bf16.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
int eval_class_launch(const void* tables, int table_bf16, const int* hi,
                      const int* lo, float* out, int B, int G, int H, int L,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16) {
    return launch<__nv_bfloat16>(tables, hi, lo, out, B, G, H, L, s);
  }
  return launch<float>(tables, hi, lo, out, B, G, H, L, s);
}

// The message of a cudaError_t returned by any *_launch of the library.
const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
