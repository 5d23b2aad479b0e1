// grad_class: the (dsum, hits) gradient blocks of a stacked (G, H, L)
// class of n-tuple tables,
//   dsum[g, hi[b, g], lo[b, g]] += dw[b]   over the valid rows b,
//   hits[g, hi[b, g], lo[b, g]] += 1       likewise,
// into outputs the wrapper allocates zeroed.
//
// Replaces tpu2048/ops/pallas_kernels.py::grad_for (its _grad_kernel).
// The TPU kernel is the transpose of the one-hot lookup: per tuple, a
// one-hot (TB, H)^T @ (TB, 3L) matmul on the MXU, with dw split into a
// bf16 head and residual, accumulated in a VMEM-resident output block
// across a sequential grid.  A GPU scatters natively, so this kernel
// scatters: one thread per (row, tuple), two f32 atomicAdds into the
// block.  dsum is an exact f32 sum of the dw (tighter than bf16x2's
// ~2^-18), but in an order that changes from run to run; hits are
// small integers, exact in any order.
//
// What bounds it on an H100: the two output blocks are at most
// 2 x 4.5 MB and stay in the 50 MB L2, so the ~17 x 8192 = 139k
// updates per call are L2 atomics.  Random rows spread over distinct
// addresses run at the L2's atomic rate; rows that hit one entry
// serialise on that address.  Every env starts from a fresh board at
// once, so early training steps send thousands of rows to a few
// entries (all-empty rows and squares): correct, but slow on those
// steps.  What the design does about it: nothing yet beyond launching
// one thread per update so that the scheduler keeps many atomics in
// flight.  Later work: warp-aggregated atomics (__match_any_sync) or a
// sort plus segmented sum.
//
// Invalid rows are skipped before their indices are read (a train
// state's first step carries placeholder indices there).  A valid
// row's index outside [0, H) x [0, L) is not written: dsum[g, 0, 0]
// becomes NaN instead, so a bad index shows.  Any B.
//
// Built by tpu2048_torch/ops/build.py with nvcc for sm_90a into a
// shared library with a C interface, called through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    grad_class_kernel(const int* __restrict__ hi,
                      const int* __restrict__ lo,
                      const float* __restrict__ dw,
                      const bool* __restrict__ valid,
                      float* __restrict__ dsum, float* __restrict__ hits,
                      long long n, int G, int H, int L) {
  // one thread per (b, g), g fastest: neighbouring threads read
  // neighbouring index words
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const long long b = i / G;
  if (!valid[b]) return;
  const int g = static_cast<int>(i - b * G);
  const int h = hi[i];
  const int l = lo[i];
  const long long base = static_cast<long long>(g) * H * L;
  if (static_cast<unsigned>(h) >= static_cast<unsigned>(H) ||
      static_cast<unsigned>(l) >= static_cast<unsigned>(L)) {
    atomicExch(dsum + base, __int_as_float(0x7fc00000));
    return;
  }
  const long long e = base + static_cast<long long>(h) * L + l;
  atomicAdd(dsum + e, dw[b]);
  atomicAdd(hits + e, 1.0f);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess).
int grad_class_launch(const int* hi, const int* lo, const float* dw,
                      const bool* valid, float* dsum, float* hits, int B,
                      int G, int H, int L, void* stream) {
  const long long n = static_cast<long long>(B) * G;
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    grad_class_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        hi, lo, dw, valid, dsum, hits, n, G, H, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
