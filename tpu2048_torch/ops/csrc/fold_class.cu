// fold_class: the D4 orbit sum of a standard-packed class pair
// x (R, G, 16^k), k <= 4, base 16, in the three doubling rounds of
// tpu2048/features/symmetry.py::symmetrize_class_sum,
//   y1 = x + T_m x,   y2 = y1 + T_r2 y1,   y3 = y2 + T_r y2,
// where a transform T of round r reads, for output tuple t and local
// index e, input tuple src_r[t] at the digit-permuted index P_rt(e).
//
// Replaces tpu2048/ops/fold_kernel.py::fold_class_pair(_repacked) (its
// _run_group / _fold_kernel).  The TPU kernel keeps a tuple group in
// VMEM and runs each transform as one-hot 256x256 permutation matmuls
// on the MXU, which needs the tuples' digits repacked so that every
// transform keeps the (hi, lo) digit pairs apart.  A GPU gathers
// natively, so this kernel gathers in standard packing: each thread
// owns one output element and evaluates its 8-term orbit sum
//   y3[t,e] = y2[t,e] + y2[s2, P2(e)],  y2[u,f] = y1[u,f] + y1[s1, P1(f)],
//   y1[v,h] = x[v,h] + x[s0, P0(h)]
// straight from x, in the reference's association order.  Adds only
// (__fadd_rn: never contracted), no round writes back into x, so the
// result is bitwise the reference's whatever nvcc does.
//
// The plan (R rounds = 3 rows of G entries [src, c0, c1, c2, c3]) is
// derived numerically on the host by applying each round's plain digit
// transpose to an index range (ops/kernels.py::fold_plan): P(e) is
// sum_p digit_p(e) * c_p.
//
// What bounds it on an H100: the input pair is at most 2 x 4.5 MB and
// sits in the 50 MB L2, so the kernel reads 8 L2 values and writes one
// f32 to memory per element: ~72 MB of L2 reads and 9 MB of writes for
// the n >= 4 class.  The rows and columns tuples permute whole digits,
// so most gathers of a warp fall in a few sectors; the squares'
// transposes stride.  The design keeps all eight loads of a thread
// independent of each other (addresses are integer arithmetic on the
// plan), so each thread has them in flight together.
//
// Built by tpu2048_torch/ops/build.py with nvcc for sm_90a into a
// shared library with a C interface, called through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlan = 5;  // [src, c0, c1, c2, c3]

struct Term {
  int t;  // tuple
  int e;  // local index
};

__device__ __forceinline__ Term image(const int* __restrict__ plan,
                                      int round, int G, int k, Term a) {
  const int* p = plan + (round * G + a.t) * kPlan;
  int j = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (d < k) j += ((a.e >> (4 * (k - 1 - d))) & 15) * p[1 + d];
  }
  return Term{p[0], j};
}

__global__ void __launch_bounds__(kThreads)
    fold_class_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const int* __restrict__ plan, long long n, int G,
                      int k) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const int shift = 4 * k;  // log2 of the table size 16^k
  const long long per_row = static_cast<long long>(G) << shift;
  const long long row = i / per_row;
  const float* xr = x + row * per_row;
  const int rem = static_cast<int>(i - row * per_row);
  const Term a{rem >> shift, rem & ((1 << shift) - 1)};

  // the 8 leaves, by the three rounds' images
  const Term b = image(plan, 2, G, k, a);         // y3 = y2[a] + y2[b]
  const Term a1 = image(plan, 1, G, k, a);        // y2[a] = y1[a] + y1[a1]
  const Term b1 = image(plan, 1, G, k, b);        // y2[b] = y1[b] + y1[b1]
  const Term a0 = image(plan, 0, G, k, a);        // y1[a] = x[a] + x[a0]
  const Term a10 = image(plan, 0, G, k, a1);
  const Term b0 = image(plan, 0, G, k, b);
  const Term b10 = image(plan, 0, G, k, b1);
  auto at = [&](Term t) {
    return __ldg(xr + ((static_cast<long long>(t.t) << shift) | t.e));
  };
  const float va = at(a), va0 = at(a0), va1 = at(a1), va10 = at(a10);
  const float vb = at(b), vb0 = at(b0), vb1 = at(b1), vb10 = at(b10);
  const float y2a = __fadd_rn(__fadd_rn(va, va0), __fadd_rn(va1, va10));
  const float y2b = __fadd_rn(__fadd_rn(vb, vb0), __fadd_rn(vb1, vb10));
  out[i] = __fadd_rn(y2a, y2b);
}

}  // namespace

extern "C" {

// x and out: (R, G, 16^k) f32, k in 1..4; plan: (3, G, 5) int32.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int fold_class_launch(const float* x, float* out, const int* plan, int R,
                      int G, int k, void* stream) {
  if (k < 1 || k > 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (static_cast<long long>(R) * G) << (4 * k);
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    fold_class_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, out, plan, n, G, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
