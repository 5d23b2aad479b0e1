// fold_class: the D4 orbit sum of a standard-packed class pair
// x (R, G, 16^k), k <= 4, base 16, in the three doubling rounds of
// tpu2048/features/symmetry.py::symmetrize_class_sum,
//   y1 = x + T_m x,   y2 = y1 + T_r2 y1,   y3 = y2 + T_r y2.
// Unrolled, output a is the sum of eight leaves x[W_j a], W_j the
// words T_m^b0 T_r2^b1 T_r^b2 (j = b0 + 2 b1 + 4 b2), added as
//   ((l0 + l1) + (l2 + l3)) + ((l4 + l5) + (l6 + l7)).
//
// Replaces tpu2048/ops/fold_kernel.py::fold_class_pair(_repacked) (its
// _run_group / _fold_kernel).  The TPU kernel keeps a tuple group in
// VMEM and runs each transform as one-hot 256x256 permutation matmuls
// on the MXU, which needs the tuples' digits repacked.  This kernel
// works in standard packing.
//
// What bounds it on an H100: bytes.  The pair is at most 2 x 4.5 MB,
// read once and written once, plus the plan (2.3 MB for the 16^4
// class), all L2-resident on the train step.  The first form of this
// kernel (one thread per output, eight gathers straight from x) read
// every value eight times, by the eight members of its orbit, through
// strided digit transposes: ~62.8 us at (2, 17, 65536) on an H100,
// ~1.2 TB/s of effective L2 reads.  This form reads each value once:
//   - the words permute digits and relabel tuples, so they map a
//     *tile* (one tuple's 4^k entries that share the high two bits of
//     every digit) onto a tile; the class splits into tile orbits of
//     at most 8 tiles (16^4 class: 623 orbits), closed under D4;
//   - one block takes one tile orbit of one row: it stages the orbit's
//     tiles in shared memory in 16-byte runs (a tile's entries with
//     equal high digits are 4 consecutive floats), then one thread per
//     entry orbit (its representative's 8 images, precomputed on the
//     host as shared-memory positions) loads the 8 leaves once and
//     writes the sum of every member of the orbit: member j reads leaf
//     i at image FOLD_CAYLEY[j][i] (D4's table in the basis of the
//     words; ops/kernels.py derives it and checks it over the whole
//     index range).  Members that coincide (stabilised orbits) compute
//     the same sum from the same values in the same order, so writing
//     it twice is harmless;
//   - the block then writes the orbit back in the same 16-byte runs.
// Adds only (__fadd_rn: never contracted), in the reference's order
// for every member, so the result is bitwise the reference's.
//
// Built by tpu2048_torch/ops/build.py with nvcc for sm_90a into a
// shared library with a C interface, called through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSlots = 8;                 // tiles of one tile orbit
constexpr int kMaxTile = 256;                // 4^k entries, k <= 4
constexpr int kOrbitWords = 4 + kMaxSlots;   // [slots, begin, end, 0, bases]
constexpr int kBatch = 4;  // a thread's staging loads in flight at once

// the offset in a 16^k table of tile-local entry l: l's k 2-bit
// digits are the low halves of the index's k 4-bit digits
__device__ __forceinline__ int spread(int l, int k) {
  int e = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (d < k) e |= ((l >> (2 * (k - 1 - d))) & 3) << (4 * (k - 1 - d));
  }
  return e;
}

// shared-memory position of orbit entry p = (slot << 2k) | l: the
// 16-byte run index's low bits XORed with the slot and l's bits 5..7,
// which spreads an entry orbit's leaves over more banks (the plan's
// positions come swizzled: ops/kernels.py::fold_swizzle, the same map)
__device__ __forceinline__ int swizzle(int p, int k) {
  const int s = p >> (2 * k), l = p & ((1 << (2 * k)) - 1);
  const int x = ((l >> 5) ^ s) & 7 & ((1 << (2 * k - 2)) - 1);
  return (s << (2 * k)) | (l ^ (x << 2));
}

__device__ __forceinline__ float tree(float l0, float l1, float l2,
                                      float l3, float l4, float l5,
                                      float l6, float l7) {
  return __fadd_rn(__fadd_rn(__fadd_rn(l0, l1), __fadd_rn(l2, l3)),
                   __fadd_rn(__fadd_rn(l4, l5), __fadd_rn(l6, l7)));
}

// member m of an entry orbit (image m of its representative) sums the
// leaves v[FOLD_CAYLEY[m][0..7]] into its shared-memory position p[m]
#define FOLD_MEMBER(m, c0, c1, c2, c3, c4, c5, c6, c7) \
  s_out[p[m]] = tree(v[c0], v[c1], v[c2], v[c3], v[c4], v[c5], v[c6], v[c7])

__device__ __forceinline__ void unpack(const uint4 q, int (&p)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[2 * i] = static_cast<int>(w[i] & 0xffffu);
    p[2 * i + 1] = static_cast<int>(w[i] >> 16);
  }
}

// grid (tile orbits, rows); block = one tile orbit of one row
__global__ void __launch_bounds__(kThreads)
    fold_class_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const int* __restrict__ orbits,
                      const uint4* __restrict__ reps, int R, int G, int k) {
  __shared__ __align__(16) float s_in[kMaxSlots * kMaxTile];
  __shared__ __align__(16) float s_out[kMaxSlots * kMaxTile];
  const int* od = orbits + blockIdx.x * kOrbitWords;
  const int slots = od[0], rep_begin = od[1], rep_end = od[2];
  const int tshift = 2 * k;  // log2 of a tile's entries
  const int tmask = (1 << tshift) - 1;
  const int runs = (slots << tshift) >> 2;  // 16-byte runs of the orbit
  const long long per_row = static_cast<long long>(G) << (4 * k);
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const float* xr = x + row * per_row;
    float* outr = out + row * per_row;
    // stage the orbit: up to kBatch loads issued before any store
    for (int i0 = threadIdx.x; i0 < runs; i0 += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < runs) {
          const int off = od[4 + ((i << 2) >> tshift)] +
                          spread((i << 2) & tmask, k);
          v[u] = __ldg(reinterpret_cast<const float4*>(xr + off));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < runs) {
          reinterpret_cast<float4*>(s_in)[swizzle(i << 2, k) >> 2] = v[u];
        }
      }
    }
    __syncthreads();
    // one thread per entry orbit: its 8 leaves, every member's sum
    for (int e = rep_begin + threadIdx.x; e < rep_end; e += kThreads) {
      int p[8];
      unpack(__ldg(reps + e), p);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = s_in[p[j]];
      FOLD_MEMBER(0, 0, 1, 2, 3, 4, 5, 6, 7);
      FOLD_MEMBER(1, 1, 0, 3, 2, 7, 6, 5, 4);
      FOLD_MEMBER(2, 2, 3, 0, 1, 6, 7, 4, 5);
      FOLD_MEMBER(3, 3, 2, 1, 0, 5, 4, 7, 6);
      FOLD_MEMBER(4, 4, 5, 6, 7, 2, 3, 0, 1);
      FOLD_MEMBER(5, 5, 4, 7, 6, 1, 0, 3, 2);
      FOLD_MEMBER(6, 6, 7, 4, 5, 0, 1, 2, 3);
      FOLD_MEMBER(7, 7, 6, 5, 4, 3, 2, 1, 0);
    }
    __syncthreads();
    // write the orbit back in the same runs
    for (int i = threadIdx.x; i < runs; i += kThreads) {
      const int off = od[4 + ((i << 2) >> tshift)] +
                      spread((i << 2) & tmask, k);
      *reinterpret_cast<float4*>(outr + off) =
          reinterpret_cast<const float4*>(s_out)[swizzle(i << 2, k) >> 2];
    }
    __syncthreads();  // the next row reuses s_in and s_out
  }
}

}  // namespace

extern "C" {

// x and out: (R, G, 16^k) f32, k in 1..4, 16-byte aligned; orbits:
// (n_orbits, 12) int32 and reps: (E, 8) int16, the plan of
// ops/kernels.py::fold_orbit_plan.  Returns the cudaError_t of the
// launch (0 = cudaSuccess).
int fold_class_launch(const float* x, float* out, const int* orbits,
                      const void* reps, int n_orbits, int R, int G, int k,
                      void* stream) {
  if (k < 1 || k > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n_orbits > 0 && R > 0) {
    const dim3 grid(n_orbits, R < 65535 ? R : 65535);
    fold_class_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, out, orbits, static_cast<const uint4*>(reps), R, G, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
