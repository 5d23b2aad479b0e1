// cross_apply: the canonical learner's sparse update of its gather
// classes (the "crosses"), in place, from one list of M updates per_j
// at table entries key_j, sorted stably by entry.  Per entry, with P =
// the sum of its per_j, Q = the sum of their |per_j|, and d = the count
// of its valid updates (at least 1) under "mean", 1 under "sum":
//   TC:  r = |E| / A (1 where A is 0) from E and A before the update,
//        w += (alpha * r) * (P / d), E += P / d, A += Q / d;
//   sgd: w += P / d.
// The reference adds each term to the tables on its own
// (tpu2048/agent/td.py:606-682, ``.at[cidx].add``); here each entry's
// terms are summed first, in a fixed order, and the tables take one
// add each: P, Q and d are taken in two passes over the sorted list,
//   1. cross_apply_groups: a warp per 32 positions of the list (its
//      windows aligned on multiples of 32); __match_any_sync groups its
//      lanes by entry, and the group's lowest lane sums the group's per
//      and |per| in ascending lane order from 0.0 and counts its valid
//      updates, written at its own position;
//   2. cross_apply_entries: the thread of an entry's first position
//      adds its groups' sums (one a window) in window order from 0.0
//      and applies the rule above, with plain loads and stores.
// So the arithmetic depends only on the list: one input gives one
// result on the card, where f32 atomics would add in the order they
// land (``kernels.cross_apply_ordered`` is the same arithmetic in
// plain PyTorch).  A fresh start puts most of a step's updates on one
// entry (24,104 of 32,768 at n=5): its thread adds 754 window sums,
// not 24,104 terms.
//
// Replaces the reference's stacked XLA scatter of the three tables
// (tpu2048/agent/td.py:669, ``wea.at[:, cidx].add``, with its gathers
// of E and A and its hit count at :606-625), which XLA applies in a
// fixed order on the TPU.  One stable sort (the wrapper's torch.sort of
// int32 keys) serves all three tables and the count.
//
// What bounds it on an H100: the bytes of the sorted list (9 bytes an
// update, read twice) and of the entries it touches (24 bytes each,
// read and written), under 1 MB a step at n=5; then the longest run's
// thread.  Built by tpu2048_torch/ops/build.py with nvcc for sm_90a
// into a shared library with a C interface, called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    cross_apply_groups(const int* __restrict__ key,
                       const float* __restrict__ per,
                       const bool* __restrict__ valid,
                       float* __restrict__ sum_p, float* __restrict__ sum_q,
                       int* __restrict__ count, int M) {
  __shared__ float p_at[kThreads], q_at[kThreads];
  __shared__ int v_at[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int base = threadIdx.x & ~31;
  const bool in = i < M;
  const int k = in ? key[i] : -1 - lane;  // an idle lane matches no lane
  const float p = in ? per[i] : 0.0f;
  p_at[threadIdx.x] = p;
  q_at[threadIdx.x] = fabsf(p);
  v_at[threadIdx.x] = in && valid[i];
  const unsigned peers = __match_any_sync(kAll, k);
  __syncwarp();
  if (!in || (peers & ((1u << lane) - 1u)) != 0) return;
  // the group's lowest lane: its sums in lane order, unrolled so that
  // the reads, broadcasts, issue at once
  float sp = 0.0f, sq = 0.0f;
  int n = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if ((peers >> j) & 1u) {
      sp = __fadd_rn(sp, p_at[base + j]);
      sq = __fadd_rn(sq, q_at[base + j]);
      n += v_at[base + j];
    }
  }
  sum_p[i] = sp;
  sum_q[i] = sq;
  count[i] = n;
}

__global__ void __launch_bounds__(kThreads)
    cross_apply_entries(const int* __restrict__ key,
                        const float* __restrict__ sum_p,
                        const float* __restrict__ sum_q,
                        const int* __restrict__ count,
                        float* __restrict__ w, float* __restrict__ e,
                        float* __restrict__ a,
                        const float* __restrict__ alpha, int M, int mean,
                        int tc) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= M) return;
  const int k = key[i];
  if (i > 0 && key[i - 1] == k) return;  // not the first of its run
  // the run's groups: at its first position, then at each window start
  // inside it
  float p = 0.0f, q = 0.0f;
  int n = 0;
  for (int j = i; j < M && key[j] == k; j = (j | 31) + 1) {
    p = __fadd_rn(p, sum_p[j]);
    q = __fadd_rn(q, sum_q[j]);
    n += count[j];
  }
  if (mean) {
    // the count in f32, exact below 2^24
    const float d = fmaxf(static_cast<float>(n), 1.0f);
    p = __fdiv_rn(p, d);
    q = __fdiv_rn(q, d);
  }
  if (!tc) {
    w[k] = __fadd_rn(w[k], p);
    return;
  }
  const float e0 = e[k], a0 = a[k];
  const float rate = a0 > 0.0f ? __fdiv_rn(fabsf(e0), fmaxf(a0, 1e-30f))
                               : 1.0f;
  // products and sums rounded one by one: no fused multiply-add
  w[k] = __fadd_rn(w[k], __fmul_rn(__fmul_rn(*alpha, rate), p));
  e[k] = __fadd_rn(e0, p);
  a[k] = __fadd_rn(a0, q);
}

}  // namespace

extern "C" {

// key: (M,) int32 table entries sorted stably, per: (M,) f32 and
// valid: (M,) bool in the same order; scratch: 3 M words (f32, f32,
// int32); w (and, under TC, e and a): the tables, updated in place;
// alpha: one f32 on the card.  Returns the cudaError_t of the launches
// (0 = cudaSuccess).
int cross_apply_launch(const int* key, const float* per, const bool* valid,
                       void* scratch, float* w, float* e, float* a,
                       const float* alpha, int M, int mean, int tc,
                       void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sum_p = static_cast<float*>(scratch);
  float* sum_q = sum_p + M;
  int* count = reinterpret_cast<int*>(sum_q + M);
  const int blocks = (M + kThreads - 1) / kThreads;
  cross_apply_groups<<<blocks, kThreads, 0, s>>>(key, per, valid, sum_p,
                                                 sum_q, count, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_apply_entries<<<blocks, kThreads, 0, s>>>(
      key, sum_p, sum_q, count, w, e, a, alpha, M, mean, tc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
