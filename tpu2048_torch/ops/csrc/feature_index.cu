// feature_index: the train actor's feature indices of its afterstates,
// from their packed row codes.  For each of R = S * N boards (S
// direction slots of N boards; a slot whose bit is set in ``tmask``
// holds its boards transposed, as the engine's up/down afterstates
// come back) it writes
//   - idx[r, f]: the flat-table index of tuple f, sum_j v[col] * coef
//     + offset over the 32-wide cell vector v = [raw, min(raw, 13)];
//   - with a canonical plan, for each gather-class feature k,
//     cidx[r, k] = the least of the 8 D4 images' indices of its entry
//     and mult[r, k] = how many of the 8 equal it (the orbit's
//     multiplicity).
// The integers equal ``kernels.feature_index_reference`` (the engine's
// ``cells_from_codes``, the transposed slots' cells permuted back,
// ``ntuple.feature_indices`` and ``canonical.canonical_gather_indices``)
// bit for bit.
//
// It replaces no TPU kernel: the JAX reference builds these indices
// with XLA ops and an index matmul (tpu2048/ops/dispatch.py's train
// evaluator), and the port's plain form took ~20 launches over (4N, F,
// K) and (4N, 8, Kc, K) intermediates, 5-7 ms a train step at the
// benchmark's sizes.  It is the port's own, like ``cross_apply``.
//
// The plan: everything is read from the tuple set's plan, which the
// wrapper builds from ``ntuple._index_plan`` and
// ``canonical._orbit_index_plan`` (``kernels.feature_index_plan``),
// nothing from n; any tuple set of up to kMaxFeat features, kMaxTerms
// cells a tuple and kMaxGather gather features.  A gather feature's
// image s reads the cells of its identity image in another order, so
// the plan lists those cells once (its digits) and, per image, each
// digit's place value and the image's offset.  The images fall in
// tables that do not overlap, so only those in the table of least
// offset can be least: the plan lists image 0 (the feature's own
// index) and those, 2-3 of the 8 at n=5 and n=6.  Image 0 is the
// feature's idx, so a canonical plan computes the other ("direct")
// features alone from their terms.
//
// What bounds it on an H100: bytes.  A board reads 16 bytes of codes
// and writes (F + 2 Kc) int32 (116 bytes at n=5, 260 at n=6); at the
// benchmark's 4 x 262,144 (n=5) and 4 x 131,072 (n=6) boards that is
// ~138 and ~145 MB, ~41 and ~43 us at 3.35 TB/s.  The design:
//   - one thread a board, one block a tile of 128 boards; one 16-byte
//     load of a board's codes; its 32 cell values go to shared memory
//     as bytes, laid out so that a warp's reads of one cell are 32
//     consecutive words;
//   - the plan is the kernel's parameter (8 KB in the constant bank:
//     parameters past 4 KB need CUDA 12.1), and every loop over it is
//     unrolled, so each of its numbers sits at a fixed offset, an
//     instruction's operand or a uniform load, the same for the whole
//     warp.  (Read from shared memory instead, the same-address reads
//     of the place values filled the SM's shared-memory bandwidth.)
//   - every output row goes through shared memory: the tile's idx rows
//     (84-132 bytes, not 16-byte aligned) as they lie in idx, its cidx
//     and mult rows at a pitch of Kc + 4 words (a warp's 16-byte
//     writes then meet no bank twice), and the block writes all three
//     with coalesced 16-byte stores.  A thread's own 16-byte stores of
//     its 64-byte cidx and mult rows had cost 119 us at n=6 (85 us
//     staged).
//
// Built by tpu2048_torch/ops/build.py with nvcc for sm_90a into a
// shared library with a C interface, called through ctypes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;  // boards of a tile, one a thread
constexpr int kMaxFeat = 64;
constexpr int kMaxTerms = 6;
constexpr int kMaxGather = 16;
constexpr int kImages = 8;
constexpr int kCellWords = 8;  // a board's 32 cell values, 4 a word

// The plan, as ``kernels.feature_index_plan`` lays it out in int32
// words (its offsets must match this struct's).
struct __align__(16) Plan {
  int feats;    // F: the words of an idx row
  int direct;   // features computed from their own terms
  int dterms;   // the terms of a direct feature (padded: place value 0)
  int gathers;  // Kc: gather features written to cidx and mult (0: none)
  int gterms;   // the digits of a gather feature (padded likewise)
  int pad[3];
  int2 dhead[kMaxFeat];  // direct feature: {feature, offset}
  // its terms: {cell, place value}; the cell a column (0-15 raw, 16-31
  // clipped) as the wrapper gives it, a byte offset (``cell_offset``)
  // as the kernel reads it
  int2 dterm[kMaxFeat][kMaxTerms];
  int gfeat[kMaxGather];             // gather k: the feature of image 0
  int gimages[kMaxGather];           // its images listed (image 0 first)
  int gown[kMaxGather];              // whether image 0 can be least
  int gcell[kMaxGather][kMaxTerms];  // its digits' cells, likewise
  // per listed image: the digits' place values, its offset, 0
  int gimg[kMaxGather][kImages][8];
};
static_assert(sizeof(Plan) == 8288, "the plan's layout changed");

// byte offset of cell column ``col`` (0-15 raw, 16-31 clipped) in the
// cells' shared memory, from a thread's own first byte
inline int cell_offset(int col) {
  return (col >> 2) * (4 * kThreads) + (col & 3);
}

// the 4 cells of a row code (cell 0 in bits 12-15), a byte each, cell
// 0 in the low byte
__device__ __forceinline__ unsigned row_cells(int x) {
  return ((x >> 12) & 15) | (((x >> 8) & 15) << 8) |
         (((x >> 4) & 15) << 16) | ((x & 15) << 24);
}

// the cells of row j of a board whose codes hold it transposed: nibble
// j of each of its 4 codes
__device__ __forceinline__ unsigned col_cells(int4 q, int j) {
  const int s = 12 - 4 * j;
  return ((q.x >> s) & 15) | (((q.y >> s) & 15) << 8) |
         (((q.z >> s) & 15) << 16) | (((q.w >> s) & 15) << 24);
}

// the stage's words: the tile's idx rows, then with whole quads of
// gather features its cidx and its mult rows at a pitch of Kc + 4
__host__ __device__ inline int stage_words(const Plan& plan) {
  const int quads = plan.gathers > 0 && (plan.gathers & 3) == 0;
  return kThreads * (plan.feats + quads * 2 * (plan.gathers + 4));
}

__global__ void __launch_bounds__(kThreads)
    feature_index_kernel(const __grid_constant__ Plan plan,
                         const int4* __restrict__ codes, int rows,
                         int per_slot, int tmask, int* __restrict__ idx,
                         int* __restrict__ cidx, int* __restrict__ mult) {
  __shared__ unsigned cells[kCellWords * kThreads];
  extern __shared__ int4 stage_space[];
  const int F = plan.feats, gathers = plan.gathers;
  const bool quads = gathers > 0 && (gathers & 3) == 0;
  const int pitch = gathers + 4;
  int* stage = reinterpret_cast<int*>(stage_space);
  int* cstage = stage + kThreads * F;
  int* mstage = cstage + kThreads * pitch;

  const int r0 = blockIdx.x * kThreads;
  const int r = r0 + threadIdx.x;
  const int boards = min(kThreads, rows - r0);
  if (r < rows) {
    const int4 q = __ldg(codes + r);
    const bool across = (tmask >> (r / per_slot)) & 1;
    const int row_code[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned w = across ? col_cells(q, j) : row_cells(row_code[j]);
      cells[j * kThreads + threadIdx.x] = w;
      cells[(4 + j) * kThreads + threadIdx.x] = __vminu4(w, 0x0d0d0d0du);
    }
    const unsigned char* mine =
        reinterpret_cast<const unsigned char*>(cells) + 4 * threadIdx.x;
    int* my_idx = stage + threadIdx.x * F;

#pragma unroll
    for (int i = 0; i < kMaxFeat; ++i) {
      if (i >= plan.direct) break;
      int acc = plan.dhead[i].y;
#pragma unroll
      for (int j = 0; j < kMaxTerms; ++j) {
        if (j < plan.dterms) {
          acc += static_cast<int>(mine[plan.dterm[i][j].x]) *
                 plan.dterm[i][j].y;
        }
      }
      my_idx[plan.dhead[i].x] = acc;
    }

    int least[4], count[4];
#pragma unroll
    for (int k = 0; k < kMaxGather; ++k) {
      if (k >= gathers) break;
      int d[kMaxTerms];
#pragma unroll
      for (int j = 0; j < kMaxTerms; ++j) {
        d[j] = j < plan.gterms ? static_cast<int>(mine[plan.gcell[k][j]])
                               : 0;
      }
      int own = 0, m = INT_MAX, c = 0;
#pragma unroll
      for (int s = 0; s < kImages; ++s) {
        if (s >= plan.gimages[k]) break;
        const int* place = plan.gimg[k][s];
        const int v = place[kMaxTerms] + d[0] * place[0] + d[1] * place[1] +
                      d[2] * place[2] + d[3] * place[3] + d[4] * place[4] +
                      d[5] * place[5];
        if (s == 0) {
          own = v;
          if (plan.gown[k]) {
            m = v;
            c = 1;
          }
        } else {
          c = v < m ? 1 : c + (v == m);
          m = min(m, v);
        }
      }
      my_idx[plan.gfeat[k]] = own;
      if (quads) {
        least[k & 3] = m;
        count[k & 3] = c;
        if ((k & 3) == 3) {
          const int at = threadIdx.x * pitch + k - 3;
          *reinterpret_cast<int4*>(cstage + at) =
              make_int4(least[0], least[1], least[2], least[3]);
          *reinterpret_cast<int4*>(mstage + at) =
              make_int4(count[0], count[1], count[2], count[3]);
        }
      } else {
        const size_t at = static_cast<size_t>(r) * gathers + k;
        cidx[at] = m;
        mult[at] = c;
      }
    }
  }
  __syncthreads();

  // the tile's idx rows lie in the stage as they lie in idx, from a
  // 16-byte boundary (r0 * F is a multiple of 4)
  const int words = boards * F;
  int* out = idx + static_cast<size_t>(r0) * F;
  const int whole = words & ~3;
  for (int i = 4 * threadIdx.x; i < whole; i += 4 * kThreads) {
    *reinterpret_cast<int4*>(out + i) =
        *reinterpret_cast<const int4*>(stage + i);
  }
  for (int i = whole + threadIdx.x; i < words; i += kThreads) {
    out[i] = stage[i];
  }
  if (quads) {
    const int per_row = gathers >> 2;
    int4* co = reinterpret_cast<int4*>(cidx + static_cast<size_t>(r0) *
                                                  gathers);
    int4* mo = reinterpret_cast<int4*>(mult + static_cast<size_t>(r0) *
                                                  gathers);
    for (int i = threadIdx.x; i < boards * per_row; i += kThreads) {
      const int row = i / per_row, at = row * pitch + 4 * (i - row * per_row);
      co[i] = *reinterpret_cast<const int4*>(cstage + at);
      mo[i] = *reinterpret_cast<const int4*>(mstage + at);
    }
  }
}

}  // namespace

extern "C" {

// The plan's size in int32 words, for the wrapper's check of its layout.
int feature_index_plan_words(void) {
  return static_cast<int>(sizeof(Plan) / 4);
}

// codes: (rows, 4) int32 row codes, 16-byte aligned, slot r / per_slot
// transposed where its bit of tmask is set; plan_words: the plan in
// host memory, copied into the launch's parameters; idx: (rows, F)
// int32; cidx, mult: (rows, Kc) int32, 16-byte aligned, or null for a
// plan without gathers.  Returns the cudaError_t of the launch (0 =
// cudaSuccess).
int feature_index_launch(const int* codes, int rows, int per_slot,
                         int tmask, const int* plan_words, int* idx,
                         int* cidx, int* mult, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  Plan plan;
  memcpy(&plan, plan_words, sizeof(Plan));
  for (auto& row : plan.dterm)
    for (int2& t : row) t.x = cell_offset(t.x);
  for (auto& row : plan.gcell)
    for (int& c : row) c = cell_offset(c);
  const int smem = 4 * stage_words(plan);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        feature_index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (rows + kThreads - 1) / kThreads;
  feature_index_kernel<<<tiles, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      plan, reinterpret_cast<const int4*>(codes), rows, per_slot, tmask, idx,
      cidx, mult);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
