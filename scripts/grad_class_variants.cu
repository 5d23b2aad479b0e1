// Two other ways to launch grad_class's scatter, beside the one the port
// ships, so that the choice can be measured again on the card:
//   variant_launch(0, ...): the caller zeroes the pair (torch.zeros, a
//     fill kernel), then the scatter launches as a plain kernel;
//   variant_launch(1, ...): one cooperative launch zeroes the pair,
//     synchronises the grid (cooperative_groups), then scatters every
//     tile, each block walking tiles blockIdx.x, + gridDim.x, ...
// The shipped form (the port's own fill kernel, then the scatter as its
// programmatic dependent) is tpu2048_torch/ops/kernels.py::grad_class.
// The scatter itself is the shipped one: this file includes its source.
// Built and timed by scripts/torch_grad_variants.py; not part of the port.

#include <cooperative_groups.h>

#include "../tpu2048_torch/ops/csrc/grad_class.cu"

namespace {

__global__ void __launch_bounds__(32 * kMaxWarps)
    cooperative_kernel(const int* __restrict__ hi,
                       const int* __restrict__ lo,
                       const float* __restrict__ dw,
                       const bool* __restrict__ valid,
                       float* __restrict__ pair, int B, int G, int H, int L,
                       int stride, bool vec, unsigned tiles) {
  extern __shared__ __align__(16) int slab[];
  const long long n = 2LL * G * H * L;
  zero_range(pair, n,
             static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
             static_cast<long long>(gridDim.x) * blockDim.x);
  cooperative_groups::this_grid().sync();
  for (unsigned t = blockIdx.x; t < tiles; t += gridDim.x) {
    scatter_tile(hi, lo, dw, valid, pair, pair + n / 2, B, G, H, L, stride,
                 vec, static_cast<long long>(t) * kRows, slab);
    __syncthreads();  // the slab is staged anew for the next tile
  }
}

}  // namespace

extern "C" {

// cooperative = 0: pair zeroed by the caller; 1: pair's contents ignored.
int variant_launch(int cooperative, const int* hi, const int* lo,
                   const float* dw, const bool* valid, float* pair, int B,
                   int G, int H, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ScatterShape sh = scatter_shape(hi, lo, B, G);
  const cudaError_t e = cudaFuncSetAttribute(
      cooperative ? reinterpret_cast<const void*>(cooperative_kernel)
                  : reinterpret_cast<const void*>(grad_class_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sh.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!cooperative) {
    grad_class_kernel<<<sh.tiles, 32 * sh.warps, sh.smem, s>>>(
        hi, lo, dw, valid, pair, pair + static_cast<size_t>(G) * H * L, B, G,
        H, L, sh.stride, sh.vec);
    return static_cast<int>(cudaGetLastError());
  }
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cooperative_kernel,
                                                32 * sh.warps, sh.smem);
  unsigned grid = static_cast<unsigned>(per_sm * sms);
  if (grid > sh.tiles) grid = sh.tiles;
  if (grid == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&hi, &lo, &dw, &valid, &pair, &B, &G, &H, &L,
                  &sh.stride, &sh.vec, &sh.tiles};
  const cudaError_t c = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cooperative_kernel), dim3(grid),
      dim3(32 * sh.warps), args, sh.smem, s);
  if (c != cudaSuccess) return static_cast<int>(c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
