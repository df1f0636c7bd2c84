// Shared helpers for the hand-written Hopper kernels of jincresize_tpu_torch.
//
// Every C entry point takes raw device pointers and the CUDA stream from the
// Python wrapper (kernels/_build.py loads the library with ctypes), launches
// on that stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Kernels above 48 KB of dynamic shared memory must opt in per function.
template <typename Kernel>
inline cudaError_t jt_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One output pixel's (fs, fs) window dot product against a weight block in
// shared memory. Source reads past the plane's bottom or right edge are
// skipped, which equals reading zeros (the JAX kernels zero-pad there).
__device__ __forceinline__ float jt_window_dot(const float* __restrict__ plane, int H, int W,
                                               int sy0, int sx0, const float* wblk, int fs) {
  const int ny = min(fs, H - sy0);
  const int nx = min(fs, W - sx0);
  float acc = 0.f;
  for (int ly = 0; ly < ny; ++ly) {
    const float* row = plane + static_cast<int64_t>(sy0 + ly) * W + sx0;
    const float* wrow = wblk + ly * fs;
    for (int lx = 0; lx < nx; ++lx) acc = fmaf(__ldg(row + lx), wrow[lx], acc);
  }
  return acc;
}

// One output pixel's (fs, fs) window sum for up to kFrames frames, against
// its block in the class-minor dictionary: s0 points at the window's top-left
// source sample of the first frame (frames `plane` floats apart, rows W apart),
// w at pbt[cy, 0, 0, cx] (taps n_ux floats apart). fp32 FMA along each tap
// row, the row sums added in ly order; kernels/gather.py window_sum_plain
// sums alike. Used by the gather interior and the gather band kernels.
template <int kFrames>
__device__ __forceinline__ void jt_gather_window(const float* __restrict__ s0, int64_t plane,
                                                 int W, const float* __restrict__ w, int n_ux,
                                                 int fs, int nf, float (&acc)[kFrames]) {
#pragma unroll
  for (int i = 0; i < kFrames; ++i) acc[i] = 0.f;
  for (int ly = 0; ly < fs; ++ly) {
    const float* srow = s0 + static_cast<int64_t>(ly) * W;
    float row[kFrames];
#pragma unroll
    for (int i = 0; i < kFrames; ++i) row[i] = 0.f;
    for (int lx = 0; lx < fs; ++lx, w += n_ux) {
      const float wv = __ldg(w);
#pragma unroll
      for (int i = 0; i < kFrames; ++i)
        if (i < nf) row[i] = fmaf(__ldg(srow + i * plane + lx), wv, row[i]);
    }
#pragma unroll
    for (int i = 0; i < kFrames; ++i) acc[i] += row[i];
  }
}
