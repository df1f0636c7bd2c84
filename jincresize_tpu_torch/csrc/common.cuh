// Shared helpers for the hand-written Hopper kernels of jincresize_tpu_torch.
//
// Every C entry point takes raw device pointers and the CUDA stream from the
// Python wrapper (kernels/_build.py loads the library with ctypes), launches
// on that stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Kernels above 48 KB of dynamic shared memory must opt in per function.
template <typename Kernel>
inline cudaError_t jt_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A source value as a product operand of the interior kernels: itself, or
// under BF16 (precision='bf16') rounded to the nearest bfloat16, ties to
// even, as torch.bfloat16 rounds on the host. The products of two rounded
// operands are exact in fp32, so each fmaf chain adds the same terms as the
// plain form on rounded operands.
template <bool BF16>
__device__ __forceinline__ float jt_operand(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ unsigned jt_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy into shared memory; writes a zero when !ok.
__device__ __forceinline__ void jt_cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(jt_smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void jt_cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(jt_smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void jt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void jt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// NF frames of one staged column of the gather and seg rings: planes of
// min(NF, 4) frames, plane_stride floats apart, each plane's frames in one
// 4-, 8- or 16-byte load.
template <int NF>
__device__ __forceinline__ void jt_load_frames(const float* p, int plane_stride, float* v) {
  if constexpr (NF == 1) {
    v[0] = p[0];
  } else if constexpr (NF == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < NF / 4; ++k) {
      const float4 q = *reinterpret_cast<const float4*>(p + k * plane_stride);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  }
}
