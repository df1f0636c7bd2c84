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

// ---- Tensor-core pieces of the bf16 modes (csrc/fused_interior.cu and
// csrc/seg_interior.cu; mirrored in kernels/fused.py for the CPU tests).
//
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, D = A * B + C, with
// the fragment maps of the PTX ISA ("Matrix Fragments for mma.m16n8k16",
// .bf16). A lane holds, with groupID g = lane >> 2 and threadID_in_group
// t = lane & 3, each b32 two bf16 values, the lower k in the lower half:
//
//   A (16 x 16, row-major), 4 x b32: a0 = A[g][2t, 2t+1]     a1 = A[g+8][2t, 2t+1]
//                                    a2 = A[g][2t+8, 2t+9] a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col"),      2 x b32: b0 = B[2t, 2t+1][g]   b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8) f32,      4 x f32: d0 = D[g][2t]  d1 = D[g][2t+1]
//                                    d2 = D[g+8][2t] d3 = D[g+8][2t+1]
//
// m16n8k8 (the tail of a tap row of at most 8 taps): a0 = A[g][2t, 2t+1],
// a1 = A[g+8][2t, 2t+1], b0 = B[2t, 2t+1][g], C and D as above.
//
// The K packing of both kernels (kernels/fused.py tap_of_k): k is only a
// summation index, so a k16 chunk of 16 taps lists them as k = 2t + h ->
// tap 4t + h and k = 2t + 8 + h -> tap 4t + 2 + h (h in {0, 1}). Lane t's
// four taps 4t .. 4t+3 are then one run: a0 | a2 of an A row are two
// consecutive words of a staged source row, and b0 | b1 one 8-byte load
// of a weight row. A k8 chunk keeps k = tap.
//
// The products of two bf16 values are exact in fp32; the tensor core sums
// them in fp32, in its own order (kernels/fused.py tc_sum_bound).
__device__ __forceinline__ void jt_mma_k16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void jt_mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Two source values rounded to bfloat16 (ties to even, as torch.bfloat16
// rounds on the host), lo in the lower half: one word of a staged bf16 row.
__device__ __forceinline__ uint32_t jt_pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

// The three bfloat16 parts of a weight w, as the JAX package splits it
// (pallas_fused.py:387-393, pallas_fused_seg.py:380-383): hi = bf16(w),
// mid = bf16(w - hi), lo = w - hi - mid, so that w == hi + mid + lo. Two
// weights' parts as three words of bf16 pairs, x in the lower half: the B
// registers of the three mmas of the wsplit3 modes. Each step converts both
// values in one instruction (cvt.rn.bf16x2.f32).
__device__ __forceinline__ uint32_t jt_bf162_bits(__nv_bfloat162 v) {
  return reinterpret_cast<const uint32_t&>(v);
}

__device__ __forceinline__ void jt_split3_pack(float x, float y, uint32_t (&b)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
  const float2 h = __bfloat1622float2(hi);
  const float xr = x - h.x, yr = y - h.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(xr, yr);
  const float2 m = __bfloat1622float2(mid);
  b[0] = jt_bf162_bits(hi);
  b[1] = jt_bf162_bits(mid);
  b[2] = jt_bf162_bits(__floats2bfloat162_rn(xr - m.x, yr - m.y));
}

__device__ __forceinline__ unsigned jt_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix.sync.aligned.m8n8.x4 / .x2 .shared.b16: lane L gives the address
// of row L % 8 of matrix L / 8 (16 contiguous bytes, 16-byte aligned; .x2
// reads lanes 0-15), and receives in register i the bf16 pair (row L / 4,
// columns 2 (L % 4), + 1) of matrix i. A matrix of 8 rows of a B operand
// (n) by 8 k-values is an m16n8k16 B register: b0 = B[2t, 2t+1][g].
__device__ __forceinline__ void jt_ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(jt_smem_addr(p)));
}

__device__ __forceinline__ void jt_ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(jt_smem_addr(p)));
}

// ---- wgmma (sm_90a): D += A * B on a warpgroup (4 warps), m64nNk16,
// bf16 in, f32 sums. A (64 x 16) from registers: warp w holds rows 16w ..
// 16w + 15 as the m16n8k16 A fragment above. B (16 x N, K-major) from
// shared memory through a descriptor, no swizzle: core matrices of 8 rows
// (n) by 16 bytes (8 k-values), each contiguous, the second k half `lbo`
// bytes after the first, the next 8 rows `sbo` bytes on. D: warp w's rows
// as N / 8 m16n8 fragments d[n][0..3] of the mma.sync map above (N = 32
// here, the one shape the kernels use). The mma
// runs asynchronously: between jt_wgmma_fence() and jt_wgmma_wait<0>()
// nothing else touches its registers; after the wait, jt_fence_operand
// orders the reads of D after it.
__device__ __forceinline__ uint64_t jt_gmma_desc(unsigned saddr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((saddr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo & 0x3ffff) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3ffff) >> 4) << 32;
}

__device__ __forceinline__ void jt_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void jt_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void jt_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void jt_fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Shared memory written through the generic proxy (stores, cp.async) made
// visible to the async proxy (wgmma's B reads) after the next barrier.
__device__ __forceinline__ void jt_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A * B, m64n32k16: d[n] the fragment of n-tile n.
__device__ __forceinline__ void jt_wgmma_m64n32k16(float (&d)[4][4], const uint32_t (&a)[4],
                                                   uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// 4-byte asynchronous copy into shared memory; writes a zero when !ok.
__device__ __forceinline__ void jt_cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(jt_smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

// 16-byte asynchronous copy of the first `bytes` (0 to 16) of src; the
// rest of the 16 bytes at dst are zeros.
__device__ __forceinline__ void jt_cp_async16z(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(jt_smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void jt_cp_async16(void* dst, const void* src) {
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
