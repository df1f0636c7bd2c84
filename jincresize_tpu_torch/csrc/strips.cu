// Full-width top/bottom border strips against host-verified anchor blocks.
//
// Replaces jincresize_tpu/kernels/pallas_strips.py::_strips_kernel (built by
// make_strips_interior). Every row of a top/bottom strip reads one constant
// source window row, and its blocks repeat with the interior's column phase
// pattern, so strip si row m, column px*j + rx of the pattern-covered range is
//
//   out[f, si, m, px*j + rx] =
//     sum_{ly, lx < fs} src[f, row0[si] + ly, base_x + offs_x[rx] + qx*j + lx]
//                       * anchors[si, m, rx][ly, lx]
//
// One block per (column tile, strip row m, frame x strip); the row's (px, fs,
// fs) anchor set is staged in shared memory (odd per-phase stride `astride`).
// Rows m >= ny[si] of a shorter strip are written as zeros.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    strips_kernel(const float* __restrict__ src, const float* __restrict__ anchors,
                  const int* __restrict__ info, const int* __restrict__ offs_x,
                  float* __restrict__ out, int H, int W, int n_strips, int ny_max, int px,
                  int qx, int base_x, int wout, int fs, int astride) {
  extern __shared__ float smem[];
  const int si = blockIdx.z % n_strips;
  const int f = blockIdx.z / n_strips;
  const int m = blockIdx.y;
  const int X = blockIdx.x * kThreads + threadIdx.x;
  float* dst = out + ((static_cast<int64_t>(f) * n_strips + si) * ny_max + m) * wout;
  if (m >= info[n_strips + si]) {  // uniform over the block
    if (X < wout) dst[X] = 0.f;
    return;
  }
  const float* a = anchors + (static_cast<int64_t>(si) * ny_max + m) * px * astride;
  for (int t = threadIdx.x; t < px * astride; t += kThreads) smem[t] = a[t];
  __syncthreads();
  if (X >= wout) return;
  const int j = X / px, rx = X - j * px;
  const int sx0 = base_x + offs_x[rx] + qx * j;
  const float* plane = src + static_cast<int64_t>(f) * H * W;
  dst[X] = jt_window_dot(plane, H, W, info[si], sx0, smem + rx * astride, fs);
}

}  // namespace

// src (F, H, W) f32; anchors (n_strips, ny_max, px, astride) f32; info
// (2*n_strips) int32 = [row0..., ny...]; offs_x (px) int32; out (F, n_strips,
// ny_max, px*nxb) f32. All contiguous.
extern "C" int jt_strips(const float* src, const float* anchors, const int* info,
                         const int* offs_x, float* out, int F, int H, int W, int n_strips,
                         int ny_max, int px, int qx, int base_x, int nxb, int fs, int astride,
                         cudaStream_t stream) {
  const int wout = px * nxb;
  const size_t smem = static_cast<size_t>(px) * astride * sizeof(float);
  cudaError_t err = jt_allow_smem(strips_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wout + kThreads - 1) / kThreads, ny_max, F * n_strips);
  strips_kernel<<<grid, kThreads, smem, stream>>>(src, anchors, info, offs_x, out, H, W, n_strips,
                                                  ny_max, px, qx, base_x, wout, fs, astride);
  return static_cast<int>(cudaGetLastError());
}
