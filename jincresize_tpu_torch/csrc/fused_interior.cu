// Periodic interior of the phase-conv resample, written in destination layout.
//
// Replaces jincresize_tpu/kernels/pallas_fused.py::_fused_kernel (built by
// make_fused_interior). For destination row ylo + py*i + ry and column
// xlo + px*j + rx of the interior block:
//
//   out[f, py*i + ry, px*j + rx] =
//     sum_{ly, lx < fs} src[f, base_y + offs_y[ry] + qy*i + ly,
//                              base_x + offs_x[rx] + qx*j + lx] * w[ry*px + rx][ly, lx]
//
// One thread per output pixel, fp32 FMA accumulation. The (py*px, fs, fs)
// weight set is staged once per block in shared memory; its per-phase stride
// `wstride` is odd so that the px column phases a warp touches fall on
// distinct banks. Frames ride gridDim.z.
#include "common.cuh"

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__global__ void __launch_bounds__(kTileX* kTileY)
    fused_interior_kernel(const float* __restrict__ src, const float* __restrict__ w,
                          const int* __restrict__ offs, float* __restrict__ out, int H, int W,
                          int py, int px, int qy, int qx, int base_y, int base_x, int hout,
                          int wout, int fs, int wstride) {
  extern __shared__ float smem[];
  const int nw = py * px * wstride;
  for (int t = threadIdx.y * kTileX + threadIdx.x; t < nw; t += kTileX * kTileY) smem[t] = w[t];
  __syncthreads();

  const int X = blockIdx.x * kTileX + threadIdx.x;
  const int Y = blockIdx.y * kTileY + threadIdx.y;
  if (X >= wout || Y >= hout) return;
  const int i = Y / py, ry = Y - i * py;
  const int j = X / px, rx = X - j * px;
  const int sy0 = base_y + offs[ry] + qy * i;
  const int sx0 = base_x + offs[py + rx] + qx * j;
  const float* plane = src + static_cast<int64_t>(blockIdx.z) * H * W;
  out[static_cast<int64_t>(blockIdx.z) * hout * wout + static_cast<int64_t>(Y) * wout + X] =
      jt_window_dot(plane, H, W, sy0, sx0, smem + (ry * px + rx) * wstride, fs);
}

}  // namespace

// src (F, H, W) f32; w (py*px, wstride) f32; offs (py + px) int32 =
// [offs_y..., offs_x...]; out (F, py*nyb, px*nxb) f32. All contiguous.
extern "C" int jt_fused_interior(const float* src, const float* w, const int* offs, float* out,
                                 int F, int H, int W, int py, int px, int qy, int qx, int base_y,
                                 int base_x, int nyb, int nxb, int fs, int wstride,
                                 cudaStream_t stream) {
  const int hout = py * nyb, wout = px * nxb;
  const size_t smem = static_cast<size_t>(py) * px * wstride * sizeof(float);
  cudaError_t err = jt_allow_smem(fused_interior_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kTileX, kTileY);
  const dim3 grid((wout + kTileX - 1) / kTileX, (hout + kTileY - 1) / kTileY, F);
  fused_interior_kernel<<<grid, block, smem, stream>>>(src, w, offs, out, H, W, py, px, qy, qx,
                                                       base_y, base_x, hout, wout, fs, wstride);
  return static_cast<int>(cudaGetLastError());
}
