// Interior of any geometry: per-pixel window starts and dictionary classes.
//
// Replaces jincresize_tpu/kernels/pallas_gather.py::_gather_kernel (built by
// make_gather_interior). For interior row m and column x:
//
//   out[f, m, x] = sum_{ly, lx < fs} src[f, sy[m] + ly, sx[x] + lx]
//                                    * pbt[cy[m], ly, lx, cx[x]]
//
// pbt is the compact class-pair dictionary stored class-minor, so the 32
// columns of a warp read one n_ux-float row per tap. One thread per output
// pixel of a 32 x 8 tile: fp32 FMA along each tap row, the row sums added in
// ly order (common.cuh jt_gather_window; kernels/gather.py's plain form sums
// alike). A thread carries up to kFrames frames (gridDim.z walks the frame
// groups), so each weight it loads serves every frame of its group. The host
// guarantees 0 <= sy <= H - fs and 0 <= sx <= W - fs (kernels/gather.py), so
// no read leaves the plane.
#include "common.cuh"

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kFrames = 4;

__global__ void __launch_bounds__(kTileX* kTileY)
    gather_interior_kernel(const float* __restrict__ src, const float* __restrict__ pbt,
                           const int* __restrict__ sy, const int* __restrict__ cy,
                           const int* __restrict__ sx, const int* __restrict__ cx,
                           float* __restrict__ out, int F, int H, int W, int nyi, int nxi,
                           int n_ux, int fs) {
  const int X = blockIdx.x * kTileX + threadIdx.x;
  const int Y = blockIdx.y * kTileY + threadIdx.y;
  if (X >= nxi || Y >= nyi) return;
  const int f0 = blockIdx.z * kFrames;
  const int nf = min(kFrames, F - f0);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* w = pbt + static_cast<int64_t>(cy[Y]) * fs * fs * n_ux + cx[X];
  const float* s0 = src + f0 * plane + static_cast<int64_t>(sy[Y]) * W + sx[X];
  float acc[kFrames];
  jt_gather_window<kFrames>(s0, plane, W, w, n_ux, fs, nf, acc);
  float* o = out + f0 * (static_cast<int64_t>(nyi) * nxi) + static_cast<int64_t>(Y) * nxi + X;
#pragma unroll
  for (int i = 0; i < kFrames; ++i)
    if (i < nf) o[i * static_cast<int64_t>(nyi) * nxi] = acc[i];
}

}  // namespace

// src (F, H, W) f32; pbt (n_uy, fs, fs, n_ux) f32; sy, cy (nyi) int32; sx, cx
// (nxi) int32; out (F, nyi, nxi) f32. All contiguous.
extern "C" int jt_gather_interior(const float* src, const float* pbt, const int* sy, const int* cy,
                                  const int* sx, const int* cx, float* out, int F, int H, int W,
                                  int nyi, int nxi, int n_ux, int fs, cudaStream_t stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((nxi + kTileX - 1) / kTileX, (nyi + kTileY - 1) / kTileY,
                  (F + kFrames - 1) / kFrames);
  gather_interior_kernel<<<grid, block, 0, stream>>>(src, pbt, sy, cy, sx, cx, out, F, H, W, nyi,
                                                     nxi, n_ux, fs);
  return static_cast<int>(cudaGetLastError());
}
