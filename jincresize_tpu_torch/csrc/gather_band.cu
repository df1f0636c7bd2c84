// One row shard of the sharded gather engine, stored into the shard's canvas.
//
// Replaces jincresize_tpu/kernels/pallas_gather.py::band_kernel (built by
// make_gather_band). For destination row r of the shard (border rows
// included) and interior column x in [0, nxi):
//
//   canvas[f, r, x_lo + x] = sum_{ly, lx < fs} band[f, syl[r] + ly, sx[x] + lx]
//                                              * pbt[cy[r], ly, lx, cx[x]]
//
// band is the shard's source rows plus the halos collected from its
// neighbours, syl the band-local window starts. The math and the thread
// layout are the gather interior's (csrc/gather_interior.cu): one thread per
// output pixel of a 32 x 8 tile, up to kFrames frames per thread, the window
// sum of common.cuh jt_gather_window. The kernel stores straight into the
// shard's (F, td, dst_w) canvas at column x_lo with the canvas row stride, so
// no interior block is copied into the canvas afterwards. The host checks
// that every window lies inside the band (kernels/gather.py make_gather_band);
// the kernel has no edge rule.
#include "common.cuh"

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kFrames = 4;

__global__ void __launch_bounds__(kTileX* kTileY)
    gather_band_kernel(const float* __restrict__ band, const float* __restrict__ pbt,
                       const int* __restrict__ syl, const int* __restrict__ cy,
                       const int* __restrict__ sx, const int* __restrict__ cx,
                       float* __restrict__ canvas, int F, int band_h, int W, int td, int nxi,
                       int n_ux, int fs, int dst_w, int x_lo) {
  const int X = blockIdx.x * kTileX + threadIdx.x;
  const int Y = blockIdx.y * kTileY + threadIdx.y;
  if (X >= nxi || Y >= td) return;
  const int f0 = blockIdx.z * kFrames;
  const int nf = min(kFrames, F - f0);
  const int64_t plane = static_cast<int64_t>(band_h) * W;
  const float* w = pbt + static_cast<int64_t>(cy[Y]) * fs * fs * n_ux + cx[X];
  const float* s0 = band + f0 * plane + static_cast<int64_t>(syl[Y]) * W + sx[X];
  float acc[kFrames];
  jt_gather_window<kFrames>(s0, plane, W, w, n_ux, fs, nf, acc);
  const int64_t frame = static_cast<int64_t>(td) * dst_w;
  float* o = canvas + f0 * frame + static_cast<int64_t>(Y) * dst_w + x_lo + X;
#pragma unroll
  for (int i = 0; i < kFrames; ++i)
    if (i < nf) o[i * frame] = acc[i];
}

}  // namespace

// band (F, band_h, W) f32; pbt (n_uy, fs, fs, n_ux) f32; syl, cy (td) int32;
// sx, cx (nxi) int32; canvas (F, td, dst_w) f32, columns [x_lo, x_lo + nxi)
// written. All contiguous.
extern "C" int jt_gather_band(const float* band, const float* pbt, const int* syl, const int* cy,
                              const int* sx, const int* cx, float* canvas, int F, int band_h,
                              int W, int td, int nxi, int n_ux, int fs, int dst_w, int x_lo,
                              cudaStream_t stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((nxi + kTileX - 1) / kTileX, (td + kTileY - 1) / kTileY,
                  (F + kFrames - 1) / kFrames);
  gather_band_kernel<<<grid, block, 0, stream>>>(band, pbt, syl, cy, sx, cx, canvas, F, band_h, W,
                                                 td, nxi, n_ux, fs, dst_w, x_lo);
  return static_cast<int>(cudaGetLastError());
}
