// Segment-periodic interior of drifted rational scales, in destination layout.
//
// Replaces jincresize_tpu/kernels/pallas_fused_seg.py::_seg_kernel (built by
// make_seg_interior). Per axis, covered coordinate k (k < p*nblocks) has the
// window start base + q*(k/p) + roff[k] and the true dictionary class
// cls[k] (phase.SegPhasePlan), so
//
//   out[f, Y, X] = sum_{ly, lx < fs} src[f, base_y + qy*(Y/py) + roff_y[Y] + ly,
//                                        base_x + qx*(X/px) + roff_x[X] + lx]
//                                  * pbt[cls_y[Y], ly, lx, cls_x[X]]
//
// The starts are affine up to a spread of at most 8, so the 32 x 8 output
// tile of a thread block reads a bounded source window: win_h x win_w from
// (base_y + qy*(Y0/py), base_x + qx*(X0/px)), sized on the host over every
// tile (kernels/seg.py). The block stages that window for each of its nfb
// frames in shared memory once (zeros past the plane's edge, never read),
// then each thread runs its pixel's fs x fs window against the compact
// dictionary, stored class-minor (pbt, __ldg, L1/L2-resident): fp32 FMA along
// each tap row, the row sums added in ly order (as the plain form does), one
// weight load serving every staged frame.
#include "common.cuh"

namespace {

constexpr int kTileX = 32;  // kernels/seg.py TILE_X
constexpr int kTileY = 8;   // kernels/seg.py TILE_Y
constexpr int kMaxFrames = 4;

__global__ void __launch_bounds__(kTileX* kTileY)
    seg_interior_kernel(const float* __restrict__ src, const float* __restrict__ pbt,
                        const int* __restrict__ cls_y, const int* __restrict__ roff_y,
                        const int* __restrict__ cls_x, const int* __restrict__ roff_x,
                        float* __restrict__ out, int F, int H, int W, int py, int qy, int base_y,
                        int px, int qx, int base_x, int hout, int wout, int n_ux, int fs,
                        int win_h, int win_w, int nfb) {
  extern __shared__ float win[];  // (nfb, win_h, win_w)
  const int f0 = blockIdx.z * nfb;
  const int nf = min(nfb, F - f0);
  const int X0 = blockIdx.x * kTileX;
  const int Y0 = blockIdx.y * kTileY;
  const int ox = qx * (X0 / px);  // window origin relative to (base_y, base_x)
  const int oy = qy * (Y0 / py);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int wsz = win_h * win_w;

  for (int t = threadIdx.y * kTileX + threadIdx.x; t < nf * wsz; t += kTileX * kTileY) {
    const int f = t / wsz;
    const int r = (t - f * wsz) / win_w;
    const int c = t - f * wsz - r * win_w;
    const int gy = base_y + oy + r, gx = base_x + ox + c;
    win[t] = (gy < H && gx < W)
                 ? __ldg(src + (f0 + f) * plane + static_cast<int64_t>(gy) * W + gx)
                 : 0.f;
  }
  __syncthreads();

  const int X = X0 + threadIdx.x;
  const int Y = Y0 + threadIdx.y;
  if (X >= wout || Y >= hout) return;
  const int ry = qy * (Y / py) + roff_y[Y] - oy;
  const int rx = qx * (X / px) + roff_x[X] - ox;
  const float* w = pbt + static_cast<int64_t>(cls_y[Y]) * fs * fs * n_ux + cls_x[X];
  const float* s0 = win + ry * win_w + rx;
  float acc[kMaxFrames] = {0.f, 0.f, 0.f, 0.f};
  for (int ly = 0; ly < fs; ++ly) {
    const float* srow = s0 + ly * win_w;
    float row[kMaxFrames] = {0.f, 0.f, 0.f, 0.f};
    for (int lx = 0; lx < fs; ++lx, w += n_ux) {
      const float wv = __ldg(w);
#pragma unroll
      for (int i = 0; i < kMaxFrames; ++i)
        if (i < nf) row[i] = fmaf(srow[i * wsz + lx], wv, row[i]);
    }
#pragma unroll
    for (int i = 0; i < kMaxFrames; ++i) acc[i] += row[i];
  }
  const int64_t oplane = static_cast<int64_t>(hout) * wout;
  float* o = out + f0 * oplane + static_cast<int64_t>(Y) * wout + X;
#pragma unroll
  for (int i = 0; i < kMaxFrames; ++i)
    if (i < nf) o[i * oplane] = acc[i];
}

}  // namespace

// src (F, H, W) f32; pbt (n_uy, fs, fs, n_ux) f32; cls_y, roff_y (hout) and
// cls_x, roff_x (wout) int32; out (F, hout, wout) f32. All contiguous.
// nfb <= 4 frames per block; shared memory nfb * win_h * win_w floats.
extern "C" int jt_seg_interior(const float* src, const float* pbt, const int* cls_y,
                               const int* roff_y, const int* cls_x, const int* roff_x, float* out,
                               int F, int H, int W, int py, int qy, int base_y, int px, int qx,
                               int base_x, int hout, int wout, int n_ux, int fs, int win_h,
                               int win_w, int nfb, cudaStream_t stream) {
  if (nfb < 1 || nfb > kMaxFrames) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(nfb) * win_h * win_w * sizeof(float);
  cudaError_t err = jt_allow_smem(seg_interior_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kTileX, kTileY);
  const dim3 grid((wout + kTileX - 1) / kTileX, (hout + kTileY - 1) / kTileY,
                  (F + nfb - 1) / nfb);
  seg_interior_kernel<<<grid, block, smem, stream>>>(src, pbt, cls_y, roff_y, cls_x, roff_x, out, F,
                                                     H, W, py, qy, base_y, px, qx, base_x, hout,
                                                     wout, n_ux, fs, win_h, win_w, nfb);
  return static_cast<int>(cudaGetLastError());
}
