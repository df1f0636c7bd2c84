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
//
// The thread block's shape (TX, TY) is a compile-time constant, one of a
// fixed set (kernels/fused.py TILES); 32x8 is the default of every engine,
// the others exist for the tile sweep (tools/fused_tile_sweep.py of the
// port), the Hopper counterpart of the TPU sweep over row-band and column
// tiles. Every shape computes the same sum in the same order, so all agree
// exactly.
#include "common.cuh"

namespace {

template <int TX, int TY>
__global__ void __launch_bounds__(TX* TY)
    fused_interior_kernel(const float* __restrict__ src, const float* __restrict__ w,
                          const int* __restrict__ offs, float* __restrict__ out, int H, int W,
                          int py, int px, int qy, int qx, int base_y, int base_x, int hout,
                          int wout, int fs, int wstride) {
  extern __shared__ float smem[];
  const int nw = py * px * wstride;
  for (int t = threadIdx.y * TX + threadIdx.x; t < nw; t += TX * TY) smem[t] = w[t];
  __syncthreads();

  const int X = blockIdx.x * TX + threadIdx.x;
  const int Y = blockIdx.y * TY + threadIdx.y;
  if (X >= wout || Y >= hout) return;
  const int i = Y / py, ry = Y - i * py;
  const int j = X / px, rx = X - j * px;
  const int sy0 = base_y + offs[ry] + qy * i;
  const int sx0 = base_x + offs[py + rx] + qx * j;
  const float* plane = src + static_cast<int64_t>(blockIdx.z) * H * W;
  out[static_cast<int64_t>(blockIdx.z) * hout * wout + static_cast<int64_t>(Y) * wout + X] =
      jt_window_dot(plane, H, W, sy0, sx0, smem + (ry * px + rx) * wstride, fs);
}

template <int TX, int TY>
cudaError_t launch(const float* src, const float* w, const int* offs, float* out, int F, int H,
                   int W, int py, int px, int qy, int qx, int base_y, int base_x, int hout,
                   int wout, int fs, int wstride, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(py) * px * wstride * sizeof(float);
  cudaError_t err = jt_allow_smem(fused_interior_kernel<TX, TY>, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(TX, TY);
  const dim3 grid((wout + TX - 1) / TX, (hout + TY - 1) / TY, F);
  fused_interior_kernel<TX, TY><<<grid, block, smem, stream>>>(
      src, w, offs, out, H, W, py, px, qy, qx, base_y, base_x, hout, wout, fs, wstride);
  return cudaGetLastError();
}

}  // namespace

// src (F, H, W) f32; w (py*px, wstride) f32; offs (py + px) int32 =
// [offs_y..., offs_x...]; out (F, py*nyb, px*nxb) f32. All contiguous.
// (tile_x, tile_y) is the thread block: 32x8, 32x4, 32x16, 64x4 or 16x16.
extern "C" int jt_fused_interior(const float* src, const float* w, const int* offs, float* out,
                                 int F, int H, int W, int py, int px, int qy, int qx, int base_y,
                                 int base_x, int nyb, int nxb, int fs, int wstride, int tile_x,
                                 int tile_y, cudaStream_t stream) {
  const int hout = py * nyb, wout = px * nxb;
#define JT_TILE(TX, TY)                                                                         \
  if (tile_x == TX && tile_y == TY)                                                             \
    return static_cast<int>(launch<TX, TY>(src, w, offs, out, F, H, W, py, px, qy, qx, base_y, \
                                           base_x, hout, wout, fs, wstride, stream));
  JT_TILE(32, 8)
  JT_TILE(32, 4)
  JT_TILE(32, 16)
  JT_TILE(64, 4)
  JT_TILE(16, 16)
#undef JT_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
