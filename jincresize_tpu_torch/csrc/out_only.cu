// Zero-write probe: stores zeros into an (F, H, W) f32 tensor, one block per
// (tile_h, tile_w) tile, frames on gridDim.z.
//
// Replaces the `out_only` probe of tools/profiling/device_loop_timing.py
// (`kern`, a pallas_call that writes a zero (48, 256) block per grid step of
// a (4320, 7680) output, vmapped over 8 frames): a store-only pass whose time
// against a memset of the same bytes shows the cost a launch pays per tile.
// It is bound by HBM bytes (each output byte written once, nothing read).
// Rows of a tile are written as float4 where the width and the pointer allow
// it, and the ragged right and bottom tiles are bounds-checked.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    out_only_kernel(float* __restrict__ out, int H, int W, int tile_h, int tile_w, bool vec) {
  const int y0 = blockIdx.y * tile_h, x0 = blockIdx.x * tile_w;
  const int h = min(tile_h, H - y0), w = min(tile_w, W - x0);
  float* tile = out + static_cast<int64_t>(blockIdx.z) * H * W + static_cast<int64_t>(y0) * W + x0;
  if (vec) {  // W, x0 and the base pointer are multiples of 4 floats, so w is too
    const int n4 = w / 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < h * n4; i += kThreads) {
      const int r = i / n4, c = i - r * n4;
      reinterpret_cast<float4*>(tile + static_cast<int64_t>(r) * W)[c] = z;
    }
    return;
  }
  for (int i = threadIdx.x; i < h * w; i += kThreads) {
    const int r = i / w, c = i - r * w;
    tile[static_cast<int64_t>(r) * W + c] = 0.f;
  }
}

}  // namespace

// out (F, H, W) f32, contiguous. tile_h, tile_w >= 1.
extern "C" int jt_out_only(float* out, int F, int H, int W, int tile_h, int tile_w,
                           cudaStream_t stream) {
  if (tile_h < 1 || tile_w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = W % 4 == 0 && tile_w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, F);
  out_only_kernel<<<grid, kThreads, 0, stream>>>(out, H, W, tile_h, tile_w, vec);
  return static_cast<int>(cudaGetLastError());
}
