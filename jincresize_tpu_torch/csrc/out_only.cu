// Zero-write probe: stores zeros into an (F, H, W) f32 tensor, one block per
// (tile_h, tile_w) tile, frames on gridDim.z.
//
// Replaces the `out_only` probe of tools/profiling/device_loop_timing.py
// (`kern`, a pallas_call that writes a zero (48, 256) block per grid step of
// a (4320, 7680) output, vmapped over 8 frames): a store-only pass whose time
// against a memset of the same bytes shows the cost a launch pays per tile.
// It is bound by HBM bytes (each output byte written once, nothing read).
//
// A block of 1024 threads maps them 2-D: 64 lanes along a tile row (one
// float4 each, 256 floats a pass) by 16 rows, so no store needs a division,
// and a (48, 256) tile takes three streaming stores (__stcs: evict first) a
// thread. Blocks of 1024 threads finish a tile in three passes, so the last
// blocks of the grid leave little of the card idle. Rows are written as
// float4 where the width and the pointer allow it; otherwise, and for the
// ragged right and bottom tiles of a non-multiple-of-4 width, one float at a
// time.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kLanesX = 64;  // float4 lanes along a tile row

__global__ void __launch_bounds__(kThreads)
    out_only_kernel(float* __restrict__ out, int H, int W, int tile_h, int tile_w, bool vec) {
  constexpr int kRowsPass = kThreads / kLanesX;  // tile rows a pass
  const int y0 = blockIdx.y * tile_h, x0 = blockIdx.x * tile_w;
  const int h = min(tile_h, H - y0), w = min(tile_w, W - x0);
  float* tile = out + static_cast<int64_t>(blockIdx.z) * H * W + static_cast<int64_t>(y0) * W + x0;
  const int lx = threadIdx.x % kLanesX, ly = threadIdx.x / kLanesX;
  if (vec) {  // W, x0 and the base pointer are multiples of 4 floats, so w is too
    const int n4 = w / 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n4 == kLanesX) {  // a full-width (256-float) row: one float4 a lane, no inner loop
      float4* p = reinterpret_cast<float4*>(tile + static_cast<int64_t>(ly) * W) + lx;
      const int64_t step = static_cast<int64_t>(kRowsPass) * W / 4;
#pragma unroll 4
      for (int r = ly; r < h; r += kRowsPass, p += step) __stcs(p, z);
      return;
    }
    for (int r = ly; r < h; r += kRowsPass) {
      float4* row = reinterpret_cast<float4*>(tile + static_cast<int64_t>(r) * W);
      for (int c = lx; c < n4; c += kLanesX) __stcs(row + c, z);
    }
    return;
  }
  for (int r = ly; r < h; r += kRowsPass)
    for (int c = lx; c < w; c += kLanesX) tile[static_cast<int64_t>(r) * W + c] = 0.f;
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
