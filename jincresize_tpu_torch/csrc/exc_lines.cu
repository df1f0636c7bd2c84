// Exception-line fixups: the destination columns and rows that a phase plan
// does not cover (float32 start-offset outliers and partial trailing
// periods), each pixel from its class-pair block, written straight into the
// caller's canvas.
//
// Replaces no TPU kernel: the JAX package computes these lines with XLA ops
// (jincresize_tpu/apply_conv.py _cols_subset / _rows_subset), and the port
// ran the same per-tap torch loop, about 8 ops for each of the fs vertical
// taps and ten more for the rows: ~360 launches a plane call at tap 16
// (fs 44), where the work is a few microseconds of the card. This kernel
// does all of a plane's lines in one launch.
//
// Pixel (y, x) of a line, frame f:
//
//   out[f, y - oy, x - ox] =
//     sum_{ly, lx < fs} pair[cy_idx[y], cx_idx[x], ly, lx]
//                       * src[f, clamp(start_y[y] + ly, 0, H - 1),
//                                clamp(start_x[x] + lx, 0, W - 1)]
//
// summed in float32 in the order of the plain form (kernels/lines.py
// exc_lines_plain), which it matches bit for bit on the card: each tap row ly
// as one fmaf chain from 0 in lx order, then the rows added in ly order (one
// chain over all fs * fs taps drifts ~5x farther from a float64 sum at fs
// 44). A line is one int4 of `lines`: (kind, index, lo, hi), a column x =
// index over rows [lo, hi) (kind 0) or a row y = index over columns [lo, hi)
// (kind 1). The host splits a column around the pixels a row owns, so a
// pixel where the two cross is computed and written once.
//
// What bounds it: neither bytes nor FMAs (11.6 M FMAs a frame at tap 16
// 1440p -> 1080p, under a microsecond of fp32 issue) but latency: a few
// thousand pixels, each fs chains of fs dependent FMAs. A first form, one
// thread a pixel running all fs chains, took ~0.5 ms a plane at one frame
// on an H100 (PERF.md section 6). Here the chains of a pixel run in
// parallel, as the order above allows:
//
// * A block takes 32 consecutive pixels of one line (a warp's lanes) and 8
//   warps; warp w runs the tap rows ly = w, w + 8, ... of those pixels, two
//   rows' chains at a time for the loads' sake, and leaves each row's sum in
//   shared memory ([fs][kFrames][32] floats).
// * After a barrier one warp a frame adds the fs row sums of its pixels in
//   ly order and writes them.
// * The frames are looped over in passes of up to 4, inside each chain, so
//   each weight is read once for all of them. Weights and source come
//   through the read-only cache (L2 holds a plane's class-pair blocks and
//   the lines' source windows): a tap row's weights are consecutive, as are
//   a row line's source windows.
#include "common.cuh"

namespace {

constexpr int kPix = 32;     // pixels of one line a block: a warp's lanes
constexpr int kWarps = 8;    // warps a block; warp w runs the tap rows ly = w mod 8
constexpr int kFrames = 4;   // frames a pass (and the warps that add the rows)

struct ExcArgs {
  const float* src;   // (F, H, W)
  const float* pair;  // (n_uy, n_ux, fs, fs)
  const int4* lines;  // (n_lines,) (kind, index, lo, hi)
  const long long* start_y;  // the operator's int64 tables
  const long long* start_x;
  const long long* cy_idx;
  const long long* cx_idx;
  float* out;
  int F, H, W, n_ux, fs;
  int64_t out_sf, out_sy, out_sx;
  int oy, ox;
};

__global__ void __launch_bounds__(kPix * kWarps) exc_lines_kernel(const ExcArgs a) {
  extern __shared__ float row_sums[];  // [fs][kFrames][kPix]
  const int4 ln = a.lines[blockIdx.y];
  // The grid is sized by the longest line: a block past its own line's end
  // has nothing to write (the same for all its threads, so before any barrier).
  if (ln.z + static_cast<int>(blockIdx.x) * kPix >= ln.w) return;
  const int lane = threadIdx.x % kPix, warp = threadIdx.x / kPix;
  const int j = ln.z + blockIdx.x * kPix + lane;
  const bool live = j < ln.w;  // lanes past the line read a live pixel's window, write nothing
  const int jj = live ? j : ln.z;
  const int y = ln.x ? ln.y : jj;
  const int x = ln.x ? jj : ln.y;
  const int fs = a.fs;
  const int sy = static_cast<int>(__ldg(a.start_y + y));
  const int sx = static_cast<int>(__ldg(a.start_x + x));
  const float* const w = a.pair + (__ldg(a.cy_idx + y) * a.n_ux + __ldg(a.cx_idx + x)) * fs * fs;
  const int64_t plane = static_cast<int64_t>(a.H) * a.W;
  for (int f0 = 0; f0 < a.F; f0 += kFrames) {
    const int nf = min(kFrames, a.F - f0);
    const float* const s = a.src + f0 * plane;
    for (int ly0 = warp; ly0 < fs; ly0 += 2 * kWarps) {
      const int ly1 = ly0 + kWarps < fs ? ly0 + kWarps : ly0;  // ly0 again: no second row left
      const float* const s0 = s + static_cast<int64_t>(min(max(sy + ly0, 0), a.H - 1)) * a.W;
      const float* const s1 = s + static_cast<int64_t>(min(max(sy + ly1, 0), a.H - 1)) * a.W;
      const float* const w0 = w + ly0 * fs;
      const float* const w1 = w + ly1 * fs;
      float r0[kFrames], r1[kFrames];
#pragma unroll
      for (int k = 0; k < kFrames; ++k) r0[k] = r1[k] = 0.f;
#pragma unroll 4
      for (int lx = 0; lx < fs; ++lx) {
        const int c = min(max(sx + lx, 0), a.W - 1);
        const float v0 = __ldg(w0 + lx), v1 = __ldg(w1 + lx);
#pragma unroll
        for (int k = 0; k < kFrames; ++k) {
          if (k < nf) {
            r0[k] = fmaf(v0, __ldg(s0 + k * plane + c), r0[k]);
            r1[k] = fmaf(v1, __ldg(s1 + k * plane + c), r1[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kFrames; ++k) {
        row_sums[(ly0 * kFrames + k) * kPix + lane] = r0[k];
        if (ly1 > ly0) row_sums[(ly1 * kFrames + k) * kPix + lane] = r1[k];
      }
    }
    __syncthreads();
    if (warp < nf && live) {
      float acc = 0.f;
      for (int ly = 0; ly < fs; ++ly)
        acc = __fadd_rn(acc, row_sums[(ly * kFrames + warp) * kPix + lane]);
      a.out[(f0 + warp) * a.out_sf + static_cast<int64_t>(y - a.oy) * a.out_sy +
            static_cast<int64_t>(x - a.ox) * a.out_sx] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// src (F, H, W) f32 contiguous; pair (n_uy, n_ux, fs, fs) f32 contiguous;
// lines (n_lines, 4) int32 (above); start_y, cy_idx (dst_h) and start_x,
// cx_idx (dst_w) int64; out f32 at any strides (elements) out_sf, out_sy,
// out_sx, its element [0, 0, 0] destination pixel (oy, ox). max_len: the
// longest line's hi - lo.
extern "C" int jt_exc_lines(const float* src, const float* pair, const int* lines,
                            const long long* start_y, const long long* start_x,
                            const long long* cy_idx, const long long* cx_idx, float* out, int F, int H, int W, int n_lines,
                            int max_len, int n_ux, int fs, int out_sf, int out_sy, int out_sx,
                            int oy, int ox, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(fs) * kFrames * kPix * sizeof(float);
  if (n_lines < 1 || n_lines > 65535 || max_len < 1 || fs < 1 || F < 1 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = jt_allow_smem(exc_lines_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ExcArgs a{src, pair, reinterpret_cast<const int4*>(lines), start_y, start_x, cy_idx,
                  cx_idx, out, F, H, W, n_ux, fs, out_sf, out_sy, out_sx, oy, ox};
  const dim3 grid((max_len + kPix - 1) / kPix, n_lines);
  exc_lines_kernel<<<grid, kPix * kWarps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
