// The border strips of the gather and fused-seg engines: every strip pixel
// of a plane, for all frames, in one launch.
//
// Replaces no TPU kernel: the JAX package computes these strips with XLA
// ops (jincresize_tpu/apply_strips_fast.py), and the port ran them as torch
// ops, a float64 einsum over float64 copies of the static per-pixel blocks
// (the top and bottom strips) and float32 products of gathered windows (the
// left and right ones): ~27 launches a plane and, at 3840x2160 -> 1366x768
// tap 16, ~9.5 ms of device time a frame.
//
// Pixel (y, x) of a strip whose blocks are `blk` (ny, nx, fs, fs), frame f:
//
//   out[f, y, x] = sum_{ly, lx < fs} blk[y - y0, x - x0, ly, lx]
//                                    * src[f, start_y[y] + ly, start_x[x] + lx]
//
// each product of two float32 values exact in float64, summed in float64,
// rounded once to float32: the plain form (kernels/band_strips.py
// band_strips_plain, a float64 einsum) sums the same products in another
// order, so the two agree within one float32 ulp. build_plane_operator
// clamps every window inside the source (the host checks it).
//
// What bounds it: the blocks' bytes. Every strip pixel has its own fs x fs
// block, 33,856 bytes at fs 92: 2.28 GB for the luma plane of that
// deployment, 0.68 ms at 3.35 TB/s, against ~6e8 float64 multiply-adds
// (~0.04 ms). Its windows are few: along a clamped axis pixels share them
// (a top strip's column shares start_y = 0, a left strip's row start_x =
// 0), 16 pixels a window at tap 16. So:
//
// * The host groups the pixels that share a window start, at most 16 a
//   group (kernels/band_strips.py make_band_strips). A block of 8 warps
//   takes one group; warp w takes its members w and w + 8.
// * The block stages the window once, as float64, in shared memory, for
//   NF frames together, a band of tap rows at a time (all fs rows unless NF
//   frames of them pass the shared memory). The staged band is split by
//   flat tap index mod 4 (below), so that the lanes of a warp read
//   consecutive doubles whatever the alignment of their block.
// * Each member's block is contiguous: a warp streams it once for the NF
//   frames, 16 bytes a lane, neighbouring lanes on neighbouring addresses,
//   8 loads in flight a lane, marked evict-first so the source stays in L2.
//   A load's 4 weights are converted to float64 once and serve all NF
//   frames. The blocks are read ceil(F / 8) times a call: once for F <= 8.
// * Each lane sums its products in float64; the warp adds its lanes' sums
//   with shuffles and lane 0 writes each frame's value.
//
// Tap index p = ly * fs + lx of the band's rows [k0, k0 + rows): the
// member's weights are floats [o, o + nb) of its strip, o = block * fs^2 +
// k0 * fs, nb = rows * fs. A lane loads the float4 at a0 + 4c, a0 = o
// rounded down to a multiple of 4, s = o - a0; its element j is tap p = 4c
// + j - s. The stage holds tap p of frame f at win[f][p & 3][(p >> 2) + 1],
// zeros at p in [-4, 0) and [nb, nb + 3), so a lane's reads for one (j, f)
// are consecutive doubles across the warp (conflict-free), and the taps a
// float4 holds outside the band meet zeros.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;      // a block's warps
constexpr int kSlots = 2;      // members a warp: a group holds at most kWarps * kSlots
constexpr int kUnroll = 8;     // 16-byte loads in flight a lane
constexpr int kMaxStrips = 4;  // top, bottom, left, right

struct BandArgs {
  const float* src;     // (F, H, W) float32
  const int4* groups;   // (start_y, start_x, m0, m1): members [m0, m1) share the window
  const int4* members;  // (strip, block, out, 0): block is the pixel's index in its strip
  float* out;           // (F, n_out) float32
  const float* blocks[kMaxStrips];  // each strip's (ny, nx, fs, fs) blocks
  long long floats[kMaxStrips];     // each strip's floats
  int F, H, W, fs, n_out, band_rows, qp;
};

__device__ __forceinline__ int strip_index(int s) { return s < 0 ? 0 : (s < kMaxStrips ? s : 0); }

template <int NF>
__global__ void __launch_bounds__(kWarps * 32) strips_band_kernel(const BandArgs a) {
  extern __shared__ double win[];  // [NF][4][qp]
  const int4 g = a.groups[blockIdx.x];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int fs = a.fs, qp = a.qp;
  const long long n = static_cast<long long>(fs) * fs;
  const int64_t plane = static_cast<int64_t>(a.H) * a.W;

  bool live[kSlots];
  int4 mem[kSlots];
  const float* base[kSlots];
  long long total[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int m = g.z + warp + k * kWarps;
    live[k] = m < g.w;
    mem[k] = live[k] ? a.members[m] : make_int4(0, 0, 0, 0);
    const int si = strip_index(mem[k].x);
    base[k] = a.blocks[si];
    total[k] = a.floats[si];
  }

  for (int f0 = 0; f0 < a.F; f0 += NF) {
    double acc[kSlots][NF];
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[k][f] = 0.0;

    for (int k0 = 0; k0 < fs; k0 += a.band_rows) {
      const int rows = min(a.band_rows, fs - k0);
      const int nb = rows * fs;
      __syncthreads();  // every warp is done with the last band
      for (int f = 0; f < NF; ++f) {
        double* const w = win + f * 4 * qp;
        if (f0 + f < a.F) {
          const float* const s =
              a.src + (f0 + f) * plane + static_cast<int64_t>(g.x + k0) * a.W + g.y;
          for (int k = warp; k < rows; k += kWarps)
            for (int l = lane; l < fs; l += 32) {
              const int p = k * fs + l;
              w[(p & 3) * qp + (p >> 2) + 1] =
                  static_cast<double>(__ldg(s + static_cast<int64_t>(k) * a.W + l));
            }
        } else {  // a frame past F in the last pass: zeros, written nowhere
          for (int p = threadIdx.x; p < nb; p += kWarps * 32) w[(p & 3) * qp + (p >> 2) + 1] = 0.0;
        }
        if (threadIdx.x < 4) {
          w[threadIdx.x * qp] = 0.0;  // taps -4 .. -1
        } else if (threadIdx.x < 7) {
          const int p = nb + threadIdx.x - 4;  // taps nb .. nb + 2
          w[(p & 3) * qp + (p >> 2) + 1] = 0.0;
        }
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (!live[k]) continue;  // the same for the whole warp
        const long long o = static_cast<long long>(mem[k].y) * n + static_cast<long long>(k0) * fs;
        const long long a0 = o & ~3LL;
        const int s = static_cast<int>(o - a0);
        const int chunks = (s + nb + 3) >> 2;
        const float4* const p4 = reinterpret_cast<const float4*>(base[k] + a0);
        int at_j[4];  // element j of chunk c is tap 4c + j - s, staged at win[at_j[j] + c]
#pragma unroll
        for (int j = 0; j < 4; ++j) at_j[j] = ((j - s) & 3) * qp + ((j - s) >> 2) + 1;
        for (int c0 = 0; c0 < chunks; c0 += 32 * kUnroll) {
          float4 v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int c = c0 + u * 32 + lane;
            const long long at = a0 + 4LL * c;
            if (c < chunks && at + 4 <= total[k]) {
              v[u] = __ldcs(p4 + c);
            } else {  // past the band, or the strip's last floats
              const float* const q = base[k] + at;
              v[u].x = c < chunks && at < total[k] ? q[0] : 0.f;
              v[u].y = c < chunks && at + 1 < total[k] ? q[1] : 0.f;
              v[u].z = c < chunks && at + 2 < total[k] ? q[2] : 0.f;
              v[u].w = 0.f;  // at + 3 >= total here
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int c = c0 + u * 32 + lane;
            if (c < chunks) {
              const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const double* const wp = win + at_j[j] + c;
                const double b = static_cast<double>(e[j]);
#pragma unroll
                for (int f = 0; f < NF; ++f) acc[k][f] = fma(b, wp[f * 4 * qp], acc[k][f]);
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        double x = acc[k][f];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0 && live[k] && f0 + f < a.F)
          a.out[static_cast<int64_t>(f0 + f) * a.n_out + mem[k].z] = static_cast<float>(x);
      }
    }
  }
}

template <int NF>
int launch(const BandArgs& a, int n_groups, size_t smem, cudaStream_t stream) {
  cudaError_t err = jt_allow_smem(strips_band_kernel<NF>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  strips_band_kernel<NF><<<n_groups, kWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src (F, H, W) f32 contiguous; groups (n_groups, 4) and members (n, 4)
// int32 (kernels/band_strips.py BandStrips); out (F, n_out) f32
// contiguous; b0 .. b3 each strip's blocks, 16-byte aligned (null past the
// plane's strips), nb0 .. nb3 their blocks (ny * nx). frames: a pass's
// frames NF in {1, 2, 4, 8}; band_rows: the tap rows a stage holds.
extern "C" int jt_band_strips(const float* src, const int* groups, const int* members, float* out,
                              const float* b0, const float* b1, const float* b2, const float* b3,
                              int nb0, int nb1, int nb2, int nb3, int F, int H, int W, int fs,
                              int n_groups, int n_out, int frames, int band_rows,
                              cudaStream_t stream) {
  if (F < 1 || fs < 1 || H < fs || W < fs || n_groups < 1 || n_out < 1 || band_rows < 1 ||
      band_rows > fs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qp = (band_rows * fs + 3) / 4 + 2;
  const size_t smem = static_cast<size_t>(frames) * 4 * qp * sizeof(double);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(fs) * fs;
  const BandArgs a{src, reinterpret_cast<const int4*>(groups), reinterpret_cast<const int4*>(members),
                   out, {b0, b1, b2, b3}, {nb0 * n, nb1 * n, nb2 * n, nb3 * n}, F, H, W, fs,
                   n_out, band_rows, qp};
  switch (frames) {
    case 1: return launch<1>(a, n_groups, smem, stream);
    case 2: return launch<2>(a, n_groups, smem, stream);
    case 4: return launch<4>(a, n_groups, smem, stream);
    case 8: return launch<8>(a, n_groups, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
