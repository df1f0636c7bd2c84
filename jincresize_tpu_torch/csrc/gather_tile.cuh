// The tile body shared by the gather interior and the gather band kernels.
//
// For output row m and column x of a launch (interior rows, or every row of
// a shard's band):
//
//   out[f, m, x] = sum_{ly, lx < fs} src[f, sy[m] + ly, sx[x] + lx]
//                                    * blocks[cy[m], cx[x], ly, lx]
//
// blocks is the compact class-pair dictionary (n_uy, n_ux, fs, fsp), each
// tap row padded to fsp = fs rounded up to 4 floats (kernels/gather.py
// padded_blocks). Per pixel and frame: an fmaf chain along each tap row in
// lx order, then the row sums added in ly order -- kernels/gather.py
// window_sum_plain sums alike, so kernel and plain form agree bit for bit.
//
// What bounds it on an H100: not the FMAs, but feeding them. Every pixel may
// own a different (fs, fs) block, so each weight serves only the frames of
// its own pixel, and the weights stream from L2 (fs 17: 89 MB padded, read
// once a frame group) or from device memory (fs 92: 138.7 MB, scattered
// over 33 GB a frame group at 4K -> 1366x768). The source is small and
// shared by neighbouring windows. The design:
//
// * A block takes a tile of kTX = 32 columns by kTY = 16 rows. Its source
//   window, [min sy, max sy + fs) x [min sx, max sx + fs), streams through
//   shared memory once, in a double-buffered cp.async ring of `ch` rows a
//   stage (4-byte copies, frame-minor: a staged row holds up to 4 frames of
//   a column side by side, a second plane the frames 4..7). Shared memory
//   thus bounds the span of one row, not fs: any filter size runs.
// * A thread owns one column and kRows = 2 consecutive rows, for NF frames
//   (NF in {1, 2, 4, 8}, chosen by the wrapper from F). For each staged
//   source row r and chunk of 4 taps it loads its 4 x NF source values once
//   (16-byte shared loads) and serves both rows: row m takes tap row
//   ly = r - sy[m] while sy[m] <= r < sy[m] + fs, so ly ascends, the plain
//   form's order. A row outside its window runs the FMAs on zero weights
//   and drops its sums, so no branch splits a chunk.
// * Each row's weights are one linear stream of 16-byte loads through its
//   block (tap rows contiguous, padded to whole chunks), kAhead = 2 chunks
//   ahead of the FMAs: one load serves 4 taps x NF frames, the lane's own
//   32-byte sector serves two chunks, and no address depends on the ring.
// * Results go straight from registers to the output, the lanes' stores
//   coalesced along the row.
//
// Tried on an H100 80GB HBM3 and dropped as slower or level: a bulk L2
// prefetch of whole weight rows, column-major block order, 4 rows a thread
// (more registers, fewer blocks), and weight loads 3 or 4 chunks ahead.
//
// The host guarantees 0 <= sy, sy + fs <= H and 0 <= sx, sx + fs <= W
// (kernels/gather.py check_window_starts), so no read leaves the plane; the
// ring's row span and depth are the host's too (kernels/gather.py
// ring_layout, whose tile_span mirrors the tile window below).
#pragma once

#include <climits>

#include "common.cuh"

namespace {

constexpr int kTX = 32;                  // columns of a tile, one a lane
constexpr int kRows = 2;                 // rows of a thread
constexpr int kGroups = 8;               // row groups (warps) of a block
constexpr int kAhead = 2;                // chunks the weight loads run ahead
constexpr int kTY = kRows * kGroups;     // rows of a tile
constexpr int kThreads = kTX * kGroups;  // threads of a block

struct GatherArgs {
  const float* src;     // (F, H, W)
  const float* blocks;  // (n_uy, n_ux, fs, fsp)
  const int* sy;        // (rows,) window starts
  const int* cy;        // (rows,) row classes
  const int* sx;        // (cols,) window starts
  const int* cx;        // (cols,) column classes
  float* out;           // out[f * out_frame + m * out_row + x]
  int64_t out_frame;
  int out_row;
  int F, H, W, rows, cols, n_ux, fs, fsp;
  int swp, ch;  // ring: columns of a staged row (padded to 4), rows a stage; 2 ch slots
};

// NB taps (the first NB of a chunk) of NF frames into each row's sums:
// NB x NF source values from the staged row at s, one weight a tap and row.
template <int NB, int NF, int FP, int R>
__device__ __forceinline__ void taps(const float* s, int plane_stride, const float4 (&w)[R],
                                     float (&row)[R][NF]) {
  float v[NB][NF];
#pragma unroll
  for (int b = 0; b < NB; ++b) jt_load_frames<NF>(s + b * FP, plane_stride, v[b]);
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const float wv[4] = {w[c].x, w[c].y, w[c].z, w[c].w};
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < NF; ++e) row[c][e] = fmaf(v[b][e], wv[b], row[c][e]);
  }
}

template <int NF>
__global__ void __launch_bounds__(kThreads) gather_tile_kernel(const GatherArgs a) {
  extern __shared__ __align__(16) float ring[];
  constexpr int FP = NF < 4 ? NF : 4;  // frames of a staged plane
  const int lane = threadIdx.x, grp = threadIdx.y;
  const int t = grp * kTX + lane;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int f0 = blockIdx.z * NF;
  const int nf = min(NF, a.F - f0);

  // The tile's window: every warp reduces the same starts, so all agree.
  const int x = x0 + lane;
  const bool xok = x < a.cols;
  const int my_sx = xok ? __ldg(a.sx + x) : INT_MAX;
  const int col_lo = __reduce_min_sync(0xffffffffu, my_sx);
  const int col_hi = __reduce_max_sync(0xffffffffu, xok ? my_sx : INT_MIN);
  const bool yok = lane < kTY && y0 + lane < a.rows;
  const int lane_sy = yok ? __ldg(a.sy + y0 + lane) : INT_MAX;
  const int row_lo = __reduce_min_sync(0xffffffffu, lane_sy);
  const int row_hi = __reduce_max_sync(0xffffffffu, yok ? lane_sy : INT_MIN);
  const int nr = row_hi - row_lo + a.fs;  // window rows
  const int sw = col_hi - col_lo + a.fs;  // window columns (<= a.swp)
  const int row_floats = a.swp * NF;      // a staged row, all its planes
  const int plane_stride = a.swp * FP;
  const int slots = 2 * a.ch;
  const int64_t plane = static_cast<int64_t>(a.H) * a.W;
  const float* const src0 = a.src + f0 * plane + static_cast<int64_t>(row_lo) * a.W + col_lo;

  // Staging: thread t copies frame e = t / kCols, columns c0 + j * kCols, so
  // a warp reads consecutive columns of one frame.
  constexpr int kCols = kThreads / NF;
  const int se = t / kCols, sc0 = t % kCols;
  const bool sok = se < nf;
  float* const sdst = ring + (se / FP) * plane_stride + (se % FP);
  const float* const ssrc = sok ? src0 + se * plane : a.src;
  auto stage = [&](int k) {  // window rows [k*ch, (k+1)*ch) into their slots
    const int s1 = min(nr, (k + 1) * a.ch);
    for (int s = k * a.ch; s < s1; ++s) {
      float* const d = sdst + (s % slots) * row_floats;
      const float* const g = ssrc + (sok ? static_cast<int64_t>(s) * a.W : 0);
      for (int c = sc0; c < sw; c += kCols) jt_cp_async4(d + c * FP, g + (sok ? c : 0), sok);
    }
    jt_cp_async_commit();
  };

  // The thread's rows: window rows relative to the tile, and the weight
  // streams. Row c reads its block's tap rows in order, one float4 (4 taps)
  // a step: float4 j of the block belongs to staged row s and chunk q with
  // j = (s - syr[c]) * nq + q, and exists for 0 <= j < fs * nq (the last
  // chunk of a tap row holds fsp - fs zeros). The stream runs kAhead steps
  // ahead of the FMAs, across staged rows too; outside the block it yields
  // zeros.
  const int nq = a.fsp >> 2;           // chunks of a tap row
  const int nb = a.fs - 4 * (nq - 1);  // taps of its last chunk, 1 to 4
  const int nj = a.fs * nq;            // float4s of a block
  const int cxv = xok ? __ldg(a.cx + x) : 0;
  const int sxo = xok ? my_sx - col_lo : 0;
  int syr[kRows], j[kRows];
  const float4* wq[kRows];
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    const int m = y0 + grp * kRows + c;
    const bool ok = m < a.rows;
    syr[c] = ok ? __ldg(a.sy + m) - row_lo : 1 << 20;  // past every staged row when !ok
    const int cyv = ok ? __ldg(a.cy + m) : 0;
    wq[c] = reinterpret_cast<const float4*>(
        a.blocks + (static_cast<int64_t>(cyv) * a.n_ux + cxv) * a.fs * a.fsp);
    j[c] = -syr[c] * nq;
  }
  auto next = [&](float4 (&w)[kRows]) {
#pragma unroll
    for (int c = 0; c < kRows; ++c) {
      w[c] = static_cast<unsigned>(j[c]) < static_cast<unsigned>(nj)
                 ? __ldg(wq[c] + j[c])
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      ++j[c];
    }
  };

  float acc[kRows][NF];
#pragma unroll
  for (int c = 0; c < kRows; ++c)
#pragma unroll
    for (int e = 0; e < NF; ++e) acc[c][e] = 0.f;
  // The next kAhead chunks' weights, oldest first.
  float4 wbuf[kAhead][kRows];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) next(wbuf[i]);
  auto step = [&](const float4 (&w)[kRows]) {  // drop the oldest, append w
#pragma unroll
    for (int i = 0; i + 1 < kAhead; ++i)
#pragma unroll
      for (int c = 0; c < kRows; ++c) wbuf[i][c] = wbuf[i + 1][c];
#pragma unroll
    for (int c = 0; c < kRows; ++c) wbuf[kAhead - 1][c] = w[c];
  };

  const int nchunks = (nr + a.ch - 1) / a.ch;
  stage(0);
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) {
      stage(k + 1);
      jt_cp_async_wait<1>();
    } else {
      jt_cp_async_wait<0>();
    }
    __syncthreads();
    const int s1 = min(nr, (k + 1) * a.ch);
    for (int s = k * a.ch; s < s1; ++s) {
      bool act[kRows];
      bool any = false;
#pragma unroll
      for (int c = 0; c < kRows; ++c) {
        act[c] = static_cast<unsigned>(s - syr[c]) < static_cast<unsigned>(a.fs);
        any |= act[c];
      }
      if (!any) {  // uniform over the warp: its rows are shared
        for (int q = 0; q < nq; ++q) {
          float4 w[kRows];
          next(w);
          step(w);
        }
        continue;
      }
      // Every row runs the FMAs; an inactive row's weights are zeros and its
      // sums are dropped below, so no branch splits a chunk.
      const float* const srow = ring + (s % slots) * row_floats + sxo * FP;
      float row[kRows][NF];
#pragma unroll
      for (int c = 0; c < kRows; ++c)
#pragma unroll
        for (int e = 0; e < NF; ++e) row[c][e] = 0.f;
      for (int q = 0; q < nq; ++q) {
        float4 wn[kRows];
        next(wn);
        const float* const sq = srow + 4 * q * FP;
        if (q + 1 < nq || nb == 4) {
          taps<4, NF, FP, kRows>(sq, plane_stride, wbuf[0], row);
        } else if (nb == 3) {
          taps<3, NF, FP, kRows>(sq, plane_stride, wbuf[0], row);
        } else if (nb == 2) {
          taps<2, NF, FP, kRows>(sq, plane_stride, wbuf[0], row);
        } else {
          taps<1, NF, FP, kRows>(sq, plane_stride, wbuf[0], row);
        }
        step(wn);
      }
#pragma unroll
      for (int c = 0; c < kRows; ++c)
        if (act[c])
#pragma unroll
          for (int e = 0; e < NF; ++e) acc[c][e] += row[c][e];
    }
    __syncthreads();
  }

  if (!xok) return;
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    const int m = y0 + grp * kRows + c;
    if (m >= a.rows) break;
    float* const o = a.out + f0 * a.out_frame + static_cast<int64_t>(m) * a.out_row + x;
#pragma unroll
    for (int e = 0; e < NF; ++e)
      if (e < nf) o[e * a.out_frame] = acc[c][e];
  }
}

template <int NF>
cudaError_t launch_nf(const GatherArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2) * a.ch * a.swp * NF * sizeof(float);
  cudaError_t err = jt_allow_smem(gather_tile_kernel<NF>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.cols + kTX - 1) / kTX, (a.rows + kTY - 1) / kTY, (a.F + NF - 1) / NF);
  gather_tile_kernel<NF><<<grid, dim3(kTX, kGroups), smem, stream>>>(a);
  return cudaGetLastError();
}

// nf: frames a thread (1, 2, 4 or 8), from kernels/gather.py ring_layout.
inline int gather_launch(const GatherArgs& a, int nf, cudaStream_t stream) {
  if (a.rows <= 0 || a.cols <= 0 || a.F <= 0) return 0;
  if (a.ch < 1 || a.swp % 4 != 0 || a.fsp % 4 != 0 || a.fsp < a.fs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (nf) {
    case 1: return static_cast<int>(launch_nf<1>(a, stream));
    case 2: return static_cast<int>(launch_nf<2>(a, stream));
    case 4: return static_cast<int>(launch_nf<4>(a, stream));
    case 8: return static_cast<int>(launch_nf<8>(a, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
