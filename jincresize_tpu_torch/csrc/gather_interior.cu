// Interior of any geometry: per-pixel window starts and dictionary classes.
//
// Replaces jincresize_tpu/kernels/pallas_gather.py::_gather_kernel (:137;
// its pallas_call at :455, built by make_gather_interior). For interior row
// m and column x:
//
//   out[f, m, x] = sum_{ly, lx < fs} src[f, sy[m] + ly, sx[x] + lx]
//                                    * blocks[cy[m], cx[x], ly, lx]
//
// Two kernels, chosen by the host (kernels/gather.py takes_grouped): the
// class-grouped kernel below where some row class holds two rows or more
// and its K rows a weight load are at least twice the launch's frames
// (2 F <= K), else the tile body of gather_tile.cuh (jt_gather_interior),
// which the band kernel (gather_band.cu) shares.
//
// The class-grouped kernel (jt_gather_interior_grouped, gather_class_kernel).
// What bounds the tile body at one frame a launch is its weight stream: each
// pixel reads its own (fs, fsp) block, 33,856 bytes at fs 92, and uses it for
// the launch's frames only -- 48.8 GB a frame at 3840x2160 -> 1366x768 tap 16,
// 23.8 ms on an H100. But a block depends only on (row class, column class),
// and a row class recurs every few rows (every 16 there: 46 luma rows a
// class, 22 chroma rows). So:
//
// * The host cuts the interior rows, in class order, into groups of at most
//   K rows of one class (kernels/gather.py row_groups; K in {4, 8, 16} from
//   the rows a class has, group_size). A block takes one group and kGCols =
//   64 columns; a thread owns one column and the group's K rows, for NF
//   frames (K * NF <= 32). A slot past a group's last rows repeats its first
//   row and stores nothing, so no branch splits the row loop.
// * The tap row ly is the outer loop. For each ly the block stages, with
//   4-byte cp.async copies (frames side by side as in the tile body), the
//   source rows sy[m_k] + ly of its K rows over the block's column window,
//   one stage: the other blocks on the SM hide its latency.
// * A thread then walks its weight row blocks[c, cx[x], ly, :] in 16-byte
//   loads, two chunks ahead of the FMAs: one load feeds 4 taps x K rows x NF
//   frames, so the weight stream is about K times shorter (4.3 GB a frame at
//   that geometry).
// * The grid runs groups in class order (blockIdx.y), the columns of a group
//   fastest (blockIdx.x), so a class's blocks of weights (8.7 MB at fs 92 and
//   256 column classes) serve its groups from L2.
// * Per pixel and frame the sum is the tile body's: an fmaf chain along each
//   tap row in lx order from 0, the row sums added in ly order. Both kernels
//   and window_sum_plain therefore agree bit for bit.
//
// What bounds it now is the SM's load/store pipe: each staged source value
// serves one FMA a frame (rows of one class share no source row at a given
// ly), read as 4-byte words that the 32 lanes of a warp take from about 88
// consecutive words -- two-way bank conflicts at that downscale -- and each
// 16-byte weight load of a warp touches 32 lines, one block each. On an H100
// 80GB HBM3 (700 W) at one frame: 2.98 ms on that luma plane (K 16), 1.08 on
// each chroma plane (K 8), against 16.19 and 3.77 for the tile body.
// Tried there and dropped: 128-column blocks (luma at K 8: 5.43 ms, against
// 4.20 at 64 and 3.86 at 32 columns), a double-buffered ring (level or
// slower once blocks are this small), a branch that skips a group's idle
// slots (luma at K 16: 5.96 ms against 4.82 without). Measured only: with
// every lane's weights broadcast the luma plane at K 8 saves 1.4 ms, with
// conflict-free source reads 1.0 ms.
//
// TPU workarounds dropped: the x-expanded class planes Wx[n_uy, fs2p,
// nxi_pad] (1.16 GB at 256x256 classes) -- a thread reads its pixel's
// block of the compact dictionary; the XLA horizontal im2col P[f, h, lx, x]
// -- the source window is staged in shared memory; _choose_tiles against
// the 12 MB VMEM budget, the band origins syloc/y0 and the padding of rows
// and columns to the tile grid -- a block covers a tile (or a group's rows)
// and masks the ragged edge; the JINCRESIZE_GATHER_TN/TM overrides; and the
// fs**2 <= 1200 envelope (the VMEM tile budget of a deep-tap window) -- the
// window streams through a ring of source rows, so fs is a run-time value.
#include "gather_tile.cuh"

namespace {

constexpr int kGWarps = 2;               // column warps of a grouped block
constexpr int kGCols = kTX * kGWarps;    // columns of a grouped block
constexpr int kMaxGroupRows = 16;        // the largest K

struct GroupArgs {
  const float* src;     // (F, H, W)
  const float* blocks;  // (n_uy, n_ux, fs, fsp)
  const int* groups;    // (n_groups, K) interior rows of one class, -1 after the last
  const int* sy;        // (rows,) window starts
  const int* cy;        // (rows,) row classes
  const int* sx;        // (cols,) window starts
  const int* cx;        // (cols,) column classes
  float* out;           // (F, rows, cols)
  int F, H, W, rows, cols, n_ux, fs, fsp;
  int swp;  // columns of a staged row, padded to 4
};

// NB taps (the first NB of a chunk) of NF frames into the sums of K rows:
// the rows' staged source rows are row_floats apart, one weight a tap
// serves every row.
template <int NB, int NF, int FP, int K>
__device__ __forceinline__ void class_taps(const float* s, int row_floats, int plane_stride,
                                           const float4& w, float (&row)[K][NF]) {
  const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v[NB][NF];
#pragma unroll
    for (int b = 0; b < NB; ++b) jt_load_frames<NF>(s + k * row_floats + b * FP, plane_stride, v[b]);
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < NF; ++e) row[k][e] = fmaf(v[b][e], wv[b], row[k][e]);
  }
}

template <int K, int NF>
__global__ void __launch_bounds__(kGCols) gather_class_kernel(const GroupArgs a) {
  extern __shared__ __align__(16) float ring[];
  __shared__ int grp_m[K], grp_sy[K], win[2];
  constexpr int FP = NF < 4 ? NF : 4;  // frames of a staged plane
  const int t = threadIdx.x, lane = t & 31;
  const int x0 = blockIdx.x * kGCols;
  const int f0 = blockIdx.z * NF;
  const int nf = min(NF, a.F - f0);

  // The group's rows (packed first, -1 after) and the block's column
  // window. A slot past the group's last row stages and sums its first row,
  // so that every thread runs K rows without a branch; it stores nothing.
  int my_m = -1;
  if (t < K) {
    const int* const grp = a.groups + static_cast<int64_t>(blockIdx.y) * K;
    my_m = __ldg(grp + t);
    grp_m[t] = my_m;
    grp_sy[t] = __ldg(a.sy + (my_m >= 0 ? my_m : __ldg(grp)));
  }
  if (t == 0) {
    win[0] = INT_MAX;
    win[1] = INT_MIN;
  }
  const int x = x0 + t;
  const bool xok = x < a.cols;
  const int my_sx = xok ? __ldg(a.sx + x) : 0;
  const int kn = __syncthreads_count(t < K && my_m >= 0);
  const int wlo = __reduce_min_sync(0xffffffffu, xok ? my_sx : INT_MAX);
  const int whi = __reduce_max_sync(0xffffffffu, xok ? my_sx : INT_MIN);
  if (lane == 0 && wlo <= whi) {
    atomicMin(&win[0], wlo);
    atomicMax(&win[1], whi);
  }
  __syncthreads();
  const int col_lo = win[0];
  const int sw = win[1] - col_lo + a.fs;  // window columns (<= a.swp)
  const int row_floats = a.swp * NF;      // a staged row, all its planes
  const int plane_stride = a.swp * FP;
  const int64_t plane = static_cast<int64_t>(a.H) * a.W;

  // Staging: thread t copies frame e = t / kCols, columns c0 + j * kCols of
  // each row, so a warp reads consecutive columns of one frame.
  constexpr int kCols = kGCols / NF;
  const int se = t / kCols, sc0 = t % kCols;
  const bool sok = se < nf;
  float* const sdst = ring + (se / FP) * plane_stride + (se % FP);
  const float* const ssrc = sok ? a.src + (f0 + se) * plane + col_lo : a.src;
  auto stage = [&](int ly) {  // tap row ly of every row
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      float* const d = sdst + k * row_floats;
      const float* const g = ssrc + (sok ? static_cast<int64_t>(grp_sy[k] + ly) * a.W : 0);
      for (int c = sc0; c < sw; c += kCols) jt_cp_async4(d + c * FP, g + (sok ? c : 0), sok);
    }
    jt_cp_async_commit();
  };

  // The thread's weights: blocks[c, cx[x]] in order, one float4 (4 taps) a
  // step: float4 j is chunk j % nq of tap row j / nq; past the block, zeros.
  const int nq = a.fsp >> 2;           // chunks of a tap row
  const int nb = a.fs - 4 * (nq - 1);  // taps of its last chunk, 1 to 4
  const int nj = a.fs * nq;            // float4s of a block
  const int cyv = __ldg(a.cy + grp_m[0]);
  const float4* const wq = reinterpret_cast<const float4*>(
      a.blocks + (static_cast<int64_t>(cyv) * a.n_ux + (xok ? __ldg(a.cx + x) : 0)) * a.fs * a.fsp);
  int j = 0;
  auto next = [&]() {
    const float4 w = j < nj ? __ldg(wq + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    ++j;
    return w;
  };
  // Warps whose columns all lie past the edge stage but compute nothing.
  const bool busy = __any_sync(0xffffffffu, xok);
  const int sxo = xok ? my_sx - col_lo : 0;

  float acc[K][NF];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < NF; ++e) acc[k][e] = 0.f;
  float4 w0 = make_float4(0.f, 0.f, 0.f, 0.f), w1 = w0;  // the next kAhead = 2 chunks
  if (busy) {
    w0 = next();
    w1 = next();
  }

  for (int ly = 0; ly < a.fs; ++ly) {
    stage(ly);
    jt_cp_async_wait<0>();
    __syncthreads();
    if (busy) {
      const float* const srow = ring + sxo * FP;
      float row[K][NF];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < NF; ++e) row[k][e] = 0.f;
      for (int q = 0; q < nq; ++q) {
        const float4 wn = next();
        const float* const sq = srow + 4 * q * FP;
        if (q + 1 < nq || nb == 4) {
          class_taps<4, NF, FP, K>(sq, row_floats, plane_stride, w0, row);
        } else if (nb == 3) {
          class_taps<3, NF, FP, K>(sq, row_floats, plane_stride, w0, row);
        } else if (nb == 2) {
          class_taps<2, NF, FP, K>(sq, row_floats, plane_stride, w0, row);
        } else {
          class_taps<1, NF, FP, K>(sq, row_floats, plane_stride, w0, row);
        }
        w0 = w1;
        w1 = wn;
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < NF; ++e) acc[k][e] += row[k][e];
    }
    __syncthreads();
  }

  if (!xok) return;
  const int64_t out_frame = static_cast<int64_t>(a.rows) * a.cols;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k >= kn) break;
    float* const o = a.out + f0 * out_frame + static_cast<int64_t>(grp_m[k]) * a.cols + x;
#pragma unroll
    for (int e = 0; e < NF; ++e)
      if (e < nf) o[e * out_frame] = acc[k][e];
  }
}

template <int K, int NF>
cudaError_t launch_class(const GroupArgs& a, int n_groups, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * a.swp * NF * sizeof(float);
  cudaError_t err = jt_allow_smem(gather_class_kernel<K, NF>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.cols + kGCols - 1) / kGCols, n_groups, (a.F + NF - 1) / NF);
  gather_class_kernel<K, NF><<<grid, kGCols, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// src (F, H, W) f32; blocks (n_uy, n_ux, fs, fsp) f32; sy, cy (nyi) int32;
// sx, cx (nxi) int32; out (F, nyi, nxi) f32. All contiguous. nf, swp, ch:
// frames a thread and the ring (kernels/gather.py ring_layout).
extern "C" int jt_gather_interior(const float* src, const float* blocks, const int* sy,
                                  const int* cy, const int* sx, const int* cx, float* out, int F,
                                  int H, int W, int nyi, int nxi, int n_ux, int fs, int fsp,
                                  int nf, int swp, int ch, cudaStream_t stream) {
  const GatherArgs a{src, blocks, sy, cy, sx, cx, out, static_cast<int64_t>(nyi) * nxi, nxi,
                     F, H, W, nyi, nxi, n_ux, fs, fsp, swp, ch};
  return gather_launch(a, nf, stream);
}

// The class-grouped kernel. groups (n_groups, k) int32: interior rows of one
// row class each, packed first, -1 after (kernels/gather.py row_groups). k,
// nf, swp: rows a group, frames a thread and the ring's row width
// (kernels/gather.py group_ring); the other arguments as above.
extern "C" int jt_gather_interior_grouped(const float* src, const float* blocks,
                                          const int* groups, const int* sy, const int* cy,
                                          const int* sx, const int* cx, float* out, int F,
                                          int H, int W, int nyi, int nxi, int n_groups, int n_ux,
                                          int fs, int fsp, int k, int nf, int swp,
                                          cudaStream_t stream) {
  if (nyi <= 0 || nxi <= 0 || F <= 0 || n_groups <= 0) return 0;
  if (swp % 4 != 0 || fsp % 4 != 0 || fsp < fs || k > kMaxGroupRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const GroupArgs a{src, blocks, groups, sy, cy, sx, cx, out, F, H, W, nyi, nxi, n_ux, fs, fsp,
                    swp};
  switch (k * 16 + nf) {
    case 4 * 16 + 1: return static_cast<int>(launch_class<4, 1>(a, n_groups, stream));
    case 4 * 16 + 2: return static_cast<int>(launch_class<4, 2>(a, n_groups, stream));
    case 4 * 16 + 4: return static_cast<int>(launch_class<4, 4>(a, n_groups, stream));
    case 4 * 16 + 8: return static_cast<int>(launch_class<4, 8>(a, n_groups, stream));
    case 8 * 16 + 1: return static_cast<int>(launch_class<8, 1>(a, n_groups, stream));
    case 8 * 16 + 2: return static_cast<int>(launch_class<8, 2>(a, n_groups, stream));
    case 8 * 16 + 4: return static_cast<int>(launch_class<8, 4>(a, n_groups, stream));
    case 16 * 16 + 1: return static_cast<int>(launch_class<16, 1>(a, n_groups, stream));
    case 16 * 16 + 2: return static_cast<int>(launch_class<16, 2>(a, n_groups, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
