// Segment-periodic interior of drifted rational scales, in destination layout.
//
// Replaces jincresize_tpu/kernels/pallas_fused_seg.py::_seg_kernel (:318;
// its pallas_call at :684, built by make_seg_interior). For covered row m
// and column x (phase.SegPhasePlan: start = base + q*(k/p) + roff[k], class
// cls[k] per axis):
//
//   out[f, m, x] = sum_{ly, lx < fs} src[f, sy[m] + ly, sx[x] + lx]
//                                    * blocks[cy[m], cx[x], ly, lx]
//
// Per pixel and frame: an fmaf chain along each tap row in lx order, then
// the row sums added in ly order -- kernels/gather.py window_sum_plain sums
// alike, so kernel and plain form agree bit for bit.
//
// What bounds it on an H100: fp32 FMA issue, if the loads that feed the
// FMAs stay rare. Unlike the gather kernel's pixels, a seg tile's pixels
// share few dictionary blocks: a 32 x 32 output tile holds at most 4 row
// classes and 5 column classes at 1440p -> 4K tap 8 and 1440p -> 1080p
// tap 16 (staircase steps are rare), so one class-pair block serves at least
// 50 of its 1024 pixels. The design:
//
// * A block takes a tile of kTX = 32 columns by kSegTY = 32 rows. The host
//   lists each tile's distinct row and column classes (kernels/seg.py
//   tile_classes); the block stages the tile's class-pair blocks in shared
//   memory once (16-byte cp.async, blocks kept bstride floats apart, with
//   bstride = 4 mod 32, so that lanes of up to 8 column classes read 8
//   distinct bank groups), and every weight load is then a shared-memory
//   broadcast: the lanes of a warp share their rows and read one word a
//   column class.
// * A warp takes kSegRows = 4 consecutive rows of the tile, and streams its
//   own source window, [min sy, max sy + fs) of its rows by the tile's
//   [min sx, max sx + fs), through its own ring of kSlots = 3 staged rows in
//   shared memory (4-byte cp.async, frames side by side, two rows in
//   flight), synchronised by __syncwarp alone. With a ring shared by the
//   block, every barrier held the warps back for the ones the staged rows
//   fed: the row windows of a tall tile are staggered, so most staged rows
//   feed only some of its warps.
// * A thread owns one column and the warp's 4 rows, for NF frames (NF in
//   {1, 2, 4, 8}, chosen by the wrapper from F). For each staged source row
//   it loads its NF source values once a tap and serves all 4 rows (row m
//   takes tap row ly = r - sy[m] while sy[m] <= r < sy[m] + fs, so ly
//   ascends, the plain form's order), against one 16-byte weight load a
//   row and 4 taps: at NF = 8, 8 source and 4 weight loads for 128 FMAs. A
//   row outside its window runs the FMAs on its block's first tap row and
//   drops the sums.
// * Results go straight from registers to the output, the lanes' stores
//   coalesced along the row.
//
// What still bounds it is shared-memory bandwidth: per tap and warp, 2
// 16-byte source loads (8 wavefronts: a 128-bit load serves a quarter warp
// a wavefront) and a share of the weight loads against 32 FMAs (8 cycles of
// the SM's FMA pipes). Tried on an H100 80GB HBM3 at 1440p -> 4K tap 8 and
// kept: two blocks an SM at 128 registers (one block at 153 registers was
// clearly slower), the per-warp rings (level with one ring a block at 8
// frames, faster at 1 to 4), the staging order below (clearly faster than
// one column a lane). Dropped as level or slower: blocks of 2 or 4 warps,
// and 4 frames a thread at three blocks an SM (much slower at fs 44).
//
// The host guarantees 0 <= sy, sy + fs <= H and 0 <= sx, sx + fs <= W
// (kernels/gather.py check_window_starts), so no read leaves the plane.
// Shared memory holds the largest tile's pair blocks beside the warps'
// rings: kernels/seg.py smem_bytes mirrors it, and is_supported declines a
// plan whose pair blocks and one-frame rings do not fit 227 KB.
//
// TPU workarounds of the Pallas kernel that this one drops: the MXU
// variant's per-column-tile groups and their 0/1 select tensor
// (_tile_groups) -- the per-tile class lists here only choose what to
// stage; _dedup_bands, _chunk_layout and the expanded weight slabs of
// _expand_w -- a thread reads its pixel's block of the compact dictionary;
// wsplit3/wsplit3_vmem -- fp32 FMA is exact; residue planes and the split3
// interleave -- threads read strided columns and store in destination
// layout; the WMAX weight gates, the 12 MB VMEM budget, the
// JINCRESIZE_SEG_* overrides and the fs**2 <= 1200 envelope (the Mosaic
// VMEM budget) -- fs is a run-time value and shared memory is the envelope.
//
// precision='bf16' (the Pallas kernel's one-pass DEFAULT dot, :397) is the
// compile-time BF16 flag (4 more instances, frames a thread in {1, 2, 4,
// 8}): the host rounds the pair blocks to bfloat16 once (kernels/seg.py
// make_seg_interior), and each staged source value is rounded as a thread
// reads it (jt_operand). Products of two bfloat16 values are exact in fp32,
// so the sums, their order and the staged layout are the fp32 mode's, and
// the kernel equals its plain form on rounded operands bit for bit.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTX = 32;                        // columns of a tile, one a lane
constexpr int kSegRows = 4;                    // rows of a thread
constexpr int kSegGroups = 8;                  // row groups (warps) of a block
constexpr int kSegTY = kSegRows * kSegGroups;  // rows of a tile (kernels/seg.py TILE_Y)
constexpr int kSegThreads = kTX * kSegGroups;
constexpr int kSlots = 3;  // staged source rows of a warp's ring: one read, two in flight

struct SegArgs {
  const float* src;     // (F, H, W)
  const float* blocks;  // (n_uy, n_ux, fs, fsp), tap rows padded to fsp floats
  const int* sy;        // (hout,) window starts
  const int* sx;        // (wout,)
  const int* lcy;       // (hout,) row class, as an index into its tile's list
  const int* lcx;       // (wout,)
  const int* tcy;       // (row tiles, ky) each tile's row classes
  const int* tcx;       // (column tiles, kx)
  const int* ncy;       // (row tiles,) row classes of each tile
  const int* ncx;       // (column tiles,)
  float* out;           // (F, hout, wout)
  int F, H, W, hout, wout, n_ux, fs, fsp;
  int bstride;  // floats between staged pair blocks (>= fs * fsp, = 4 mod 32)
  int ky, kx;   // row length of tcy / tcx
  int pairs;    // pair blocks room: max over tiles of ncy * ncx
  int swp;      // columns of a staged row (the widest tile window, padded to 4)
};

// NB taps (the first NB of a chunk of 4) of NF frames into each row's sums:
// the source values of a tap once (under BF16 rounded to bfloat16 as they
// are read), one weight a tap and row.
template <int NB, int NF, int FP, bool BF16>
__device__ __forceinline__ void seg_taps(const float* s, int plane_stride,
                                         const float4 (&w)[kSegRows],
                                         float (&row)[kSegRows][NF]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float v[NF];
    jt_load_frames<NF>(s + b * FP, plane_stride, v);
#pragma unroll
    for (int e = 0; e < NF; ++e) v[e] = jt_operand<BF16>(v[e]);
#pragma unroll
    for (int c = 0; c < kSegRows; ++c) {
      const float wv = b == 0 ? w[c].x : b == 1 ? w[c].y : b == 2 ? w[c].z : w[c].w;
#pragma unroll
      for (int e = 0; e < NF; ++e) row[c][e] = fmaf(v[e], wv, row[c][e]);
    }
  }
}

template <int NF, bool BF16>
__global__ void __launch_bounds__(kSegThreads, 2) seg_tile_kernel(const SegArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int FP = NF < 4 ? NF : 4;  // frames of a staged plane
  const int lane = threadIdx.x, grp = threadIdx.y;
  const int t = grp * kTX + lane;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int x0 = tx * kTX, y0 = ty * kSegTY + grp * kSegRows;  // y0: the warp's first row
  const int f0 = blockIdx.z * NF;
  const int nf = min(NF, a.F - f0);
  const int row_floats = a.swp * NF;  // a staged row, all its planes
  const int plane_stride = a.swp * FP;
  float* const wsm = smem;
  float* const ring = smem + a.pairs * a.bstride + grp * kSlots * row_floats;  // the warp's

  // The tile's class-pair blocks, pair p = (row class p / ncx, column class
  // p % ncx), the first cp.async group.
  const int ncx = __ldg(a.ncx + tx), ncy = __ldg(a.ncy + ty);
  const int nblk = a.fs * a.fsp;
  const int n4 = nblk >> 2;
  for (int i = t; i < ncy * ncx * n4; i += kSegThreads) {
    const int p = i / n4, v = i - p * n4;
    const int cy = __ldg(a.tcy + ty * a.ky + p / ncx);
    const int cx = __ldg(a.tcx + tx * a.kx + p % ncx);
    jt_cp_async16(wsm + p * a.bstride + 4 * v,
                  a.blocks + (static_cast<int64_t>(cy) * a.n_ux + cx) * nblk + 4 * v);
  }
  jt_cp_async_commit();

  // The window: the tile's columns, the warp's rows.
  const int x = x0 + lane;
  const bool xok = x < a.wout;
  const int my_sx = xok ? __ldg(a.sx + x) : INT_MAX;
  const int col_lo = __reduce_min_sync(0xffffffffu, my_sx);
  const int col_hi = __reduce_max_sync(0xffffffffu, xok ? my_sx : INT_MIN);
  const bool yok = lane < kSegRows && y0 + lane < a.hout;
  const int lane_sy = yok ? __ldg(a.sy + y0 + lane) : INT_MAX;
  const int row_lo = __reduce_min_sync(0xffffffffu, lane_sy);
  const int row_hi = __reduce_max_sync(0xffffffffu, yok ? lane_sy : INT_MIN);
  const int nr = y0 < a.hout ? row_hi - row_lo + a.fs : 0;  // window rows (none past the plane)
  const int sw = col_hi - col_lo + a.fs;                     // window columns (<= a.swp)
  const int64_t plane = static_cast<int64_t>(a.H) * a.W;
  const float* const src0 =
      a.src + f0 * plane + static_cast<int64_t>(nr ? row_lo : 0) * a.W + col_lo;

  // Window row r into slot r % kSlots, plane by plane: consecutive lanes
  // write consecutive words (column i / FP of frame i % FP), so the stores
  // hit distinct banks (one column a lane, frame by frame, cost 4-way bank
  // conflicts at FP = 4). One group a call, empty past the window, so that
  // waiting for all but the newest group waits for row r - 1.
  auto stage = [&](int r) {
    if (r < nr) {
      float* const d = ring + (r % kSlots) * row_floats;
      const float* const g = src0 + static_cast<int64_t>(r) * a.W;
#pragma unroll
      for (int p = 0; p < NF / FP; ++p)
        for (int i = lane; i < sw * FP; i += kTX) {
          const int e = p * FP + i % FP;
          if (e < nf) jt_cp_async4(d + p * plane_stride + i, g + e * plane + i / FP, true);
        }
    }
    jt_cp_async_commit();
  };

  // The thread's rows, window-relative, and each row's pair block.
  const int lcx = xok ? __ldg(a.lcx + x) : 0;
  const int sxo = xok ? my_sx - col_lo : 0;
  int syr[kSegRows], woff[kSegRows];
#pragma unroll
  for (int c = 0; c < kSegRows; ++c) {
    const int m = y0 + c;
    const bool ok = m < a.hout;
    syr[c] = ok ? __ldg(a.sy + m) - row_lo : 1 << 20;  // past every staged row when !ok
    woff[c] = ((ok ? __ldg(a.lcy + m) : 0) * ncx + lcx) * a.bstride;
  }

  float acc[kSegRows][NF];
#pragma unroll
  for (int c = 0; c < kSegRows; ++c)
#pragma unroll
    for (int e = 0; e < NF; ++e) acc[c][e] = 0.f;

  const int nq = a.fsp >> 2;           // chunks of 4 taps of a tap row
  const int nb = a.fs - 4 * (nq - 1);  // taps of its last chunk, 1 to 4
  stage(0);
  stage(1);
  jt_cp_async_wait<1>();  // the pair blocks and row 0
  __syncthreads();        // the only block-wide barrier: warps run apart from here
  for (int s = 0; s < nr; ++s) {
    if (s) {
      jt_cp_async_wait<1>();  // row s
      __syncwarp();           // ... copied by every lane; slot (s - 1) % kSlots read by all
    }
    stage(s + 2);  // into slot (s + 2) % kSlots == (s - 1) % kSlots
    bool act[kSegRows];
#pragma unroll
    for (int c = 0; c < kSegRows; ++c)
      act[c] = static_cast<unsigned>(s - syr[c]) < static_cast<unsigned>(a.fs);
    const float* const srow = ring + (s % kSlots) * row_floats + sxo * FP;
    const float* wr[kSegRows];
#pragma unroll
    for (int c = 0; c < kSegRows; ++c) wr[c] = wsm + woff[c] + (act[c] ? s - syr[c] : 0) * a.fsp;
    float row[kSegRows][NF];
#pragma unroll
    for (int c = 0; c < kSegRows; ++c)
#pragma unroll
      for (int e = 0; e < NF; ++e) row[c][e] = 0.f;
    for (int q = 0; q < nq; ++q) {
      float4 w[kSegRows];
#pragma unroll
      for (int c = 0; c < kSegRows; ++c) w[c] = *reinterpret_cast<const float4*>(wr[c] + 4 * q);
      const float* const sq = srow + 4 * q * FP;
      if (q + 1 < nq || nb == 4) {
        seg_taps<4, NF, FP, BF16>(sq, plane_stride, w, row);
      } else if (nb == 3) {
        seg_taps<3, NF, FP, BF16>(sq, plane_stride, w, row);
      } else if (nb == 2) {
        seg_taps<2, NF, FP, BF16>(sq, plane_stride, w, row);
      } else {
        seg_taps<1, NF, FP, BF16>(sq, plane_stride, w, row);
      }
    }
#pragma unroll
    for (int c = 0; c < kSegRows; ++c)
      if (act[c])
#pragma unroll
        for (int e = 0; e < NF; ++e) acc[c][e] += row[c][e];
  }

  if (!xok) return;
  const int64_t oplane = static_cast<int64_t>(a.hout) * a.wout;
#pragma unroll
  for (int c = 0; c < kSegRows; ++c) {
    const int m = y0 + c;
    if (m >= a.hout) break;
    float* const o = a.out + f0 * oplane + static_cast<int64_t>(m) * a.wout + x;
#pragma unroll
    for (int e = 0; e < NF; ++e)
      if (e < nf) o[e * oplane] = acc[c][e];
  }
}

template <int NF, bool BF16>
cudaError_t seg_launch(const SegArgs& a, cudaStream_t stream) {
  const size_t ring = static_cast<size_t>(kSegGroups) * kSlots * a.swp * NF;
  const size_t smem = (static_cast<size_t>(a.pairs) * a.bstride + ring) * sizeof(float);
  cudaError_t err = jt_allow_smem(seg_tile_kernel<NF, BF16>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.wout + kTX - 1) / kTX, (a.hout + kSegTY - 1) / kSegTY, (a.F + NF - 1) / NF);
  seg_tile_kernel<NF, BF16><<<grid, dim3(kTX, kSegGroups), smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t seg_launch_nf(const SegArgs& a, int nf, cudaStream_t stream) {
  switch (nf) {
    case 1: return seg_launch<1, BF16>(a, stream);
    case 2: return seg_launch<2, BF16>(a, stream);
    case 4: return seg_launch<4, BF16>(a, stream);
    case 8: return seg_launch<8, BF16>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src (F, H, W) f32; blocks (n_uy, n_ux, fs, fsp) f32; sy, lcy (hout) and
// sx, lcx (wout) int32; tcy (ceil(hout / 32), ky), ncy (ceil(hout / 32)),
// tcx (ceil(wout / 32), kx), ncx (ceil(wout / 32)) int32; out (F, hout,
// wout) f32. All contiguous. bstride, pairs, nf, swp: the shared-memory
// layout (kernels/seg.py smem_bytes). bf16: round each source value to
// bfloat16 as it is read (precision='bf16'; the blocks come rounded from
// the host).
extern "C" int jt_seg_interior(const float* src, const float* blocks, const int* sy,
                               const int* sx, const int* lcy, const int* lcx, const int* tcy,
                               const int* tcx, const int* ncy, const int* ncx, float* out, int F,
                               int H, int W, int hout, int wout, int n_ux, int fs, int fsp,
                               int bstride, int ky, int kx, int pairs, int nf, int swp, int bf16,
                               cudaStream_t stream) {
  if (hout <= 0 || wout <= 0 || F <= 0) return 0;
  if (swp % 4 != 0 || fsp % 4 != 0 || fsp < fs || bstride % 4 != 0 ||
      bstride < fs * fsp || pairs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const SegArgs a{src, blocks, sy, sx, lcy, lcx, tcy, tcx, ncy, ncx, out, F, H,
                  W, hout, wout, n_ux, fs, fsp, bstride, ky, kx, pairs, swp};
  return static_cast<int>(bf16 ? seg_launch_nf<true>(a, nf, stream)
                               : seg_launch_nf<false>(a, nf, stream));
}
