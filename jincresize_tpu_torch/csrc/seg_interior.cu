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
// the stacked wsplit3 (three copies of the slabs; wsplit3_vmem, its
// in-kernel twin, is ported: below); residue planes and the split3
// interleave -- threads read strided columns and store in destination
// layout; the WMAX weight gates, the 12 MB VMEM budget, the
// JINCRESIZE_SEG_* overrides and the fs**2 <= 1200 envelope (the Mosaic
// VMEM budget) -- fs is a run-time value and shared memory is the envelope.
//
// precision='bf16' replaces the Pallas kernel's one-pass DEFAULT dot
// (pallas_fused_seg.py:397: both operands rounded to bfloat16, exact
// products, fp32 sums) with a second kernel, seg_tc_kernel below, on the
// tensor cores (mma.sync m16n8k16 / m16n8k8, bf16 in, fp32 sums;
// common.cuh). The host rounds the pair blocks to bfloat16 once
// (kernels/seg.py make_seg_interior: tc_blocks, tap rows padded with zeros
// to fsk k-slots). Per class cx of a tile, the sum is a product
//
//   out[f, m, x] += sum_lx A[(x, f), lx] * B[lx, m] for each staged row r,
//   A[(x, f), lx] = src[f, r, sx[x] + lx],
//   B[lx, m] = blocks[cy[m], cx, r - sy[m], lx] (zero unless 0 <= r - sy[m] < fs):
//
// * M (16): slots (column x, frame f) of one column class of the tile:
//   the host lists each tile's columns grouped by class (kernels/seg.py
//   tile_columns: pcx, and scx where each class's run starts); a class of
//   n columns over nf frames takes ceil(n * nf / 16) m-tiles, slot i being
//   column i % n of frame i / n. Frames fill M: at 1440p -> 4K a 32-column
//   tile holds 3.9 classes of ~8 columns, so M is 52% useful at one frame
//   and 94% at eight.
// * N (8): 8 consecutive output rows m; each lane's B column is its own
//   row's block, so rows of any class and any start share an mma.
// * K: the taps lx of one staged source row, in k16 chunks and a k8 tail
//   (fsk slots: fs 44 -> 48, 92% useful). Where one tap is left over (fs =
//   16n + 1: fs 17 at 1440p -> 4K), one k8 mma takes that tap of 8 staged
//   rows (k = row), so fs 17 costs 16 + 1/8 slots a row, not 24 (clearly
//   faster on an H100 than a k8 mma a row). Along rows an
//   n-tile runs from its first row's start to its last row's end: fs of
//   fs + 5 staged rows are useful at 1440p -> 4K (77%), fs of fs + 10 at
//   1440p -> 1080p tap 16 (81%). All told ~40% of the mma slots are useful
//   at one frame and ~70% at eight.
// * A block of 16 warps takes the fp32 kernel's 32 x 32 tile and NF frames.
//   It stages the tile's pair blocks (16-byte cp.async: bf16 needs no
//   conversion), its tables (each class-grouped column's start, each row's
//   start and class, each m-tile's class) and its whole source window for
//   all NF frames once, in bf16: threads load f32 values from global memory
//   (four words' values before they store any), round them and store two
//   copies, word m of copy 0 holding columns (2m, 2m + 1) and of copy 1
//   (2m + 1, 2m + 2), so that every A fragment word is one aligned 4-byte
//   load whatever the parity of sx[x] (a cp.async cannot convert, and a
//   copy in f32 beside the bf16 one would take the room the frames need).
//   One barrier; then each warp takes items (m-tile, n-tile) in turn with
//   no further barrier: per staged row of its n-tile and k16 chunk, 4 A
//   words, one 8-byte B load and one mma, two accumulator sets (even and
//   odd chunks, the packed tail in the odd one) to keep two mmas in flight;
//   the sums go from the fragments straight to the output.
//
// What bounds it on an H100: the bf16 bound is bytes (0.0142 ms a frame at
// 1440p -> 4K, 4.8 G useful MACs a frame at 989 TFLOP/s take a third of
// it); the design is bounded by shared-memory bandwidth, about 6 wavefronts
// (4 A, 2 B) of 128 bytes per mma, and by the mma issue rate of mma.sync.
// Not wgmma: it reads A from shared memory only through a descriptor of
// 8 x 16-byte core matrices, and a Hankel window, whose rows are one
// element apart, cannot be described so; A from registers, 64-row
// warpgroup tiles and TMA are later work. The sums run in the tensor
// core's order, so the kernel is held to its plain form (which rounds the
// source first and sums in fp32 FMA order) within kernels/fused.py
// tc_sum_bound, not bit for bit. The window takes win_h rows of 2 * cw
// words a frame: kernels/seg.py tc_smem_bytes mirrors the layout, and
// frames_of picks the most frames whose windows fit beside the pairs.
//
// precision='wsplit3' replaces the Pallas kernel's wsplit3_vmem mode
// (pallas_fused_seg.py:371-389), the mode u8 planes take: seg_tc_kernel
// with SPLIT. As there, the weights stay resident in one copy and are
// split at every use: the tile's pair blocks are staged in f32 as the fp32
// mode keeps them (kernels/gather.py padded_blocks: tap rows of fsp =
// fs rounded up to 4 floats; a lane's taps past fsp read as zeros, tested
// only in the k16 chunk or the k8 tail that reaches past fsp), and
// each lane's B taps, one 16-byte load a k16 chunk, are split in registers
// into three bfloat16 parts, w == hi + mid + lo (common.cuh
// jt_split3_pack: three two-value conversions and four subtractions a
// pair of values), which feed three mmas against the same A fragment. A
// warp's item is two m-tiles of one class (MP = 2), so each split B
// fragment feeds six mmas where the class has two. Products of u8 values
// and bfloat16 parts are exact in fp32, so the kernel is held to the fp32
// plain form within kernels/fused.py wsplit3_bound.
//
// What bounds it: at 1440p -> 1080p tap 16 (fs 44) the tile's 20 class-pair
// blocks take most of the 227 KB, and the frames a block fills M: a class
// of ~8 columns fills half an m-tile at one frame, all of it at two. Rows
// of fsp floats (not the k-slots' fsk: 48 at fs 44) leave room for a
// second frame's window (kernels/seg.py tc_words, frames_of), which halves
// the mmas, the splits and the block starts a frame there. The split and
// the B load set the pace where a B fragment feeds three mmas (most fs-44
// classes: one m-tile at two frames). Tried on an H100 and dropped as
// slower at 1440p -> 4K: the blocks split once as they are staged (three
// bf16 parts resident, 1.5 times the f32 room: no split at the loads, but
// three 8-byte B loads a chunk), and up to four m-tiles an item. A plan
// whose blocks and one frame's window do not fit is built in the fp32 mode
// on the host (kernels/seg.py kernel_precision).
#include <climits>
#include <type_traits>

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
// the source values of a tap once, one weight a tap and row.
template <int NB, int NF, int FP>
__device__ __forceinline__ void seg_taps(const float* s, int plane_stride,
                                         const float4 (&w)[kSegRows],
                                         float (&row)[kSegRows][NF]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float v[NF];
    jt_load_frames<NF>(s + b * FP, plane_stride, v);
#pragma unroll
    for (int c = 0; c < kSegRows; ++c) {
      const float wv = b == 0 ? w[c].x : b == 1 ? w[c].y : b == 2 ? w[c].z : w[c].w;
#pragma unroll
      for (int e = 0; e < NF; ++e) row[c][e] = fmaf(v[e], wv, row[c][e]);
    }
  }
}

template <int NF>
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
        seg_taps<4, NF, FP>(sq, plane_stride, w, row);
      } else if (nb == 3) {
        seg_taps<3, NF, FP>(sq, plane_stride, w, row);
      } else if (nb == 2) {
        seg_taps<2, NF, FP>(sq, plane_stride, w, row);
      } else {
        seg_taps<1, NF, FP>(sq, plane_stride, w, row);
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

template <int NF>
cudaError_t seg_launch(const SegArgs& a, cudaStream_t stream) {
  const size_t ring = static_cast<size_t>(kSegGroups) * kSlots * a.swp * NF;
  const size_t smem = (static_cast<size_t>(a.pairs) * a.bstride + ring) * sizeof(float);
  cudaError_t err = jt_allow_smem(seg_tile_kernel<NF>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.wout + kTX - 1) / kTX, (a.hout + kSegTY - 1) / kSegTY, (a.F + NF - 1) / NF);
  seg_tile_kernel<NF><<<grid, dim3(kTX, kSegGroups), smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- precision='bf16': the tensor-core kernel (header note).

constexpr int kTcWarps = 16;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcLoads = 4;  // staged words a thread loads before it stores any

// The block's tables, ahead of its windows in shared memory (kernels/seg.py
// tc_table_words): per class-grouped column i its column and its start in
// the window, per row its start in the window and its class, where each
// class's run starts, and per m-tile its class and its place in it.
constexpr int kTabCol = 0, kTabXs = 32, kTabSyr = 64, kTabLcy = 96, kTabRun = 128,
              kTabNmt = 161, kTabMt = 162;

struct SegTcArgs {
  const float* src;        // (F, H, W)
  const uint32_t* blocks;  // bf16: (n_uy, n_ux, fs, fsk) bf16; wsplit3: (n_uy, n_ux, fs, fsp) f32; words
  const int* sy;           // (hout,) window starts
  const int* sx;           // (wout,)
  const int* lcy;          // (hout,) row class, as an index into its tile's list
  const int* tcy;          // (row tiles, ky) each tile's row classes
  const int* tcx;          // (column tiles, kx)
  const int* ncy;          // (row tiles,) row classes of each tile
  const int* ncx;          // (column tiles,)
  const int* pcx;          // (column tiles, kTX) each tile's columns, grouped by class
  const int* scx;          // (column tiles, kx + 1) where each class's run starts in pcx
  float* out;              // (F, hout, wout)
  int F, H, W, hout, wout, n_ux, fs, fsk, fsp, ky, kx;
  int pairs;  // pair blocks room: max over tiles of ncy * ncx
  int bs;     // words between staged pair blocks, a multiple of 4 (kernels/seg.py tc_words)
  int tab;    // words of the block's tables (>= kTabMt + 2 * NF + 32, a multiple of 4)
  int cw;     // words of a staged copy row (>= the widest window's words)
  int plane;  // words of a staged frame (>= its tallest window's rows * 2 * cw)
};

// SPLIT: precision='wsplit3' (header note): the fp32 mode's blocks are
// staged at their fsp-float rows and each B fragment is split into three
// bfloat16 parts at its load, once for MP = 2 m-tiles of a class (an item),
// so that the split and the B load are paid once a pair of m-tiles' 6 mmas.
// CLIP: the k-slots pass the fsp floats of a row (fsk > fsp without the
// one-tap tail, e.g. fs 44), so a lane's taps past them read as zeros,
// tested per lane in the one k16 chunk (or the k8 tail) that reaches past
// fsp alone. Compiled apart: the test in every chunk, or the clipped
// chunk's code in every plan's instance, slowed 1440p -> 4K on an H100
// (PERF.md, findings).
template <int NF, bool SPLIT, bool CLIP>
__global__ void __launch_bounds__(kTcThreads) seg_tc_kernel(const SegTcArgs a) {
  constexpr int MP = SPLIT ? 2 : 1;  // m-tiles an item
  extern __shared__ __align__(16) uint32_t tsm[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;  // groupID, threadID_in_group
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int x0 = tx * kTX, y0 = ty * kSegTY;
  const int f0 = blockIdx.z * NF;
  const int nf = min(NF, a.F - f0);
  const int ncx = __ldg(a.ncx + tx), ncy = __ldg(a.ncy + ty);
  uint32_t* const wsm = tsm;
  int* const tab = reinterpret_cast<int*>(tsm + a.pairs * a.bs);
  uint32_t* const win = tsm + a.pairs * a.bs + a.tab;

  // The tile's class-pair blocks, pair p = (row class p / ncx, column
  // class p % ncx).
  const int n4 = a.fs * (SPLIT ? a.fsp : a.fsk / 2) / 4;  // 16-byte pieces of a block
  for (int i = t; i < ncy * ncx * n4; i += kTcThreads) {
    const int p = i / n4, v = i - p * n4;
    const int cy = __ldg(a.tcy + ty * a.ky + p / ncx);
    const int cx = __ldg(a.tcx + tx * a.kx + p % ncx);
    jt_cp_async16(wsm + p * a.bs + 4 * v,
                  a.blocks + (static_cast<int64_t>(cy) * a.n_ux + cx) * (4 * n4) + 4 * v);
  }
  jt_cp_async_commit();

  // The window: [row_lo, row_hi + fs) x [col_lo, col_hi + fsk), the
  // columns a k-slot past the last tap read as zeros beyond the plane.
  const int xl = x0 + lane, yl = y0 + lane;
  const bool xok = xl < a.wout, yok = yl < a.hout;
  const int my_sx = xok ? __ldg(a.sx + xl) : INT_MAX;
  const int my_sy = yok ? __ldg(a.sy + yl) : INT_MAX;
  const int col_lo = __reduce_min_sync(0xffffffffu, my_sx);
  const int col_hi = __reduce_max_sync(0xffffffffu, xok ? my_sx : INT_MIN);
  const int row_lo = __reduce_min_sync(0xffffffffu, my_sy);
  const int row_hi = __reduce_max_sync(0xffffffffu, yok ? my_sy : INT_MIN);
  const int nr = row_hi - row_lo + a.fs;
  const int nw = (col_hi - col_lo + a.fsk + 1) / 2;  // words of a copy row that A reads
  const int* const sc = a.scx + tx * (a.kx + 1);
  if (warp == 0) {
    const int col = __ldg(a.pcx + x0 + lane);  // 0 past a ragged tile's end
    tab[kTabCol + lane] = col;
    tab[kTabXs + lane] = __ldg(a.sx + min(x0 + col, a.wout - 1)) - col_lo;
    tab[kTabSyr + lane] = yok ? my_sy - row_lo : 1 << 20;
    tab[kTabLcy + lane] = yok ? __ldg(a.lcy + yl) : 0;
    if (lane < ncx) tab[kTabRun + lane] = __ldg(sc + lane);
    if (lane == 0) {  // m-tiles: ceil(n * nf / 16) of a class of n columns, MP an item
      tab[kTabRun + ncx] = __ldg(sc + ncx);
      int j = 0;
      for (int c = 0; c < ncx; ++c) {
        const int mtc = ((__ldg(sc + c + 1) - __ldg(sc + c)) * nf + 15) >> 4;
        for (int jc = 0; jc < mtc; jc += MP) tab[kTabMt + j++] = c << 16 | jc;
      }
      tab[kTabNmt] = j;
    }
  }
  // The window of each frame, rounded to bfloat16 once: row r's word m of
  // copy 0 holds columns (2m, 2m + 1), of copy 1 (2m + 1, 2m + 2). A thread
  // loads LOADS words' values before it stores any: 16 in the wsplit3
  // instances of up to 2 frames, where one block fills the SM (fs 44) and
  // nothing overlaps its staging (faster on an H100 than 4 there, slower
  // at 8 frames, whose registers it raises).
  constexpr int LOADS = SPLIT && NF <= 2 ? 4 * kTcLoads : kTcLoads;
  const int64_t fplane = static_cast<int64_t>(a.H) * a.W;
  const int nrw = nr * nw, total = nf * nrw;
  for (int i0 = t; i0 < total; i0 += LOADS * kTcThreads) {
    float v[LOADS][3];
    int d[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = i0 + i * kTcThreads;
      d[i] = -1;
      if (idx < total) {
        const int e = idx / nrw, r = (idx - e * nrw) / nw, m = idx - e * nrw - r * nw;
        const float* const gr = a.src + (f0 + e) * fplane + static_cast<int64_t>(row_lo + r) * a.W;
        const int c = col_lo + 2 * m;
        v[i][0] = c < a.W ? __ldg(gr + c) : 0.f;
        v[i][1] = c + 1 < a.W ? __ldg(gr + c + 1) : 0.f;
        v[i][2] = c + 2 < a.W ? __ldg(gr + c + 2) : 0.f;
        d[i] = e * a.plane + r * 2 * a.cw + m;
      }
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i)
      if (d[i] >= 0) {
        win[d[i]] = jt_pack_bf16(v[i][0], v[i][1]);
        win[d[i] + a.cw] = jt_pack_bf16(v[i][1], v[i][2]);
      }
  }
  jt_cp_async_wait<0>();
  __syncthreads();  // the only barrier: the warps run apart from here

  const int mt = tab[kTabNmt];  // items' m-tiles: MP m-tiles of 16 slots (column, frame) of one class
  const int nt = (min(kSegTY, a.hout - y0) + 7) >> 3;  // n-tiles: 8 rows each
  const int n16 = a.fsk >> 4;
  const int nin = CLIP ? min(n16, a.fsp >> 4) : n16;  // k16 chunks within fsp floats
  const bool tail8 = (a.fsk & 15) != 0;
  const bool last1 = (a.fs & 15) == 1;  // the tail is one tap: 8 rows' in one mma (note)
  const int hw = SPLIT ? a.fsp : a.fsk >> 1;  // words of a staged tap row
  const int64_t oplane = static_cast<int64_t>(a.hout) * a.wout;
  for (int item = warp; item < mt * nt; item += kTcWarps) {
    const int j = item / nt, k = item - j * nt;
    const int cj = tab[kTabMt + j], c = cj >> 16, jc = cj & 0xffff;
    const int base = tab[kTabRun + c], cnt = tab[kTabRun + c + 1] - base;
    // The item's M m-tiles (M = 2 where its class has a second m-tile,
    // warp-uniform), each body compiled for its M.
    auto run = [&](auto m_tiles) {
      constexpr int M = decltype(m_tiles)::value;
      // The lane's A rows g and g + 8 of each m-tile: slot i = column i % cnt
      // of frame i / cnt.
      int aoff[M][2], col[M][2], fr[M][2];
      bool sok[M][2];
#pragma unroll
      for (int u = 0; u < M; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int slot = (jc + u) * 16 + g + 8 * h;
          sok[u][h] = slot < cnt * nf;
          fr[u][h] = sok[u][h] ? slot / cnt : 0;
          const int i = base + (sok[u][h] ? slot - fr[u][h] * cnt : 0);
          col[u][h] = tab[kTabCol + i];
          const int xs = tab[kTabXs + i];
          aoff[u][h] = fr[u][h] * a.plane + (xs & 1) * a.cw + (xs >> 1);
        }
      // The lane's B column: row 8k + g of the tile.
      const int syr = tab[kTabSyr + 8 * k + g];
      const bool mok = y0 + 8 * k + g < a.hout;
      const int boff = (tab[kTabLcy + 8 * k + g] * ncx + c) * a.bs;
      const int s_lo = __reduce_min_sync(0xffffffffu, mok ? syr : INT_MAX);
      const int s_hi = __reduce_max_sync(0xffffffffu, mok ? syr : INT_MIN) + a.fs;
      // Two accumulators an m-tile, chunks 0, 2, .. and 1, 3, ..: two mmas in flight.
      float acc0[M][4], acc1[M][4];
#pragma unroll
      for (int u = 0; u < M; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc0[u][i] = acc1[u][i] = 0.f;
      constexpr int PARTS = SPLIT ? 3 : 1;
#pragma unroll 2
      for (int s = s_lo; s < s_hi; ++s) {
        const int ly = s - syr;
        const bool bok = static_cast<unsigned>(ly) < static_cast<unsigned>(a.fs);
        const uint32_t* const ar = win + s * 2 * a.cw;
        const uint32_t* const br = wsm + boff + (bok ? ly : 0) * hw;
        // One B fragment (SPLIT: split once) for the item's m-tiles; clip:
        // the chunk reaches past fsp (a constant at each call).
        auto k16 = [&](float(&d)[M][4], int q, bool clip) {
          const int o = 8 * q + 2 * tq;  // lane tq's taps 16q + 4tq .. + 3
          uint32_t b0[PARTS], b1[PARTS];
          if constexpr (SPLIT) {  // the f32 taps at word 2o (none past the row), split
            const float4 w = bok && (!clip || 2 * o < a.fsp)
                                 ? *reinterpret_cast<const float4*>(br + 2 * o)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            jt_split3_pack(w.x, w.y, b0);
            jt_split3_pack(w.z, w.w, b1);
          } else {
            const uint2 b = bok ? *reinterpret_cast<const uint2*>(br + o) : make_uint2(0u, 0u);
            b0[0] = b.x;
            b1[0] = b.y;
          }
#pragma unroll
          for (int u = 0; u < M; ++u) {
            const uint32_t a0 = ar[aoff[u][0] + o], a1 = ar[aoff[u][1] + o];
            const uint32_t a2 = ar[aoff[u][0] + o + 1], a3 = ar[aoff[u][1] + o + 1];
#pragma unroll
            for (int p = 0; p < PARTS; ++p) jt_mma_k16(d[u], a0, a1, a2, a3, b0[p], b1[p]);
          }
        };
        int q = 0;
        for (; q + 1 < nin; q += 2) {
          k16(acc0, q, false);
          k16(acc1, q + 1, false);
        }
        if (q < nin) k16(acc0, q++, false);
        if constexpr (CLIP) {
          if (q < n16) {  // at most one chunk past them
            if (q & 1) {
              k16(acc1, q, true);
            } else {
              k16(acc0, q, true);
            }
          }
        }
        if (tail8 && !last1) {
          const int o = 8 * n16 + tq;  // taps 16 n16 + 2tq, + 1
          uint32_t b[PARTS];
          if constexpr (SPLIT) {
            const float2 w = bok && (!CLIP || 2 * o < a.fsp)
                                 ? *reinterpret_cast<const float2*>(br + 2 * o)
                                 : make_float2(0.f, 0.f);
            jt_split3_pack(w.x, w.y, b);
          } else {
            b[0] = bok ? br[o] : 0u;
          }
#pragma unroll
          for (int u = 0; u < M; ++u) {
            const uint32_t a0 = ar[aoff[u][0] + o], a1 = ar[aoff[u][1] + o];
#pragma unroll
            for (int p = 0; p < PARTS; ++p) {
              if (n16 & 1) {
                jt_mma_k8(acc1[u], a0, a1, b[p]);
              } else {
                jt_mma_k8(acc0[u], a0, a1, b[p]);
              }
            }
          }
        }
      }
      if (last1) {  // the last tap of 8 staged rows in one k8 mma: k = row r0 + k
        const int o = 8 * n16;  // its word in a row: the low half, in the copy of the slot's parity
        for (int r0 = s_lo; r0 < s_hi; r0 += 8) {
          uint32_t bv[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int ly = r0 + 2 * tq + i - syr;
            // SPLIT: the tap's f32 bits, at word 2o of its row
            bv[i] = static_cast<unsigned>(ly) < static_cast<unsigned>(a.fs)
                        ? wsm[boff + ly * hw + (SPLIT ? 2 * o : o)] : 0u;
          }
          uint32_t b[PARTS];
          if constexpr (SPLIT) {
            jt_split3_pack(__uint_as_float(bv[0]), __uint_as_float(bv[1]), b);
          } else {
            b[0] = __byte_perm(bv[0], bv[1], 0x5410);
          }
#pragma unroll
          for (int u = 0; u < M; ++u) {
            uint32_t av[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = r0 + 2 * tq + i;
              const uint32_t* const ar = win + min(r, s_hi - 1) * 2 * a.cw;
              av[0][i] = r < s_hi ? ar[aoff[u][0] + o] : 0u;  // no row past the window
              av[1][i] = r < s_hi ? ar[aoff[u][1] + o] : 0u;
            }
            const uint32_t a0 = __byte_perm(av[0][0], av[0][1], 0x5410);
            const uint32_t a1 = __byte_perm(av[1][0], av[1][1], 0x5410);
#pragma unroll
            for (int p = 0; p < PARTS; ++p) jt_mma_k8(acc1[u], a0, a1, b[p]);
          }
        }
      }
      // d0, d1: slot g, rows 2tq and 2tq + 1 of the n-tile; d2, d3: slot g + 8.
#pragma unroll
      for (int u = 0; u < M; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!sok[u][h]) continue;
          float* const o = a.out + (f0 + fr[u][h]) * oplane + x0 + col[u][h];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int mm = y0 + 8 * k + 2 * tq + i;
            if (mm < a.hout)
              o[static_cast<int64_t>(mm) * a.wout] = acc0[u][2 * h + i] + acc1[u][2 * h + i];
          }
        }
    };
    if (MP == 2 && (cnt * nf + 15) / 16 - jc >= 2) {
      run(std::integral_constant<int, MP>{});
    } else {
      run(std::integral_constant<int, 1>{});
    }
  }
}

template <int NF, bool SPLIT, bool CLIP>
cudaError_t seg_tc_launch(const SegTcArgs& a, cudaStream_t stream) {
  if (a.tab < kTabMt + 2 * NF + 32) return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(a.pairs) * a.bs + a.tab +
                       static_cast<size_t>(NF) * a.plane) * sizeof(uint32_t);
  cudaError_t err = jt_allow_smem(seg_tc_kernel<NF, SPLIT, CLIP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.wout + kTX - 1) / kTX, (a.hout + kSegTY - 1) / kSegTY, (a.F + NF - 1) / NF);
  seg_tc_kernel<NF, SPLIT, CLIP><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The checks and arguments of both tensor-core entries below.
template <bool SPLIT, bool CLIP>
int seg_tc_entry(const float* src, const void* blocks, const int* sy, const int* sx,
                 const int* lcy, const int* tcy, const int* tcx, const int* ncy, const int* ncx,
                 const int* pcx, const int* scx, float* out, int F, int H, int W, int hout,
                 int wout, int n_ux, int fs, int fsk, int fsp, int ky, int kx, int pairs, int bs,
                 int tab, int cw, int plane, int nf, cudaStream_t stream) {
  if (hout <= 0 || wout <= 0 || F <= 0) return 0;
  if (fsk % 8 != 0 || fsk < fs || fsk - fs >= 16 || fsp % 4 != 0 || fsp < fs || bs % 4 != 0 ||
      bs < (SPLIT ? fs * fsp : fs * fsk / 2) || pairs < 1 || tab % 4 != 0 || kx > 32 ||
      plane < 2 * cw)
    return static_cast<int>(cudaErrorInvalidValue);
  const SegTcArgs a{src, static_cast<const uint32_t*>(blocks), sy, sx, lcy, tcy, tcx, ncy, ncx,
                    pcx, scx, out, F, H, W, hout, wout, n_ux, fs, fsk, fsp, ky, kx, pairs, bs,
                    tab, cw, plane};
  switch (nf) {
    case 1: return static_cast<int>(seg_tc_launch<1, SPLIT, CLIP>(a, stream));
    case 2: return static_cast<int>(seg_tc_launch<2, SPLIT, CLIP>(a, stream));
    case 4: return static_cast<int>(seg_tc_launch<4, SPLIT, CLIP>(a, stream));
    case 8: return static_cast<int>(seg_tc_launch<8, SPLIT, CLIP>(a, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// src (F, H, W) f32; blocks (n_uy, n_ux, fs, fsp) f32; sy, lcy (hout) and
// sx, lcx (wout) int32; tcy (ceil(hout / 32), ky), ncy (ceil(hout / 32)),
// tcx (ceil(wout / 32), kx), ncx (ceil(wout / 32)) int32; out (F, hout,
// wout) f32. All contiguous. bstride, pairs, nf, swp: the shared-memory
// layout (kernels/seg.py smem_bytes).
extern "C" int jt_seg_interior(const float* src, const float* blocks, const int* sy,
                               const int* sx, const int* lcy, const int* lcx, const int* tcy,
                               const int* tcx, const int* ncy, const int* ncx, float* out, int F,
                               int H, int W, int hout, int wout, int n_ux, int fs, int fsp,
                               int bstride, int ky, int kx, int pairs, int nf, int swp,
                               cudaStream_t stream) {
  if (hout <= 0 || wout <= 0 || F <= 0) return 0;
  if (swp % 4 != 0 || fsp % 4 != 0 || fsp < fs || bstride % 4 != 0 ||
      bstride < fs * fsp || pairs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const SegArgs a{src, blocks, sy, sx, lcy, lcx, tcy, tcx, ncy, ncx, out, F, H,
                  W, hout, wout, n_ux, fs, fsp, bstride, ky, kx, pairs, swp};
  switch (nf) {
    case 1: return static_cast<int>(seg_launch<1>(a, stream));
    case 2: return static_cast<int>(seg_launch<2>(a, stream));
    case 4: return static_cast<int>(seg_launch<4>(a, stream));
    case 8: return static_cast<int>(seg_launch<8>(a, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// precision='bf16', the tensor-core kernel. blocks (n_uy, n_ux, fs, fsk)
// bf16, tap rows padded with zeros to fsk = the k-slots of fs (a multiple
// of 8); pcx (ceil(wout / 32), 32), scx (ceil(wout / 32), kx + 1) int32
// (kernels/seg.py tile_columns); the rest as above. pairs, bs, tab, cw,
// plane, nf: the shared-memory layout (kernels/seg.py tc_smem_bytes).
extern "C" int jt_seg_interior_bf16(const float* src, const void* blocks, const int* sy,
                                    const int* sx, const int* lcy, const int* tcy,
                                    const int* tcx, const int* ncy, const int* ncx,
                                    const int* pcx, const int* scx, float* out, int F, int H,
                                    int W, int hout, int wout, int n_ux, int fs, int fsk, int ky,
                                    int kx, int pairs, int bs, int tab, int cw, int plane,
                                    int nf, cudaStream_t stream) {
  return seg_tc_entry<false, false>(src, blocks, sy, sx, lcy, tcy, tcx, ncy, ncx, pcx, scx, out, F,
                                    H, W, hout, wout, n_ux, fs, fsk, (fs + 3) / 4 * 4, ky, kx,
                                    pairs, bs, tab, cw, plane, nf, stream);
}

// precision='wsplit3', the tensor-core kernel on three parts of the fp32
// mode's blocks: blocks (n_uy, n_ux, fs, fsp) f32, tap rows padded with
// zeros to fsp floats (kernels/gather.py padded_blocks), staged at bs >= fs
// * fsp words and split at each B load (kernels/seg.py tc_words); the rest
// as above.
extern "C" int jt_seg_interior_wsplit3(const float* src, const void* blocks, const int* sy,
                                       const int* sx, const int* lcy, const int* tcy,
                                       const int* tcx, const int* ncy, const int* ncx,
                                       const int* pcx, const int* scx, float* out, int F, int H,
                                       int W, int hout, int wout, int n_ux, int fs, int fsk,
                                       int fsp, int ky, int kx, int pairs, int bs, int tab, int cw,
                                       int plane, int nf, cudaStream_t stream) {
  if (fsk > fsp && fs % 16 != 1)
    return seg_tc_entry<true, true>(src, blocks, sy, sx, lcy, tcy, tcx, ncy, ncx, pcx, scx, out, F,
                                    H, W, hout, wout, n_ux, fs, fsk, fsp, ky, kx, pairs, bs, tab,
                                    cw, plane, nf, stream);
  return seg_tc_entry<true, false>(src, blocks, sy, sx, lcy, tcy, tcx, ncy, ncx, pcx, scx, out, F,
                                   H, W, hout, wout, n_ux, fs, fsk, fsp, ky, kx, pairs, bs, tab,
                                   cw, plane, nf, stream);
}
