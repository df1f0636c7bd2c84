// Periodic interior of the phase-conv resample, written in destination layout.
//
// Replaces jincresize_tpu/kernels/pallas_fused.py::_fused_kernel (built by
// make_fused_interior). Each phase's (fs, fs) block sits at its source offset
// in a zero-padded (kh, kw) kernel K (phase.build_conv_kernels), so for
// destination row ylo + py*i + ry and column xlo + px*j + rx of the
// interior block:
//
//   out[f, py*i + ry, px*j + rx] =
//     sum_{a < kh, b < kw} src[f, base_y + qy*i + a, base_x + qx*j + b] * K[ry*px + rx][a, b]
//
// summed as one fmaf chain in (a, b) order, the plain form's order
// (kernels/fused.py fused_interior_plain), so both agree bit for bit. Reads
// past the plane are zeros.
//
// What bounds it: fp32 FMA issue. 4K->8K tap 8 is 9.6 G FMAs a frame, 0.29 ms
// at 67 TFLOP/s (2 flops an FMA), against 166 MB of traffic, 0.05 ms at
// 3.35 TB/s. So the design keeps loads and address arithmetic rare beside
// the FMAs:
//
// * A block takes C anchor rows by TX*R anchor columns of one group of G
//   phases (G = 4 where py*px allows, else 1; groups ride gridDim.z with the
//   frames). Its source window, qy*(C-1) + kh rows by qx*(TX*R-1) + kw
//   columns, streams through shared memory once, in a ring of `ch` rows a
//   stage, double-buffered with 4-byte cp.async (zero-filled past the plane).
//   Staged rows are padded by 4 floats every 32, so the lanes' 16-byte loads
//   of windows qx*R floats apart hit distinct banks.
// * A thread holds R consecutive anchors of C rows for its G phases: R*C*G =
//   32 accumulators. For each staged row and chunk of 8 taps it loads its
//   register window (qx*(R-1) + 8 values, in 16-byte loads) once, then for
//   each of its C rows that uses the source row, the chunk's 8*G weights
//   (16-byte loads at one address for the whole block, a broadcast), and
//   runs 8*R*G FMAs. At 4K->8K (R = 4, C = 2, G = 4) that is 3 window and
//   16 weight loads for 256 FMAs; at 4K->1080p tap 16 (R = 4, C = 8, G = 1)
//   4 window and 16 weight loads for 256 FMAs.
// * The accumulators go through shared memory (the ring, reused) to
//   coalesced output rows, phases interleaved.
//
// The shapes (TX, R, C*G) are compile-time (kernels/fused.py SHAPES: the
// default, and a narrow block for plans whose default window row does not
// fit, 2 shapes x G in {1, 4} x qx in {1, 2, other} = 12 instances); qx = 1
// and 2 are compile-time too, so the register window is indexed
// statically; other qx load one anchor's 8 taps at a time. The arithmetic
// that places a block's window and a thread's register window is mirrored
// in kernels/fused.py (layout, block_origin, thread_window) and tested
// there.
//
// precision='bf16' replaces the Pallas kernel's one-pass DEFAULT dot
// (pallas_fused.py:235: both operands rounded to bfloat16, exact products,
// fp32 sums) with fused_tc_kernel below, on the tensor cores (mma.sync
// m16n8k16 / m16n8k8, bf16 in, fp32 sums; common.cuh). The host rounds the
// kernels to bfloat16 once and writes them as bf16 weight rows
// (kernels/fused.py tc_weights). For each staged source row s, every
// anchor row c that reads it (kernel row a = s - qy*c) gets a product
//
//   acc[j, (c, e)] += sum_b A[j, b] * B[b, (c, e)],
//   A[j, b] = src[row0 + s, col0 + qx*j + b],  B[b, (c, e)] = K[e][s - qy*c][b]
//
// (B zero where s - qy*c is outside [0, kh)), the Pallas kernel's own
// packing (its w is (px*TMo, taps x hbu), pallas_fused.py:225-236):
//
// * M (16): anchor columns j; K: the taps b of one row, in k16 chunks and a
//   k8 tail (k-slots: kw 65 -> 72, 90% useful). Where one tap is left over
//   (kw = 16n + 1: kw 17 at 4K -> 8K, 65 at tap 16), one k8 mma takes that
//   tap of 8 staged rows (k = row), so kw 17 costs 16 + 1/8 slots a row,
//   not 24. N (8): (anchor row c, phase e) pairs, 8 a tile, C*G = 32 a
//   block (4 n-tiles: C = 8 anchor rows of 4 phases, or 32 of one).
// * A warp holds 2 m-tiles x 4 n-tiles (32 accumulators a lane): each A
//   fragment, a Hankel slice of one source row, feeds 4 mmas, each B
//   fragment 2. Per k16 chunk a warp reads 8 A words and 4 8-byte B loads
//   for 8 mmas, about 2 wavefronts of shared memory an mma. Every n-tile
//   runs every row (its B is zero where its rows do not reach): branching
//   around an idle one made each n-tile's B load wait for the previous
//   n-tile's mmas (convergence barriers around each), clearly slower on an
//   H100.
// * The source lands through a ring of kTcLand stages of ch rows in f32
//   (16-byte cp.async where rows are 16-byte aligned, else 4-byte; two
//   stages in flight during the mmas), and each stage is rounded to
//   bfloat16 once, in one pass, into the bf16 rows the mmas read: a
//   cp.async cannot convert, and loads into registers held the threads on
//   each stage's latency. Each pair of columns is stored twice, word m of
//   copy 0 holding columns (2m, 2m + 1) and of copy 1 (2m + 1, 2m + 2), so
//   that every A word is one aligned 4-byte load whatever the parity of
//   qx*j (copy 1 only for odd qx, where that parity changes from anchor to
//   anchor). Two barriers a stage.
// * The accumulators go through shared memory to coalesced output rows,
//   phases interleaved, as in the fp32 kernel (write_tile).
//
// What bounds the bf16 form on an H100: at 4K -> 8K the bound is bytes
// (0.049 ms a frame) and 9.6 G MACs take 0.019 ms at 989 TFLOP/s. A block
// lands and rounds its rows, runs its mmas, then writes its tile; its SM
// overlaps these phases only across its 4-5 blocks, and the mmas are
// bounded by the shared-memory loads of their A and B fragments. Not
// wgmma: it
// reads A from shared memory only through a descriptor of 8 x 16-byte core
// matrices, and a Hankel window, whose rows are one element apart, cannot
// be described so; A from registers, 64-row warpgroup tiles and TMA are
// later work. Shapes: SHAPES' thread counts (128 -> 4 warps, 128 anchors a
// block; 32 -> 1 warp, 32 anchors) x G in {1, 4} = 4 instances, both
// shapes with the default's stages, so they add alike;
// kernels/fused.py tc_layout mirrors the layout. The sums run in the
// tensor core's order, so the kernel is held to its plain form (rounded
// operands, fp32 FMA order) within kernels/fused.py tc_sum_bound, not bit
// for bit.
//
// precision='wsplit3' replaces the Pallas kernel's weight split
// (pallas_fused.py:383-393, three DEFAULT dots a pack at :236-251), the
// mode u8 planes take, with a kernel of its own, fused_ws3_kernel below.
// The host splits each fp32 weight w into three bfloat16 parts, w == c0 +
// c1 + c2 exactly (kernels/fused.py split_bf16x3, checked bit for bit at
// the build). Every product of a u8 value (exact in bfloat16) and a part is
// exact in fp32, so only the order of the 3 * kh * kw sums differs from
// the fp32 plain form (kernels/fused.py wsplit3_bound). The products are
// those of the bf16 mode, three times over. What bounds the mode on an
// H100 is the issue of the products and of their fragments, not the
// tensor cores' rate: at 4K -> 8K its mmas (3 x 9.6 G MACs a frame, a
// quarter skipped) take about 0.044 ms at 989 TFLOP/s and the kernel
// 0.29, the same kernel on one weight part 0.25 (tools/kernel_variants.py
// one-part), so the fixed cost of a staged row (A loads, addresses, the
// staging and rounding around them) weighs more than two more parts'
// products. The design:
//
// * A pipeline of stages of ch window rows with one barrier a stage: while
//   stage u is computed from a ring of two bf16 stages, stage u + 1,
//   landed in f32 by cp.async, is rounded into the other (two copies of
//   each row, as the bf16 mode's, one cvt.rn.bf16x2 a word, the work of
//   every warp) and stage u + 2 lands. A producer warp that landed and
//   rounded alone, handing stages over by named barriers, was slower on an
//   H100: its rounding, one warp's, set the pace.
// * A block walks fb frames one after another (kernels/fused.py
//   ws3_frames), so that its weights, its row tables and the start of its
//   pipeline are paid once for them all and the next frame's rows land
//   while this one's are computed.
// * No products on zeros: a staged row s runs only the n-tiles that hold an
//   anchor row c with 0 <= s - qy*c < kh (kernels/fused.py live_tiles), a
//   code path compiled for each contiguous range of n-tiles, chosen per
//   run of rows: 25% fewer mmas at 4K -> 8K, 38% at 4K -> 1080p tap 16.
// * B from 16-byte weight rows (8 taps a chunk): kernel row a, phase e at
//   row R(a, e) = ((a mod qy) * (lq + lp) + lp + lq - 1 - a div qy) * G + e
//   (kernels/fused.py weight_row), so that the columns (c, e) of an n-tile
//   that read staged row s sit on consecutive rows R0(s) + c*G + e. With
//   lp = 8/G - 1 zero slots padding each residue (the 4-warp shape with G
//   = 4, where they fit), a column of a live n-tile whose kernel row is
//   outside [0, kh) lands on a zero row there too, so an n-tile's B is one
//   core matrix of 8 rows at R0(s) + 8n: the rows that reach all 4 n-tiles
//   run as wgmma m64n32k16 (A from registers, B through a descriptor, one
//   warpgroup a block), 6 wgmmas a k16 chunk, each chunk waiting for its
//   own. The other rows, and every row of other plans, run mma.sync with B
//   from ldmatrix.x4 (two n-tiles' fragments as 128-byte runs; a column
//   outside [0, kh) points at the last row, zeros). One D shape for every
//   wgmma: wgmmas of the exact live ranges (n8 to n32) on the same
//   accumulators were serialized by ptxas (C7511) and slower than mma.sync;
//   n32 on every row (lp = C - 1) was 4% faster at 4K -> 8K but 1.75x
//   slower on the 2/3 plan; a second set of A registers overlapping a
//   chunk's loads with the previous chunk's products was slower; wgmma
//   with G = 1 (4K -> 1080p tap 16) was slower than mma.sync (PERF.md).
//   R0(s) and each row's live n-tiles come from two tables a block fills
//   once: integer divisions by qy on every row cost as many instructions
//   as the row's products.
// * A from the bf16 copies, one 4-byte load a register, each A fragment
//   feeding three parts times the live n-tiles; the one-tap tail (kw =
//   16n + 1) packed 8 rows to one k8 mma, its B from a column of that tap.
// * The sums go from the fragments straight to the output (8-byte stores
//   where G and px are even), no tile in shared memory, no barrier.
//
// Shared memory: the three parts (kernels/fused.py ws3_layout), the row
// tables, the landing stages and the ring; stages of 8 rows where those
// fit two blocks an SM, fewer otherwise (then a one-tap tail is a k8
// chunk). The weights are laid out once a plan, at the build's shape, and
// a launch at another shape keeps their layout (its tail and padding).
// Two shapes as the bf16 mode's: 4 warps (128 anchors), 1 (32), each x G
// in {1, 4}, and the wgmma form of the 4-warp shape: 6 instances. The bf16
// mode keeps fused_tc_kernel: this body on one weight part took 0.74x,
// 0.94x and 1.28x its time at 4K -> 8K, tap 16 and the 2/3 plan on an H100
// (tools/kernel_variants.py one-part, at wsplit3's stage layout); moving
// bf16 here waits for the 2/3 plan at 8-row stages (ROADMAP follow-up h).
//
// TPU workarounds dropped: split3 (the output is stored interleaved),
// residue planes (threads read strided anchors from registers), the VMEM
// row-band budget and the Mosaic deep-tap envelope (kh and kw are runtime
// values).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kChunk = 8;  // taps of a register window (kernels/fused.py CHUNK)

struct FusedArgs {
  const float* src;
  const float* w;
  float* out;
  int H, W, py, px, qy, qx, base_y, base_x, nyb, nxb, kh, kw, kwp, ngroups, ch, slots, swp;
};

// Physical offset of window column x in a staged row (kernels/fused.py _skew).
__device__ __forceinline__ int skew(int x) { return x + 4 * (x >> 5); }

template <int N>
__device__ __forceinline__ void load4(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}

// The tile of a block's sums, row (c, e) of anchor row c and phase e at
// (c*G + e)*BJP, anchor jj at jj + jj/32, -> coalesced output rows, phases
// interleaved; THREADS threads.
template <int THREADS, int BJ, int C, int G>
__device__ __forceinline__ void write_tile(const float* tile, float* out, int t, int f, int grp,
                                           int i0, int j0, int py, int px, int nyb, int nxb) {
  constexpr int BJP = BJ + BJ / 32 + 1;
  const int hout = py * nyb, wout = px * nxb;
  float* const outf = out + static_cast<int64_t>(f) * hout * wout;
  const int ph0 = grp * G;
  const int ry0 = ph0 / px, ry1 = (ph0 + G - 1) / px;
  const int ncols = min(px * BJ, wout - px * j0);
  for (int c = 0; c < C && i0 + c < nyb; ++c) {
    const float* const trow = tile + c * G * BJP;
    for (int ry = ry0; ry <= ry1; ++ry) {
      float* const orow = outf + static_cast<int64_t>(py * (i0 + c) + ry) * wout + px * j0;
      if (THREADS % px == 0) {  // column u = t + THREADS*k keeps phase rx = t % px
        const int e = ry * px + t % px - ph0;
        if (e < 0 || e >= G) continue;
        const int step = THREADS / px;
        int jj = t / px;
        for (int u = t; u < ncols; u += THREADS, jj += step)
          orow[u] = trow[e * BJP + jj + (jj >> 5)];
      } else {
        for (int u = t; u < ncols; u += THREADS) {
          const int jj = u / px;
          const int e = ry * px + (u - jj * px) - ph0;
          if (e >= 0 && e < G) orow[u] = trow[e * BJP + jj + (jj >> 5)];
        }
      }
    }
  }
}

// One staged source row s (window-relative) into the accumulators of every
// anchor row c that reads it (kernel row a = s - qy*c).
template <int R, int C, int G, int QX>
__device__ __forceinline__ void row_taps(const float* __restrict__ row,
                                         const float* __restrict__ wsm, int s, int x0, int qx,
                                         int qy, int kh, int kw, int kwp,
                                         float (&acc)[C][G][R]) {
  int b0 = 0;
  for (; b0 + kChunk <= kw; b0 += kChunk) {
    if constexpr (QX != 0) {
      constexpr int kWin = (QX * (R - 1) + kChunk + 3) / 4 * 4;
      float win[kWin];
#pragma unroll
      for (int v = 0; v < kWin / 4; ++v) load4<4>(row + skew(x0 + b0 + 4 * v), win + 4 * v);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int a = s - qy * c;
        if (a < 0 || a >= kh) continue;
        float w[kChunk * G];
        load4<kChunk * G>(wsm + (a * kwp + b0) * G, w);
#pragma unroll
        for (int b = 0; b < kChunk; ++b)
#pragma unroll
          for (int e = 0; e < G; ++e)
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[c][e][r] = fmaf(win[QX * r + b], w[b * G + e], acc[c][e][r]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int a = s - qy * c;
        if (a < 0 || a >= kh) continue;
        float w[kChunk * G];
        load4<kChunk * G>(wsm + (a * kwp + b0) * G, w);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v[kChunk];
#pragma unroll
          for (int b = 0; b < kChunk; ++b) v[b] = row[skew(x0 + qx * r + b0 + b)];
#pragma unroll
          for (int b = 0; b < kChunk; ++b)
#pragma unroll
            for (int e = 0; e < G; ++e) acc[c][e][r] = fmaf(v[b], w[b * G + e], acc[c][e][r]);
        }
      }
    }
  }
  for (int b = b0; b < kw; ++b) {  // the last kw % 8 taps, one at a time
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = row[skew(x0 + qx * r + b)];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int a = s - qy * c;
      if (a < 0 || a >= kh) continue;
      float w[G];
      if constexpr (G == 4) {
        load4<4>(wsm + (a * kwp + b) * G, w);
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e) w[e] = wsm[(a * kwp + b) * G + e];
      }
#pragma unroll
      for (int e = 0; e < G; ++e)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[c][e][r] = fmaf(v[r], w[e], acc[c][e][r]);
    }
  }
}

template <int TX, int R, int C, int G, int QX>
__global__ void __launch_bounds__(TX, 512 / TX) fused_interior_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BJ = TX * R;             // anchor columns of a block
  constexpr int BJP = BJ + BJ / 32 + 1;  // output tile row, padded every 32
  const int qx = QX ? QX : a.qx;
  const int t = threadIdx.x;
  const int g = blockIdx.z % a.ngroups, f = blockIdx.z / a.ngroups;
  const int i0 = blockIdx.y * C, j0 = blockIdx.x * BJ;
  const int row0 = a.base_y + a.qy * i0, col0 = a.base_x + qx * j0;
  const int nr = a.qy * (C - 1) + a.kh;  // window rows
  const int sw = qx * (BJ - 1) + a.kw;   // window columns
  const int wn = a.kh * a.kwp * G;       // this group's weights, a multiple of 4 floats
  float* const wsm = smem;
  float* const ring = smem + wn;
  const float* const plane = a.src + static_cast<int64_t>(f) * a.H * a.W;

  const float* const wg = a.w + static_cast<int64_t>(g) * wn;
  for (int v = t; v < wn / 4; v += TX) jt_cp_async16(wsm + 4 * v, wg + 4 * v);

  auto stage = [&](int k) {  // window rows [k*ch, (k+1)*ch) into their ring slots
    const int s1 = min(nr, (k + 1) * a.ch);
    for (int s = k * a.ch; s < s1; ++s) {
      const int y = row0 + s;
      const bool yok = static_cast<unsigned>(y) < static_cast<unsigned>(a.H);
      const float* const srow = plane + static_cast<int64_t>(yok ? y : 0) * a.W;
      float* const drow = ring + (s % a.slots) * a.swp;
      for (int x = t; x < sw; x += TX) {
        const int xx = col0 + x;
        const bool ok = yok && static_cast<unsigned>(xx) < static_cast<unsigned>(a.W);
        jt_cp_async4(drow + skew(x), ok ? srow + xx : plane, ok);
      }
    }
    jt_cp_async_commit();
  };

  float acc[C][G][R];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < G; ++e)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][e][r] = 0.f;

  const int nchunks = (nr + a.ch - 1) / a.ch;
  const int x0 = qx * R * t;  // the thread's first window column
  stage(0);                   // the weights ride the first group
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) {
      stage(k + 1);
      jt_cp_async_wait<1>();
    } else {
      jt_cp_async_wait<0>();
    }
    __syncthreads();
    const int s1 = min(nr, (k + 1) * a.ch);
    for (int s = k * a.ch; s < s1; ++s)
      row_taps<R, C, G, QX>(ring + (s % a.slots) * a.swp, wsm, s, x0, qx, a.qy, a.kh, a.kw,
                            a.kwp, acc);
    __syncthreads();
  }

  // Accumulators -> the tile (over the ring) -> coalesced output rows.
  float* const tile = ring;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < G; ++e)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int jj = R * t + r;
        tile[(c * G + e) * BJP + jj + (jj >> 5)] = acc[c][e][r];
      }
  __syncthreads();
  write_tile<TX, BJ, C, G>(tile, a.out, t, f, g, i0, j0, a.py, a.px, a.nyb, a.nxb);
}

template <int TX, int R, int C, int G, int QX>
cudaError_t launch(const FusedArgs& a, int F, cudaStream_t stream) {
  constexpr int BJ = TX * R;
  constexpr int BJP = BJ + BJ / 32 + 1;
  const int region = a.slots * a.swp > C * G * BJP ? a.slots * a.swp : C * G * BJP;
  const size_t smem = (static_cast<size_t>(a.kh) * a.kwp * G + region) * sizeof(float);
  cudaError_t err = jt_allow_smem(fused_interior_kernel<TX, R, C, G, QX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nxb + BJ - 1) / BJ, (a.nyb + C - 1) / C, F * a.ngroups);
  fused_interior_kernel<TX, R, C, G, QX><<<grid, TX, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int TX, int R, int CG, int QX>
cudaError_t launch_g(const FusedArgs& a, int F, int g, cudaStream_t stream) {
  if (g == 4) return launch<TX, R, CG / 4, 4, QX>(a, F, stream);
  if (g == 1) return launch<TX, R, CG, 1, QX>(a, F, stream);
  return cudaErrorInvalidValue;
}

template <int TX, int R, int CG>
cudaError_t launch_shape(const FusedArgs& a, int F, int g, cudaStream_t stream) {
  if (a.qx == 1) return launch_g<TX, R, CG, 1>(a, F, g, stream);
  if (a.qx == 2) return launch_g<TX, R, CG, 2>(a, F, g, stream);
  return launch_g<TX, R, CG, 0>(a, F, g, stream);
}

// ---- precision='bf16': the tensor-core kernel (header note).

constexpr int kTcMW = 2;  // m-tiles (16 anchor columns each) a warp
constexpr int kTcNT = 4;  // n-tiles (8 (anchor row, phase) pairs each) a warp and a block
constexpr int kTcLand = 3;  // stages of f32 rows landing at once: two in flight during the mmas

struct FusedTcArgs {
  const float* src;
  const uint32_t* w;  // (ngroups, wn) words: phase group*G + e's row a at (a*G + e)*ws
  float* out;
  int H, W, py, px, qy, qx, base_y, base_x, nyb, nxb, kh, kw, kwk, ngroups;
  int ws;   // words of a weight row (kwk bf16): >= kwk / 2, even
  int wn;   // words of a phase group's weights: >= kh * G * ws, a multiple of 4
  int cw;   // words of a staged copy row
  int ch;   // rows a stage
  int swf;  // floats of a landing row: >= 2 * (words of a copy row A reads) + 4, 4k
};

// Blocks an SM: 5 four-phase blocks (the 4K -> 8K plan; faster than 4 on an
// H100), 4 one-phase ones (the tap-16 plans, slower at 5).
template <int WARPS, int G>
__global__ void __launch_bounds__(WARPS * 32, (G == 4 ? 20 : 16) / WARPS)
    fused_tc_kernel(const FusedTcArgs a) {
  constexpr int THREADS = WARPS * 32;
  constexpr int BJ = WARPS * kTcMW * 16;  // anchor columns of a block
  constexpr int C = kTcNT * 8 / G;        // anchor rows of a block
  constexpr int BJP = BJ + BJ / 32 + 1;
  extern __shared__ __align__(16) uint32_t tsm[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;  // groupID, threadID_in_group
  const int grp = blockIdx.z % a.ngroups, f = blockIdx.z / a.ngroups;
  const int i0 = blockIdx.y * C, j0 = blockIdx.x * BJ;
  const int row0 = a.base_y + a.qy * i0, col0 = a.base_x + a.qx * j0;
  const int nr = a.qy * (C - 1) + a.kh;              // window rows
  const int nw = (a.qx * (BJ - 1) + a.kwk + 1) / 2;  // words of a copy row that A reads
  const int rw = 2 * a.cw;
  const bool odd = (a.qx & 1) != 0;
  const int nst = (nr + a.ch - 1) / a.ch;  // stages of ch rows
  uint32_t* const wsm = tsm;
  float* const land = reinterpret_cast<float*>(tsm + a.wn);  // kTcLand stages of ch f32 rows
  uint32_t* const ring = tsm + a.wn + kTcLand * a.ch * a.swf;  // the current stage in bf16
  const float* const plane = a.src + static_cast<int64_t>(f) * a.H * a.W;

  const uint32_t* const wg = a.w + static_cast<int64_t>(grp) * a.wn;
  for (int v = t; v < a.wn / 4; v += THREADS) jt_cp_async16(wsm + 4 * v, wg + 4 * v);

  // Stage k's window rows, columns [0, 2nw], as f32 into landing buffer
  // k % kTcLand, zeros past the plane; one group a call, empty past the
  // last stage. Where rows are 16-byte aligned (W % 4 == 0) a landing row
  // starts at the aligned column at or left of col0 (window column 0 at
  // float dx) and lands in 16-byte copies; else in 4-byte ones (dx = 0).
  const int nsw = 2 * nw + 1;
  const bool vec = (a.W & 3) == 0 && col0 >= 0;
  const int dx = vec ? col0 & 3 : 0;
  auto issue = [&](int k) {
    if (k < nst) {
      const int r0 = k * a.ch, rows = min(nr, r0 + a.ch) - r0;
      float* const d = land + (k % kTcLand) * a.ch * a.swf;
      if (vec) {
        const int nq = (dx + nsw + 3) >> 2;  // 16-byte pieces of a row
        int r = t / nq, x = t - r * nq;
        for (int idx = t; idx < rows * nq; idx += THREADS) {
          const int y = row0 + r0 + r, xx = col0 - dx + 4 * x;
          const int bytes = static_cast<unsigned>(y) < static_cast<unsigned>(a.H)
                                ? 4 * max(0, min(4, a.W - xx)) : 0;
          jt_cp_async16z(d + r * a.swf + 4 * x,
                         bytes ? plane + static_cast<int64_t>(y) * a.W + xx : plane, bytes);
          for (x += THREADS; x >= nq; x -= nq) ++r;
        }
      } else {
        int r = t / nsw, x = t - r * nsw;
        for (int idx = t; idx < rows * nsw; idx += THREADS) {
          const int y = row0 + r0 + r, xx = col0 + x;
          const bool ok = static_cast<unsigned>(y) < static_cast<unsigned>(a.H) &&
                          static_cast<unsigned>(xx) < static_cast<unsigned>(a.W);
          jt_cp_async4(d + r * a.swf + x, ok ? plane + static_cast<int64_t>(y) * a.W + xx : plane,
                       ok);
          for (x += THREADS; x >= nsw; x -= nsw) ++r;
        }
      }
    }
    jt_cp_async_commit();
  };
  // Stage k landed, rounded to bfloat16 once, into the ring: word m of
  // copy 0 holds columns (2m, 2m + 1), of copy 1 (2m + 1, 2m + 2).
  auto convert = [&](int k) {
    const int n = (min(nr, k * a.ch + a.ch) - k * a.ch) * nw;
    const float* const l = land + (k % kTcLand) * a.ch * a.swf;
    int r = t / nw, m = t - r * nw;
    for (int idx = t; idx < n; idx += THREADS) {
      const float* const p = l + r * a.swf + dx + 2 * m;
      uint32_t* const d = ring + r * rw;
      d[m] = jt_pack_bf16(p[0], p[1]);
      if (odd) d[a.cw + m] = jt_pack_bf16(p[1], p[2]);
      for (m += THREADS; m >= nw; m -= nw) ++r;
    }
  };

  // The lane's A rows: anchors warp*32 + mw*16 + g (+ 8), window column
  // qx*j, a word of copy (qx*j) & 1.
  int aoff[kTcMW][2];
#pragma unroll
  for (int mw = 0; mw < kTcMW; ++mw)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = a.qx * (warp * 32 + mw * 16 + g + 8 * h);
      aoff[mw][h] = (x & 1) * a.cw + (x >> 1);
    }
  const int n16 = a.kwk >> 4;
  const bool tail8 = (a.kwk & 15) != 0;
  const bool last1 = (a.kw & 15) == 1;  // the tail is one tap: 8 rows' in one mma (note)
  float acc[kTcMW][kTcNT][4];
#pragma unroll
  for (int mw = 0; mw < kTcMW; ++mw)
#pragma unroll
    for (int n = 0; n < kTcNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mw][n][i] = 0.f;
  for (int k = 0; k + 1 < kTcLand; ++k) issue(k);  // the weights ride the first group
  for (int k = 0; k < nst; ++k) {
    issue(k + kTcLand - 1);           // into the buffer stage k - 1 left
    jt_cp_async_wait<kTcLand - 1>();  // stage k (and the weights) landed
    __syncthreads();                  // ... for every thread; stage k - 1's mmas done
    convert(k);
    __syncthreads();
    const int s1 = min(nr, (k + 1) * a.ch);
#pragma unroll 2
    for (int s = k * a.ch; s < s1; ++s) {
      const uint32_t* const row = ring + (s - k * a.ch) * rw;
      // n-tile n holds columns 8n .. 8n + 7 = (c, e) = (col / G, col % G);
      // the lane's B column 8n + g reads weight row (s - qy*c, e), zero
      // outside [0, kh). Every n-tile runs every row: branching around an
      // idle one kept the next one's loads from issuing before its mmas.
      bool bok[kTcNT];
      const uint32_t* bp[kTcNT];
#pragma unroll
      for (int n = 0; n < kTcNT; ++n) {
        const int col = 8 * n + g, ar = s - a.qy * (col / G);
        bok[n] = static_cast<unsigned>(ar) < static_cast<unsigned>(a.kh);
        bp[n] = wsm + ((bok[n] ? ar : 0) * G + col % G) * a.ws;
      }
      for (int q = 0; q < n16; ++q) {
        const int o = 8 * q + 2 * tq;  // lane tq's taps 16q + 4tq .. + 3
        uint32_t af[kTcMW][4];
#pragma unroll
        for (int mw = 0; mw < kTcMW; ++mw) {
          af[mw][0] = row[aoff[mw][0] + o];
          af[mw][1] = row[aoff[mw][1] + o];
          af[mw][2] = row[aoff[mw][0] + o + 1];
          af[mw][3] = row[aoff[mw][1] + o + 1];
        }
        uint2 bf[kTcNT];
#pragma unroll
        for (int n = 0; n < kTcNT; ++n)
          bf[n] = bok[n] ? *reinterpret_cast<const uint2*>(bp[n] + o) : make_uint2(0u, 0u);
#pragma unroll
        for (int n = 0; n < kTcNT; ++n)
#pragma unroll
          for (int mw = 0; mw < kTcMW; ++mw)
            jt_mma_k16(acc[mw][n], af[mw][0], af[mw][1], af[mw][2], af[mw][3], bf[n].x, bf[n].y);
      }
      if (tail8 && !last1) {
        const int o = 8 * n16 + tq;  // taps 16 n16 + 2tq, + 1
        uint32_t af[kTcMW][2];
#pragma unroll
        for (int mw = 0; mw < kTcMW; ++mw) {
          af[mw][0] = row[aoff[mw][0] + o];
          af[mw][1] = row[aoff[mw][1] + o];
        }
        uint32_t bf[kTcNT];
#pragma unroll
        for (int n = 0; n < kTcNT; ++n) bf[n] = bok[n] ? bp[n][o] : 0u;
#pragma unroll
        for (int n = 0; n < kTcNT; ++n)
#pragma unroll
          for (int mw = 0; mw < kTcMW; ++mw) jt_mma_k8(acc[mw][n], af[mw][0], af[mw][1], bf[n]);
      }
    }
    if (last1) {  // the last tap of 8 stage rows in one k8 mma: k = row r0 + k
      const int o = 8 * n16;  // its word in a row: the low half, in the copy of the anchor's parity
      for (int r0 = k * a.ch; r0 < s1; r0 += 8) {
        uint32_t af[kTcMW][2];
#pragma unroll
        for (int mw = 0; mw < kTcMW; ++mw)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t v[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = r0 + 2 * tq + i;  // no row past the stage
              v[i] = r < s1 ? ring[(r - k * a.ch) * rw + aoff[mw][h] + o] : 0u;
            }
            af[mw][h] = __byte_perm(v[0], v[1], 0x5410);
          }
#pragma unroll
        for (int n = 0; n < kTcNT; ++n) {
          const int col = 8 * n + g;
          uint32_t v[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int ar = r0 + 2 * tq + i - a.qy * (col / G);
            v[i] = static_cast<unsigned>(ar) < static_cast<unsigned>(a.kh)
                       ? wsm[(ar * G + col % G) * a.ws + o] : 0u;
          }
          const uint32_t b = __byte_perm(v[0], v[1], 0x5410);
#pragma unroll
          for (int mw = 0; mw < kTcMW; ++mw) jt_mma_k8(acc[mw][n], af[mw][0], af[mw][1], b);
        }
      }
    }
  }
  __syncthreads();  // every warp's mmas done: the tile overlays the landing rows and the ring

  // Fragments -> the tile: d0 anchor g column 2tq, d1 column 2tq + 1, d2
  // and d3 anchor g + 8.
  float* const tile = land;
#pragma unroll
  for (int mw = 0; mw < kTcMW; ++mw)
#pragma unroll
    for (int n = 0; n < kTcNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jj = warp * 32 + mw * 16 + g + 8 * (i >> 1);
        const int col = 8 * n + 2 * tq + (i & 1);
        tile[col * BJP + jj + (jj >> 5)] = acc[mw][n][i];
      }
  __syncthreads();
  write_tile<THREADS, BJ, C, G>(tile, a.out, t, f, grp, i0, j0, a.py, a.px, a.nyb, a.nxb);
}

template <int WARPS, int G>
cudaError_t tc_launch(const FusedTcArgs& a, int F, cudaStream_t stream) {
  constexpr int BJ = WARPS * kTcMW * 16;
  constexpr int C = kTcNT * 8 / G;
  constexpr int BJP = BJ + BJ / 32 + 1;
  const size_t rows = static_cast<size_t>(a.ch) * (kTcLand * a.swf + 2 * a.cw), tile = C * G * BJP;
  const size_t smem = (static_cast<size_t>(a.wn) + (rows > tile ? rows : tile)) * sizeof(uint32_t);
  cudaError_t err = jt_allow_smem(fused_tc_kernel<WARPS, G>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nxb + BJ - 1) / BJ, (a.nyb + C - 1) / C, F * a.ngroups);
  fused_tc_kernel<WARPS, G><<<grid, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- precision='wsplit3': the weight-split kernel (header note).

constexpr int kWsMw = 2;    // m-tiles (16 anchor columns each) a warp (kernels/fused.py WS3_MW)
constexpr int kWsNs = 2;    // bf16 stages of the ring (WS3_NS): one read while the next is rounded
constexpr int kWsLand = 2;  // f32 stages landing (WS3_LAND): one rounded while the next lands

struct FusedWsArgs {
  const float* src;
  const uint32_t* w;  // (ngroups, 3, wn) words (kernels/fused.py ws3_weights)
  float* out;
  int F, H, W, py, px, qy, qx, base_y, base_x, nyb, nxb, kh, kw, ngroups;
  int nq16;      // k16 chunks of a row
  int k8;        // one k8 chunk past them (1 to 8 taps left)
  int last1;     // one tap past them: the packed tail
  int lq, lp;    // kernel rows of a residue, zero slots padding it (kernels/fused.py weight_row)
  int rows;      // weight rows of a chunk: R0(s) + c*G + e; the last zeros
  int wn;        // words of one part
  int cw;        // words of a staged bf16 copy row
  int swf;       // floats of a landing row
  int ch;        // window rows a stage: 8 with the packed tail (its 8 rows)
  int fb;        // frames a block, one after another
};

// WARPS warps. Blocks an SM of 4 warps: 5 with four phases (at most 102
// registers a thread), 4 with one. WG: the products as wgmma, the block's 4
// warps one warpgroup, B from the padded weight rows (lp = 8 / G - 1).
template <int WARPS, int G, bool WG>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 ? (G == 4 ? 5 : 4) : 16)
    fused_ws3_kernel(const FusedWsArgs a) {
  static_assert(!WG || WARPS == 4, "a wgmma takes one warpgroup");
  constexpr int THREADS = WARPS * 32;
  constexpr int NT = kTcNT;  // n-tiles of 8 (anchor row, phase) pairs
  constexpr int C = NT * 8 / G;
  constexpr int CPT = 8 / G;  // anchor rows an n-tile
  constexpr int BJ = WARPS * kWsMw * 16;
  extern __shared__ __align__(16) uint32_t tsm[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;  // groupID, threadID_in_group
  const int grp = blockIdx.z % a.ngroups, f0 = blockIdx.z / a.ngroups * a.fb;
  const int i0 = blockIdx.y * C, j0 = blockIdx.x * BJ;
  const int row0 = a.base_y + a.qy * i0, col0 = a.base_x + a.qx * j0;
  const int nr = a.qy * (C - 1) + a.kh;  // window rows
  const int nst = (nr + a.ch - 1) / a.ch;  // stages a frame
  const int nu = min(a.fb, a.F - f0) * nst;  // stages of the block's frames
  const int nk8 = 2 * a.nq16 + a.k8;
  const int nw = (a.qx * (BJ - 1) + 16 * a.nq16 + 8 * (a.k8 | a.last1) + 1) / 2;  // words A reads
  const int rw = 2 * a.cw;
  const int tabw = (nr + 4) / 4 * 4;  // words of each row table: nr + 1 entries
  uint32_t* const wsm = tsm;                                 // three parts of wn words
  int* const r0t = reinterpret_cast<int*>(tsm + 3 * a.wn);  // each staged row's R0(s)
  int* const spt = r0t + tabw;  // and its live n-tiles (kernels/fused.py live_tiles)
  float* const land = reinterpret_cast<float*>(spt + tabw);  // kWsLand stages of f32 rows
  uint32_t* const ring = reinterpret_cast<uint32_t*>(land + kWsLand * a.ch * a.swf);  // bf16 rows

  const uint32_t* const wg = a.w + static_cast<int64_t>(grp) * 3 * a.wn;
  for (int v = t; v < 3 * a.wn / 4; v += THREADS) jt_cp_async16(wsm + 4 * v, wg + 4 * v);
  jt_cp_async_commit();
  // The rows' tables, once a block (the divisions by qy off the products'
  // path): the weight row of anchor row 0, phase 0 (kernels/fused.py
  // weight_row: R(s - qy*c, e) = R0(s) + c*G + e where 0 <= s - qy*c < kh),
  // and the live n-tiles [cmin / CPT, cmax / CPT] as lo*NT + hi (NT where no
  // anchor row c reads the row: cmin..cmax those with 0 <= s - qy*c < kh).
  for (int s = t; s <= nr; s += THREADS) {
    r0t[s] = ((s % a.qy) * (a.lq + a.lp) + a.lp + a.lq - 1 - s / a.qy) * G;
    const int cmin = s - a.kh + 1 <= 0 ? 0 : (s - a.kh + a.qy) / a.qy;
    const int cmax = min(C - 1, s / a.qy);
    spt[s] = cmin > cmax ? NT : (cmin / CPT) * NT + cmax / CPT;
  }

  // Stage u (frame f0 + u / nst, window rows from (u % nst) * ch), columns
  // [0, 2nw] from col0, as f32 into landing stage u % kWsLand, zeros past
  // the plane: 16-byte copies from the aligned column at or left of col0
  // (window column 0 at float dx) where rows are 16-byte aligned, else
  // 4-byte ones (dx = 0). One group a call, empty past the last stage.
  const int nsw = 2 * nw + 1;
  const bool vec = (a.W & 3) == 0 && col0 >= 0;
  const int dx = vec ? col0 & 3 : 0;
  auto issue = [&](int u) {
    if (u < nu) {
      const float* const plane = a.src + static_cast<int64_t>(f0 + u / nst) * a.H * a.W;
      const int r0 = u % nst * a.ch, rows = min(nr, r0 + a.ch) - r0;
      float* const d = land + (u % kWsLand) * a.ch * a.swf;
      if (vec) {
        const int nq = (dx + nsw + 3) >> 2;  // 16-byte pieces of a row
        int r = t / nq, x = t - r * nq;
        for (int idx = t; idx < rows * nq; idx += THREADS) {
          const int y = row0 + r0 + r, xx = col0 - dx + 4 * x;
          const int bytes = static_cast<unsigned>(y) < static_cast<unsigned>(a.H)
                                ? 4 * max(0, min(4, a.W - xx)) : 0;
          jt_cp_async16z(d + r * a.swf + 4 * x,
                         bytes ? plane + static_cast<int64_t>(y) * a.W + xx : plane, bytes);
          for (x += THREADS; x >= nq; x -= nq) ++r;
        }
      } else {
        int r = t / nsw, x = t - r * nsw;
        for (int idx = t; idx < rows * nsw; idx += THREADS) {
          const int y = row0 + r0 + r, xx = col0 + x;
          const bool ok = static_cast<unsigned>(y) < static_cast<unsigned>(a.H) &&
                          static_cast<unsigned>(xx) < static_cast<unsigned>(a.W);
          jt_cp_async4(d + r * a.swf + x, ok ? plane + static_cast<int64_t>(y) * a.W + xx : plane,
                       ok);
          for (x += THREADS; x >= nsw; x -= nsw) ++r;
        }
      }
    }
    jt_cp_async_commit();
  };
  // Stage u landed, rounded to bfloat16 once (two values an instruction,
  // exact for u8 values) into ring stage u % kWsNs: word m of copy 0 holds
  // columns (2m, 2m + 1), of copy 1 (2m + 1, 2m + 2) (copy 1 for odd qx
  // alone, whose anchors start at both parities).
  const bool odd = (a.qx & 1) != 0;
  auto convert = [&](int u) {
    if (u >= nu) return;
    const int r0 = u % nst * a.ch, n = (min(nr, r0 + a.ch) - r0) * nw;
    const float* const l = land + (u % kWsLand) * a.ch * a.swf + dx;
    uint32_t* const d = ring + (u % kWsNs) * a.ch * rw;
    int r = t / nw, m = t - r * nw;
    for (int idx = t; idx < n; idx += THREADS) {
      const float* const p = l + r * a.swf + 2 * m;
      const float v0 = p[0], v1 = p[1];
      d[r * rw + m] = jt_bf162_bits(__floats2bfloat162_rn(v0, v1));
      if (odd) d[r * rw + a.cw + m] = jt_bf162_bits(__floats2bfloat162_rn(v1, p[2]));
      for (m += THREADS; m >= nw; m -= nw) ++r;
    }
  };

  // The lane's A rows: anchors warp*kWsMw*16 + mw*16 + g
  // (+ 8), window column qx*j, a word of copy (qx*j) & 1.
  int aoff[kWsMw][2];
#pragma unroll
  for (int mw = 0; mw < kWsMw; ++mw)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = a.qx * (warp * kWsMw * 16 + mw * 16 + g + 8 * h);
      aoff[mw][h] = (x & 1) * a.cw + (x >> 1);
    }
  float acc[kWsMw][NT][4];
  // The word of the weight row that column col of an n-tile reads for
  // staged row s (R0(s) = r0s), or of the zero row (kernels/fused.py b_row).
  auto b_word = [&](int s, int r0s, int col) {
    const int ar = s - a.qy * (col / G);
    return 4 * (static_cast<unsigned>(ar) < static_cast<unsigned>(a.kh) ? r0s + col : a.rows - 1);
  };
  // ldmatrix rows: lane L reads row L % 8 of matrix L / 8; matrices 0 | 1
  // (and 2 | 3) are the two 8-tap halves of a k16 chunk, of n-tiles n (and
  // n + 1): column 8n + lcol of the lane, chunk half lk.
  const int lcol = 8 * (lane >> 4) + (lane & 7), lk = 4 * a.rows * ((lane >> 3) & 1);

  // The products of staged rows [s0, s1) with n-tiles LO..HI, the n-tiles
  // whose anchor rows read them (kernels/fused.py live_tiles): for each
  // k16 chunk, the A fragments once, then per weight part the B fragments
  // of the n-tiles (one ldmatrix a pair) and an mma per m-tile and n-tile.
  // WG: staged rows [s0, s1) whose anchor rows reach all 4 n-tiles, as
  // wgmma m64n32k16 (one D shape: wgmmas of several shapes on the same
  // accumulators were serialized by ptxas). A step is a row's k16 chunk (a
  // k8 chunk as a k16 one, its second A half zeros): its A fragments, then
  // per weight part and m-tile one wgmma, B the core matrices at R0(s) (a
  // column whose kernel row is outside [0, kh) reads a padded zero row).
  // Each step waits for its products (two sets of A registers, a step's
  // loads overlapping the previous step's products, were slower on an H100).
  const unsigned wsa = jt_smem_addr(wsm);
  auto run_wg = [&](const uint32_t* st, int r0, int s0, int s1) {
    for (int s = s0; s < s1; ++s) {
      const uint32_t* const row = st + (s - r0) * rw;
      for (int q = 0; q < a.nq16 + a.k8; ++q) {
        const bool k8 = q == a.nq16;
        const int o = 8 * q + tq;
        uint32_t af[kWsMw][4];
#pragma unroll
        for (int mw = 0; mw < kWsMw; ++mw) {
          af[mw][0] = row[aoff[mw][0] + o];
          af[mw][1] = row[aoff[mw][1] + o];
          af[mw][2] = k8 ? 0u : row[aoff[mw][0] + o + 4];
          af[mw][3] = k8 ? 0u : row[aoff[mw][1] + o + 4];
        }
        const unsigned bq = wsa + 16u * r0t[s] + 32u * q * a.rows;
        const unsigned lbo = k8 ? 0u : 16u * a.rows;
        jt_wgmma_fence();
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int mw = 0; mw < kWsMw; ++mw)
            jt_wgmma_m64n32k16(acc[mw], af[mw], jt_gmma_desc(bq + 4u * p * a.wn, lbo, 128u));
        jt_wgmma_commit();
        jt_wgmma_wait<0>();
      }
    }
#pragma unroll
    for (int mw = 0; mw < kWsMw; ++mw)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) jt_fence_operand(acc[mw][n][i]);
  };
  auto run = [&](auto lo_c, auto hi_c, const uint32_t* st, int r0, int s0, int s1) {
    constexpr int LO = decltype(lo_c)::value, HI = decltype(hi_c)::value;
    for (int s = s0; s < s1; ++s) {
      const uint32_t* const row = st + (s - r0) * rw;
      const int r0s = r0t[s];
      int bw[NT];  // the lane's weight row word of each pair of n-tiles from n
#pragma unroll
      for (int n = LO; n <= HI; n += 2) bw[n] = b_word(s, r0s, 8 * n + lcol) + lk;
      for (int q = 0; q < a.nq16; ++q) {
        const int o = 8 * q + tq;  // taps 16q + 2tq, + 1 (a0, a1); + 8 (a2, a3)
        uint32_t af[kWsMw][4];
#pragma unroll
        for (int mw = 0; mw < kWsMw; ++mw) {
          af[mw][0] = row[aoff[mw][0] + o];
          af[mw][1] = row[aoff[mw][1] + o];
          af[mw][2] = row[aoff[mw][0] + o + 4];
          af[mw][3] = row[aoff[mw][1] + o + 4];
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const uint32_t* const bq = wsm + p * a.wn + 8 * q * a.rows;
          uint32_t bf[NT][2];
#pragma unroll
          for (int n = LO; n <= HI; n += 2) {
            if (n + 1 <= HI) {
              uint32_t r[4];
              jt_ldsm_x4(r, bq + bw[n]);
              bf[n][0] = r[0];
              bf[n][1] = r[1];
              bf[n + 1][0] = r[2];
              bf[n + 1][1] = r[3];
            } else {
              jt_ldsm_x2(bf[n], bq + bw[n]);
            }
          }
#pragma unroll
          for (int n = LO; n <= HI; ++n)
#pragma unroll
            for (int mw = 0; mw < kWsMw; ++mw)
              jt_mma_k16(acc[mw][n], af[mw][0], af[mw][1], af[mw][2], af[mw][3], bf[n][0],
                         bf[n][1]);
        }
      }
      if (a.k8) {  // taps 16 nq16 .. + 7: one 8-tap matrix an n-tile
        const int o = 8 * a.nq16 + tq;
        uint32_t af[kWsMw][2];
#pragma unroll
        for (int mw = 0; mw < kWsMw; ++mw) {
          af[mw][0] = row[aoff[mw][0] + o];
          af[mw][1] = row[aoff[mw][1] + o];
        }
        // matrix L / 8 is n-tile LO + L / 8 (the last n-tile again past HI)
        const int lt = LO + min(lane >> 3, HI - LO);
        const uint32_t* const b8 = wsm + b_word(s, r0s, 8 * lt + (lane & 7)) + 8 * a.nq16 * a.rows;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          uint32_t r[4];
          jt_ldsm_x4(r, b8 + p * a.wn);
#pragma unroll
          for (int n = LO; n <= HI; ++n)
#pragma unroll
            for (int mw = 0; mw < kWsMw; ++mw)
              jt_mma_k8(acc[mw][n], af[mw][0], af[mw][1], r[n - LO]);
        }
      }
    }
  };
  auto step = [&](auto lo_c, auto hi_c, const uint32_t* st, int r0, int s0, int s1) {
    if constexpr (WG && decltype(lo_c)::value == 0 && decltype(hi_c)::value == NT - 1) {
      run_wg(st, r0, s0, s1);
    } else {
      run(lo_c, hi_c, st, r0, s0, s1);
    }
  };
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I3 = std::integral_constant<int, 3>;
  static_assert(NT == 4, "the live n-tile ranges below are those of 4 n-tiles");

  const uint16_t* const col16 = reinterpret_cast<const uint16_t*>(wsm) + 8 * nk8 * a.rows;
  const int64_t wout = static_cast<int64_t>(a.px) * a.nxb;
  const bool pairs = G % 2 == 0 && a.px % 2 == 0;
  // The pipeline, one barrier a stage. At iteration u, after the barrier
  // (stage u + 1 landed and stage u rounded, for every thread; ring stage
  // (u + 1) % 2 read by every warp), stage u + 2 starts landing into the
  // landing stage that stage u left, stage u + 1 is rounded into the ring,
  // and stage u is computed.
  issue(0);
  issue(1);
  jt_cp_async_wait<1>();  // the weights and stage 0
  if constexpr (WG) jt_fence_proxy_async();  // the weights, read by wgmma
  __syncthreads();  // the weights, the row tables and stage 0 landed for every thread
  convert(0);
  for (int u = 0; u < nu; ++u) {
    const int k = u % nst, slot = u % kWsNs;
    jt_cp_async_wait<0>();  // stage u + 1 landed (this thread's copies)
    __syncthreads();        // ... for every thread; stage u rounded; ring stage u - 1 read
    issue(u + 2);           // into the landing stage stage u left
    convert(u + 1);         // into the ring stage stage u - 1 left
    if (k == 0) {
#pragma unroll
      for (int mw = 0; mw < kWsMw; ++mw)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mw][n][i] = 0.f;
    }
    const uint32_t* const st = ring + slot * a.ch * rw;
    const int r0 = k * a.ch, r1 = min(nr, r0 + a.ch);
    for (int s = r0; s < r1;) {  // runs of rows with the same live n-tiles
      const int span = spt[s];
      int e = s + 1;
      while (e < r1 && spt[e] == span) ++e;
      switch (span) {
        case 0 * NT + 0: step(I0{}, I0{}, st, r0, s, e); break;
        case 0 * NT + 1: step(I0{}, I1{}, st, r0, s, e); break;
        case 0 * NT + 2: step(I0{}, I2{}, st, r0, s, e); break;
        case 0 * NT + 3: step(I0{}, I3{}, st, r0, s, e); break;
        case 1 * NT + 1: step(I1{}, I1{}, st, r0, s, e); break;
        case 1 * NT + 2: step(I1{}, I2{}, st, r0, s, e); break;
        case 1 * NT + 3: step(I1{}, I3{}, st, r0, s, e); break;
        case 2 * NT + 2: step(I2{}, I2{}, st, r0, s, e); break;
        case 2 * NT + 3: step(I2{}, I3{}, st, r0, s, e); break;
        case 3 * NT + 3: step(I3{}, I3{}, st, r0, s, e); break;
        default: break;  // no anchor row reads these rows
      }
      s = e;
    }
    if (a.last1) {  // the last tap of the stage's 8 rows in one k8 mma: k = row r0 + k
      const int o = 8 * a.nq16;  // its word in a row: the low half, in the copy of the anchor's parity
      const int ra = r0 + 2 * tq;  // the lane's rows ra, ra + 1 (none past the window)
      uint32_t af[kWsMw][2];
#pragma unroll
      for (int mw = 0; mw < kWsMw; ++mw)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v0 = ra < r1 ? st[(ra - r0) * rw + aoff[mw][h] + o] : 0u;
          const uint32_t v1 = ra + 1 < r1 ? st[(ra + 1 - r0) * rw + aoff[mw][h] + o] : 0u;
          af[mw][h] = __byte_perm(v0, v1, 0x5410);
        }
      const int rb0 = r0t[ra], rb1 = r0t[ra + 1];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = 8 * n + g;  // (anchor row col / G, phase col % G)
          const int ar = ra - a.qy * (col / G);
          const uint16_t* const cp = col16 + 2 * p * a.wn + col;
          const uint32_t v0 = static_cast<unsigned>(ar) < static_cast<unsigned>(a.kh) ? cp[rb0] : 0u;
          const uint32_t v1 =
              static_cast<unsigned>(ar + 1) < static_cast<unsigned>(a.kh) ? cp[rb1] : 0u;
          const uint32_t b = v0 | v1 << 16;
#pragma unroll
          for (int mw = 0; mw < kWsMw; ++mw) jt_mma_k8(acc[mw][n], af[mw][0], af[mw][1], b);
        }
    }
    if (k + 1 < nst) continue;
    // The frame's sums straight to the output: d0 (anchor g, column 2tq),
    // d1 (g, 2tq + 1), d2 and d3 anchor g + 8; column (c, e) = (col / G, col
    // % G), phase grp*G + e at output row py*(i0 + c) + ph / px, column
    // px*j + ph % px. Where G and px are even, columns 2tq and 2tq + 1 are
    // neighbouring output pixels: one 8-byte store.
    float* const outf = a.out + static_cast<int64_t>(f0 + u / nst) * a.py * a.nyb * wout;
#pragma unroll
    for (int mw = 0; mw < kWsMw; ++mw)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + warp * kWsMw * 16 + mw * 16 + g + 8 * h;
        if (j >= a.nxb) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = 8 * n + 2 * tq, c = col / G;
          if (i0 + c >= a.nyb) continue;
          const int ph = grp * G + col % G;
          float* const o = outf + static_cast<int64_t>(a.py * (i0 + c) + ph / a.px) * wout +
                           static_cast<int64_t>(a.px) * j + ph % a.px;
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(acc[mw][n][2 * h], acc[mw][n][2 * h + 1]);
          } else {
            o[0] = acc[mw][n][2 * h];
            const int col1 = col + 1, c1 = col1 / G, ph1 = grp * G + col1 % G;
            if (i0 + c1 < a.nyb)
              outf[static_cast<int64_t>(a.py * (i0 + c1) + ph1 / a.px) * wout +
                   static_cast<int64_t>(a.px) * j + ph1 % a.px] = acc[mw][n][2 * h + 1];
          }
        }
      }
  }
}

template <int WARPS, int G, bool WG = false>
cudaError_t ws3_launch(const FusedWsArgs& a, cudaStream_t stream) {
  constexpr int BJ = WARPS * kWsMw * 16;
  constexpr int C = kTcNT * 8 / G;
  const int nr = a.qy * (C - 1) + a.kh;
  const size_t smem = (3 * static_cast<size_t>(a.wn) + 2 * ((nr + 4) / 4 * 4) +
                       static_cast<size_t>(a.ch) * (kWsLand * a.swf + kWsNs * 2 * a.cw)) *
                      sizeof(uint32_t);
  cudaError_t err = jt_allow_smem(fused_ws3_kernel<WARPS, G, WG>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nxb + BJ - 1) / BJ, (a.nyb + C - 1) / C, (a.F + a.fb - 1) / a.fb * a.ngroups);
  fused_ws3_kernel<WARPS, G, WG><<<grid, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// src (F, H, W) f32; w (ngroups, kh, kwp, g) f32, phase ph = group*g + e's
// kernel at [group, :, :kw, e], zeros beyond kw; out (F, py*nyb, px*nxb)
// f32. All contiguous. ch/slots/swp: the ring (kernels/fused.py layout).
// (tx, r, cg): the shape, one of kernels/fused.py SHAPES.
extern "C" int jt_fused_interior(const float* src, const float* w, float* out, int F, int H,
                                 int W, int py, int px, int qy, int qx, int base_y, int base_x,
                                 int nyb, int nxb, int kh, int kw, int kwp, int g, int ngroups,
                                 int ch, int slots, int swp, int tx, int r, int cg,
                                 cudaStream_t stream) {
  if (g * ngroups != py * px || ch < 1 || slots < 1 || kwp % 4 != 0 || swp % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{src, w, out, H, W, py, px, qy, qx, base_y, base_x, nyb, nxb,
                    kh, kw, kwp, ngroups, ch, slots, swp};
#define JT_SHAPE(TX, R, CG) \
  if (tx == TX && r == R && cg == CG)  \
    return static_cast<int>(launch_shape<TX, R, CG>(a, F, g, stream));
  JT_SHAPE(128, 4, 8)
  JT_SHAPE(32, 4, 8)
#undef JT_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

// precision='bf16', the tensor-core kernel. w (ngroups, wn) words of bf16
// weights (kernels/fused.py tc_weights: phase group*g + e's kernel row a at
// word (a*g + e)*ws, kwk = the k-slots of kw, zeros beyond kw); the rest as
// above. (ws, wn, cw, ch, swf): kernels/fused.py tc_layout; warps: 4 or 1
// (SHAPES' 128 or 32 threads).
extern "C" int jt_fused_interior_bf16(const float* src, const void* w, float* out, int F, int H,
                                      int W, int py, int px, int qy, int qx, int base_y,
                                      int base_x, int nyb, int nxb, int kh, int kw, int kwk,
                                      int g, int ngroups, int ws, int wn, int cw, int ch,
                                      int swf, int warps, cudaStream_t stream) {
  if (g * ngroups != py * px || ch < 1 || swf % 4 != 0 || kwk % 8 != 0 || kwk < kw ||
      kwk - kw >= 16 || ws % 2 != 0 || 2 * ws < kwk || wn % 4 != 0 || wn < kh * g * ws)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedTcArgs a{src, static_cast<const uint32_t*>(w), out, H, W, py, px, qy, qx, base_y,
                      base_x, nyb, nxb, kh, kw, kwk, ngroups, ws, wn, cw, ch, swf};
  if (warps == 4 && g == 4) return static_cast<int>(tc_launch<4, 4>(a, F, stream));
  if (warps == 4 && g == 1) return static_cast<int>(tc_launch<4, 1>(a, F, stream));
  if (warps == 1 && g == 4) return static_cast<int>(tc_launch<1, 4>(a, F, stream));
  if (warps == 1 && g == 1) return static_cast<int>(tc_launch<1, 1>(a, F, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

// precision='wsplit3', the weight-split kernel: w (ngroups, 3, wn) words,
// the three bfloat16 parts of each phase group's weights in the layout of
// kernels/fused.py ws3_weights (nq16, k8, last1, lq, rows, wn, cw, swf, ch:
// ws3_layout); fb frames a block, one after another (ws3_frames); warps:
// 4 or 1 (SHAPES' 128 or 32 threads); the rest as above.
extern "C" int jt_fused_interior_wsplit3(const float* src, const void* w, float* out, int F,
                                         int H, int W, int py, int px, int qy, int qx,
                                         int base_y, int base_x, int nyb, int nxb, int kh, int kw,
                                         int g, int ngroups, int nq16, int k8, int last1,
                                         int lq, int lp, int rows, int wn, int cw, int swf,
                                         int ch, int fb, int warps, cudaStream_t stream) {
  const int kslots = 16 * nq16 + 8 * (k8 | last1);
  if (g * ngroups != py * px || swf % 4 != 0 || cw % 32 != 16 || fb < 1 || kslots < kw ||
      kslots - kw >= 16 || (k8 && last1) || ch < 1 || (last1 && ch != 8) || lq * qy < kh ||
      (lp != 0 && lp != 8 / g - 1) || rows != (qy * (lq + lp) + lp) * g + 1 ||
      wn % 4 != 0 ||
      wn < 4 * (2 * nq16 + k8) * rows + last1 * (rows + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedWsArgs a{src, static_cast<const uint32_t*>(w), out, F, H, W, py, px, qy, qx,
                      base_y, base_x, nyb, nxb, kh, kw, ngroups, nq16, k8, last1, lq, lp,
                      rows, wn, cw, swf, ch, fb};
  if (warps == 4 && g == 4 && lp) return static_cast<int>(ws3_launch<4, 4, true>(a, stream));
  if (warps == 4 && g == 1 && lp) return static_cast<int>(ws3_launch<4, 1, true>(a, stream));
  if (warps == 4 && g == 4) return static_cast<int>(ws3_launch<4, 4>(a, stream));
  if (warps == 4 && g == 1) return static_cast<int>(ws3_launch<4, 1>(a, stream));
  if (warps == 1 && g == 4) return static_cast<int>(ws3_launch<1, 4>(a, stream));
  if (warps == 1 && g == 1) return static_cast<int>(ws3_launch<1, 1>(a, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
