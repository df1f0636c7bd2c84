// Full-width top/bottom border strips against host-verified anchor blocks.
//
// Replaces jincresize_tpu/kernels/pallas_strips.py::_strips_kernel (built by
// make_strips_interior). Strip si's rows m read source window rows from
// row0[si][m] on, and its blocks repeat with the interior's column phase
// pattern, so strip si row m, column px*j + rx of the pattern-covered range is
//
//   out[f, si, m, px*j + rx] =
//     sum_{ly, lx < fs} src[f, row0[si][m] + ly, base_x + offs_x[rx] + qx*j + lx]
//                       * anchors[si, m, rx][ly, lx]
//
// summed as one fmaf chain in (ly, lx) order. The rows of one strip share
// one source band, rows [row_min, row_min + nb) with nb = fs + max(row0 -
// row_min): the host (kernels/strips.py make_strips) writes each row's taps
// into that band at its own offset, zeros elsewhere, as
//
//   w[si, rx, rb, k, lx, mm] = anchors[si, m, rx][k - (row0[si][m] - row_min), lx]
//
// for row m = rb*rbr + mm, so every row of a strip runs over the same band
// rows k; a zero weight adds nothing, and each pixel still sums its taps in
// (ly, lx) order. Reads past the plane are zeros; make_strips declines an
// operator with a nonzero weight on a window row outside the source, where
// the reference clamps.
//
// What bounds it: fp32 FMA issue. 4K->1080p tap 16 is 255 M FMAs a frame
// (7.6 us at 67 TFLOP/s) against 1.3 MB of bytes; 4K->8K tap 8 70.7 M FMAs
// (2.1 us). The kernel it replaces computed one pixel a thread, two loads an
// FMA (the source from L1/L2, the weight from shared memory), each strip
// row in its own blocks, so the same source band was read again for every
// row. This one keeps loads rare beside the FMAs:
//
// * A block takes a tile of 128 anchor columns j of one phase rx, rbr strip
//   rows of one strip (one warp each 4 rows), one frame. Its source band
//   (nb rows by qx*127 + fs columns) and the band rows' weights (fs * rbr
//   floats a row) stream through shared memory once, `ch` band rows a stage,
//   double-buffered with cp.async (zero-filled past the plane). Staged rows
//   are padded by 4 floats every 32 so the lanes' 16-byte loads of windows
//   qx*4 floats apart hit distinct banks.
// * A thread holds 4 consecutive anchors j of its warp's 4 rows: 16
//   accumulators. For each staged band row and chunk of 8 taps it loads its
//   register window (qx*3 + 8 values, in 16-byte loads) once, and for each
//   tap one 16-byte load at one address for the whole warp (a broadcast)
//   brings the 4 rows' weights: 3-5 window and 8 weight loads for 128 FMAs,
//   all issued before the chunk's FMAs. The rows of a strip share every
//   source value, whatever their starts.
// * The accumulators go through shared memory (the ring, reused) so that
//   each store instruction writes 32 consecutive anchors of one row.
//
// On the card it runs at about a quarter of the FMA bound at 4K->1080p tap
// 16 and a sixth at 4K->8K (PERF.md section 6): the FMAs wait on shared
// memory, where a 16-byte load takes the SM's pipe 4 cycles even as a
// broadcast. Forms with 8 anchors a thread, or with the next chunk's loads
// in a register double buffer, were not faster there.
//
// qx = 1, 2 and 3 are compile-time, so the register window is indexed
// statically; other qx load one anchor's taps at a time. The arithmetic
// that sizes a block's staged row and ring is mirrored in kernels/strips.py
// (layout) and tested there.
//
// TPU workarounds dropped: the residue planes and the 0/1 scatter-matmul
// phase interleave (a thread reads strided columns from registers, stores
// go straight to interleaved columns), the K-packing of taps, the padding of
// rows to multiples of 8 and the VMEM gate px * round_up(fs, 8) <= 120.
#include "common.cuh"

namespace {

constexpr int kR = 4;        // anchors a thread (kernels/strips.py ANCHORS)
constexpr int kRows = 4;     // strip rows a warp (kernels/strips.py ROWS)
constexpr int kChunk = 8;    // taps of a register window (kernels/strips.py CHUNK)
constexpr int kBJ = 32 * kR; // anchor columns a block (kernels/strips.py TILE)

struct StripsArgs {
  const float* src;
  const float* w;
  const int* info;
  const int* offs_x;
  float* out;
  int H, W, n_strips, ny_max, px, qx, base_x, nxb, fs, nb_max, rbr, nrb, ch, swp;
};

// Physical offset of window column x in a staged row (kernels/strips.py _skew).
__device__ __forceinline__ int skew(int x) { return x + 4 * (x >> 5); }

__device__ __forceinline__ void fma_rows(float v, const float4 w, int r,
                                         float (&acc)[kRows][kR]) {
  acc[0][r] = fmaf(v, w.x, acc[0][r]);
  acc[1][r] = fmaf(v, w.y, acc[1][r]);
  acc[2][r] = fmaf(v, w.z, acc[2][r]);
  acc[3][r] = fmaf(v, w.w, acc[3][r]);
}

// Floats of a thread's register window: taps [b0, b0 + 8) of its 4 anchors
// qx apart, rounded up to whole 16-byte loads.
template <int QX>
constexpr int kWin = (QX * (kR - 1) + kChunk + 3) / 4 * 4;

// One register-window chunk: the thread's window for taps [b0, b0 + 8) of
// its 4 anchors (16-byte loads), and the 8 taps' weights of the warp's 4
// rows (one broadcast 16-byte load a tap), all issued before any FMA.
template <int QX>
__device__ __forceinline__ void load_chunk(const float* __restrict__ row,
                                           const float* __restrict__ w, int x0, int b0, int rbr,
                                           float* win, float4* wv) {
#pragma unroll
  for (int v = 0; v < kWin<QX> / 4; ++v) {
    const float4 q = *reinterpret_cast<const float4*>(row + skew(x0 + b0 + 4 * v));
    win[4 * v] = q.x;
    win[4 * v + 1] = q.y;
    win[4 * v + 2] = q.z;
    win[4 * v + 3] = q.w;
  }
#pragma unroll
  for (int b = 0; b < kChunk; ++b) wv[b] = *reinterpret_cast<const float4*>(w + (b0 + b) * rbr);
}

// One staged band row into the accumulators: `row` the source, `w` the
// warp's weights of this band row (tap lx's 4 rows at w + lx*rbr).
template <int QX>
__device__ __forceinline__ void band_row(const float* __restrict__ row,
                                         const float* __restrict__ w, int x0, int qx, int fs,
                                         int rbr, float (&acc)[kRows][kR]) {
  int b0 = 0;
  for (; b0 + kChunk <= fs; b0 += kChunk) {
    if constexpr (QX != 0) {
      float win[kWin<QX>];
      float4 wv[kChunk];
      load_chunk<QX>(row, w, x0, b0, rbr, win, wv);
#pragma unroll
      for (int b = 0; b < kChunk; ++b)
#pragma unroll
        for (int r = 0; r < kR; ++r) fma_rows(win[QX * r + b], wv[b], r, acc);
    } else {
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
        const float4 wv = *reinterpret_cast<const float4*>(w + (b0 + b) * rbr);
#pragma unroll
        for (int r = 0; r < kR; ++r) fma_rows(row[skew(x0 + qx * r + b0 + b)], wv, r, acc);
      }
    }
  }
  for (int b = b0; b < fs; ++b) {  // the last fs % 8 taps, one at a time
    const float4 wv = *reinterpret_cast<const float4*>(w + b * rbr);
#pragma unroll
    for (int r = 0; r < kR; ++r) fma_rows(row[skew(x0 + qx * r + b)], wv, r, acc);
  }
}

template <int QX>
__global__ void __launch_bounds__(256) strips_kernel(const StripsArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int qx = QX ? QX : a.qx;
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int si = blockIdx.z % a.n_strips, f = blockIdx.z / a.n_strips;
  const int rx = blockIdx.y % a.px, rb = blockIdx.y / a.px;
  const int j0 = blockIdx.x * kBJ;
  const int row_min = a.info[si], ny = a.info[a.n_strips + si], nb = a.info[2 * a.n_strips + si];
  const int m0 = rb * a.rbr + kRows * wy;  // the warp's first strip row
  const int wout = a.px * a.nxb;
  float* const outs = a.out + (static_cast<int64_t>(f) * a.n_strips + si) * a.ny_max * wout;

  float acc[kRows][kR];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[m][r] = 0.f;

  const int wn = a.fs * a.rbr;           // a band row's weights, a multiple of 4 floats
  const int slot = wn + a.swp;           // floats of one ring slot: weights, then source
  const int slots = 2 * a.ch;
  if (rb * a.rbr < ny) {  // uniform over the block; rows past the strip stay zero
    const int col0 = a.base_x + a.offs_x[rx] + qx * j0;
    const int sw = qx * (kBJ - 1) + a.fs;  // staged columns
    const float* const plane = a.src + static_cast<int64_t>(f) * a.H * a.W;
    const float* const wg =
        a.w + ((static_cast<int64_t>(si) * a.px + rx) * a.nrb + rb) * a.nb_max * wn;

    auto stage = [&](int k) {  // band rows [k*ch, (k+1)*ch) into their ring slots
      const int s1 = min(nb, (k + 1) * a.ch);
      for (int s = k * a.ch; s < s1; ++s) {
        float* const dst = smem + (s % slots) * slot;
        const float* const ws = wg + static_cast<int64_t>(s) * wn;
        for (int v = threadIdx.x; v < wn / 4; v += blockDim.x) jt_cp_async16(dst + 4 * v, ws + 4 * v);
        const int y = row_min + s;
        const bool yok = static_cast<unsigned>(y) < static_cast<unsigned>(a.H);
        const float* const srow = plane + static_cast<int64_t>(yok ? y : 0) * a.W;
        float* const drow = dst + wn;
        for (int x = threadIdx.x; x < sw; x += blockDim.x) {
          const int xx = col0 + x;
          const bool ok = yok && static_cast<unsigned>(xx) < static_cast<unsigned>(a.W);
          jt_cp_async4(drow + skew(x), ok ? srow + xx : plane, ok);
        }
      }
      jt_cp_async_commit();
    };

    const bool active = m0 < ny;  // uniform over the warp
    const int x0 = qx * kR * lane;  // the thread's first window column
    const int nstages = (nb + a.ch - 1) / a.ch;
    stage(0);
    for (int k = 0; k < nstages; ++k) {
      if (k + 1 < nstages) {
        stage(k + 1);
        jt_cp_async_wait<1>();
      } else {
        jt_cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const int s1 = min(nb, (k + 1) * a.ch);
        for (int s = k * a.ch; s < s1; ++s) {
          const float* const sl = smem + (s % slots) * slot;
          band_row<QX>(sl + wn, sl + kRows * wy, x0, qx, a.fs, a.rbr, acc);
        }
      }
      __syncthreads();
    }
  }

  // Accumulators -> the warp's tile (over the ring) -> each store one row's
  // 32 consecutive anchors.
  float* const tile = smem + wy * kRows * kBJ;
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int r = 0; r < kR; r += 4)
      *reinterpret_cast<float4*>(tile + m * kBJ + kR * lane + r) =
          make_float4(acc[m][r], acc[m][r + 1], acc[m][r + 2], acc[m][r + 3]);
  __syncwarp();
  for (int m = 0; m < kRows && m0 + m < a.ny_max; ++m) {
    float* const orow = outs + static_cast<int64_t>(m0 + m) * wout + rx;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int jj = 32 * k + lane;
      if (j0 + jj < a.nxb) orow[a.px * (j0 + jj)] = tile[m * kBJ + jj];
    }
  }
}

template <int QX>
cudaError_t launch(const StripsArgs& a, int F, cudaStream_t stream) {
  const int warps = a.rbr / kRows;
  const size_t ring = static_cast<size_t>(2) * a.ch * (a.fs * a.rbr + a.swp);
  const size_t tile = static_cast<size_t>(warps) * kRows * kBJ;
  const size_t smem = (ring > tile ? ring : tile) * sizeof(float);
  cudaError_t err = jt_allow_smem(strips_kernel<QX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nxb + kBJ - 1) / kBJ, a.px * a.nrb, F * a.n_strips);
  strips_kernel<QX><<<grid, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// src (F, H, W) f32; w (n_strips, px, nrb, nb_max, fs, rbr) f32 (above);
// info (3*n_strips) int32 = [row_min..., ny..., nb...]; offs_x (px) int32;
// out (F, n_strips, ny_max, px*nxb) f32, rows >= ny of a strip written as
// zeros. All contiguous. rbr (strip rows a block, 4 a warp), ch (band rows a
// stage) and swp (floats of a staged source row): kernels/strips.py layout.
extern "C" int jt_strips(const float* src, const float* w, const int* info, const int* offs_x,
                         float* out, int F, int H, int W, int n_strips, int ny_max, int px,
                         int qx, int base_x, int nxb, int fs, int nb_max, int rbr, int nrb,
                         int ch, int swp, cudaStream_t stream) {
  if (rbr < kRows || rbr > 8 * kRows || rbr % kRows != 0 || nrb * rbr < ny_max || ch < 1 ||
      swp % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const StripsArgs a{src, w, info, offs_x, out, H, W, n_strips, ny_max, px, qx, base_x, nxb,
                     fs, nb_max, rbr, nrb, ch, swp};
  if (qx == 1) return static_cast<int>(launch<1>(a, F, stream));
  if (qx == 2) return static_cast<int>(launch<2>(a, F, stream));
  if (qx == 3) return static_cast<int>(launch<3>(a, F, stream));
  return static_cast<int>(launch<0>(a, F, stream));
}
