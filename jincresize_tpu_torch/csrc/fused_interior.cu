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
// fit, 2 shapes x G in {1, 4} x qx in {1, 2, other} x {fp32, bf16} = 24
// instances); qx = 1 and 2 are compile-time too, so the register window is
// indexed statically; other qx load one anchor's 8 taps at a time. The
// arithmetic that places a block's window and a thread's register window is
// mirrored in kernels/fused.py (layout, block_origin, thread_window) and
// tested there.
//
// precision='bf16' (the Pallas kernel's one-pass DEFAULT dot, :235) is the
// compile-time BF16 flag: the host rounds the weights to bfloat16 once
// (kernels/fused.py make_fused_interior), and each staged source value is
// rounded as it is read into registers (jt_operand); the ring, the tiling
// and the fmaf chain are the fp32 mode's. A product of two bfloat16 values
// is exact in fp32, so this is the MXU's one-pass dot with exact products
// and fp32 sums, and the kernel still equals its plain form (on rounded
// operands) bit for bit.
//
// TPU workarounds dropped: split3 (the output is stored interleaved),
// residue planes (threads read strided anchors from registers), wsplit3
// (fp32 FMA is exact), the VMEM row-band budget and the Mosaic deep-tap
// envelope (kh and kw are runtime values).
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

// One staged source row s (window-relative) into the accumulators of every
// anchor row c that reads it (kernel row a = s - qy*c). Under BF16 each
// source value is rounded to bfloat16 as it is read into registers.
template <int R, int C, int G, int QX, bool BF16>
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
      for (int v = 0; v < kWin; ++v) win[v] = jt_operand<BF16>(win[v]);
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
          for (int b = 0; b < kChunk; ++b) v[b] = jt_operand<BF16>(row[skew(x0 + qx * r + b0 + b)]);
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
    for (int r = 0; r < R; ++r) v[r] = jt_operand<BF16>(row[skew(x0 + qx * r + b)]);
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

template <int TX, int R, int C, int G, int QX, bool BF16>
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
      row_taps<R, C, G, QX, BF16>(ring + (s % a.slots) * a.swp, wsm, s, x0, qx, a.qy, a.kh,
                                  a.kw, a.kwp, acc);
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
  const int hout = a.py * a.nyb, wout = a.px * a.nxb;
  float* const outf = a.out + static_cast<int64_t>(f) * hout * wout;
  const int ph0 = g * G;
  const int ry0 = ph0 / a.px, ry1 = (ph0 + G - 1) / a.px;
  const int ncols = min(a.px * BJ, wout - a.px * j0);
  for (int c = 0; c < C && i0 + c < a.nyb; ++c) {
    const float* const trow = tile + c * G * BJP;
    for (int ry = ry0; ry <= ry1; ++ry) {
      float* const orow = outf + static_cast<int64_t>(a.py * (i0 + c) + ry) * wout + a.px * j0;
      if (TX % a.px == 0) {  // column u = t + TX*k keeps phase rx = t % px
        const int e = ry * a.px + t % a.px - ph0;
        if (e < 0 || e >= G) continue;
        const int step = TX / a.px;
        int jj = t / a.px;
        for (int u = t; u < ncols; u += TX, jj += step) orow[u] = trow[e * BJP + jj + (jj >> 5)];
      } else {
        for (int u = t; u < ncols; u += TX) {
          const int jj = u / a.px;
          const int e = ry * a.px + (u - jj * a.px) - ph0;
          if (e >= 0 && e < G) orow[u] = trow[e * BJP + jj + (jj >> 5)];
        }
      }
    }
  }
}

template <int TX, int R, int C, int G, int QX, bool BF16>
cudaError_t launch(const FusedArgs& a, int F, cudaStream_t stream) {
  constexpr int BJ = TX * R;
  constexpr int BJP = BJ + BJ / 32 + 1;
  const int region = a.slots * a.swp > C * G * BJP ? a.slots * a.swp : C * G * BJP;
  const size_t smem = (static_cast<size_t>(a.kh) * a.kwp * G + region) * sizeof(float);
  cudaError_t err = jt_allow_smem(fused_interior_kernel<TX, R, C, G, QX, BF16>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nxb + BJ - 1) / BJ, (a.nyb + C - 1) / C, F * a.ngroups);
  fused_interior_kernel<TX, R, C, G, QX, BF16><<<grid, TX, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int TX, int R, int CG, int QX, bool BF16>
cudaError_t launch_g(const FusedArgs& a, int F, int g, cudaStream_t stream) {
  if (g == 4) return launch<TX, R, CG / 4, 4, QX, BF16>(a, F, stream);
  if (g == 1) return launch<TX, R, CG, 1, QX, BF16>(a, F, stream);
  return cudaErrorInvalidValue;
}

template <int TX, int R, int CG, bool BF16>
cudaError_t launch_qx(const FusedArgs& a, int F, int g, cudaStream_t stream) {
  if (a.qx == 1) return launch_g<TX, R, CG, 1, BF16>(a, F, g, stream);
  if (a.qx == 2) return launch_g<TX, R, CG, 2, BF16>(a, F, g, stream);
  return launch_g<TX, R, CG, 0, BF16>(a, F, g, stream);
}

template <int TX, int R, int CG>
cudaError_t launch_shape(const FusedArgs& a, int F, int g, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_qx<TX, R, CG, true>(a, F, g, stream)
              : launch_qx<TX, R, CG, false>(a, F, g, stream);
}

}  // namespace

// src (F, H, W) f32; w (ngroups, kh, kwp, g) f32, phase ph = group*g + e's
// kernel at [group, :, :kw, e], zeros beyond kw; out (F, py*nyb, px*nxb)
// f32. All contiguous. ch/slots/swp: the ring (kernels/fused.py layout).
// (tx, r, cg): the shape, one of kernels/fused.py SHAPES. bf16: round each
// source value to bfloat16 at its register load (precision='bf16'; the
// weights come rounded from the host).
extern "C" int jt_fused_interior(const float* src, const float* w, float* out, int F, int H,
                                 int W, int py, int px, int qy, int qx, int base_y, int base_x,
                                 int nyb, int nxb, int kh, int kw, int kwp, int g, int ngroups,
                                 int ch, int slots, int swp, int tx, int r, int cg, int bf16,
                                 cudaStream_t stream) {
  if (g * ngroups != py * px || ch < 1 || slots < 1 || kwp % 4 != 0 || swp % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{src, w, out, H, W, py, px, qy, qx, base_y, base_x, nyb, nxb,
                    kh, kw, kwp, ngroups, ch, slots, swp};
#define JT_SHAPE(TX, R, CG) \
  if (tx == TX && r == R && cg == CG)  \
    return static_cast<int>(launch_shape<TX, R, CG>(a, F, g, bf16 != 0, stream));
  JT_SHAPE(128, 4, 8)
  JT_SHAPE(32, 4, 8)
#undef JT_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}
