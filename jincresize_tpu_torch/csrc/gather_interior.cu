// Interior of any geometry: per-pixel window starts and dictionary classes.
//
// Replaces jincresize_tpu/kernels/pallas_gather.py::_gather_kernel (:137;
// its pallas_call at :455, built by make_gather_interior). For interior row
// m and column x:
//
//   out[f, m, x] = sum_{ly, lx < fs} src[f, sy[m] + ly, sx[x] + lx]
//                                    * blocks[cy[m], cx[x], ly, lx]
//
// The tile body, what bounds it on an H100 and what the design does about
// it are in gather_tile.cuh, shared with the band kernel (gather_band.cu).
//
// TPU workarounds dropped: the x-expanded class planes Wx[n_uy, fs2p,
// nxi_pad] (1.16 GB at 256x256 classes) -- a thread reads its pixel's
// block of the compact dictionary; the XLA horizontal im2col P[f, h, lx, x]
// -- the source window is staged in shared memory; _choose_tiles against
// the 12 MB VMEM budget, the band origins syloc/y0 and the padding of rows
// and columns to the tile grid -- a block covers a 32 x 16 tile and masks
// the ragged edge; the JINCRESIZE_GATHER_TN/TM overrides; and the
// fs**2 <= 1200 envelope (the VMEM tile budget of a deep-tap window) -- the
// window streams through a ring of source rows, so fs is a run-time value.
#include "gather_tile.cuh"

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
