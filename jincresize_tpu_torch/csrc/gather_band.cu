// One row shard of the sharded gather engine, stored into the shard's canvas.
//
// Replaces jincresize_tpu/kernels/pallas_gather.py::band_kernel (:306; its
// pallas_call at :333, built by make_gather_band). For destination row r of
// the shard (border rows included) and interior column x in [0, nxi):
//
//   canvas[f, r, x_lo + x] = sum_{ly, lx < fs} band[f, syl[r] + ly, sx[x] + lx]
//                                              * blocks[cy[r], cx[x], ly, lx]
//
// band is the shard's source rows plus the halos collected from its
// neighbours, syl the band-local window starts. The tile body is the gather
// interior's (gather_tile.cuh: staged source ring, 4 rows and up to 8 frames
// a thread, one 16-byte weight load per 4 taps and row); here it reads the
// band, covers every row of the shard, and stores straight into the
// shard's (F, td, dst_w) canvas at column x_lo with the canvas row stride,
// so no interior block is copied into the canvas afterwards. The host
// checks that every window lies inside the band (kernels/gather.py
// make_gather_band); the kernel has no edge rule.
//
// TPU workarounds dropped besides the gather interior's (the fs**2 <= 1200
// envelope among them): the x-expanded class planes passed as a jit
// argument (the remote compile's HTTP 413 limit), the XLA im2col
// P = band[:, colsT], choose_band_tiles against the 12 MB VMEM budget, the
// per-band origins y0, the padding of the band to hp_need, and the
// dynamic_update_slice of the interior into the canvas.
#include "gather_tile.cuh"

// band (F, band_h, W) f32; blocks (n_uy, n_ux, fs, fsp) f32; syl, cy (td)
// int32; sx, cx (nxi) int32; canvas (F, td, dst_w) f32, columns
// [x_lo, x_lo + nxi) written. All contiguous. nf, swp, ch: frames a thread
// and the ring (kernels/gather.py ring_layout).
extern "C" int jt_gather_band(const float* band, const float* blocks, const int* syl,
                              const int* cy, const int* sx, const int* cx, float* canvas, int F,
                              int band_h, int W, int td, int nxi, int n_ux, int fs, int fsp,
                              int dst_w, int x_lo, int nf, int swp, int ch, cudaStream_t stream) {
  const GatherArgs a{band, blocks, syl, cy, sx, cx, canvas + x_lo,
                     static_cast<int64_t>(td) * dst_w, dst_w, F, band_h, W, td, nxi, n_ux, fs,
                     fsp, swp, ch};
  return gather_launch(a, nf, stream);
}
