// Native operator-builder core: coefficient block computation.
//
// Equivalent of the reference's generate_coeff_table_c inner loops
// (the reference's src/JincResize.cpp:480-514) re-architected for the
// vectorized builder: instead of walking destination pixels with a memo, the
// Python layer hands us the deduplicated per-row/per-column tap-distance
// vectors and we produce normalized (fs x fs) float32 blocks for the full
// (ny x nx) grid — the same quantity operator.compute_blocks computes in
// NumPy, bit-for-bit:
//   * float64 distances = float32 pre-step offsets x float64 filter steps;
//   * LUT index = round-half-even(1023 * (dx^2 + dy^2) / radius^2)
//     (the reference's DOUBLE_ROUND_MAGIC_NUMBER trick is exactly f64 RNE);
//   * float32 factor from the float64 LUT, zero past the end;
//   * strictly serial float32 normalization in ly-major tap order.
//
// Exposed as a plain C ABI for ctypes; OpenMP-free (the builder parallelizes
// across block rows in Python threads if ever needed — construction is
// one-time cost).

#include <cfenv>
#include <cmath>
#include <cstdint>

extern "C" {

// dist_y: (ny, fs) float32; dist_x: (nx, fs) float32; lut: (lut_size,) float64
// out: (ny, nx, fs, fs) float32
void build_blocks(const float* dist_y, const float* dist_x, int64_t ny,
                  int64_t nx, int64_t fs, double step_y, double step_x,
                  const double* lut, int64_t lut_size, double radius2,
                  double samples_minus_1, float* out) {
  // Precompute squared scaled distances once per axis.
  double* dy2 = new double[ny * fs];
  double* dx2 = new double[nx * fs];
  for (int64_t i = 0; i < ny * fs; ++i) {
    const double d = static_cast<double>(dist_y[i]) * step_y;
    dy2[i] = d * d;
  }
  for (int64_t i = 0; i < nx * fs; ++i) {
    const double d = static_cast<double>(dist_x[i]) * step_x;
    dx2[i] = d * d;
  }

  const int64_t bs = fs * fs;
  for (int64_t iy = 0; iy < ny; ++iy) {
    for (int64_t ix = 0; ix < nx; ++ix) {
      float* blk = out + (iy * nx + ix) * bs;
      float divider = 0.0f;
      for (int64_t ly = 0; ly < fs; ++ly) {
        const double y2 = dy2[iy * fs + ly];
        for (int64_t lx = 0; lx < fs; ++lx) {
          const double val =
              (samples_minus_1 * (dx2[ix * fs + lx] + y2)) / radius2;
          // nearbyint under FE_TONEAREST == round-half-even == np.rint.
          const long long index = static_cast<long long>(std::nearbyint(val));
          const float factor =
              (index < lut_size) ? static_cast<float>(lut[index]) : 0.0f;
          blk[ly * fs + lx] = factor;
          divider += factor;  // strictly serial f32, ly-major order
        }
      }
      for (int64_t k = 0; k < bs; ++k) blk[k] /= divider;
    }
  }
  delete[] dy2;
  delete[] dx2;
}

}  // extern "C"
