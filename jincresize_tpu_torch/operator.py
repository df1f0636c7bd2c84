"""Banded sparse resampling operator: host-side builder and data structures.

A re-design of the reference's coefficient-table "compiler"
(``generate_coeff_table_c`` + ``EWAPixelCoeff``, the reference's
src/JincResize.cpp:284-533, JincResize.h:11-25). A copy of
``jincresize_tpu/operator.py``: the port imports nothing of the JAX package,
and the code is unchanged, so the operators are bit for bit the same.

The reference emits, per destination pixel, a window start and a pointer into a
flat float array of deduplicated (quantized) coefficient blocks. Instead of a
pointer soup, we exploit the separability of the metadata (SURVEY.md §2 C11):

  * apply-time window starts are per-axis vectors ``start_x[dst_w]``,
    ``start_y[dst_h]``;
  * interior pixels' coefficient blocks depend only on the pair of sub-pixel
    quantization classes ``(class_y[y], class_x[x])`` — the reference's
    ``factor_map`` memo becomes a dense pair dictionary
    ``pair_blocks[n_uy, n_ux, fs, fs]``;
  * border pixels (a prefix/suffix of rows and columns) get per-pixel blocks,
    stored as four rectangular strips.

The result is a frozen, device-shippable pytree: frame-time application is a
pure gather-MAC over these arrays with no transcendental math, exactly like
the reference's frame loop touches only ``factor``/``meta`` (SURVEY.md §1
L2->L1 interface).

Bit parity: blocks are computed at the *first-occurrence* destination
coordinate of each class (the reference memoizes first-come blocks, so later
same-class pixels reuse the first block even when float32 drift makes their
positions differ by an ulp). First occurrence of a class pair in row-major
scan order factorizes into (first interior row with class_y, first interior
column with class_x), which the builder replicates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .filters import JINC_ZEROS, LUT_SIZE, build_lut, lut_get_factor
from .geometry import PlaneGeometry, build_plane_geometry

f32 = np.float32
f64 = np.float64


@dataclass(frozen=True)
class BorderStrip:
    """Rectangular strip of border pixels with per-pixel coefficient blocks."""

    y0: int  # destination-row range [y0, y1)
    y1: int
    x0: int  # destination-column range [x0, x1)
    x1: int
    blocks: np.ndarray  # (y1-y0, x1-x0, fs, fs) float32

    @property
    def npixels(self) -> int:
        return (self.y1 - self.y0) * (self.x1 - self.x0)


@dataclass(frozen=True)
class PlaneOperator:
    """Frozen banded sparse resampling operator for one plane geometry."""

    src_width: int
    src_height: int
    dst_width: int
    dst_height: int
    filter_size: int
    radius: float
    # Apply-time window starts (the reference's EWAPixelCoeffMeta start_x/y,
    # which are per-axis by construction).
    start_x: np.ndarray  # (dst_w,) int32
    start_y: np.ndarray  # (dst_h,) int32
    # Interior rectangle [y_lo, y_hi) x [x_lo, x_hi) — everything outside is
    # border (handled by strips).
    x_lo: int
    x_hi: int
    y_lo: int
    y_hi: int
    # Interior dictionary: pair_blocks[cy_idx[y], cx_idx[x]] is the coefficient
    # block of interior pixel (y, x).
    cx_idx: np.ndarray  # (dst_w,) int32 (valid on [x_lo, x_hi))
    cy_idx: np.ndarray  # (dst_h,) int32 (valid on [y_lo, y_hi))
    pair_blocks: np.ndarray  # (n_uy, n_ux, fs, fs) float32
    # Border strips: top, bottom (full width), left, right (interior rows).
    strips: tuple[BorderStrip, ...] = field(default_factory=tuple)

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Operator statistics for observability (SURVEY.md §5 metrics)."""
        fs = self.filter_size
        n_interior = max(0, self.y_hi - self.y_lo) * max(0, self.x_hi - self.x_lo)
        n_border = sum(s.npixels for s in self.strips)
        n_blocks = self.pair_blocks.shape[0] * self.pair_blocks.shape[1]
        dense_nnz = (n_interior + n_border) * fs * fs
        stored = (n_blocks + n_border) * fs * fs
        return {
            "filter_size": fs,
            "dst_pixels": self.dst_width * self.dst_height,
            "interior_pixels": n_interior,
            "border_pixels": n_border,
            "dict_blocks": n_blocks,
            "logical_nnz": dense_nnz,
            "stored_coeff_floats": stored,
            "dedup_ratio": float(dense_nnz) / max(stored, 1),
            "coeff_bytes": int(stored * 4),
        }


def _serial_f32_sum(flat: np.ndarray) -> np.ndarray:
    """Sum along the last axis with strict serial float32 accumulation.

    Replicates the reference's scalar ``divider += factor`` loop
    (JincResize.cpp:493) whose order is ly-major, lx-minor — i.e. row-major
    over the (fs, fs) block.
    """
    acc = np.zeros(flat.shape[:-1], dtype=f32)
    for k in range(flat.shape[-1]):
        acc = (acc + flat[..., k]).astype(f32)
    return acc


def compute_blocks(
    dist_y: np.ndarray,
    dist_x: np.ndarray,
    step_y: float,
    step_x: float,
    lut: np.ndarray,
    radius: float,
    samples: int = LUT_SIZE,
) -> np.ndarray:
    """Compute normalized coefficient blocks for a grid of (y, x) tap vectors.

    ``dist_y``: (ny, fs) float32 pre-step tap distances for each row;
    ``dist_x``: (nx, fs) likewise per column. Returns (ny, nx, fs, fs) float32.

    Semantics per JincResize.cpp:480-514: float64 distances (float32 offset
    times float64 filter step), squared-radius LUT index with
    round-half-to-even (the DOUBLE_ROUND_MAGIC_NUMBER trick at :488 is exactly
    float64 rint), float32 LUT factor, serial float32 normalization.

    Dispatches to the native C++ core (native/jinc_builder.cpp, bit-identical
    semantics) when a toolchain is available; NumPy otherwise.
    """
    from . import native

    out = native.compute_blocks_native(
        dist_y, dist_x, step_y, step_x, lut, radius, samples
    )
    if out is not None:
        return out
    radius2 = f64(radius) * f64(radius)
    dy = dist_y.astype(f64) * f64(step_y)  # (ny, fs)
    dx = dist_x.astype(f64) * f64(step_x)  # (nx, fs)
    # (ny, nx, fs_y, fs_x): dx*dx + dy*dy, then * (samples-1), then / radius2 —
    # same float64 expression order as the reference.
    d2 = dx[None, :, None, :] ** 2 + dy[:, None, :, None] ** 2
    val = (f64(samples - 1) * d2) / radius2
    idx = np.rint(val).astype(np.int64)
    w = lut_get_factor(lut, idx)  # float32
    ny, nx, fs, _ = w.shape
    divider = _serial_f32_sum(w.reshape(ny, nx, fs * fs))
    with np.errstate(divide="ignore", invalid="ignore"):
        w = (w / divider[..., None, None]).astype(f32)
    return w


def _contiguous_border(border: np.ndarray) -> tuple[int, int]:
    """Return (lo, hi): border is a prefix [0, lo) plus suffix [hi, n).

    Window begins/ends are monotone in the position, so axis border flags are
    always a prefix and/or suffix; this is asserted.
    """
    n = len(border)
    interior = np.flatnonzero(~border)
    if len(interior) == 0:
        return n, n
    lo = int(interior[0])
    hi = int(interior[-1]) + 1
    # All coordinates between lo and hi must be interior.
    assert not border[lo:hi].any(), "non-contiguous border flags"
    return lo, hi


def build_plane_operator(
    src_width: int,
    src_height: int,
    dst_width: int,
    dst_height: int,
    radius: float,
    crop_left: float = 0.0,
    crop_top: float = 0.0,
    crop_width: float | None = None,
    crop_height: float | None = None,
    quantize_x: int = 256,
    quantize_y: int = 256,
    blur: float = 1.0,
    lut: np.ndarray | None = None,
    border_chunk_rows: int = 64,
    pos_precision: str | None = None,
) -> PlaneOperator:
    """Build the banded sparse resampling operator for one plane geometry.

    One call per distinct plane geometry, mirroring the reference's one
    ``generate_coeff_table_c`` call per geometry (JincResize.cpp:822-866):
    one operator for luma/444/RGB planes, a second for subsampled chroma.

    ``pos_precision``: None/'f32' replicates the reference's float32 position
    walk (bit parity, default); 'f64' is the drift-free geometry mode that
    keeps rational scale ratios exactly periodic — see
    ``geometry.build_axis_geometry``.
    """
    if crop_width is None:
        crop_width = float(src_width)
    if crop_height is None:
        crop_height = float(src_height)
    if lut is None:
        lut = build_lut(radius, blur)

    g: PlaneGeometry = build_plane_geometry(
        src_width=src_width,
        src_height=src_height,
        dst_width=dst_width,
        dst_height=dst_height,
        radius=radius,
        crop_left=crop_left,
        crop_top=crop_top,
        crop_width=crop_width,
        crop_height=crop_height,
        quantize_x=quantize_x,
        quantize_y=quantize_y,
        pos_dtype=pos_precision or "f32",
    )
    fs = g.filter_size
    gx, gy = g.x, g.y

    x_lo, x_hi = _contiguous_border(gx.border)
    y_lo, y_hi = _contiguous_border(gy.border)

    # ---------------------------------------------------------------- interior
    cx_idx = np.zeros(dst_width, dtype=np.int32)
    cy_idx = np.zeros(dst_height, dtype=np.int32)
    if x_hi > x_lo and y_hi > y_lo:
        ux, x_first, x_inv = np.unique(
            gx.qclass[x_lo:x_hi], return_index=True, return_inverse=True
        )
        uy, y_first, y_inv = np.unique(
            gy.qclass[y_lo:y_hi], return_index=True, return_inverse=True
        )
        cx_idx[x_lo:x_hi] = x_inv.astype(np.int32)
        cy_idx[y_lo:y_hi] = y_inv.astype(np.int32)
        pair_blocks = compute_blocks(
            gy.dist_quant[y_lo + y_first],
            gx.dist_quant[x_lo + x_first],
            gy.filter_step,
            gx.filter_step,
            lut,
            radius,
        )
    else:
        pair_blocks = np.zeros((0, 0, fs, fs), dtype=f32)

    # ------------------------------------------------------------------ border
    # Border pixels use the *unquantized* clamped positions for both axes
    # (is_border short-circuits quantization — JincResize.cpp:485-486), so
    # their blocks come from dist_raw x dist_raw.
    def strip(y0: int, y1: int, x0: int, x1: int) -> BorderStrip | None:
        if y1 <= y0 or x1 <= x0:
            return None
        parts = []
        for cy0 in range(y0, y1, border_chunk_rows):
            cy1 = min(cy0 + border_chunk_rows, y1)
            parts.append(
                compute_blocks(
                    gy.dist_raw[cy0:cy1],
                    gx.dist_raw[x0:x1],
                    gy.filter_step,
                    gx.filter_step,
                    lut,
                    radius,
                )
            )
        blocks = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        return BorderStrip(y0=y0, y1=y1, x0=x0, x1=x1, blocks=blocks)

    strips = [
        strip(0, y_lo, 0, dst_width),  # top (full width)
        strip(y_hi, dst_height, 0, dst_width),  # bottom (full width)
        strip(y_lo, y_hi, 0, x_lo),  # left (interior rows)
        strip(y_lo, y_hi, x_hi, dst_width),  # right (interior rows)
    ]
    strips = tuple(s for s in strips if s is not None)

    return PlaneOperator(
        src_width=src_width,
        src_height=src_height,
        dst_width=dst_width,
        dst_height=dst_height,
        filter_size=fs,
        radius=radius,
        start_x=gx.start.astype(np.int32),
        start_y=gy.start.astype(np.int32),
        x_lo=x_lo,
        x_hi=x_hi,
        y_lo=y_lo,
        y_hi=y_hi,
        cx_idx=cx_idx,
        cy_idx=cy_idx,
        pair_blocks=pair_blocks,
        strips=strips,
    )


def radius_for_tap(tap: int) -> float:
    """``radius = jinc_zeros[tap-1]`` (JincResize.cpp:794)."""
    if not 1 <= tap <= 16:
        raise ValueError("JincResize: tap must be between 1..16.")
    return float(JINC_ZEROS[tap - 1])
