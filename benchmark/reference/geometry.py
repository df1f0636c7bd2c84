"""Per-axis window geometry of JincResize (frozen copy, float32 walk only).

A copy, frozen for the benchmark's reference, of the host math that places
each destination pixel's EWA window (AviSynth JincResize's
``generate_coeff_table_c``, its src/JincResize.cpp:336-529). Every quantity
is separable: the x geometry depends on the destination column only, the y
geometry on the row only, and a pixel is a border pixel iff its row or its
column is. Replicated bit for bit:

* the float32 serial position walk ``pos += step`` (drift included);
* C truncation toward zero for window ends and quantization;
* the shared ``filter_support = max(support_x, support_y)`` of both axes;
* quantized positions give the distances of interior pixels, unquantized
  clamped positions those of border pixels; the window start a pixel reads
  from is the unquantized clamped begin in both cases.

Only the default float32 walk is kept (the benchmark runs no
``pos_precision='f64'`` configuration).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

f32 = np.float32
f64 = np.float64


def trunc_to_int(x) -> np.ndarray:
    """C ``static_cast<int>`` of a float: truncation toward zero."""
    return np.trunc(np.asarray(x, dtype=f64)).astype(np.int64)


@dataclass(frozen=True)
class Axis:
    """One destination axis: per coordinate, the window start, the border
    flag and the pre-step tap distances (quantized and unquantized)."""

    size_src: int
    filter_step: float  # float64: min(dst / crop, 1)
    start: np.ndarray  # (n,) int64 clamped window begin
    border: np.ndarray  # (n,) bool
    dist_raw: np.ndarray  # (n, fs) float32, border pixels
    dist_quant: np.ndarray  # (n, fs) float32, interior pixels


def _axis(size_src, size_dst, crop_size, quantize, support, fs, step, start_pos) -> Axis:
    buf = np.full(size_dst, f32(crop_size / size_dst), dtype=f32)
    buf[0] = start_pos
    pos = np.cumsum(buf, dtype=f32)  # strict left-to-right float32 walk

    end = trunc_to_int((pos + support).astype(f32))
    border = end >= size_src
    end = np.where(border, size_src - 1, end)
    begin = end - fs + 1
    left = begin < 0
    border = border | left
    begin = np.where(left, 0, begin)

    q_int = trunc_to_int((pos * f32(quantize)).astype(f32))
    qpos = (q_int.astype(f32) / f32(quantize)).astype(f32)
    qbegin = trunc_to_int((qpos + support).astype(f32)) - fs + 1

    taps = np.arange(fs, dtype=np.int64)
    hi = f32(size_src - 1)
    pos_cl = np.clip(pos, f32(0.0), hi).astype(f32)
    qpos_cl = np.clip(qpos, f32(0.0), hi).astype(f32)
    dist_raw = (pos_cl[:, None] - (begin[:, None] + taps).astype(f32)).astype(f32)
    dist_quant = (qpos_cl[:, None] - (qbegin[:, None] + taps).astype(f32)).astype(f32)
    return Axis(size_src, step, begin, border, dist_raw, dist_quant)


@dataclass(frozen=True)
class Plane:
    """Both axes of one plane and their shared filter size."""

    x: Axis
    y: Axis
    filter_size: int


def plane_geometry(
    src_width: int,
    src_height: int,
    dst_width: int,
    dst_height: int,
    radius: float,
    crop_left: float,
    crop_top: float,
    crop_width: float,
    crop_height: float,
    quantize_x: int,
    quantize_y: int,
) -> Plane:
    """Float64 steps, float32 supports, the shared filter size and the
    float32 start positions (the y start divides by ``dst_height * 2`` in
    double before the float32 cast)."""
    step_x = min(float(dst_width) / crop_width, 1.0)
    step_y = min(float(dst_height) / crop_height, 1.0)
    support_x = f32(radius / step_x)
    support_y = f32(radius / step_y)
    support = max(support_x, support_y)
    fs = max(int(np.ceil(f64(support_x) * 2.0)), int(np.ceil(f64(support_y) * 2.0)))
    start_x = f32(crop_left + (crop_width / dst_width - 1.0) / 2.0)
    start_y = f32(crop_top + (crop_height - dst_height) / (dst_height * 2.0))
    return Plane(
        x=_axis(src_width, dst_width, crop_width, quantize_x, support, fs, step_x, start_x),
        y=_axis(src_height, dst_height, crop_height, quantize_y, support, fs, step_y, start_y),
        filter_size=fs,
    )


def chroma_crop(cplace, src_width, src_height, dst_width, dst_height, sub_w, sub_h):
    """(left, top, width, height) of a subsampled chroma plane's crop with
    no user crop: MPEG2 and topleft shift the horizontal crop by half the
    luma/chroma phase difference, topleft the vertical one too, MPEG1 is a
    plain scale (JincResize.cpp:833-862)."""
    div_w, div_h = float(1 << sub_w), float(1 << sub_h)
    left = top = 0.0
    if cplace in ("mpeg2", "topleft"):
        left = 0.5 * (1.0 - float(src_width) / dst_width) / div_w
    if cplace == "topleft":
        top = 0.5 * (1.0 - float(src_height) / dst_height) / div_h
    return left, top, src_width / div_w, src_height / div_h
