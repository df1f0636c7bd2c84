"""Per-axis resampling geometry with bit-exact float32 position semantics.

The reference walks destination pixels accumulating ``xpos += x_step`` /
``ypos += y_step`` in float32 and derives, per destination coordinate, the EWA
window placement, border clamping and sub-pixel quantization class
(``generate_coeff_table_c``, the reference's src/JincResize.cpp:336-529).

The load-bearing structural fact (SURVEY.md §2 C11): every one of those
quantities is separable — x-geometry depends only on the destination column and
y-geometry only on the destination row; a pixel is a border pixel iff its
column or row is. This module computes the per-axis vectors once on the host
(NumPy, float32/float64 exactly where the reference uses them) so that the
operator builder and the device kernels never re-derive positions.

Bit-level details replicated:
  * float32 serial accumulation of positions (drift included);
  * C truncation-toward-zero casts for window ends and quantization
    (``static_cast<int>``);
  * the shared ``filter_support = max(support_x, support_y)`` used for both
    axes (JincResize.cpp:355-356, 392-393);
  * quantized positions re-derive a *rebased* window begin used only for
    coefficient values, while the apply-time window start stays at the
    unquantized clamped begin (JincResize.cpp:420-421 vs :449-450).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

f32 = np.float32
f64 = np.float64


def accumulate_positions(start: f32, step: f32, n: int) -> np.ndarray:
    """Serial float32 accumulation: pos[i+1] = f32(pos[i] + step).

    Matches the reference's ``xpos += x_step`` walk (JincResize.cpp:524, 527),
    including float32 drift. ``np.cumsum`` on float32 performs strict
    left-to-right accumulation, which is verified against an explicit loop in
    the test suite.
    """
    if n <= 0:
        return np.empty(0, dtype=f32)
    buf = np.full(n, step, dtype=f32)
    buf[0] = start
    return np.cumsum(buf, dtype=f32)


def trunc_to_int(x: np.ndarray) -> np.ndarray:
    """C ``static_cast<int>`` of a float: truncation toward zero."""
    return np.trunc(np.asarray(x, dtype=f64)).astype(np.int64)


@dataclass(frozen=True)
class AxisGeometry:
    """Geometry of one destination axis (x over columns or y over rows)."""

    size_src: int
    size_dst: int
    quantize: int
    filter_step: float  # float64: min(dst/crop, 1.0)
    # Per-destination-coordinate arrays (length size_dst):
    pos: np.ndarray  # accumulated position: f32 (parity) or f64 (drift-free)
    start: np.ndarray  # int64: clamped window begin (apply-time start)
    border: np.ndarray  # bool: axis border flag
    qclass: np.ndarray  # int64: quantization class (trunc-mod)
    qpos: np.ndarray  # quantized position: f32 (parity) or f64 (drift-free)
    qbegin: np.ndarray  # int64: rebased window begin from quantized position
    # Tap-distance vectors (length size_dst x filter_size), float32, pre-step:
    # (clamped position - window coordinate); multiply by filter_step in f64
    # to get the reference's ``dx``/``dy``. Empty (0, fs) when the geometry
    # was built with dists=False (phase-probe mode — see build_axis_geometry).
    dist_raw: np.ndarray  # from unquantized pos and clamped begin (border path)
    dist_quant: np.ndarray  # from quantized pos and rebased begin (interior)


def build_axis_geometry(
    size_src: int,
    size_dst: int,
    crop_start: float,
    crop_size: float,
    quantize: int,
    filter_support: f32,
    filter_size: int,
    filter_step: float,
    start_pos: f32,
    pos_dtype: str = "f32",
    dists: bool = True,
) -> AxisGeometry:
    """Compute all per-coordinate geometry for one axis.

    ``filter_support`` is the *shared* float32 support (max over the two axes);
    ``start_pos`` is the float32 initial position (axis-specific formula — see
    ``plane_start_positions``).

    ``dists=False`` skips the (size_dst x filter_size) tap-distance matrices
    (stored empty) — the phase-probe mode used by the drift hint, which only
    needs classes/starts/borders and should not pay for coefficient inputs.

    ``pos_dtype='f32'`` (default) replicates the reference's serial float32
    position walk bit-for-bit, drift included. ``'f64'`` is the drift-free
    mode: positions are computed directly as ``start + k*step`` in float64, so
    rational scale ratios yield *exactly* periodic quantization classes and
    window starts — the phase compiler (phase.py) then maps the geometry onto
    the phase-conv path instead of the per-pixel-weight gather kernel. This is a
    documented non-parity mode (outputs differ from the reference wherever its
    float32 drift flipped a quantization class); there is no analog in the
    reference, whose gather kernels are insensitive to periodicity.
    """
    n = size_dst
    if pos_dtype == "f64":
        # Drift-free: direct f64 evaluation, same formula shapes as below but
        # without intermediate float32 rounding.
        step = f64(crop_size) / f64(size_dst)
        pos = f64(start_pos) + np.arange(n, dtype=f64) * step
        support = f64(filter_support)
        end = trunc_to_int(pos + support)
        border = end >= size_src
        end = np.where(border, size_src - 1, end)
        begin = end - filter_size + 1
        left_border = begin < 0
        border = border | left_border
        begin = np.where(left_border, 0, begin)

        q_int = trunc_to_int(pos * f64(quantize))
        qclass = np.fmod(q_int, quantize)
        qpos = q_int.astype(f64) / f64(quantize)
        qbegin = trunc_to_int(qpos + support) - filter_size + 1

        if dists:
            taps = np.arange(filter_size, dtype=np.int64)
            hi = f64(size_src - 1)
            pos_cl = np.clip(pos, f64(0.0), hi)
            qpos_cl = np.clip(qpos, f64(0.0), hi)
            # Cast to f32 at the end: block computation re-widens to f64 and
            # multiplies by the f64 filter step either way (operator.py
            # compute_blocks), so one final rounding keeps the downstream
            # native/NumPy builders unchanged.
            dist_raw = (pos_cl[:, None] - (begin[:, None] + taps[None, :])).astype(f32)
            dist_quant = (
                qpos_cl[:, None] - (qbegin[:, None] + taps[None, :])
            ).astype(f32)
        else:
            dist_raw = np.empty((0, filter_size), dtype=f32)
            dist_quant = np.empty((0, filter_size), dtype=f32)
        return AxisGeometry(
            size_src=size_src,
            size_dst=size_dst,
            quantize=quantize,
            filter_step=filter_step,
            pos=pos,
            start=begin,
            border=border,
            qclass=qclass,
            qpos=qpos,
            qbegin=qbegin,
            dist_raw=dist_raw,
            dist_quant=dist_quant,
        )
    if pos_dtype != "f32":
        raise ValueError(f"build_axis_geometry: unknown pos_dtype {pos_dtype!r}")
    pos = accumulate_positions(start_pos, f32(crop_size / size_dst), n)

    support = f32(filter_support)
    # window_end = int(pos + support)  — float32 add, trunc toward zero
    # (JincResize.cpp:392-393).
    end = trunc_to_int((pos + support).astype(f32))
    border = end >= size_src
    end = np.where(border, size_src - 1, end)
    begin = end - filter_size + 1
    left_border = begin < 0
    border = border | left_border
    begin = np.where(left_border, 0, begin)

    # Quantization (JincResize.cpp:424-429): float32 multiply, trunc cast,
    # C trunc-mod, float32 divide.
    q_int = trunc_to_int((pos * f32(quantize)).astype(f32))
    qclass = np.fmod(q_int, quantize)  # trunc-mod: sign of dividend, like C %
    qpos = (q_int.astype(f32) / f32(quantize)).astype(f32)
    qbegin = trunc_to_int((qpos + support).astype(f32)) - filter_size + 1

    if dists:
        # Distance vectors for the coefficient gather (JincResize.cpp:485-486):
        # float32 ``clamp(pos, 0, src-1) - window_coord`` per tap.
        taps = np.arange(filter_size, dtype=np.int64)
        hi = f32(size_src - 1)
        pos_cl = np.clip(pos, f32(0.0), hi).astype(f32)
        qpos_cl = np.clip(qpos, f32(0.0), hi).astype(f32)
        # float32 subtraction of (clamped float32 pos) - (int window coordinate)
        dist_raw = (
            pos_cl[:, None] - (begin[:, None] + taps[None, :]).astype(f32)
        ).astype(f32)
        dist_quant = (
            qpos_cl[:, None] - (qbegin[:, None] + taps[None, :]).astype(f32)
        ).astype(f32)
    else:
        dist_raw = np.empty((0, filter_size), dtype=f32)
        dist_quant = np.empty((0, filter_size), dtype=f32)

    return AxisGeometry(
        size_src=size_src,
        size_dst=size_dst,
        quantize=quantize,
        filter_step=filter_step,
        pos=pos,
        start=begin,
        border=border,
        qclass=qclass,
        qpos=qpos,
        qbegin=qbegin,
        dist_raw=dist_raw,
        dist_quant=dist_quant,
    )


@dataclass(frozen=True)
class PlaneGeometry:
    """Joint geometry of one plane: two axes + the shared filter footprint."""

    x: AxisGeometry
    y: AxisGeometry
    radius: float
    filter_size: int
    filter_support: f32


def build_plane_geometry(
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
    pos_dtype: str = "f32",
    dists: bool = True,
) -> PlaneGeometry:
    """Derive the shared filter footprint and both axis geometries.

    Mirrors the head of ``generate_coeff_table_c`` (JincResize.cpp:349-364):
    float64 steps, float32 supports, shared max support, shared filter size,
    and the float32 start positions (note the y start divides by
    ``dst_height * 2`` in *double* before the float32 cast).
    ``pos_dtype`` selects the per-coordinate position semantics — see
    ``build_axis_geometry``.
    """
    filter_step_x = min(float(dst_width) / crop_width, 1.0)
    filter_step_y = min(float(dst_height) / crop_height, 1.0)

    support_x = f32(radius / filter_step_x)
    support_y = f32(radius / filter_step_y)
    support = max(support_x, support_y)
    filter_size = max(
        int(np.ceil(f64(support_x) * 2.0)), int(np.ceil(f64(support_y) * 2.0))
    )

    start_x = crop_left + (crop_width / dst_width - 1.0) / 2.0
    start_y = crop_top + (crop_height - dst_height) / (dst_height * 2.0)
    if pos_dtype == "f32":
        start_x, start_y = f32(start_x), f32(start_y)

    gx = build_axis_geometry(
        size_src=src_width,
        size_dst=dst_width,
        crop_start=crop_left,
        crop_size=crop_width,
        quantize=quantize_x,
        filter_support=support,
        filter_size=filter_size,
        filter_step=filter_step_x,
        start_pos=start_x,
        pos_dtype=pos_dtype,
        dists=dists,
    )
    gy = build_axis_geometry(
        size_src=src_height,
        size_dst=dst_height,
        crop_start=crop_top,
        crop_size=crop_height,
        quantize=quantize_y,
        filter_support=support,
        filter_size=filter_size,
        filter_step=filter_step_y,
        start_pos=start_y,
        pos_dtype=pos_dtype,
        dists=dists,
    )
    return PlaneGeometry(
        x=gx, y=gy, radius=radius, filter_size=filter_size, filter_support=support
    )


def chroma_crop(
    cplace: str,
    src_width: int,
    src_height: int,
    dst_width: int,
    dst_height: int,
    crop_left: float,
    crop_top: float,
    crop_width: float,
    crop_height: float,
    sub_w: int,
    sub_h: int,
) -> tuple[float, float, float, float]:
    """Chroma-plane crop rectangle for subsampled formats.

    Chroma-siting math from JincResize.cpp:833-862: MPEG2/topleft shift the
    horizontal crop by half the luma/chroma phase difference; topleft
    additionally shifts vertically; MPEG1 is a plain scale.
    """
    div_w = float(1 << sub_w)
    div_h = float(1 << sub_h)
    if cplace in ("mpeg2", "topleft"):
        crop_left_uv = (0.5 * (1.0 - float(src_width) / dst_width) + crop_left) / div_w
    else:
        crop_left_uv = crop_left / div_w
    if cplace == "topleft":
        crop_top_uv = (0.5 * (1.0 - float(src_height) / dst_height) + crop_top) / div_h
    else:
        crop_top_uv = crop_top / div_h
    return crop_left_uv, crop_top_uv, crop_width / div_w, crop_height / div_h
