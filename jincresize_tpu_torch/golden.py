"""Golden models: the executable specification of the resampling semantics.

Two independent oracles:

  * ``reference_resize_plane`` — a deliberately slow, scalar re-derivation of
    the complete reference algorithm (coefficient generation with the
    factor-map memo + the frame gather-MAC loop,
    the reference's src/JincResize.cpp:336-601) in pure Python/NumPy scalars.
    It shares no code with the vectorized builder, so agreement between the
    two is a strong end-to-end check. Use only on tiny configurations.

  * ``apply_plane_numpy`` — the fast vectorized float32 apply over a built
    ``PlaneOperator``; this is the host-side golden for the device paths.

Both accumulate per destination pixel in the reference's loop order
(ly-major, lx-minor, float32 mul then add — JincResize.cpp:570-579) and store
with ``lrintf(clamp(result, 0, peak))`` for integer formats (round half to
even) and the raw float32 for float formats (JincResize.cpp:581-584).
"""

from __future__ import annotations

import numpy as np

from .filters import LUT_SIZE, build_lut
from .operator import PlaneOperator

f32 = np.float32
f64 = np.float64


def materialize_blocks(op: PlaneOperator) -> np.ndarray:
    """Expand the operator to a dense per-pixel block tensor (dst_h, dst_w, fs, fs).

    Memory-hungry (the un-deduplicated form the reference would occupy with
    quantize=1); intended for golden checks and the tile compiler on small to
    medium planes.
    """
    fs = op.filter_size
    out = np.zeros((op.dst_height, op.dst_width, fs, fs), dtype=f32)
    if op.pair_blocks.size:
        inter = op.pair_blocks[
            op.cy_idx[op.y_lo : op.y_hi][:, None], op.cx_idx[op.x_lo : op.x_hi][None, :]
        ]
        out[op.y_lo : op.y_hi, op.x_lo : op.x_hi] = inter
    for s in op.strips:
        out[s.y0 : s.y1, s.x0 : s.x1] = s.blocks
    return out


def finalize(acc: np.ndarray, out_dtype, peak: float | None) -> np.ndarray:
    """Reference output conversion: clamp+round-half-even for ints, raw floats."""
    if np.issubdtype(np.dtype(out_dtype), np.integer):
        assert peak is not None
        return np.rint(np.clip(acc, f32(0.0), f32(peak))).astype(out_dtype)
    return acc.astype(out_dtype)


def apply_plane_numpy(
    op: PlaneOperator,
    src: np.ndarray,
    out_dtype=None,
    peak: float | None = None,
    float_clamp_min: float | None = None,
) -> np.ndarray:
    """Vectorized float32 gather-MAC apply of a PlaneOperator (host golden).

    ``float_clamp_min`` replicates the SIMD kernels' float-path source clamp
    (``max_ps`` with -0.5 for chroma/alpha, 0.0 for luma/RGB —
    resize_plane_avx2.cpp:24, :89); the reference C kernel does not clamp, so
    the default is None (C semantics).
    """
    if out_dtype is None:
        out_dtype = src.dtype
    fs = op.filter_size
    src_f = src.astype(f32)
    if float_clamp_min is not None and np.issubdtype(src.dtype, np.floating):
        src_f = np.maximum(src_f, f32(float_clamp_min))
    H, W = src_f.shape
    blocks = materialize_blocks(op)
    acc = np.zeros((op.dst_height, op.dst_width), dtype=f32)
    for ly in range(fs):
        rows = np.clip(op.start_y + ly, 0, H - 1)
        srows = src_f[rows]
        for lx in range(fs):
            cols = np.clip(op.start_x + lx, 0, W - 1)
            acc = (acc + srows[:, cols] * blocks[:, :, ly, lx]).astype(f32)
    return finalize(acc, out_dtype, peak)


# ---------------------------------------------------------------------------
# Sampled scalar oracle (production-scale spot checks).
# ---------------------------------------------------------------------------


def reference_sample_pixels(
    src: np.ndarray,
    ys: np.ndarray,
    xs: np.ndarray,
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
):
    """Scalar-oracle values at sampled destination pixels, any plane size.

    Replicates ``reference_resize_plane`` semantics at O(dst_w + dst_h +
    n_samples * fs^2) cost instead of O(dst_px * fs^2): position accumulators
    are advanced serially in float32 exactly like the reference's
    ``xpos += x_step`` loop (JincResize.cpp:524, 531), and a sampled pixel's
    memoized block is computed at the key's FIRST row-major occurrence.
    First-occurrence factorization is exact here because the memo key
    ``(qy_val, qx_val)`` is separable: the set of interior column classes is
    identical in every interior row, so the first pixel with pair (a, b) lies
    in the first interior row with row class a, at the first interior column
    with column class b (the builder relies on the same argument,
    operator.py:25-31 — this oracle derives the classes from the serial
    scalar recurrence instead, so agreement at large indices pins the
    builder's float32 drift tracking at production scale).

    Returns (values[n], blocks[n, fs, fs], start_y[n], start_x[n]).
    """
    src_height, src_width = src.shape
    if crop_width is None:
        crop_width = float(src_width)
    if crop_height is None:
        crop_height = float(src_height)
    lut = build_lut(radius, blur)
    samples = LUT_SIZE

    filter_step_x = min(float(dst_width) / crop_width, 1.0)
    filter_step_y = min(float(dst_height) / crop_height, 1.0)
    support_x = f32(radius / filter_step_x)
    support_y = f32(radius / filter_step_y)
    filter_size = max(
        int(np.ceil(f64(support_x) * 2.0)), int(np.ceil(f64(support_y) * 2.0))
    )
    x_step = f32(crop_width / dst_width)
    y_step = f32(crop_height / dst_height)
    radius2 = f64(radius) * f64(radius)

    def trunc(v) -> int:
        return int(np.trunc(f64(v)))

    # Serial float32 position recurrences (bit-exact reference semantics).
    xpos = np.empty(dst_width, dtype=f32)
    p = f32(crop_left + (crop_width / dst_width - 1.0) / 2.0)
    for x in range(dst_width):
        xpos[x] = p
        p = f32(p + x_step)
    ypos = np.empty(dst_height, dtype=f32)
    p = f32(crop_top + (crop_height - dst_height) / (dst_height * 2.0))
    for y in range(dst_height):
        ypos[y] = p
        p = f32(p + y_step)

    def axis_meta(pos, support, quantize, src_dim):
        n = len(pos)
        end = np.empty(n, dtype=np.int64)
        border = np.zeros(n, dtype=bool)
        qval = np.empty(n, dtype=np.int64)
        for i in range(n):
            e = trunc(f32(pos[i] + support))
            if e >= src_dim:
                e = src_dim - 1
                border[i] = True
            b = e - filter_size + 1
            if b < 0:
                b = 0
                border[i] = True
            end[i] = b  # store window BEGIN
            qi = trunc(f32(pos[i] * f32(quantize)))
            qval[i] = int(np.fmod(qi, quantize))
        return end, border, qval

    beg_x, bor_x, qv_x = axis_meta(xpos, support_x, quantize_x, src_width)
    beg_y, bor_y, qv_y = axis_meta(ypos, support_y, quantize_y, src_height)

    def first_idx(border, qv, cls):
        hits = np.flatnonzero((~border) & (qv == cls))
        return int(hits[0])

    def compute_block(y, x, is_border):
        # Identical math to reference_resize_plane's block branch.
        px_, py_ = xpos[x], ypos[y]
        wbx, wby = int(beg_x[x]), int(beg_y[y])
        if not is_border:
            qx_int = trunc(f32(px_ * f32(quantize_x)))
            qy_int = trunc(f32(py_ * f32(quantize_y)))
            q_xpos = f32(f32(qx_int) / f32(quantize_x))
            q_ypos = f32(f32(qy_int) / f32(quantize_y))
            wbx = trunc(f32(q_xpos + support_x)) - filter_size + 1
            wby = trunc(f32(q_ypos + support_y)) - filter_size + 1
            px_, py_ = q_xpos, q_ypos
        px_ = min(max(px_, f32(0.0)), f32(src_width - 1))
        py_ = min(max(py_, f32(0.0)), f32(src_height - 1))
        block = np.zeros((filter_size, filter_size), dtype=f32)
        divider = f32(0.0)
        for ly in range(filter_size):
            for lx in range(filter_size):
                dx = f64(f32(px_ - f32(wbx + lx))) * f64(filter_step_x)
                dy = f64(f32(py_ - f32(wby + ly))) * f64(filter_step_y)
                val = (f64(samples - 1) * (dx * dx + dy * dy)) / radius2
                index = int(np.rint(val))
                factor = f32(lut[index]) if index < len(lut) else f32(0.0)
                block[ly, lx] = factor
                divider = f32(divider + factor)
        return (block / divider).astype(f32)

    src_f = src.astype(f32)
    n = len(ys)
    vals = np.empty(n, dtype=f32)
    blocks = np.empty((n, filter_size, filter_size), dtype=f32)
    sx_out = np.empty(n, dtype=np.int64)
    sy_out = np.empty(n, dtype=np.int64)
    for i in range(n):
        y, x = int(ys[i]), int(xs[i])
        is_border = bool(bor_x[x] or bor_y[y])
        if is_border:
            block = compute_block(y, x, True)
        else:
            # Memoized block: computed at the key's first occurrence.
            block = compute_block(
                first_idx(bor_y, qv_y, qv_y[y]), first_idx(bor_x, qv_x, qv_x[x]), False
            )
        blocks[i] = block
        sy_out[i], sx_out[i] = beg_y[y], beg_x[x]
        acc = f32(0.0)
        for ly in range(filter_size):
            sy = min(int(beg_y[y]) + ly, src_height - 1)
            for lx in range(filter_size):
                sx = min(int(beg_x[x]) + lx, src_width - 1)
                acc = f32(acc + f32(src_f[sy, sx] * block[ly, lx]))
        vals[i] = acc
    return vals, blocks, sy_out, sx_out


# ---------------------------------------------------------------------------
# Scalar end-to-end oracle (tiny configs only).
# ---------------------------------------------------------------------------


def reference_resize_plane(
    src: np.ndarray,
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
    out_dtype=None,
    peak: float | None = None,
) -> np.ndarray:
    """Scalar re-derivation of generate_coeff_table_c + resize_plane_c.

    Follows the reference's src/JincResize.cpp:336-601 step by step with
    explicit float32/float64 casts. O(dst_px * fs^2) Python-level work — keep
    destinations tiny (<= ~96x96).
    """
    src_height, src_width = src.shape
    if crop_width is None:
        crop_width = float(src_width)
    if crop_height is None:
        crop_height = float(src_height)
    if out_dtype is None:
        out_dtype = src.dtype

    lut = build_lut(radius, blur)
    samples = LUT_SIZE

    filter_step_x = min(float(dst_width) / crop_width, 1.0)
    filter_step_y = min(float(dst_height) / crop_height, 1.0)
    support_x = f32(radius / filter_step_x)
    support_y = f32(radius / filter_step_y)
    support = max(support_x, support_y)
    filter_size = max(
        int(np.ceil(f64(support_x) * 2.0)), int(np.ceil(f64(support_y) * 2.0))
    )
    start_x = f32(crop_left + (crop_width / dst_width - 1.0) / 2.0)
    x_step = f32(crop_width / dst_width)
    y_step = f32(crop_height / dst_height)
    radius2 = f64(radius) * f64(radius)

    factor_map: dict[tuple[int, int], np.ndarray] = {}
    src_f = src.astype(f32)
    dst = np.zeros((dst_height, dst_width), dtype=f32)

    def trunc(v) -> int:
        return int(np.trunc(f64(v)))

    ypos = f32(crop_top + (crop_height - dst_height) / (dst_height * 2.0))
    for y in range(dst_height):
        xpos = start_x
        for x in range(dst_width):
            is_border = False
            window_end_x = trunc(f32(xpos + support))
            window_end_y = trunc(f32(ypos + support))
            if window_end_x >= src_width:
                window_end_x = src_width - 1
                is_border = True
            if window_end_y >= src_height:
                window_end_y = src_height - 1
                is_border = True
            window_begin_x = window_end_x - filter_size + 1
            window_begin_y = window_end_y - filter_size + 1
            if window_begin_x < 0:
                window_begin_x = 0
                is_border = True
            if window_begin_y < 0:
                window_begin_y = 0
                is_border = True
            start_px, start_py = window_begin_x, window_begin_y

            qx_int = trunc(f32(xpos * f32(quantize_x)))
            qy_int = trunc(f32(ypos * f32(quantize_y)))
            qx_val = int(np.fmod(qx_int, quantize_x))
            qy_val = int(np.fmod(qy_int, quantize_y))
            q_xpos = f32(f32(qx_int) / f32(quantize_x))
            q_ypos = f32(f32(qy_int) / f32(quantize_y))

            key = (qy_val, qx_val)
            if not is_border and key in factor_map:
                block = factor_map[key]
            else:
                wbx, wby = window_begin_x, window_begin_y
                if not is_border:
                    wbx = trunc(f32(q_xpos + support)) - filter_size + 1
                    wby = trunc(f32(q_ypos + support)) - filter_size + 1
                px = xpos if is_border else q_xpos
                py = ypos if is_border else q_ypos
                px = min(max(px, f32(0.0)), f32(src_width - 1))
                py = min(max(py, f32(0.0)), f32(src_height - 1))
                block = np.zeros((filter_size, filter_size), dtype=f32)
                divider = f32(0.0)
                for ly in range(filter_size):
                    for lx in range(filter_size):
                        dx = f64(f32(px - f32(wbx + lx))) * f64(filter_step_x)
                        dy = f64(f32(py - f32(wby + ly))) * f64(filter_step_y)
                        val = (f64(samples - 1) * (dx * dx + dy * dy)) / radius2
                        index = int(np.rint(val))
                        factor = (
                            f32(lut[index]) if index < len(lut) else f32(0.0)
                        )
                        block[ly, lx] = factor
                        divider = f32(divider + factor)
                block = (block / divider).astype(f32)
                if not is_border:
                    factor_map[key] = block

            acc = f32(0.0)
            for ly in range(filter_size):
                sy = min(start_py + ly, src_height - 1)
                for lx in range(filter_size):
                    sx = min(start_px + lx, src_width - 1)
                    acc = f32(acc + f32(src_f[sy, sx] * block[ly, lx]))
            dst[y, x] = acc

            xpos = f32(xpos + x_step)
        ypos = f32(ypos + y_step)

    return finalize(dst, out_dtype, peak)
