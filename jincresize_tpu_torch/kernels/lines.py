"""Exception-line fixups: hand-written CUDA kernel and plain form.

A phase plan (``phase.plan_phases``, ``phase.plan_phases_seg``) leaves out
the destination columns and rows whose windows break its pattern: float32
start-offset outliers and partial trailing periods. Each of their pixels is
computed from its class-pair block, over the fs x fs window at its clamped
start, as the reference does; the appliers paste the plan's interior
first, then these lines, then the border strips.

``make_lines`` builds a plane's spec once, at applier construction: the
lines, each split around the pixels that an exception row owns, so a pixel
where a column crosses a row is computed once, with the row's precedence,
beside the device operator's window starts, class indices and class-pair
blocks, which it shares. ``exc_lines`` then fills every line of the plane,
for all frames, straight into the caller's canvas: one launch of
``csrc/exc_lines.cu`` on a CUDA tensor, ``exc_lines_plain`` on a CPU one.

The kernel replaces no TPU kernel: the JAX package computes these lines
with XLA ops (``_cols_subset`` / ``_rows_subset`` of its ``apply_conv``),
which the port ran as about 8 torch ops a vertical tap; the kernel does a
plane's lines in one launch. Both forms sum in float32, in every precision
mode of the appliers: each tap row from 0 in lx order, one multiply-add a
tap, then the rows in ly order (a chain over all fs * fs taps drifts ~5x
farther from a float64 sum at fs 44).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import metrics
from ..apply_xla import DevicePlaneOperator
from . import _build

COLUMN, ROW = 0, 1  # a line's kind, the first of its four int32s


@dataclass(frozen=True)
class ExcLines:
    """A plane's exception lines and the operator tables the kernel reads."""

    lines: torch.Tensor  # (n_segments, 4) int32: (kind, index, lo, hi)
    dop: DevicePlaneOperator  # its start_*, c*_idx (int64) and pair_blocks, shared
    origin: tuple  # (oy, ox): the destination pixel at the canvas's [.., 0, 0]
    extent: tuple  # (y0, y1, x0, x1): every line pixel lies in [y0, y1) x [x0, x1)
    n_lines: int  # exception columns + exception rows
    n_pixels: int  # the segments' pixels, each once
    max_len: int  # the longest segment's pixels


def line_segments(exc_x, exc_y, col_rows, row_cols) -> np.ndarray:
    """(n, 4) int32 (kind, index, lo, hi): each exception column over the rows
    ``col_rows`` = (y0, y1), less the rows of ``exc_y`` wherever the column
    lies in ``row_cols`` = (x0, x1), which those rows own; each exception
    row over the columns ``row_cols``."""
    (y0, y1), (x0, x1) = col_rows, row_cols
    out = []
    for x in map(int, exc_x):
        cuts = sorted(int(y) for y in exc_y if y0 <= y < y1) if x0 <= x < x1 else []
        lo = y0
        for y in [*cuts, y1]:
            if y > lo:
                out.append((COLUMN, x, lo, y))
            lo = y + 1
    out.extend((ROW, int(y), x0, x1) for y in exc_y if x1 > x0)
    return np.asarray(out, dtype=np.int32).reshape(-1, 4)


def pixels(spec: ExcLines) -> tuple[np.ndarray, np.ndarray]:
    """(ys, xs) int64: every pixel of the spec's segments, in their order."""
    ys, xs = [], []
    for kind, i, lo, hi in spec.lines.tolist():
        along, across = np.arange(lo, hi), np.full(hi - lo, i)
        ys.append(across if kind == ROW else along)
        xs.append(along if kind == ROW else across)
    return np.concatenate(ys).astype(np.int64), np.concatenate(xs).astype(np.int64)


def make_lines(
    dop: DevicePlaneOperator,
    exc_x,
    exc_y,
    col_rows: tuple | None = None,
    row_cols: tuple | None = None,
    origin: tuple = (0, 0),
) -> ExcLines | None:
    """The spec of ``dop``'s exception lines on its device, or None when the
    plan has none.

    ``exc_x``, ``exc_y``: the plan's exception columns and rows. Columns
    span the rows ``col_rows`` and rows the columns ``row_cols`` (default:
    the whole plane); ``origin`` is the destination pixel that the canvas
    given to ``exc_lines`` holds at its [.., 0, 0].
    """
    exc_x, exc_y = np.asarray(exc_x), np.asarray(exc_y)
    if exc_x.size + exc_y.size == 0:
        return None
    H, W = dop.dst_height, dop.dst_width
    col_rows, row_cols = col_rows or (0, H), row_cols or (0, W)
    if not all(col_rows[0] <= y < col_rows[1] for y in exc_y):
        raise ValueError(f"make_lines: an exception row outside the rows {col_rows}")
    segs = line_segments(exc_x, exc_y, col_rows, row_cols)
    cols, rows = segs[segs[:, 0] == COLUMN], segs[segs[:, 0] == ROW]
    ys = [*cols[:, 2], *(cols[:, 3] - 1), *rows[:, 1]]
    xs = [*cols[:, 1], *rows[:, 2], *(rows[:, 3] - 1)]
    lens = segs[:, 3] - segs[:, 2]
    return ExcLines(
        lines=torch.from_numpy(segs).to(dop.pair_blocks.device),
        dop=dop,
        origin=tuple(origin),
        extent=(int(min(ys)), int(max(ys)) + 1, int(min(xs)), int(max(xs)) + 1),
        n_lines=int(exc_x.size + exc_y.size),
        n_pixels=int(lens.sum()),
        max_len=int(lens.max()),
    )


def exc_lines_plain(spec: ExcLines, src_f: torch.Tensor, out: torch.Tensor) -> None:
    """Plain PyTorch form: each line pixel's window gathered a tap row at a
    time; a row's taps summed in float32 from 0, one ``addcmul_`` a tap in lx
    order, and the rows added in ly order, as the kernel does. On a CUDA
    tensor each ``addcmul_`` step is one fused multiply-add, so this equals
    ``csrc/exc_lines.cu`` bit for bit."""
    F, H, W = src_f.shape
    dop = spec.dop
    fs = dop.filter_size
    ys, xs = (torch.from_numpy(a).to(src_f.device) for a in pixels(spec))
    taps = torch.arange(fs, device=src_f.device)
    sy = dop.start_y[ys]
    cols = torch.clamp(dop.start_x[xs][:, None] + taps, 0, W - 1)
    cy, cx = dop.cy_idx[ys], dop.cx_idx[xs]
    acc = src_f.new_zeros((F, ys.shape[0]))
    for ly in range(fs):
        rows = torch.clamp(sy + ly, 0, H - 1)
        P = src_f[:, rows[:, None], cols]  # (F, n_pixels, fs)
        w = dop.pair_blocks[cy, cx, ly]  # (n_pixels, fs)
        row = torch.zeros_like(acc)
        for lx in range(fs):
            row.addcmul_(P[:, :, lx], w[:, lx])
        acc += row
    oy, ox = spec.origin
    out[:, ys - oy, xs - ox] = acc


def exc_lines(spec: ExcLines, src_f: torch.Tensor, out: torch.Tensor) -> None:
    """Write the lines of ``spec`` for every frame of ``src_f`` (F, H, W)
    float32 into ``out`` (F, h, w) float32, in place; ``out`` must hold every
    line pixel, less the spec's origin, or this raises.

    On a CPU tensor this is ``exc_lines_plain``. On a CUDA tensor it launches
    ``csrc/exc_lines.cu`` (counted in ``exc_lines.launches`` and in the
    counter ``exception_launches``) or raises; it never falls back. Either
    adds the lines it computed to the counter ``exception_lines``.
    """
    if src_f.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"exc_lines: unsupported device {src_f.device}")
    if src_f.dtype != torch.float32 or src_f.dim() != 3 or not src_f.is_contiguous():
        raise ValueError("exc_lines: src must be a contiguous (F, H, W) float32 tensor")
    if out.dtype != torch.float32 or out.dim() != 3 or out.shape[0] != src_f.shape[0]:
        raise ValueError("exc_lines: out must be an (F, h, w) float32 tensor")
    (y0, y1, x0, x1), (oy, ox) = spec.extent, spec.origin
    if not (oy <= y0 and y1 - oy <= out.shape[1] and ox <= x0 and x1 - ox <= out.shape[2]):
        raise ValueError(
            f"exc_lines: a {tuple(out.shape[1:])} canvas at {spec.origin} does not hold "
            f"the lines' rows [{y0}, {y1}) and columns [{x0}, {x1})"
        )
    if not (spec.lines.device == src_f.device == out.device):
        raise ValueError("exc_lines: spec, source and canvas on different devices")
    F, H, W = src_f.shape
    if F == 0:
        return None
    if src_f.device.type == "cpu":
        exc_lines_plain(spec, src_f, out)
        metrics.count("exception_lines", spec.n_lines)
        return None
    dop = spec.dop
    with torch.cuda.device(src_f.device):
        rc = _build.library().jt_exc_lines(
            src_f.data_ptr(), dop.pair_blocks.data_ptr(), spec.lines.data_ptr(),
            dop.start_y.data_ptr(), dop.start_x.data_ptr(), dop.cy_idx.data_ptr(),
            dop.cx_idx.data_ptr(), out.data_ptr(), F, H, W, spec.lines.shape[0], spec.max_len,
            dop.pair_blocks.shape[1], dop.filter_size, *out.stride(), oy, ox,
            _build.stream_of(src_f),
        )  # fmt: skip
    _build.check(rc, "jt_exc_lines")
    exc_lines.launches += 1
    metrics.count("exception_launches")
    metrics.count("exception_lines", spec.n_lines)
    return None


exc_lines.launches = 0
