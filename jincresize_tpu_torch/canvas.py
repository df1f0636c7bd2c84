"""The plane pipeline that the single-card engines share, and its canvas.

``ConvApplier``, ``SegConvApplier`` and ``GatherApplier`` are interior
providers over ``PlaneApplier``: each computes its interior rectangle on
its own kernel (``_interior``) and its border strips (``_strips``), and
``PlaneApplier.__call__`` runs the one pipeline between them, each step
under its ``jinc.*`` span: the source to float32, the interior, the
strips, the canvas, ``finalize``.

``Canvas`` holds the one rule that decides how a plane's canvas is
assembled. Where the strips are exactly the top, bottom, left and right of
the interior rectangle and every exception line of the plan crosses it,
the canvas is one concatenate, ``[top; [left | interior | right];
bottom]``, and the exception lines are written over the middle block
(columns over the rectangle's rows, rows over its columns): the strips own
every other pixel. Otherwise the canvas is pasted: zeros, the interior,
the lines over the whole canvas, then the strips, which own their pixels.
Both forms give the same values wherever both apply.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .apply_xla import DevicePlaneOperator, finalize, source_f32
from .kernels import lines as lines_k
from .metrics import span

f32 = torch.float32


def _cat(parts, dim):
    parts = [p for p in parts if p is not None]
    return torch.cat(parts, dim) if len(parts) > 1 else parts[0]


@dataclass(frozen=True)
class Canvas:
    """A plane's canvas: its size, the interior rectangle ``rect`` = (ylo,
    yhi, xlo, xhi), the assembly form (``concat``) and the exception lines
    (``kernels.lines.make_lines`` over that form's canvas, or None)."""

    height: int
    width: int
    rect: tuple
    concat: bool
    lines: lines_k.ExcLines | None

    @classmethod
    def make(cls, dop: DevicePlaneOperator, rect, exc_x=(), exc_y=()) -> Canvas:
        """The canvas of ``dop`` around the interior ``rect``, with the
        plan's exception columns ``exc_x`` and rows ``exc_y``."""
        ylo, yhi, xlo, xhi = rect
        H, W = dop.dst_height, dop.dst_width
        frame = [
            r
            for r, present in (
                ((0, ylo, 0, W), ylo > 0),
                ((yhi, H, 0, W), yhi < H),
                ((ylo, yhi, 0, xlo), xlo > 0),
                ((ylo, yhi, xhi, W), xhi < W),
            )
            if present
        ]
        concat = (
            sorted((s.y0, s.y1, s.x0, s.x1) for s in dop.strips) == sorted(frame)
            and all(xlo <= x < xhi for x in exc_x)
            and all(ylo <= y < yhi for y in exc_y)
        )
        window = dict(col_rows=(ylo, yhi), row_cols=(xlo, xhi), origin=(ylo, 0)) if concat else {}
        lines = lines_k.make_lines(dop, exc_x, exc_y, **window)
        return cls(H, W, tuple(rect), concat, lines)

    def assemble(self, interior, strips: dict, src_f) -> torch.Tensor:
        """(F, height, width) from the (F, yhi - ylo, xhi - xlo) interior,
        the strips ``{(y0, y1, x0, x1): values}`` and the float32 source
        ``src_f`` the lines read."""
        ylo, yhi, xlo, xhi = self.rect
        H, W = self.height, self.width
        if self.concat:
            mid = _cat([strips.get((ylo, yhi, 0, xlo)), interior, strips.get((ylo, yhi, xhi, W))], 2)
            if self.lines is not None:
                lines_k.exc_lines(self.lines, src_f, mid)
            return _cat([strips.get((0, ylo, 0, W)), mid, strips.get((yhi, H, 0, W))], 1)
        canvas = torch.zeros((src_f.shape[0], H, W), dtype=f32, device=src_f.device)
        canvas[:, ylo:yhi, xlo:xhi] = interior
        if self.lines is not None:
            lines_k.exc_lines(self.lines, src_f, canvas)
        for (y0, y1, x0, x1), vals in strips.items():
            canvas[:, y0:y1, x0:x1] = vals
        return canvas


class PlaneApplier:
    """The call of a single-card engine: a subclass sets ``canvas`` and
    gives ``_interior(src_f)``, the (F, yhi - ylo, xhi - xlo) interior, and
    ``_strips(src_f)``, ``{(y0, y1, x0, x1): (F, ny, nx) values}`` of
    every border strip, both float32 from the (F, H, W) float32 source."""

    canvas: Canvas

    def __call__(self, src, out_dtype=f32, peak=None, float_clamp_min=None):
        """Resample ``src`` (H, W) or (F, H, W) on the applier's device."""
        if src.dim() == 2:
            return self(src[None], out_dtype, peak, float_clamp_min)[0]
        with span("jinc.source_f32"):
            src_f = source_f32(src, float_clamp_min)
        with span("jinc.interior"):
            interior = self._interior(src_f)
        with span("jinc.strips"):
            strips = self._strips(src_f)
        with span("jinc.assemble"):
            acc = self.canvas.assemble(interior, strips, src_f)
        with span("jinc.finalize"):
            return finalize(acc, out_dtype, peak)
