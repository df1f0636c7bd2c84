"""General-geometry apply: the gather-kernel engine.

Port of ``jincresize_tpu/apply_gather.py``. The execution engine for
aperiodic geometry (no phase plan, no segment-periodic plan): the interior
rectangle ``[y_lo, y_hi) x [x_lo, x_hi)`` runs on ``kernels/gather.py``;
the border strips come from each strip's source row band
(``apply_conv._strip_values_banded``), and the canvas is assembled with one
concatenate when the strips exactly frame the interior, else pasted.
"""

from __future__ import annotations

import torch

from .operator import PlaneOperator

from .apply_conv import banded_strip_values, strip_row_bands
from .apply_xla import finalize, resolve_device, source_f32, to_device
from .kernels import gather as gather_k
from .kernels import lines as lines_k
from .metrics import span

f32 = torch.float32


def strips_frame_interior(op: PlaneOperator, ylo: int, yhi: int, xlo: int, xhi: int) -> bool:
    """The strips are exactly top/bottom full width plus left/right of the
    interior rows around ``[ylo, yhi) x [xlo, xhi)``: one-concatenate assembly."""
    H, W = op.dst_height, op.dst_width
    rects = {(s.y0, s.y1, s.x0, s.x1) for s in op.strips}
    expected = set()
    if ylo > 0:
        expected.add((0, ylo, 0, W))
    if yhi < H:
        expected.add((yhi, H, 0, W))
    if xlo > 0:
        expected.add((ylo, yhi, 0, xlo))
    if xhi < W:
        expected.add((ylo, yhi, xhi, W))
    return rects == expected and len(rects) == len(op.strips)


def assemble(op, interior, rect, strips: dict, src_f, lines=None) -> torch.Tensor:
    """Canvas (F, dst_h, dst_w) from the interior block at ``rect`` =
    (ylo, yhi, xlo, xhi), the exception lines ``lines``
    (``kernels.lines.make_lines`` over the whole canvas, or None), and the
    strips ``{(y0, y1, x0, x1): values}``, which own their pixels."""
    ylo, yhi, xlo, xhi = rect
    H, W = op.dst_height, op.dst_width
    canvas = torch.zeros((src_f.shape[0], H, W), dtype=f32, device=src_f.device)
    canvas[:, ylo:yhi, xlo:xhi] = interior
    if lines is not None:
        lines_k.exc_lines(lines, src_f, canvas)
    for (y0, y1, x0, x1), vals in strips.items():
        canvas[:, y0:y1, x0:x1] = vals
    return canvas


def concat(op, interior, rect, strips: dict) -> torch.Tensor:
    """One-concatenate canvas: rows = [top; [left | interior | right]; bottom]."""
    ylo, yhi, xlo, xhi = rect
    H, W = op.dst_height, op.dst_width
    mid = [strips.get((ylo, yhi, 0, xlo)), interior, strips.get((ylo, yhi, xhi, W))]
    mid = [m for m in mid if m is not None]
    mid = torch.cat(mid, dim=2) if len(mid) > 1 else mid[0]
    rows = [strips.get((0, ylo, 0, W)), mid, strips.get((yhi, H, 0, W))]
    rows = [r for r in rows if r is not None]
    return torch.cat(rows, dim=1) if len(rows) > 1 else rows[0]


class GatherApplier:
    """Aperiodic-geometry applier: gather-kernel interior, banded strips.

    Interface-compatible with ``apply_conv.ConvApplier``: call with (H, W) or
    (F, H, W) sources, get finalized planes back. Raises ValueError when the
    geometry is outside the kernel envelope.
    """

    def __init__(self, op: PlaneOperator, device="cuda"):
        self.device = resolve_device(device)
        if not gather_k.is_supported(op):
            raise ValueError("GatherApplier: geometry outside kernel envelope")
        self.op = op
        self.interior = "gather"
        self.effective_precision = "fp32"  # fp32 FMA throughout, no precision modes
        self.gi = gather_k.make_gather_interior(op, self.device)
        self._dop = to_device(op, self.device)
        self._strip_bands = strip_row_bands(op)
        self._rect = (op.y_lo, op.y_hi, op.x_lo, op.x_hi)
        self._concat = strips_frame_interior(op, *self._rect)

    def _acc(self, src_f):
        """(F, H, W) float32 -> (F, dst_h, dst_w) float32 accumulator."""
        with span("jinc.interior"):
            interior = gather_k.gather_interior(self.gi, src_f)
        strips = banded_strip_values(self._dop, self._strip_bands, src_f)
        with span("jinc.assemble"):
            if self._concat:
                return concat(self.op, interior, self._rect, strips)
            return assemble(self.op, interior, self._rect, strips, src_f)

    def __call__(self, src, out_dtype=f32, peak=None, float_clamp_min=None):
        """Resample ``src`` (H, W) or (F, H, W) on the applier's device."""
        if src.dim() == 2:
            return self(src[None], out_dtype, peak, float_clamp_min)[0]
        with span("jinc.source_f32"):
            src_f = source_f32(src, float_clamp_min)
        acc = self._acc(src_f)
        with span("jinc.finalize"):
            return finalize(acc, out_dtype, peak)
