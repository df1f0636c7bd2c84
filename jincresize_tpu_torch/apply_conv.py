"""Phase-decomposed convolution apply: the fused-kernel engine.

Port of ``jincresize_tpu/apply_conv.py`` for ``interior='fused'``. For
periodic geometry (``phase.plan_phases``) the interior resample is a strided
correlation in which every (row-phase, column-phase) pair owns one (fs, fs)
coefficient block; ``kernels/fused.py`` computes it in destination layout.
Full-width top/bottom strips run on ``kernels/strips.py``; the left/right
strips are patched with small gathers and tap sums. ``canvas.Canvas``
assembles the plane and writes the exception rows and columns (float32
position drift, partial trailing periods) with ``kernels/lines.py``.

The JAX package's XLA shift-sum interiors (``apply_plane_conv`` and its
deep-tap forms ``_shift_sum_deep``, ``_shift_sum_scan``, ``_shift_sum_mxu``)
are not an engine here: every periodic plan, deep taps (fs = 49, 65 at tap
16) included, runs the fused kernel. Where the strip kernel declines a
plan's top/bottom strips (``kernels.strips._anchor_blocks`` finds the anchor
pattern too broken, or a window row outside the source carries weight), the
strips take the value path, as in the JAX package. The strip kernel takes
strips whose rows step their window start (composed chain operators), where
the JAX package's kernel declines and its value path gives the same values.

No float32 matmul runs here, so a caller's TF32 or bf16 float32-matmul
setting does not reach the glue: where the windows are already gathered one
a pixel, their taps are summed as elementwise float32 products; where one
window serves many pixels' blocks, the contraction runs as a float64 einsum
rounded to float32 (``apply_xla.einsum64``), which no such setting reaches.
"""

from __future__ import annotations

import numpy as np
import torch

from .operator import PlaneOperator
from .phase import PhasePlan, plan_phases

from .apply_strips_fast import _strip_values, plan_strips, strip_values_fast, window_indices
from .apply_xla import einsum64, resolve_device, to_device
from .canvas import Canvas, PlaneApplier
from .kernels import fused as fused_k
from .kernels import strips as strips_k

f32 = torch.float32


def _strip_cols_patch(src_f, band_rows, cols_sx, blocks_band):
    """Per-pixel strip values for selected columns: (F, ny, m).

    ``band_rows`` (nb,) are the strip's source band rows, clamped into the
    plane as the reference clamps window rows; ``cols_sx`` (m,) the columns'
    window starts; ``blocks_band`` (ny, m, nb, fs) their per-pixel blocks
    (corners + verified exceptions of the strip kernel, kernels/strips.py),
    each row's taps at its window start's offset in the band, zeros
    elsewhere.
    """
    W = src_f.shape[2]
    fs = blocks_band.shape[-1]
    taps = torch.arange(fs, device=src_f.device)
    band = src_f[:, band_rows, :]
    cidx = torch.clamp(cols_sx[:, None] + taps[None, :], 0, W - 1)  # (m, fs)
    P = band[:, :, cidx]  # (F, nb, m, fs)
    return einsum64("fkml,ymkl->fym", P, blocks_band)


class ConvApplier(PlaneApplier):
    """Phase-conv applier with the fused interior kernel.

    Every plan of ``phase.plan_phases`` is inside
    ``kernels.fused.is_supported`` (deep taps included); a plan outside it
    raises ValueError. ``precision`` is ``'fp32'`` (the exact fp32 kernel),
    ``'fp32_u8src'`` (sources known bfloat16-exact, u8 planes: the kernel's
    ``'wsplit3'`` mode, exact products summed on the tensor cores) or
    ``'bf16'``, the documented non-parity mode: the interior kernel on
    bfloat16-rounded operands (``kernels/fused.py``); the strips kernel and
    the glue stay fp32, as in the JAX package. ``effective_precision``
    reports the interior's mode in these names (``'fp32'`` where a plan's
    weight parts pass the wsplit3 kernel's shared memory; the JAX package's
    attribute, ``'fp32'`` there off the TPU, where its ``shift`` interior
    runs).
    """

    def __init__(
        self,
        op: PlaneOperator,
        plan: PhasePlan | None = None,
        precision: str = "fp32",
        device="cuda",
    ):
        self.device = resolve_device(device)
        if precision not in fused_k.KERNEL_PRECISION:
            raise ValueError(f"ConvApplier: unknown precision {precision!r}")
        self.precision = precision
        if plan is None:
            plan = plan_phases(op)
        if plan is None:
            raise ValueError("ConvApplier: geometry is aperiodic")
        if not fused_k.is_supported(op, plan):
            raise ValueError("ConvApplier: plan outside the fused kernel envelope")
        self.fi = fused_k.make_fused_interior(
            op, plan, self.device, fused_k.KERNEL_PRECISION[precision]
        )
        self.effective_precision = fused_k.APPLIER_PRECISION[self.fi.precision]
        self._dop = to_device(op, self.device)
        self._strip_plans = plan_strips(op, plan)
        if self._strip_plans is not None:
            self._strip_idx = window_indices(self._dop, self._strip_plans)
        self.strips_spec = None
        self._setup_strip_kernel(op, plan)
        ylo, xlo = plan.y.lo, plan.x.lo
        rect = (ylo, ylo + plan.y.p * plan.y.nblocks, xlo, xlo + plan.x.p * plan.x.nblocks)
        self.canvas = Canvas.make(self._dop, rect, plan.x.exceptions, plan.y.exceptions)

    def _interior(self, src_f):
        return fused_k.fused_interior(self.fi, src_f)

    # ----------------------------------------------------------------- strips
    def _strips_default(self, src_f, only=None):
        dop = self._dop
        if self._strip_plans is not None:
            return {
                rect: acc
                for _, rect, acc in strip_values_fast(
                    dop, self._strip_plans, self._strip_idx, src_f, only=only
                )
            }
        return {
            (s.y0, s.y1, s.x0, s.x1): _strip_values(dop, src_f, s)
            for i, s in enumerate(dop.strips)
            if only is None or i in only
        }

    def _setup_strip_kernel(self, op, plan):
        """Put the full-width strips on the strip kernel when it applies.

        kernels/strips.py computes the pattern-covered top/bottom strip values
        from anchor blocks (bitwise-verified); corners and exception columns
        are patched per pixel; left/right strips stay on strip_values_fast.
        """
        r = strips_k.make_strips(op, plan, self.device)
        self._strip_patches = {}
        self._strips_meta = None
        self._rem = None
        if r is None:
            return
        spec, patches, meta = r
        kernel_rects = set()
        fs = op.filter_size
        for (s, cols), (row_min, _ny, nb) in zip(patches, spec.rows, strict=True):
            kernel_rects.add((s.y0, s.y1, s.x0, s.x1))
            if len(cols) == 0:
                continue
            blocks = np.zeros((s.y1 - s.y0, len(cols), nb, fs), dtype=np.float32)
            for m, d in enumerate(op.start_y[s.y0 : s.y1] - row_min):
                blocks[m, :, d : d + fs] = s.blocks[m, cols - s.x0]
            band_rows = np.clip(row_min + np.arange(nb), 0, op.src_height - 1)
            self._strip_patches[(s.y0, s.y1)] = (
                torch.from_numpy(band_rows).to(self.device),
                torch.from_numpy(cols).to(self.device),
                torch.from_numpy(op.start_x[cols].astype(np.int64)).to(self.device),
                torch.from_numpy(blocks).to(self.device),
            )
        self._rem = tuple(
            i
            for i, s in enumerate(op.strips)
            if (s.y0, s.y1, s.x0, s.x1) not in kernel_rects
        )
        self.strips_spec = spec
        self._strips_meta = meta

    def _strips(self, src_f):
        """{rect: values (F, ny, nx)} of every border strip."""
        if self.strips_spec is None:
            return self._strips_default(src_f)
        meta = self._strips_meta
        xlo, width = meta["xlo"], meta["width"]
        F = src_f.shape[0]
        dst_w = self._dop.dst_width
        out = strips_k.strips(self.strips_spec, src_f)
        blocks = {}
        for si, (y0, y1) in enumerate(meta["strips"]):
            # Full-width row block: kernel values + per-pixel corner and
            # exception columns.
            row_block = torch.zeros((F, y1 - y0, dst_w), dtype=f32, device=src_f.device)
            row_block[:, :, xlo : xlo + width] = out[:, si, : y1 - y0]
            p = self._strip_patches.get((y0, y1))
            if p is not None:
                band_rows, cols, cols_sx, blocks_band = p
                row_block[:, :, cols] = _strip_cols_patch(src_f, band_rows, cols_sx, blocks_band)
            blocks[(y0, y1, 0, dst_w)] = row_block
        if self._rem:
            blocks.update(self._strips_default(src_f, only=self._rem))
        return blocks
