"""Segment-periodic conv apply: the engine for drifted rational scales.

Port of ``jincresize_tpu/apply_conv_seg.py``. Pairs the shared planner
``phase.plan_phases_seg`` with ``kernels/seg.py``: the kernel computes the
plan-covered interior rectangle; exception rows and columns (start-offset
outliers and partial trailing periods) are recomputed with the conv path's
``_cols_subset``/``_rows_subset``; border strips come from each strip's
source row band. The canvas is assembled with one concatenate when the
strips frame the interior and no exceptions exist, else pasted with the
precedence columns, then rows, then strips.
"""

from __future__ import annotations

import numpy as np
import torch

from .operator import PlaneOperator
from .phase import SegPhasePlan, plan_phases_seg

from .apply_conv import _cols_subset, _rows_subset, banded_strip_values, strip_row_bands
from .apply_gather import assemble, concat, strips_frame_interior
from .apply_xla import finalize, resolve_device, source_f32, to_device
from .kernels import seg as seg_k

f32 = torch.float32


class SegConvApplier:
    """Drifted-geometry applier: segment-periodic kernel interior.

    Interface-compatible with ``ConvApplier``/``GatherApplier``. Raises
    ValueError when the geometry has no segment-periodic plan or the plan is
    outside the kernel envelope. ``precision`` is ``'fp32'`` or
    ``'fp32_u8src'`` (both run the exact fp32 kernel) or ``'bf16'``, the
    documented non-parity mode: the interior kernel on bfloat16-rounded
    operands (``kernels/seg.py``); strips and fixups stay fp32.
    """

    def __init__(
        self,
        op: PlaneOperator,
        plan: SegPhasePlan | None = None,
        precision: str = "fp32",
        device="cuda",
    ):
        self.device = resolve_device(device)
        if precision not in seg_k.PRECISIONS:
            raise ValueError(f"SegConvApplier: unknown precision {precision!r}")
        if plan is None:
            plan = plan_phases_seg(op)
        if plan is None:
            raise ValueError("SegConvApplier: no segment-periodic structure")
        if not seg_k.is_supported(op, plan):
            raise ValueError("SegConvApplier: geometry outside kernel envelope")
        self.op = op
        self.plan = plan
        self.interior = "fused-seg"
        self.precision = precision
        self.effective_precision = precision
        self.si = seg_k.make_seg_interior(op, plan, self.device, precision)
        self._dop = to_device(op, self.device)
        self._strip_bands = strip_row_bands(op)

        def t(a):
            return torch.from_numpy(a.astype(np.int64)).to(self.device)

        self._exc_x = t(plan.x.exceptions)
        self._exc_y = t(plan.y.exceptions)
        self._rect = (plan.y.lo, plan.y.hi, plan.x.lo, plan.x.hi)
        self._concat = (
            strips_frame_interior(op, *self._rect)
            and len(plan.x.exceptions) == 0
            and len(plan.y.exceptions) == 0
        )

    def _acc(self, src_f):
        """(F, H, W) float32 -> (F, dst_h, dst_w) float32 accumulator."""
        dop = self._dop
        interior = seg_k.seg_interior(self.si, src_f)
        strips = banded_strip_values(dop, self._strip_bands, src_f)
        if self._concat:
            return concat(self.op, interior, self._rect, strips)
        # Exceptions: start-offset outliers + trailing partial periods, with
        # apply_conv._assemble's precedence: columns, then rows, then strips.
        fixups = []
        if self._exc_x.shape[0]:
            cols = _cols_subset(dop, src_f, self._exc_x)
            fixups.append(((slice(None), slice(None), self._exc_x), cols))
        if self._exc_y.shape[0]:
            fixups.append(((slice(None), self._exc_y), _rows_subset(dop, src_f, self._exc_y)))
        return assemble(self.op, interior, self._rect, strips, src_f, fixups)

    def __call__(self, src, out_dtype=f32, peak=None, float_clamp_min=None):
        """Resample ``src`` (H, W) or (F, H, W) on the applier's device."""
        if src.dim() == 2:
            return self(src[None], out_dtype, peak, float_clamp_min)[0]
        return finalize(self._acc(source_f32(src, float_clamp_min)), out_dtype, peak)
