"""Segment-periodic conv apply: the engine for drifted rational scales.

Port of ``jincresize_tpu/apply_conv_seg.py``. Pairs the shared planner
``phase.plan_phases_seg`` with ``kernels/seg.py``: the kernel computes the
plan-covered interior rectangle; the border strips run on
``kernels/band_strips.py``.
``canvas.Canvas`` assembles the plane and writes the exception rows and
columns (start-offset outliers and partial trailing periods) with
``kernels/lines.py``.
"""

from __future__ import annotations

from .operator import PlaneOperator
from .phase import SegPhasePlan, plan_phases_seg

from .apply_xla import resolve_device, to_device
from .canvas import Canvas, PlaneApplier
from .kernels import band_strips as band_k
from .kernels import fused as fused_k
from .kernels import seg as seg_k


class SegConvApplier(PlaneApplier):
    """Drifted-geometry applier: segment-periodic kernel interior.

    Interface-compatible with ``ConvApplier``/``GatherApplier``. Raises
    ValueError when the geometry has no segment-periodic plan or the plan is
    outside the kernel envelope. ``precision`` is ``'fp32'`` (the exact
    fp32 kernel), ``'fp32_u8src'`` (sources known bfloat16-exact, u8 planes:
    the kernel mode ``kernels.fused.KERNEL_PRECISION`` maps it to) or
    ``'bf16'``, the documented non-parity mode: the interior kernel on
    bfloat16-rounded operands (``kernels/seg.py``); strips and fixups stay
    fp32. ``effective_precision`` reports the interior's mode in these names
    (``'fp32'`` where a plan's fp32 blocks pass the wsplit3 kernel's shared
    memory).
    """

    def __init__(
        self,
        op: PlaneOperator,
        plan: SegPhasePlan | None = None,
        precision: str = "fp32",
        device="cuda",
    ):
        self.device = resolve_device(device)
        if precision not in fused_k.KERNEL_PRECISION:
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
        self.si = seg_k.make_seg_interior(
            op, plan, self.device, fused_k.KERNEL_PRECISION[precision]
        )
        self.effective_precision = fused_k.APPLIER_PRECISION[self.si.precision]
        self._dop = to_device(op, self.device)
        self.band_spec = band_k.make_band_strips(op, self._dop)
        rect = (plan.y.lo, plan.y.hi, plan.x.lo, plan.x.hi)
        self.canvas = Canvas.make(self._dop, rect, plan.x.exceptions, plan.y.exceptions)

    def _interior(self, src_f):
        return seg_k.seg_interior(self.si, src_f)

    def _strips(self, src_f):
        return band_k.band_strips(self.band_spec, src_f)
