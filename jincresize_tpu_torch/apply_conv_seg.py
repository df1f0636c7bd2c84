"""Segment-periodic conv apply: the engine for drifted rational scales.

Port of ``jincresize_tpu/apply_conv_seg.py``. Pairs the shared planner
``phase.plan_phases_seg`` with ``kernels/seg.py``: the kernel computes the
plan-covered interior rectangle; exception rows and columns (start-offset
outliers and partial trailing periods) are written into the canvas by
``kernels/lines.py`` (one kernel launch a call); border strips come from
each strip's source row band. The canvas is assembled with one concatenate
when the strips frame the interior and no exceptions exist, else pasted
with the precedence columns, then rows, then strips.
"""

from __future__ import annotations

import torch

from .operator import PlaneOperator
from .phase import SegPhasePlan, plan_phases_seg

from .apply_conv import banded_strip_values, strip_row_bands
from .apply_gather import assemble, concat, strips_frame_interior
from .apply_xla import finalize, resolve_device, source_f32, to_device
from .kernels import fused as fused_k
from .kernels import lines as lines_k
from .kernels import seg as seg_k
from .metrics import span

f32 = torch.float32

# The seg interior's kernel mode for each applier precision: the JAX
# package's mapping (jincresize_tpu/apply_conv_seg.py:72-76), where u8
# planes ('fp32_u8src', bf16-exact sources) take its in-kernel weight split
# wsplit3_vmem, the seg kernel's 'wsplit3' mode here. On an H100 80GB HBM3
# at 700 W (chip_smoke.py phase 4, 8-frame u8 luma batches): 0.184 ms/frame
# at 1440p->4K tap 8 against the fp32 FMA kernel's 0.239; at 1440p->1080p
# tap 16 (fs 44, one frame a block beside the float32 blocks) 0.558 against
# 0.436, slower.
KERNEL_PRECISION = {"fp32": "fp32", "bf16": "bf16", "fp32_u8src": "wsplit3"}


class SegConvApplier:
    """Drifted-geometry applier: segment-periodic kernel interior.

    Interface-compatible with ``ConvApplier``/``GatherApplier``. Raises
    ValueError when the geometry has no segment-periodic plan or the plan is
    outside the kernel envelope. ``precision`` is ``'fp32'`` (the exact
    fp32 kernel), ``'fp32_u8src'`` (sources known bfloat16-exact, u8 planes:
    the kernel mode ``KERNEL_PRECISION`` maps it to) or ``'bf16'``, the
    documented non-parity mode: the interior kernel on bfloat16-rounded
    operands (``kernels/seg.py``); strips and fixups stay fp32.
    ``effective_precision`` reports the interior's mode in these names
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
        if precision not in KERNEL_PRECISION:
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
        self.si = seg_k.make_seg_interior(op, plan, self.device, KERNEL_PRECISION[precision])
        self.effective_precision = fused_k.APPLIER_PRECISION[self.si.precision]
        self._dop = to_device(op, self.device)
        self._strip_bands = strip_row_bands(op)
        self.lines = lines_k.make_lines(self._dop, plan.x.exceptions, plan.y.exceptions)
        self._rect = (plan.y.lo, plan.y.hi, plan.x.lo, plan.x.hi)
        self._concat = (
            strips_frame_interior(op, *self._rect)
            and len(plan.x.exceptions) == 0
            and len(plan.y.exceptions) == 0
        )

    def _acc(self, src_f):
        """(F, H, W) float32 -> (F, dst_h, dst_w) float32 accumulator."""
        dop = self._dop
        with span("jinc.interior"):
            interior = seg_k.seg_interior(self.si, src_f)
        strips = banded_strip_values(dop, self._strip_bands, src_f)
        with span("jinc.assemble"):
            if self._concat:
                return concat(self.op, interior, self._rect, strips)
            # Exceptions: start-offset outliers + trailing partial periods, with
            # apply_conv._assemble's precedence: columns, then rows, then strips.
            return assemble(self.op, interior, self._rect, strips, src_f, self.lines)

    def __call__(self, src, out_dtype=f32, peak=None, float_clamp_min=None):
        """Resample ``src`` (H, W) or (F, H, W) on the applier's device."""
        if src.dim() == 2:
            return self(src[None], out_dtype, peak, float_clamp_min)[0]
        with span("jinc.source_f32"):
            src_f = source_f32(src, float_clamp_min)
        acc = self._acc(src_f)
        with span("jinc.finalize"):
            return finalize(acc, out_dtype, peak)
