"""General-geometry apply: the gather-kernel engine.

Port of ``jincresize_tpu/apply_gather.py``. The execution engine for
aperiodic geometry (no phase plan, no segment-periodic plan): the interior
rectangle ``[y_lo, y_hi) x [x_lo, x_hi)`` runs on ``kernels/gather.py``,
the border strips on ``kernels/band_strips.py``, and ``canvas.Canvas``
assembles the plane.
"""

from __future__ import annotations

from .operator import PlaneOperator

from .apply_xla import resolve_device, to_device
from .canvas import Canvas, PlaneApplier
from .kernels import band_strips as band_k
from .kernels import gather as gather_k


class GatherApplier(PlaneApplier):
    """Aperiodic-geometry applier: gather-kernel interior, band-strips kernel.

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
        self.band_spec = band_k.make_band_strips(op, self._dop)
        self.canvas = Canvas.make(self._dop, (op.y_lo, op.y_hi, op.x_lo, op.x_hi))

    def _interior(self, src_f):
        return gather_k.gather_interior(self.gi, src_f)

    def _strips(self, src_f):
        return band_k.band_strips(self.band_spec, src_f)
