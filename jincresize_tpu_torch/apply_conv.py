"""Phase-decomposed convolution apply: the fused-kernel engine.

Port of ``jincresize_tpu/apply_conv.py`` for ``interior='fused'``. For
periodic geometry (``phase.plan_phases``) the interior resample is a strided
correlation in which every (row-phase, column-phase) pair owns one (fs, fs)
coefficient block; ``kernels/fused.py`` computes it in destination layout.
Full-width top/bottom strips run on ``kernels/strips.py``; exception rows and
columns (float32 position drift, partial trailing periods) are written into
the canvas by ``kernels/lines.py`` (one kernel launch a call); the left/right
strips are patched with small gathers and tap sums. When the strips exactly
frame the interior, the canvas is assembled with one concatenate.
``strip_row_bands`` and ``banded_strip_values`` serve the gather and
segment-periodic appliers' strips from each strip's source row band
(``_strip_values_banded``).

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

from dataclasses import dataclass

import numpy as np
import torch

from .operator import PlaneOperator
from .phase import PhasePlan, build_conv_kernels, plan_phases

from .apply_strips_fast import plan_strips, strip_values_fast, window_indices
from .apply_xla import (DevicePlaneOperator, einsum64, finalize, resolve_device, source_f32,
                        to_device)
from .kernels import fused as fused_k
from .kernels import lines as lines_k
from .kernels import strips as strips_k
from .metrics import span

f32 = torch.float32


@dataclass(frozen=True)
class ConvOperator:
    """Device-resident phase-conv operator (kernels + fixup metadata)."""

    kernels: torch.Tensor  # (py*px, 1, Kh, Kw) float32
    dop: DevicePlaneOperator
    exc_x: torch.Tensor  # (mx,) int64 exception columns (may be empty)
    exc_y: torch.Tensor  # (my,) int64 exception rows
    meta: tuple  # static geometry tuple -- see build_conv_operator
    phase_offsets: tuple = ()  # static ((oy, ox), ...) per phase channel


def build_conv_operator(
    op: PlaneOperator, plan: PhasePlan | None = None, device="cuda"
) -> ConvOperator | None:
    """Compile a PlaneOperator into its phase-conv form; None if aperiodic."""
    device = resolve_device(device)
    if plan is None:
        plan = plan_phases(op)
    if plan is None:
        return None
    K = build_conv_kernels(op, plan)
    Kh, Kw = K.shape[2], K.shape[3]
    meta = (
        plan.y.lo,
        plan.x.lo,
        plan.y.p,
        plan.x.p,
        plan.y.q,
        plan.x.q,
        plan.y.base,
        plan.x.base,
        plan.y.nblocks,
        plan.x.nblocks,
        Kh,
        Kw,
    )
    offs_y = plan.y.offsets
    offs_x = plan.x.offsets
    phase_offsets = tuple(
        (int(offs_y[ry]), int(offs_x[rx]))
        for ry in range(plan.y.p)
        for rx in range(plan.x.p)
    )
    return ConvOperator(
        kernels=torch.from_numpy(K).to(device),
        dop=to_device(op, device),
        exc_x=torch.from_numpy(plan.x.exceptions.astype(np.int64)).to(device),
        exc_y=torch.from_numpy(plan.y.exceptions.astype(np.int64)).to(device),
        meta=meta,
        phase_offsets=phase_offsets,
    )


# ---------------------------------------------------------------------------
# Strip computations: small targeted gathers. Sources are (F, H, W) float32;
# results carry the frame dimension first.
# ---------------------------------------------------------------------------


def _strip_values(dop: DevicePlaneOperator, src_f, s) -> torch.Tensor:
    """Per-pixel border strip apply: (F, ny, nx) via one im2col and tap sums."""
    fs = dop.filter_size
    F, H, W = src_f.shape
    taps = torch.arange(fs, device=src_f.device)
    cols = torch.clamp(dop.start_x[s.x0 : s.x1][:, None] + taps[None, :], 0, W - 1)
    P = src_f[:, :, cols]  # (F, H, nx, fs)
    rows = torch.clamp(dop.start_y[s.y0 : s.y1][:, None] + taps[None, :], 0, H - 1)
    G = P[:, rows]  # (F, ny, k, nx, l)
    return (G.permute(0, 1, 3, 2, 4) * s.blocks).sum((-2, -1))


def _strip_values_banded(
    dop: DevicePlaneOperator,
    src_f,
    s,
    y_min: int,
    band_h: int,
    const_sy: bool = False,
) -> torch.Tensor:
    """``_strip_values`` over the strip's source row band: (F, ny, nx).

    ``_strip_values`` gathers a full-height (F, H, nx, fs) im2col, although a
    strip's windows touch only the ``band_h`` rows from ``y_min`` on
    (``strip_row_bands``, from the host operator's start_y). Here the
    horizontal im2col is taken from that band alone: the windows are
    ``unfold`` views of the band, gathered at the strip's column starts.
    """
    fs = dop.filter_size
    H = src_f.shape[1]
    band_h = min(band_h, H - y_min)
    band = src_f[:, y_min : y_min + band_h]
    # Builder-clamped begins satisfy 0 <= start <= W - fs (strip_row_bands
    # checks src >= fs), so every window is a whole unfold view.
    P = band.unfold(2, fs, 1)[:, :, dop.start_x[s.x0 : s.x1]]  # (F, band_h, nx, fs)
    if const_sy:
        # Every strip row shares one window start (the clamped top/bottom
        # border strips): the vertical taps are a static slice.
        return einsum64("fkxl,yxkl->fyx", P[:, :fs], s.blocks)
    taps = torch.arange(fs, device=src_f.device)
    rows = (dop.start_y[s.y0 : s.y1] - y_min)[:, None] + taps[None, :]
    G = P[:, rows]  # (F, ny, k, nx, l)
    return (G.permute(0, 1, 3, 2, 4) * s.blocks).sum((-2, -1))


def banded_strip_values(dop: DevicePlaneOperator, bands: dict, src_f) -> dict:
    """{(y0, y1, x0, x1): (F, ny, nx) values} of every strip, from its row
    band in ``bands`` (``strip_row_bands``)."""
    with span("jinc.strips"):
        return {
            (s.y0, s.y1, s.x0, s.x1): _strip_values_banded(
                dop, src_f, s, *bands[(s.y0, s.y1, s.x0, s.x1)]
            )
            for s in dop.strips
        }


def strip_row_bands(op: PlaneOperator) -> dict:
    """Static (y_min, band_h, const_sy) per strip rect, from host start_y."""
    fs = op.filter_size
    if op.src_height < fs or op.src_width < fs:
        raise ValueError(
            f"strip_row_bands: source {op.src_width}x{op.src_height} smaller "
            f"than filter_size {fs} -- window slices would be out of bounds"
        )
    out = {}
    for s in op.strips:
        sy = np.asarray(op.start_y[s.y0 : s.y1], dtype=np.int64)
        y_min = int(sy.min())
        out[(s.y0, s.y1, s.x0, s.x1)] = (
            y_min,
            int(sy.max()) - y_min + fs,
            bool((sy == sy[0]).all()),
        )
    return out


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


# ---------------------------------------------------------------------------
# Canvas assembly and the applier.
# ---------------------------------------------------------------------------


def _assemble(cop: ConvOperator, block, src_f, strip_blocks, lines=None) -> torch.Tensor:
    """Paste the dst-layout interior block, then the exception lines
    ``lines`` (``kernels.lines.make_lines`` over the whole canvas, or None),
    then strips.

    Used when the strips do not exactly frame the interior.
    """
    dop = cop.dop
    (ylo, xlo, py, px, qy, qx, base_y, base_x, nyb, nxb, Kh, Kw) = cop.meta
    F = src_f.shape[0]
    canvas = torch.zeros(
        (F, dop.dst_height, dop.dst_width), dtype=f32, device=src_f.device
    )
    canvas[:, ylo : ylo + py * nyb, xlo : xlo + px * nxb] = block
    # Exception fixups (float32 drift deviations + partial trailing periods).
    if lines is not None:
        lines_k.exc_lines(lines, src_f, canvas)
    # Border strips own their pixels.
    for (y0, y1, x0, x1), blk in strip_blocks:
        canvas[:, y0:y1, x0:x1] = blk
    return canvas


# The fused interior's kernel mode for each applier precision: the JAX
# package's mapping (jincresize_tpu/apply_conv.py:656-660). u8 planes
# ('fp32_u8src', bf16-exact sources) take the three-pass weight split on the
# tensor cores, exact products at a third of an fp32 dot's passes: on an
# H100 80GB HBM3 at 700 W (chip_smoke.py phase 4, 8-frame u8 luma batches)
# 0.460 ms/frame at 4K->8K tap 8 against the fp32 FMA kernel's 0.670.
KERNEL_PRECISION = {"fp32": "fp32", "bf16": "bf16", "fp32_u8src": "wsplit3"}


class ConvApplier:
    """Phase-conv applier with the fused interior kernel.

    ``interior`` must be ``'fused'``: the JAX package's XLA shift-sum
    interiors are not ported. Every plan of ``phase.plan_phases`` is inside
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
        interior: str = "fused",
        precision: str = "fp32",
        device="cuda",
    ):
        self.device = resolve_device(device)
        if precision not in KERNEL_PRECISION:
            raise ValueError(f"ConvApplier: unknown precision {precision!r}")
        if interior != "fused":
            raise NotImplementedError(
                f"ConvApplier: interior={interior!r} is not ported; only the "
                "fused kernel interior exists in this package"
            )
        self.precision = precision
        if plan is None:
            plan = plan_phases(op)
        if plan is None:
            raise ValueError("ConvApplier: geometry is aperiodic")
        if not fused_k.is_supported(op, plan):
            raise ValueError("ConvApplier: plan outside the fused kernel envelope")
        self.fi = fused_k.make_fused_interior(op, plan, self.device, KERNEL_PRECISION[precision])
        self.effective_precision = fused_k.APPLIER_PRECISION[self.fi.precision]
        self.cop = build_conv_operator(op, plan, self.device)
        self._strip_plans = plan_strips(op, plan)
        if self._strip_plans is not None:
            self._strip_idx = window_indices(self.cop.dop, self._strip_plans)
        self.strips_spec = None
        self._setup_strip_kernel(op, plan)
        self._concat = self._frame_classification(op)
        # The exception lines: over the middle block of the one-concatenate
        # assembly (columns over its rows, rows over the interior's columns),
        # else over the whole canvas.
        if self._concat is not None:
            ylo, xlo, yhi, xhi, _, _ = self._concat
            window = dict(col_rows=(ylo, yhi), row_cols=(xlo, xhi), origin=(ylo, 0))
        else:
            window = {}
        self.lines = lines_k.make_lines(
            self.cop.dop, plan.x.exceptions, plan.y.exceptions, **window
        )

    # ----------------------------------------------------------------- strips
    def _strip_blocks_default(self, src_f, only=None):
        dop = self.cop.dop
        if self._strip_plans is not None:
            return [
                (rect, acc)
                for _, rect, acc in strip_values_fast(
                    dop, self._strip_plans, self._strip_idx, src_f, only=only
                )
            ]
        return [
            ((s.y0, s.y1, s.x0, s.x1), _strip_values(dop, src_f, s))
            for i, s in enumerate(dop.strips)
            if only is None or i in only
        ]

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

    def _strip_blocks(self, src_f):
        """[(rect, values (F, ny, nx))] for every border strip."""
        with span("jinc.strips"):
            if self.strips_spec is None:
                return self._strip_blocks_default(src_f)
            meta = self._strips_meta
            xlo, width = meta["xlo"], meta["width"]
            F = src_f.shape[0]
            dst_w = self.cop.dop.dst_width
            out = strips_k.strips(self.strips_spec, src_f)
            blocks = []
            for si, (y0, y1) in enumerate(meta["strips"]):
                # Full-width row block: kernel values + per-pixel corner and
                # exception columns.
                row_block = torch.zeros((F, y1 - y0, dst_w), dtype=f32, device=src_f.device)
                row_block[:, :, xlo : xlo + width] = out[:, si, : y1 - y0]
                p = self._strip_patches.get((y0, y1))
                if p is not None:
                    band_rows, cols, cols_sx, blocks_band = p
                    row_block[:, :, cols] = _strip_cols_patch(
                        src_f, band_rows, cols_sx, blocks_band
                    )
                blocks.append(((y0, y1, 0, dst_w), row_block))
            if self._rem:
                blocks.extend(self._strip_blocks_default(src_f, only=self._rem))
            return blocks

    # --------------------------------------------------------------- assembly
    def _frame_classification(self, op):
        """(ylo, xlo, yhi, xhi, H, W) when the strips exactly frame the
        interior block (one-concatenate assembly), else None."""
        (ylo, xlo, py_, px_, qy, qx, by_, bx_, nyb, nxb, Kh, Kw) = self.cop.meta
        H, W = op.dst_height, op.dst_width
        yhi, xhi = ylo + py_ * nyb, xlo + px_ * nxb
        seen, ok = set(), True
        for s in op.strips:
            r = (s.y0, s.y1, s.x0, s.x1)
            if r in (
                (0, ylo, 0, W),
                (yhi, H, 0, W),
                (ylo, yhi, 0, xlo),
                (ylo, yhi, xhi, W),
            ) and r not in seen:
                seen.add(r)
            else:
                ok = False
        if (
            ok
            and (ylo == 0 or (0, ylo, 0, W) in seen)
            and (yhi == H or (yhi, H, 0, W) in seen)
            and (xlo == 0 or (ylo, yhi, 0, xlo) in seen)
            and (xhi == W or (ylo, yhi, xhi, W) in seen)
        ):
            return (ylo, xlo, yhi, xhi, H, W)
        return None

    def _acc_concat(self, src_f):
        """Single-write canvas assembly: rows = [top; [left|interior|right];
        bottom], with exception fixups applied to the middle block only (the
        border strips own their pixels -- same precedence as the
        paste-then-overwrite order of ``_assemble``)."""
        ylo, xlo, yhi, xhi, H, W = self._concat
        with span("jinc.interior"):
            block = fused_k.fused_interior(self.fi, src_f)
        by_rect = dict(self._strip_blocks(src_f))
        with span("jinc.assemble"):
            mid = [
                by_rect.pop((ylo, yhi, 0, xlo), None),
                block,
                by_rect.pop((ylo, yhi, xhi, W), None),
            ]
            mid = [m for m in mid if m is not None]
            mid = torch.cat(mid, dim=2) if len(mid) > 1 else mid[0]
            if self.lines is not None:
                lines_k.exc_lines(self.lines, src_f, mid)
            rows = [
                by_rect.pop((0, ylo, 0, W), None),
                mid,
                by_rect.pop((yhi, H, 0, W), None),
            ]
            rows = [r for r in rows if r is not None]
            return torch.cat(rows, dim=1) if len(rows) > 1 else rows[0]

    def _acc(self, src_f):
        if self._concat is not None:
            return self._acc_concat(src_f)
        with span("jinc.interior"):
            block = fused_k.fused_interior(self.fi, src_f)
        strips = self._strip_blocks(src_f)
        with span("jinc.assemble"):
            return _assemble(self.cop, block, src_f, strips, self.lines)

    def __call__(self, src, out_dtype=f32, peak=None, float_clamp_min=None):
        """Resample ``src`` (H, W) or (F, H, W) on the applier's device."""
        if src.dim() == 2:
            return self(src[None], out_dtype, peak, float_clamp_min)[0]
        with span("jinc.source_f32"):
            src_f = source_f32(src, float_clamp_min)
        acc = self._acc(src_f)
        with span("jinc.finalize"):
            return finalize(acc, out_dtype, peak)
