"""Fused phase-conv interior: hand-written CUDA kernel and its plain form.

``fused_interior`` replaces ``jincresize_tpu/kernels/pallas_fused.py``
``make_fused_interior``/``_fused_kernel``: it computes the whole periodic
interior of a phase plan directly in destination layout ``(F, py*nyb,
px*nxb)`` (the block that belongs at ``canvas[ylo:, xlo:]``). The CUDA kernel
is ``csrc/fused_interior.cu``.

What bounds it on an H100: each output pixel costs ``Kh*Kw`` fp32 FMAs
(``fs**2`` plus the phases' offset padding), 9.6 G FMAs a frame at 4K->8K
tap 8 and 8.8 G at 4K->1080p tap 16, against 67 TFLOP/s of fp32 FMA; its
bytes (33 MB in, 133 MB out at 4K->8K) take a sixth of that time. So the
kernel is bound by FMA issue, and the design keeps every other instruction
rare beside the FMAs:

* all phases share one window: each phase's (fs, fs) block is placed at its
  source offset in a zero-padded ``(Kh, Kw)`` kernel (``build_conv_kernels``,
  the plain form's own kernels), so output (i, j) of every phase reads the
  source from ``(base_y + qy*i, base_x + qx*j)``;
* a block computes ``C`` anchor rows by ``TX*R`` anchor columns of one group
  of ``G`` phases (``G`` = 4 where the phase count allows, else 1). It
  streams its source window through shared memory once, row by row, in a
  double-buffered ring of ``ch`` rows a stage (4-byte ``cp.async``; zeros
  past the plane);
* a thread holds ``R`` consecutive anchors of ``C`` rows for all ``G``
  phases in registers (``R*C*G`` = 32 accumulators). For each staged source
  row and chunk of 8 taps it loads its register window (``qx*(R-1) + 8``
  values, as 16-byte loads) once and the chunk's weights of each of its
  rows (``8*G`` floats, one 16-byte load per 4, at one address for the whole
  block: a shared-memory broadcast), then runs ``8*R*C*G`` FMAs; the rows
  are padded every 32 floats, so the lanes' 16-byte window loads hit
  distinct banks;
* the accumulators go through shared memory to coalesced output rows.

Every output is one ``fmaf`` chain over its ``(Kh, Kw)`` kernel in row-major
order, the plain form's order (the zero taps of the offset padding add
exact zeros), so the kernel equals ``fused_interior_plain`` bit for bit.

``precision='bf16'`` is the documented non-parity mode, the Pallas kernel's
DEFAULT dot (``pallas_fused.py:235``): the MXU rounds both operands to
bfloat16 in one pass, multiplies exactly and sums in fp32. Here the weights
are rounded once on the host (``round_bf16``: ties to even, kept float32),
and the kernel, built with its compile-time bf16 flag, rounds each source
value as it reads it into registers; the ring, the tiling and the ``fmaf``
chain are the fp32 mode's. What the mode drops is the one-pass MXU dot: a
product of two bfloat16 values is exact in fp32, so an fp32 FMA on the
rounded operands computes what that dot computes, summed in the plain
form's order, and the kernel still equals ``fused_interior_plain`` (which
rounds the source first) bit for bit. A bfloat16 tensor-core form is later
work (ROADMAP).
``layout`` keeps in Python the arithmetic that places a block's staged
window and a thread's register window; the tests check it on the CPU.

TPU workarounds of the Pallas kernel that this one drops:

* the ``split3`` 0/1 scatter-matmul column-phase interleave -- the block
  writes interleaved output rows directly;
* ``residue_planes`` -- Mosaic cannot lower lane-strided slices; a thread
  reads its strided anchors from its register window;
* the ``wsplit3`` bf16 weight split -- fp32 FMA is already exact, so
  ``precision='fp32_u8src'`` runs the same fp32 kernel;
* ``_choose_tmb``, ``_vmem_bytes`` and ``VMEM_BUDGET`` -- the row band is
  ``C`` anchor rows, and shared memory holds one phase group's weights and
  a ring of source rows, not the band;
* the Mosaic deep-tap envelope (``py*px <= 4``, ``fs**2 <= 4500``,
  ``JINCRESIZE_FUSED_FS2_MAX``) -- the kernel reads ``Kh`` and ``Kw`` at run
  time, so a deep tap (fs = 49 or 65 at tap 16) is the same loop, only longer;
* the ``JINCRESIZE_DEEP_FUSED_MIN_PIXELS`` output-size gate
  (``jincresize_tpu/apply_conv.py``), which exists because a Mosaic compile
  takes minutes -- a deep-tap plan takes this kernel at every output size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..operator import PlaneOperator
from ..phase import PhasePlan, build_conv_kernels

from . import _build

# Per-block shared memory an H100 kernel may opt into (227 KB).
MAX_SMEM_BYTES = 232448
# fs**2 above which a plan has deep taps: the envelope of the TPU's seg and
# gather kernels (the Mosaic VMEM budget), which no kernel of the port keeps
# (each is bounded by its shared memory); the tests name deep-tap plans by it.
FS2_MAX = 1200
# The kernel's shapes (compile-time constants of csrc/fused_interior.cu):
# (threads a block, R anchors a thread along x, C*G accumulator rows a
# thread). A thread of a G-phase group holds C = CG // G anchor rows, so
# R*CG accumulators whatever the phase count. Every main-path plan runs the
# default; the narrow block stages rows a quarter as long, for the plans
# with a large step q whose default window row does not fit (``fit_shape``).
DEFAULT_SHAPE = (128, 4, 8)
NARROW_SHAPE = (32, 4, 8)
SHAPES = (DEFAULT_SHAPE, NARROW_SHAPE)
CHUNK = 8  # taps of a register window (csrc/fused_interior.cu kChunk)
# precision modes: 'fp32' and 'fp32_u8src' run the exact fp32 kernel, 'bf16'
# the same kernel on bfloat16-rounded operands.
PRECISIONS = ("fp32", "fp32_u8src", "bf16")
# Shared memory a block aims to stay under: a window that does not fit
# whole streams through the ring in stages of a few rows, so that one
# stage's copies overlap the last one's FMAs (faster on the card than one
# stage of the whole window); a plan whose weights alone pass it streams
# one row a stage.
SMEM_TARGET = 40 * 1024


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bfloat16, ties to even, kept float32:
    the operand rounding of ``precision='bf16'`` (the kernels' own, on the
    card, is ``__float2bfloat16_rn``)."""
    return x.to(torch.bfloat16).to(torch.float32)


F32_U = 2.0**-24  # unit roundoff of float32
BF16_U = 2.0**-8  # unit roundoff of bfloat16 (8 significand bits)
BF16_SUM_TOL = 2e-6  # the fp32 summation limit of the kernels' fp32 modes


def f32_sum_bound(n: int, wsum: float, max_src: float) -> float:
    """The rounding of any float32 multiply-add chain over ``n`` taps
    against its exact value rounded once to float32: (gamma_n + u) * sum|w|
    * max|src|, with u = 2**-24 and gamma_n = n*u / (1 - n*u). A bound of
    the arithmetic, whatever the order of the sum."""
    gamma = n * F32_U / (1 - n * F32_U)
    return (gamma + F32_U) * wsum * max_src


def bf16_bound(op, max_src: float = 1.0) -> float:
    """The analytic bound of a bf16 interior against its fp32 mode on the
    plane of ``op``: each product w*s becomes w*s*(1 + d1)*(1 + d2) with
    |d| <= u, so a pixel moves by at most (2u + u**2) * sum|w| * max|src|,
    sum|w| over the plane's largest class-pair block; plus the fp32
    summation limit."""
    s = float(np.abs(op.pair_blocks).sum((2, 3)).max())
    return (2 * BF16_U + BF16_U**2) * s * max_src + BF16_SUM_TOL


def bf16_lsb(op, peak: float) -> int:
    """``bf16_bound`` at ``max|src| = 1`` in LSB of an integer format of
    ``peak``: floor(bound * peak) + 1."""
    return int(bf16_bound(op) * peak) + 1


def shape_name(shape) -> str:
    return "{}t r{} cg{}".format(*shape)


def _skew(x: int) -> int:
    """Physical offset of window column ``x`` in a staged row: 4 floats of
    padding after every 32, so lanes ``qx*R`` columns apart hit distinct
    banks with 16-byte loads."""
    return x + 4 * (x >> 5)


@dataclass(frozen=True)
class Layout:
    """How the kernel tiles one plan (mirrors ``csrc/fused_interior.cu``)."""

    tx: int  # threads a block
    r: int  # anchors a thread along x
    c: int  # anchor rows a thread (and a block)
    g: int  # phases a thread (a block's phase group)
    ngroups: int  # phase groups: gridDim.z = frames * ngroups
    kh: int  # kernel rows: fs + max(offs_y)
    kw: int  # kernel columns: fs + max(offs_x)
    kwp: int  # weight row stride, kw rounded up to 4
    qx_mode: int  # compile-time qx of the register window (1, 2), else 0
    nr: int  # source rows of a block's window: qy*(c - 1) + kh
    sw: int  # source columns staged: qx*(tx*r - 1) + kw
    swp: int  # floats a staged row takes (padded, skewed)
    ch: int  # rows a ring stage
    slots: int  # staged rows held at once
    smem_bytes: int

    @property
    def bj(self) -> int:
        """Anchor columns of a block."""
        return self.tx * self.r


def layout(
    py: int, px: int, qy: int, qx: int, kh: int, kw: int, shape=DEFAULT_SHAPE, g: int | None = None
) -> Layout:
    """The kernel's tiling of a plan with ``(Kh, Kw)`` kernels under
    ``shape``, ``g`` phases a block (default 4 where the phases split so)."""
    tx, r, cg = shape
    nph = py * px
    if g is None:
        g = 4 if nph % 4 == 0 else 1
    c = cg // g
    kwp = -(-kw // 4) * 4
    nr = qy * (c - 1) + kh
    sw = qx * (tx * r - 1) + kw
    # Window loads of a chunk reach qx*(r - 1) + CHUNK columns past a
    # thread's first, rounded up to 16-byte loads.
    swa = -(-(sw + 4) // 4) * 4
    swp = _skew(swa) + 4
    wfloats = kh * kwp * g
    bjp = tx * r + (tx * r) // 32 + 1
    tile = c * g * bjp
    row_bytes = swp * 4
    room = SMEM_TARGET - wfloats * 4
    if nr * row_bytes <= room:
        ch, slots = nr, nr
    else:
        ch = max(1, room // (2 * row_bytes))
        ch = min(ch, nr)
        slots = nr if ch >= nr else 2 * ch
    smem = (wfloats + max(slots * swp, tile)) * 4
    return Layout(
        tx=tx, r=r, c=c, g=g, ngroups=nph // g, kh=kh, kw=kw, kwp=kwp,
        qx_mode=qx if qx in (1, 2) else 0, nr=nr, sw=sw, swp=swp, ch=ch, slots=slots,
        smem_bytes=smem,
    )  # fmt: skip


def plan_layout(op: PlaneOperator, plan: PhasePlan, shape=DEFAULT_SHAPE) -> Layout:
    fs = op.filter_size
    kh = fs + int(plan.y.offsets.max())
    kw = fs + int(plan.x.offsets.max())
    return layout(plan.y.p, plan.x.p, plan.y.q, plan.x.q, kh, kw, shape)


def block_origin(lay: Layout, qy: int, qx: int, base_y: int, base_x: int, by: int, bx: int):
    """Source (row, column) of block (by, bx)'s staged window, and its first
    anchor (row, column): anchors ``i0 + c``, ``j0 + t*R + r``."""
    i0, j0 = by * lay.c, bx * lay.bj
    return base_y + qy * i0, base_x + qx * j0, i0, j0


def thread_window(lay: Layout, qx: int, t: int, b0: int, taps: int = CHUNK) -> range:
    """Window columns (relative to the block's staged window) that thread
    ``t`` loads for the chunk of ``taps`` taps from ``b0``: with a
    compile-time qx (``qx_mode``) one run of 16-byte loads from
    ``qx*R*t + b0``, else ``qx*r + b`` for each anchor."""
    x0 = qx * lay.r * t + b0
    if lay.qx_mode and taps == CHUNK:
        return range(x0, x0 + -(-(qx * (lay.r - 1) + CHUNK) // 4) * 4)
    return range(x0, x0 + qx * (lay.r - 1) + taps)


def fit_shape(py: int, px: int, qy: int, qx: int, kh: int, kw: int):
    """(shape, g) a plan runs: the default shape with 4 phases a block where
    the phases split so, else the narrow one (shorter staged rows), then
    both with one phase a block (a quarter of the weights), whichever first
    fits the shared memory; None if none fits."""
    for g in dict.fromkeys((4 if py * px % 4 == 0 else 1, 1)):
        for shape in SHAPES:
            if layout(py, px, qy, qx, kh, kw, shape, g).smem_bytes <= MAX_SMEM_BYTES:
                return shape, g
    return None


def smem_bytes(op: PlaneOperator, plan: PhasePlan, shape=DEFAULT_SHAPE) -> int:
    """Shared memory a block of the kernel takes on ``plan``: one phase
    group's weights and the larger of the source ring and the output tile."""
    return plan_layout(op, plan, shape).smem_bytes


def is_supported(op: PlaneOperator, plan: PhasePlan) -> bool:
    """Envelope: one block of some shape fits the shared memory.

    ``phase.plan_phases`` caps ``py*px*fs**2`` at 32768; shared memory holds
    one phase group's weights (at most 4 phases) and a ring of source rows,
    so every plan it returns is admitted, deep taps included; the check
    keeps the kernel honest if that cap ever moves.
    """
    lay = plan_layout(op, plan)
    return fit_shape(plan.y.p, plan.x.p, plan.y.q, plan.x.q, lay.kh, lay.kw) is not None


@dataclass(frozen=True)
class FusedInterior:
    """Device operator of the fused interior for one phase plan."""

    w: torch.Tensor  # (ngroups, Kh, kwp, G) f32: phase g*G + e's kernel at [g, :, :Kw, e]
    kernels: torch.Tensor  # (py*px, Kh, Kw) f32: phase.build_conv_kernels (plain form)
    py: int
    px: int
    qy: int
    qx: int
    base_y: int
    base_x: int
    nyb: int
    nxb: int
    fs: int
    shape: tuple  # the kernel shape engines launch (fit_shape)
    g: int  # phases a block (fit_shape; the layout of w)
    bf16: bool  # precision='bf16': w and kernels rounded, the source in the kernel

    @property
    def out_shape(self) -> tuple[int, int]:
        return self.py * self.nyb, self.px * self.nxb

    def layout(self, shape=None) -> Layout:
        _, kh, kw = self.kernels.shape
        return layout(self.py, self.px, self.qy, self.qx, kh, kw, shape or self.shape, self.g)


def make_fused_interior(
    op: PlaneOperator,
    plan: PhasePlan,
    device: torch.device | str = "cpu",
    precision: str = "fp32",
) -> FusedInterior:
    """Host build of the fused interior's weights for ``plan`` on ``device``
    (``precision='bf16'``: rounded to bfloat16 here, once per geometry)."""
    if precision not in PRECISIONS:
        raise ValueError(f"make_fused_interior: unknown precision {precision!r}")
    bf16 = precision == "bf16"
    K = build_conv_kernels(op, plan)[:, 0]
    if bf16:
        K = round_bf16(torch.from_numpy(K)).numpy()
    nph, kh, kw = K.shape
    fit = fit_shape(plan.y.p, plan.x.p, plan.y.q, plan.x.q, kh, kw)
    if fit is None:
        raise ValueError("make_fused_interior: plan outside the kernel envelope")
    shape, g = fit
    lay = layout(plan.y.p, plan.x.p, plan.y.q, plan.x.q, kh, kw, shape, g)
    w = np.zeros((lay.ngroups, g, kh, lay.kwp), dtype=np.float32)
    w[..., :kw] = K.reshape(lay.ngroups, g, kh, kw)
    return FusedInterior(
        w=torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 3, 1))).to(device),
        kernels=torch.from_numpy(K).to(device),
        py=plan.y.p,
        px=plan.x.p,
        qy=plan.y.q,
        qx=plan.x.q,
        base_y=plan.y.base,
        base_x=plan.x.base,
        nyb=plan.y.nblocks,
        nxb=plan.x.nblocks,
        fs=op.filter_size,
        shape=shape,
        g=g,
        bf16=bf16,
    )


def fused_interior_plain(fi: FusedInterior, src_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: shift-sum over the conv kernels + phase interleave.

    ``src_f`` (F, H, W) float32 -> (F, py*nyb, px*nxb) float32. Reads past the
    plane are zeros (padding), as in the kernel. Under ``fi.bf16`` the
    source is rounded to bfloat16 first (the kernels come rounded). Calls
    are counted in ``fused_interior_plain.calls``, so that a run on the card
    can show that no engine took the plain form.
    """
    fused_interior_plain.calls += 1
    if fi.bf16:
        src_f = round_bf16(src_f)
    F, H, W = src_f.shape
    K = fi.kernels
    nph, Kh, Kw = K.shape
    qy, qx, nyb, nxb = fi.qy, fi.qx, fi.nyb, fi.nxb
    eh = (nyb - 1) * qy + Kh
    ew = (nxb - 1) * qx + Kw
    pad_h = max(0, fi.base_y + eh - H)
    pad_w = max(0, fi.base_x + ew - W)
    lhs = torch.nn.functional.pad(src_f, (0, pad_w, 0, pad_h))
    lhs = lhs[:, fi.base_y : fi.base_y + eh, fi.base_x : fi.base_x + ew]
    conv = torch.zeros((F, nph, nyb, nxb), dtype=torch.float32, device=src_f.device)
    for a in range(Kh):
        for b in range(Kw):
            win = lhs[:, a : a + (nyb - 1) * qy + 1 : qy, b : b + (nxb - 1) * qx + 1 : qx]
            conv.addcmul_(K[:, a, b].view(1, nph, 1, 1), win.unsqueeze(1))
    return (
        conv.view(F, fi.py, fi.px, nyb, nxb)
        .permute(0, 3, 1, 4, 2)
        .reshape(F, fi.py * nyb, fi.px * nxb)
    )


fused_interior_plain.calls = 0


def fused_interior(fi: FusedInterior, src_f: torch.Tensor, shape=None) -> torch.Tensor:
    """Fused interior of ``src_f`` (F, H, W) float32 in destination layout.

    On a CPU tensor this is ``fused_interior_plain``. On a CUDA tensor it
    launches ``csrc/fused_interior.cu`` (counted in ``fused_interior.launches``)
    or raises; it never falls back. ``shape`` is the kernel's (threads,
    R, C*G), one of ``SHAPES`` (default ``fi.shape``); every shape gives the
    same result.
    """
    shape = tuple(shape or fi.shape)
    if shape not in SHAPES:
        raise ValueError(f"fused_interior: shape {shape} is not one of {SHAPES}")
    if src_f.device.type == "cpu":
        return fused_interior_plain(fi, src_f)
    if src_f.device.type != "cuda":
        raise RuntimeError(f"fused_interior: unsupported device {src_f.device}")
    if src_f.dtype != torch.float32 or src_f.dim() != 3 or not src_f.is_contiguous():
        raise ValueError("fused_interior: src must be a contiguous (F, H, W) float32 tensor")
    if fi.w.device != src_f.device:
        raise ValueError("fused_interior: operator and source on different devices")
    lay = fi.layout(shape)
    if lay.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"fused_interior: shape {shape} needs {lay.smem_bytes} B of shared memory")
    F, H, W = src_f.shape
    hout, wout = fi.out_shape
    out = torch.empty((F, hout, wout), dtype=torch.float32, device=src_f.device)
    if F == 0:
        return out
    if F * lay.ngroups > 65535 or -(-fi.nyb // lay.c) > 65535:
        raise ValueError("fused_interior: grid too large (frames x phase groups or anchor rows)")
    with torch.cuda.device(src_f.device):
        rc = _build.library().jt_fused_interior(
            src_f.data_ptr(), fi.w.data_ptr(), out.data_ptr(),
            F, H, W, fi.py, fi.px, fi.qy, fi.qx, fi.base_y, fi.base_x, fi.nyb, fi.nxb,
            lay.kh, lay.kw, lay.kwp, lay.g, lay.ngroups, lay.ch, lay.slots, lay.swp,
            *shape, int(fi.bf16), _build.stream_of(src_f),
        )  # fmt: skip
    _build.check(rc, "jt_fused_interior")
    fused_interior.launches += 1
    return out


fused_interior.launches = 0
